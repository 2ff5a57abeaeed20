"""paddle.nn.decode (counterpart of ``paddle_tpu/nn/decode.py``): the
decode framework's 2.0 names."""
from ..fluid.layers import BeamSearchDecoder, dynamic_decode

__all__ = ["BeamSearchDecoder", "dynamic_decode"]
