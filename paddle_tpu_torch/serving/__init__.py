"""paddle_tpu_torch.serving — the inference serving plane (counterpart of
``paddle_tpu.serving``): :func:`freeze_program` turns a Program into a
read-only serving Program, :class:`ServingEngine` batches requests onto
it with deadlines, pause/resume and per-engine instruments, and
:class:`DecodeEngine` serves autoregressive decode with KV caches carried
on the card, block-paged pools, prefix reuse and speculative decoding."""
from .freeze import freeze_program, strip_distribution_ops
from .engine import (ServingEngine, ServingFuture, ServingError,
                     QueueFullError, DeadlineExceededError,
                     EngineClosedError)
from .decode import (DecodeModel, DecodeEngine, DecodeFuture,
                     DecodeRejectedError, build_demo_decode_model,
                     decode_sequential)

__all__ = ["freeze_program", "strip_distribution_ops", "ServingEngine",
           "ServingFuture", "ServingError", "QueueFullError",
           "DeadlineExceededError", "EngineClosedError", "DecodeModel",
           "DecodeEngine", "DecodeFuture", "DecodeRejectedError",
           "build_demo_decode_model", "decode_sequential"]
