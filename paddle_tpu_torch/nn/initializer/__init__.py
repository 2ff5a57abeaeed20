"""paddle.nn.initializer (counterpart of ``paddle_tpu/nn/initializer/``):
the 2.0 initializer classes over the fluid initializers, and
``set_global_initializer``."""
from . import assign, constant, kaiming, normal, uniform, xavier
from .assign import Assign
from .constant import Constant
from .kaiming import KaimingNormal, KaimingUniform
from .normal import Normal, TruncatedNormal
from .uniform import Uniform
from .xavier import XavierNormal, XavierUniform
from ...fluid.initializer import set_global_initializer, Bilinear

__all__ = ["Assign", "Constant", "KaimingNormal", "KaimingUniform",
           "Normal", "TruncatedNormal", "Uniform", "XavierNormal",
           "XavierUniform", "Bilinear", "set_global_initializer"]
