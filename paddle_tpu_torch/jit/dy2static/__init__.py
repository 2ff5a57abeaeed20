"""paddle.jit.dy2static namespace (reference jit/dy2static/; counterpart
of ``paddle_tpu/jit/dy2static``): the runtime helpers the AST rewrite
targets, re-exported from the dygraph dygraph_to_static implementation."""
from . import convert_operators
from . import convert_call_func
from . import variable_trans_func
from .convert_call_func import convert_call
from .convert_operators import *      # noqa: F401,F403
from .variable_trans_func import *    # noqa: F401,F403

__all__ = (["convert_call"] + list(convert_operators.__all__)
           + list(variable_trans_func.__all__))
