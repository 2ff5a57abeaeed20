"""convert_call (reference jit/dy2static/convert_call_func.py;
counterpart of ``paddle_tpu/jit/dy2static/convert_call_func.py``): route
a callable through the dygraph-to-static converter when it is a plain
python function; builtins and already-converted callables pass through."""
from __future__ import annotations

import builtins
import types

__all__ = ["convert_call"]


def convert_call(func):
    if isinstance(func, types.BuiltinFunctionType) or \
            getattr(builtins, getattr(func, "__name__", ""), None) is func:
        return func
    if getattr(func, "_already_converted", False):
        return func
    try:
        from ...dygraph.dygraph_to_static.ast_transformer import \
            ast_to_static
        converted = ast_to_static(func)
        if converted is None:
            return func
        converted._already_converted = True
        return converted
    except (OSError, TypeError, SyntaxError):
        return func          # source unavailable (C ext, lambda REPL…)
