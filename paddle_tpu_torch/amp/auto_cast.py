"""``auto_cast`` (counterpart of ``paddle_tpu/amp/auto_cast.py``;
reference python/paddle/amp/auto_cast.py): switches the dygraph tracer's
autocast (``dygraph/base.py Tracer._autocast``) on for the context, in
``bfloat16`` or ``float16``, and back to what it was after.  White ops
run in that dtype, black ops in float32, gray ops follow their inputs
(``amp/lists.py``).  Outside dygraph it marks the default main program,
as the reference does; the static rewrite is the ``amp_bf16`` pass
(``fluid/passes/amp.py``)."""
from __future__ import annotations

import contextlib

from ..fluid.framework import _dygraph_tracer, default_main_program


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              dtype="bfloat16"):
    target = _dygraph_tracer()
    if target is None:
        target = default_main_program()
    prev = (getattr(target, "_amp_enabled", False),
            getattr(target, "_amp_dtype", None))
    target._amp_enabled = enable
    target._amp_dtype = dtype
    try:
        yield
    finally:
        target._amp_enabled, target._amp_dtype = prev


amp_guard = auto_cast
