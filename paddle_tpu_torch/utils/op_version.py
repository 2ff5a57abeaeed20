"""paddle.utils.op_version analog over the real op-version registry
(counterpart of ``paddle_tpu/utils/op_version.py``)
(reference python/paddle/utils/op_version.py OpLastCheckpointChecker over
op_version_registry.h; here fluid/op_version_registry.py holds the
mirrored REGISTER_OP_VERSION pins and their attr-default converters)."""
from __future__ import annotations

__all__ = ["OpLastCheckpointChecker"]


class OpLastCheckpointChecker:
    """Query an op's latest version checkpoint: which attrs gained
    defaults at the last bump (the reference uses this to decide quant
    compatibility)."""

    def __init__(self):
        from ..fluid import op_version_registry as reg
        self._reg = reg

    def version(self, op_name):
        return self._reg.current_version(op_name)

    def _last_checkpoint_attrs(self, op_name):
        cur = self._reg.current_version(op_name)
        if cur == 0:
            return {}
        conv = self._reg._CONVERTERS.get((op_name, cur - 1))
        if conv is None:
            return {}
        attrs: dict = {}
        conv(attrs)             # converters inject the new defaults
        return attrs

    def check_modify(self, op_name, attr_name=None):
        attrs = self._last_checkpoint_attrs(op_name)
        if attr_name is None:
            return sorted(attrs)
        return [attr_name] if attr_name in attrs else []

    def check_add(self, op_name, attr_name=None):
        return self.check_modify(op_name, attr_name)
