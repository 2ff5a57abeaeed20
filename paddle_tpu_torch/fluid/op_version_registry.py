"""Op semantic-version registry — what a saved op's attrs MEAN
(counterpart of ``paddle_tpu/fluid/op_version_registry.py``, the same
pins and converters).

Reference analog: paddle/fluid/framework/op_version_registry.h (each op
registers a version; saved programs carry an OpVersionMap; loaders use it
for compatibility decisions).  Here the registry does two jobs:

* on SAVE, `snapshot()` records the current version of every op type that
  appears in the program into ProgramDesc.op_version_map;
* on LOAD, `check_and_convert()` compares each saved op's version with the
  running registry: older versions are upgraded through registered
  attr-level converters (applied in sequence v, v+1, ... current-1), a
  NEWER version than the runtime knows is a hard error (the attrs could
  silently mean something else), and an op absent from the saved map is
  treated as version 0 (pre-versioning save).

Register a version bump together with its converter so old artifacts keep
loading:

    register_op_version("dropout", 1)

    @register_converter("dropout", from_version=0)
    def _(attrs):  # mutate attrs in place to version-1 meaning
        attrs.setdefault("dropout_implementation", "downgrade_in_infer")
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

__all__ = ["register_op_version", "register_converter", "current_version",
           "snapshot", "check_and_convert", "OpVersionError"]


class OpVersionError(RuntimeError):
    """Saved op version is ahead of what this runtime understands."""


_VERSIONS: Dict[str, int] = {}
_CONVERTERS: Dict[Tuple[str, int], Callable] = {}


def register_op_version(op_type: str, version: int) -> None:
    if version < 0:
        raise ValueError("op version must be >= 0")
    _VERSIONS[op_type] = max(version, _VERSIONS.get(op_type, 0))


def register_converter(op_type: str, from_version: int):
    """Decorator: register fn(attrs_dict) upgrading `op_type` attrs from
    `from_version` to `from_version + 1` semantics (mutates in place)."""
    def deco(fn):
        _CONVERTERS[(op_type, from_version)] = fn
        return fn
    return deco


def current_version(op_type: str) -> int:
    return _VERSIONS.get(op_type, 0)


def snapshot(op_types) -> Dict[str, int]:
    """Current version of every op type in the iterable (for save)."""
    return {t: current_version(t) for t in set(op_types)}


def check_and_convert(op_type: str, attrs: dict, saved_version: int) -> None:
    """Upgrade `attrs` in place from saved_version to the current version.

    Raises OpVersionError only for ops THIS registry tracks when the
    artifact is ahead of the known history — for untracked ops any saved
    version is accepted, because real reference exports pin versions for
    many ops (their registry, op_version_registry.h) whose current
    semantics are exactly what this framework implements; refusing those
    would reject every genuine reference model."""
    cur = current_version(op_type)
    if saved_version > cur:
        if op_type in _VERSIONS:
            raise OpVersionError(
                f"op '{op_type}' was saved at version {saved_version} but "
                f"this runtime only understands version {cur}; upgrade "
                f"paddle_tpu_torch or re-export the model")
        return  # untracked op: implementation follows the reference head
    for v in range(saved_version, cur):
        conv = _CONVERTERS.get((op_type, v))
        if conv is not None:
            conv(attrs)


# --- registered version history -------------------------------------------
# dropout v1: `dropout_implementation` attr became load-bearing (upscale vs
# downgrade semantics, reference dropout_op.cc); v0 saves predate the attr
# and meant the historical default.
register_op_version("dropout", 1)


@register_converter("dropout", from_version=0)
def _dropout_v0_to_v1(attrs):
    attrs.setdefault("dropout_implementation", "downgrade_in_infer")


# --- the reference's own REGISTER_OP_VERSION pins (all 26 sites under
# operators/; each has one checkpoint = version 1).  Attr-adding
# checkpoints get converters injecting the checkpoint's defaults so a v0
# artifact means exactly what it meant; input/output additions and
# behavior bugfixes need no attr conversion (missing inputs are optional
# in the lowerings, and this framework implements the POST-fix behavior).

def _defaults(op_type, **kv):
    register_op_version(op_type, 1)

    @register_converter(op_type, from_version=0)
    def _conv(attrs, _kv=kv):
        for k, v in _kv.items():
            # copy list defaults: a shared mutable would alias across ops
            attrs.setdefault(k, list(v) if isinstance(v, list) else v)


_defaults("arg_max", flatten=False)                # arg_max_op.cc:35
_defaults("arg_min", flatten=False)                # arg_min_op.cc
_defaults("cumsum", flatten=False)                 # cumsum_op.cc
_defaults("softplus", beta=1.0, threshold=20.0)    # activation_op.cc:1375
_defaults("momentum", regularization_method="",    # momentum_op.cc
          regularization_coeff=0.0)
_defaults("conv2d", use_addto=False)               # conv_op.cc
_defaults("conv3d", use_addto=False)
_defaults("depthwise_conv2d", use_addto=False)
_defaults("conv2d_transpose", output_padding=[])   # conv_transpose_op.cc
_defaults("unique", return_index=False,            # unique_op.cc
          return_inverse=False, return_counts=False)

for _op in ("leaky_relu", "hard_shrink", "lookup_table_v2", "clip",
            "gather", "roi_align", "roi_pool", "fill_constant",
            "gaussian_random", "cudnn_lstm", "data_norm", "matrix_nms",
            "generate_proposals", "collect_fpn_proposals",
            "distribute_fpn_proposals", "quantize"):
    register_op_version(_op, 1)
