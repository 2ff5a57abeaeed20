"""Operator registry: op type -> lowering rule on torch tensors.

Counterpart of ``paddle_tpu/ops/registry.py``.  An op is a plain function
``fn(inputs, attrs, ctx) -> outputs`` over named variadic slots
(``Dict[slot, List[torch.Tensor]]``).  The executor calls the rules one by
one, eagerly; shape inference calls the same rules on ``meta`` tensors;
``generic_grad`` (fluid/backward.py) differentiates them with
``torch.func.vjp`` unless the op carries a ``custom_grad``.
Ids stay int64 (the TPU package narrows them to int32 through
``wide_int``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

LoweringFn = Callable[..., Dict[str, Any]]


@dataclasses.dataclass
class OpDef:
    type: str
    fn: LoweringFn                       # fn(ins, attrs, ctx) -> outs
    # slots that are never differentiated (int indices, seeds, masks...)
    nondiff_inputs: Sequence[str] = ()
    # outputs that carry no cotangent (int outputs, saved state)
    nondiff_outputs: Sequence[str] = ()
    differentiable: bool = True          # False: a leaf of the grad sweep
    # why a differentiable=False op has no gradient: "<category>: <text>"
    # (stamped from ops/nondiff_reasons.py when ops/__init__ is imported)
    nondiff_reason: Optional[str] = None
    stateful_rng: bool = False           # draws random numbers (dropout, *_random)
    # (ins, outs, out_grads, attrs, ctx) -> in_grads, in place of the vjp;
    # ``generic_grad`` passes outs=None (the forward is not rerun)
    custom_grad: Optional[Callable] = None
    # custom_grad gets each output slot's whole list of cotangents (by
    # default the slot's first, for the single-output ops)
    grad_lists: bool = False


_OP_REGISTRY: Dict[str, OpDef] = {}


def register_op(type: str, fn: LoweringFn = None, **kwargs):
    """Register a lowering rule.  Usable as decorator or direct call."""
    def deco(f):
        if type in _OP_REGISTRY:
            raise ValueError(f"op '{type}' already registered")
        _OP_REGISTRY[type] = OpDef(type=type, fn=f, **kwargs)
        return f
    if fn is not None:
        return deco(fn)
    return deco


def get_op(type: str) -> OpDef:
    if type not in _OP_REGISTRY:
        raise NotImplementedError(
            f"op '{type}' has no lowering in paddle_tpu_torch yet "
            f"({len(_OP_REGISTRY)} ops ported)")
    return _OP_REGISTRY[type]


def has_op(type: str) -> bool:
    return type in _OP_REGISTRY


def all_ops() -> List[str]:
    return sorted(_OP_REGISTRY)


_MASK64 = (1 << 64) - 1


def _mix(a: int, b: int) -> int:
    """SplitMix64 finaliser over the pair: a 64-bit seed that changes
    with either input."""
    z = (int(a) * 0x9E3779B97F4A7C15 + int(b) + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


class LoweringContext:
    """Per-run context handed to lowering rules.

    ``device`` is where ops that create tensors from nothing (fill and
    random ops) put them.  ``base_seed`` plays the TPU package's step
    key: random ops derive their seed from (base_seed, op_seed), so one
    op draws the same numbers wherever it is lowered in a step.
    ``is_test`` switches dropout to its inference behaviour.  Under shape
    bucketing ``batch_padded`` is the padded leading dim and
    ``batch_valid`` the true row count.
    """

    def __init__(self, device=None, base_seed: Optional[int] = None,
                 is_test: bool = False):
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self.base_seed = base_seed
        self.is_test = is_test
        self.batch_valid: Optional[int] = None
        self.batch_padded: Optional[int] = None
        # per-op IR hint set by the executor: False when the op's primary
        # input is never batch-major (a parameter), True when the IR marks
        # it batch-major (-1 leading dim), None when unknown
        self.cur_op_batch_major: Optional[bool] = None

    def batch_mask(self, dim0: int) -> Optional[torch.Tensor]:
        """Row-validity mask (bool[dim0] on ``device``) when ``dim0`` is
        the padded batch axis under shape bucketing, else None.  The IR
        hint (``cur_op_batch_major``) vetoes masking for persistable
        inputs; for unknown provenance the dim0-equality heuristic
        applies.  ``batch_valid`` is a host int, so making the mask never
        waits on the card."""
        if self.batch_valid is None or self.batch_padded != dim0 \
                or self.cur_op_batch_major is False:
            return None
        return torch.arange(int(dim0), device=self.device) \
            < self.batch_valid

    def seed_for(self, op_seed: int) -> int:
        """The 64-bit seed of one op's random numbers, mixed from
        (base_seed, op_seed): the dropout kernels' Philox key.  A host
        integer, so a launch never waits on the card for it."""
        return _mix(0 if self.base_seed is None else self.base_seed,
                    int(op_seed))

    def key_for(self, op_seed: int) -> Optional[torch.Generator]:
        """A generator on ``device`` seeded with ``seed_for(op_seed)``;
        None on the meta device, where nothing is drawn."""
        if self.device.type == "meta":
            return None
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed_for(op_seed))
        return g
