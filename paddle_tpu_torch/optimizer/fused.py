"""Coalesced Adam over a model's parameter list (counterpart of
``paddle_tpu/optimizer/fused.py``), the update of the flagship dygraph
training step.

Small parameters (the biases and norm scales, whose separate updates
would be launch overhead) are packed into one flat float32 buffer and
updated together; parameters above ``_COALESCE_MAX`` values update on
their own.  The update is PyTorch elementwise ops, as the reference
leaves it to XLA; its formula, ``p - lr·(m/c1)/(sqrt(v/c2) + eps)``, is
not the bucketed ``fused_adam`` kernel's.  The reference pads each
parameter's segment to its TPU tile row (1024 values); the port packs
them back to back, which changes no value.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch


class FlatSpec:
    """Shapes and offsets of a coalesced parameter buffer."""

    def __init__(self, shapes: Sequence[Tuple[int, ...]], dtypes=None):
        self.shapes = [tuple(s) for s in shapes]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.offsets = [sum(self.sizes[:i]) for i in range(len(self.sizes))]
        self.dtypes = list(dtypes) if dtypes is not None else None

    def flatten(self, tensors: Sequence[torch.Tensor],
                dtype=torch.float32) -> torch.Tensor:
        if not tensors:
            return torch.zeros((0,), dtype=dtype)
        return torch.cat([t.reshape(-1).to(dtype) for t in tensors])

    def unflatten(self, buf: torch.Tensor) -> List[torch.Tensor]:
        out = []
        for i, (shape, size, off) in enumerate(zip(self.shapes, self.sizes,
                                                   self.offsets)):
            piece = buf[off:off + size].reshape(shape)
            if self.dtypes is not None:
                piece = piece.to(self.dtypes[i])
            out.append(piece)
        return out


_COALESCE_MAX = 1 << 20      # params above 1M values update individually


def make_fused_adam(param_values: Sequence[torch.Tensor], lr=1e-4,
                    beta1=0.9, beta2=0.999, epsilon=1e-8, weight_decay=0.0):
    """(state, spec, update) for a coalesced Adam (AdamW with
    ``weight_decay``).

    state = (large params, their m, their v, (small buffer, m, v), t),
    float32 throughout, t an int32 step count on the parameters' device.
    ``update(state, grads) -> (new_state, params)`` with params in the
    order of ``param_values``, in their dtypes; it allocates new tensors
    and leaves ``state`` as it was.  ``update.params_of(state)`` gives
    the params of a state."""
    small_ix = [i for i, p in enumerate(param_values)
                if p.numel() <= _COALESCE_MAX]
    large_ix = [i for i, p in enumerate(param_values)
                if p.numel() > _COALESCE_MAX]
    spec = FlatSpec([param_values[i].shape for i in small_ix],
                    [param_values[i].dtype for i in small_ix])
    device = param_values[0].device if param_values else None
    sbuf = spec.flatten([param_values[i] for i in small_ix]).to(device)
    lp = [param_values[i].detach().to(torch.float32, copy=True)
          for i in large_ix]
    state0 = (lp, [torch.zeros_like(p) for p in lp],
              [torch.zeros_like(p) for p in lp],
              (sbuf, torch.zeros_like(sbuf), torch.zeros_like(sbuf)),
              torch.zeros((), dtype=torch.int32, device=device))

    def _adam(p, g, m, v, c1, c2):
        m = beta1 * m + (1.0 - beta1) * g
        v = beta2 * v + (1.0 - beta2) * g * g
        step = lr * (m / c1) / (torch.sqrt(v / c2) + epsilon)
        if weight_decay:
            step = step + lr * weight_decay * p
        return p - step, m, v

    def _params(lp, sbuf):
        params = [None] * len(param_values)
        for j, p in zip(small_ix, spec.unflatten(sbuf)):
            params[j] = p
        for j, p in zip(large_ix, lp):
            params[j] = p.to(param_values[j].dtype)
        return params

    def params_of(state):
        return _params(state[0], state[3][0])

    @torch.no_grad()
    def update(state, grads):
        lp, lm, lv, (sbuf, sm, sv), t = state
        t = t + 1
        tf = t.to(torch.float32)
        c1 = 1.0 - beta1 ** tf
        c2 = 1.0 - beta2 ** tf
        sg = spec.flatten([grads[i] for i in small_ix])
        sbuf, sm, sv = _adam(sbuf, sg, sm, sv, c1, c2)
        new = [_adam(p, grads[i].to(torch.float32), m, v, c1, c2)
               for p, i, m, v in zip(lp, large_ix, lm, lv)]
        lp = [n[0] for n in new]
        state = (lp, [n[1] for n in new], [n[2] for n in new],
                 (sbuf, sm, sv), t)
        return state, _params(lp, sbuf)

    update.params_of = params_of
    return state0, spec, update
