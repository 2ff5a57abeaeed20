"""Values across the package boundary, as numpy arrays.

The two packages draw different random numbers from the same seed, so a
comparison carries the reference's parameter values into the port's
scope (static programs), layer (dygraph models) or ``hapi.Model``
(either adapter) instead of re-running the port's initializers.  A BoxPS table's host rows and pass state cross
the same way (``box_from_numpy``); its numpy initializer draws the same
rows from the same seed in both packages, so a pass staged by each from
one seed is equal too.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from .fluid.core import Place, Scope


def scope_from_numpy(arrays: Dict[str, np.ndarray], scope: Scope,
                     place: Place) -> Scope:
    """Set each array as a tensor on ``place`` under its name."""
    device = place.torch_device()
    for name, a in arrays.items():
        scope.set_var(name, _tensor(np.array(a)).to(device))
    return scope


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a tensor; a bfloat16 array (ml_dtypes', which
    torch cannot read) through its bits."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def scope_to_numpy(scope: Scope, names: Iterable[str]) -> Dict[str, np.ndarray]:
    """Host copies of the named tensors (names absent from the scope are
    skipped)."""
    out = {}
    for n in names:
        v = scope.find_var(n)
        if v is not None:
            out[n] = v.detach().cpu().numpy()
    return out


def layer_from_numpy(layer, state: Dict[str, np.ndarray]):
    """Set a dygraph Layer's parameters and buffers from ``state``, a
    ``Layer.state_dict()`` of the same model (numpy arrays by structured
    name), each on its own device and dtype.  Refuses a name the layer
    lacks, a name ``state`` lacks, and a shape that differs."""
    mine = dict(layer._named_leaves())
    missing = [n for n in mine if n not in state]
    extra = [n for n in state if n not in mine]
    if missing or extra:
        raise KeyError(f"state_dict mismatch: missing {missing}, "
                       f"unexpected {extra}")
    for name, v in mine.items():
        a = np.asarray(state[name])
        if tuple(a.shape) != v.shape:
            raise ValueError(f"{name}: shape {tuple(a.shape)} is not the "
                             f"layer's {v.shape}")
        v.set_value(a)
    return layer


def box_from_numpy(box, host_ids, host_vals, pass_ids=None, cache_rows=0,
                   rng_state=None):
    """Carry a BoxPS wrapper's state into ``box`` (a port
    ``BoxPSWrapper``), as numpy: the host store's rows (``host_ids``,
    ``host_vals``), mid-pass the pass's sorted unique ids and padded cache
    row count, and the host initializer's ``RandomState`` state, so rows
    created later draw what the source would have drawn.  The cache value
    itself goes into the scope (:func:`scope_from_numpy`)."""
    ids = np.asarray(host_ids, np.int64).reshape(-1)
    if len(ids):
        box.host.set_row_state(
            {"ids": ids, "vals": np.asarray(host_vals, np.float32)})
    if rng_state is not None:
        box.host.init.rng.set_state(rng_state)
    if pass_ids is not None:
        box._pass_ids = np.asarray(pass_ids, np.int64).copy()
        box._cache_rows = int(cache_rows)
    return box


def box_to_numpy(box) -> Dict[str, np.ndarray]:
    """The inverse view: ``{"host_ids", "host_vals", "pass_ids"}`` of a
    BoxPS wrapper (``pass_ids`` None between passes)."""
    box.wait_writeback()
    ids = box.host.all_ids()
    return {"host_ids": ids, "host_vals": box.host.pull(ids),
            "pass_ids": box.pass_ids}


def model_from_numpy(model, state):
    """Set a ``hapi.Model``'s parameters from ``state``: a list of arrays
    in ``model.parameters()``'s order, or a dict by name (a dygraph
    Model's ``Layer.state_dict()`` names; a static Model's program
    parameter names).  The optimizer's accumulators are not carried: a
    carried model trains from step 0."""
    params = model.parameters()
    if isinstance(state, (list, tuple)):
        if len(state) != len(params):
            raise ValueError(f"{len(state)} arrays for {len(params)} "
                             f"parameters")
        for p, a in zip(params, state):
            if tuple(np.shape(a)) != tuple(p.shape):
                raise ValueError(f"{p.name}: shape {np.shape(a)} is not "
                                 f"the parameter's {tuple(p.shape)}")
        if model._adapter is None:
            for p, a in zip(params, state):
                p.set_value(np.asarray(a))
            return model
        state = {p.name: a for p, a in zip(params, state)}
    if model._adapter is None:
        layer_from_numpy(model.network, state)
    else:
        names = {p.name for p in params}
        extra = [n for n in state if n not in names]
        if extra:
            raise KeyError(f"not parameters of the model: {extra}")
        model._adapter.set_state_dict(state)
    return model
