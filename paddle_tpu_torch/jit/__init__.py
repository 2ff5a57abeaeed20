"""paddle.jit — the 2.0 dygraph-to-static namespace (counterpart of
``paddle_tpu/jit/__init__.py``).

Reference: python/paddle/fluid/dygraph/jit.py (``@declarative`` /
``to_static``, ``TracedLayer``) and 2.0's ``paddle.jit.save/load``
(TranslatedLayer).  ``to_static`` runs a function as one ``run_program``
op (dygraph/jit_static.py).  ``save`` exports the layer's eval forward
with ``torch.export`` and writes it with ``torch.export.save`` as
``model.pt2``, the weights inside the artifact; beside it go the
reference's ``state.npz`` (the parameters by name) and ``jit_meta.json``
in the reference's layout, so a state dict crosses packages.  The
exported graph holds ``paddle_tpu_torch::flash_attention_fwd`` where the
layer attends (ops/attention.py): the hand-written kernel on the card,
the plain version on the host.  ``load`` returns a ``TranslatedLayer``
that serves the artifact with no Python model class.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..dygraph.jit import TracedLayer
from ..dygraph.jit_static import StaticFunction, declarative, to_static

__all__ = ["to_static", "declarative", "TracedLayer", "save", "load",
           "TranslatedLayer"]

_ARTIFACT = "model.pt2"
_META = "jit_meta.json"
_STATE = "state.npz"


def _serving_module(fn, values):
    """An ``nn.Module`` whose forward is ``fn(values, *xs)``, the values
    its buffers (``torch.export`` wants a module)."""
    import torch

    class Serving(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for i, v in enumerate(values):
                self.register_buffer(f"w{i}", v.detach())

        def forward(self, *xs):
            return fn([getattr(self, f"w{i}") for i in range(len(values))],
                      *xs)

    return Serving()


def save(layer, path, input_spec):
    """Export a dygraph Layer's forward for deployment.

    input_spec: example inputs (arrays, VarBases, or objects with
    .shape/.dtype) fixing the exported signature — one artifact per
    served shape.  ``path`` is a directory.  Runs in dygraph mode, on the
    tracer's device."""
    import torch

    from ..dygraph.base import VarBase, _device
    from ..dygraph.functional import functionalize

    net = getattr(layer, "network", layer)
    examples = []
    for spec in (input_spec if isinstance(input_spec, (list, tuple))
                 else [input_spec]):
        if isinstance(spec, VarBase):
            spec = spec.numpy()
        examples.append(np.zeros(tuple(int(d) for d in spec.shape),
                                 np.dtype(spec.dtype).name)
                        if not isinstance(spec, np.ndarray)
                        else np.asarray(spec))

    values, fn = functionalize(net)
    args = tuple(torch.from_numpy(np.ascontiguousarray(e)).to(_device())
                 for e in examples)
    # grad off around the export, not inside the forward (there it would
    # wrap the graph in a set-grad region): the eval forward's attention
    # then takes the flash op
    with torch.no_grad():
        exported = torch.export.export(_serving_module(fn, values), args,
                                       strict=False)

    os.makedirs(path, exist_ok=True)
    torch.export.save(exported, os.path.join(path, _ARTIFACT))
    state = {k: v.numpy() for k, v in net.named_parameters()}
    np.savez(os.path.join(path, _STATE), **state)
    with open(os.path.join(path, _META), "w") as f:
        json.dump({"input_shapes": [list(e.shape) for e in examples],
                   "input_dtypes": [str(e.dtype) for e in examples],
                   "layer_type": type(net).__name__}, f)


class TranslatedLayer:
    """Loaded serving callable (2.0 TranslatedLayer analog).  Runs the
    loaded ``ExportedProgram`` on the device its weights were saved from;
    ``state_dict()`` exposes the saved weights for inspection or
    warm-starting a fresh Python model."""

    def __init__(self, path):
        import torch
        from ..ops import attention  # noqa: F401  (registers the flash op)
        self._exported = torch.export.load(os.path.join(path, _ARTIFACT))
        self._module = self._exported.module()
        with open(os.path.join(path, _META)) as f:
            self._meta = json.load(f)
        self._state = dict(np.load(os.path.join(path, _STATE)))
        weights = list(self._exported.state_dict.values())
        self._device = weights[0].device if weights else torch.device("cpu")

    def __call__(self, *inputs):
        import torch
        from ..dygraph.base import VarBase
        arrs = [x._value if isinstance(x, VarBase)
                else torch.as_tensor(np.asarray(x)).to(self._device)
                for x in inputs]
        with torch.no_grad():
            out = self._module(*arrs)
        if isinstance(out, (list, tuple)):
            outs = [VarBase(o) for o in out]
            return outs if len(outs) > 1 else outs[0]
        return VarBase(out)

    forward = __call__

    def eval(self):
        return self

    def state_dict(self):
        return dict(self._state)


def load(path) -> TranslatedLayer:
    return TranslatedLayer(path)


# reference jit/__init__.py tail: translator controls + dy2static
from . import dy2static                                 # noqa: E402,F401
from ..dygraph.dygraph_to_static import (               # noqa: E402,F401
    ProgramTranslator, set_code_level, set_verbosity)


def not_to_static(func=None):
    """Mark a function excluded from dygraph-to-static conversion
    (reference jit/api.py not_to_static)."""
    if func is None:
        return not_to_static
    func._already_converted = True      # convert_call passes it through
    return func
