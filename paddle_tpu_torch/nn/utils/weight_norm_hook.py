"""Weight normalization (counterpart of
``paddle_tpu/nn/utils/weight_norm_hook.py``): a layer's weight
reparameterised as ``g * v / ||v||``, with ``g`` and ``v`` the trainable
parameters, recomputed at every forward."""
from __future__ import annotations

import torch

from ...fluid import layers as L

__all__ = ["weight_norm", "remove_weight_norm"]


def _norm_except(v, dim):
    """The L2 norm over every axis but ``dim`` (whose extent stays)."""
    if dim is None:
        return L.sqrt(L.reduce_sum(L.square(v)))
    axes = [i for i in range(len(v.shape)) if i != dim]
    return L.sqrt(L.reduce_sum(L.square(v), dim=axes, keep_dim=True))


def weight_norm(layer, name="weight", dim=0):
    """Replace ``layer.<name>`` by new parameters ``<name>_g`` and
    ``<name>_v``; the weight is recomputed from them before each
    forward.  Dygraph layers only, as in the reference."""
    from ...dygraph.base import ParamBase
    from ...fluid.framework import in_dygraph_mode
    if not in_dygraph_mode():
        raise ValueError("weight_norm hooks are a dygraph-layer feature; "
                         "in static mode compose the expression directly")
    w = getattr(layer, name)
    v0 = w._value
    if dim is None:
        g0 = torch.sqrt(torch.sum(torch.square(v0)))
    else:
        axes = tuple(i for i in range(v0.ndim) if i != dim)
        g0 = torch.sqrt(torch.sum(torch.square(v0), dim=axes, keepdim=True))
    layer.add_parameter(name + "_g", ParamBase(g0, name=w.name + "_g"))
    layer.add_parameter(name + "_v", ParamBase(v0, name=w.name + "_v"))
    if name in layer._parameters:
        del layer._parameters[name]
    layer.__dict__["_weight_norm_state"] = {"name": name, "dim": dim}

    cls = type(layer)
    # a guard per class: a flag inherited from a patched base class would
    # leave a subclass's own forward unwrapped
    if "_wn_patched" not in cls.__dict__:
        orig_forward = cls.forward

        def forward(self, *a, **kw):
            st = self.__dict__.get("_weight_norm_state")
            if st is not None:
                gg = getattr(self, st["name"] + "_g")
                vv = getattr(self, st["name"] + "_v")
                setattr(self, st["name"],
                        vv * (gg / _norm_except(vv, st["dim"])))
            return orig_forward(self, *a, **kw)

        cls.forward = forward
        cls._wn_patched = True
    return layer


def remove_weight_norm(layer, name="weight"):
    """Fold ``g`` and ``v`` back into one parameter ``<name>``."""
    from ...dygraph.base import ParamBase
    st = layer.__dict__.pop("_weight_norm_state", None)
    if st is None:
        return layer
    g = getattr(layer, name + "_g")
    v = getattr(layer, name + "_v")
    w = v * (g / _norm_except(v, st["dim"]))
    old = getattr(layer, name, None)
    p = ParamBase(w._value, name=getattr(old, "name", name))
    for k in (name + "_g", name + "_v"):
        layer._parameters.pop(k, None)
    layer.add_parameter(name, p)
    return layer
