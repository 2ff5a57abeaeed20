"""Layer base class and containers (counterpart of
``paddle_tpu/dygraph/layers.py``; reference
python/paddle/fluid/dygraph/layers.py).

Parameters and sublayers register through attribute assignment, in
assignment order, so ``named_parameters`` and ``state_dict`` name and
order them as the reference does (``bert.encoder.layers.0.linear1.weight``
and so on).  Buffers (``register_buffer``: a batch norm's moving
statistics) are state that is not trained; ``state_dict`` carries them
after each layer's parameters, as the reference's does.  ``state_dict``
gives host numpy arrays; ``set_state_dict`` (also ``set_dict`` and
``load_dict``) puts values back on each tensor's own device and dtype.  ``__call__`` runs the
forward pre-hooks, ``forward`` and the post-hooks.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..fluid.framework import unique_name, _dygraph_tracer
from .base import ParamBase, VarBase, to_variable


class _HookRemoveHelper:
    """The handle ``register_forward_*_hook`` returns: ``remove()``
    detaches the hook."""

    _next_id = 0

    def __init__(self, hooks, hook):
        self._hooks = hooks
        self._id = _HookRemoveHelper._next_id
        _HookRemoveHelper._next_id += 1
        hooks[self._id] = hook

    def remove(self):
        self._hooks.pop(self._id, None)


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self._full_name = unique_name(name_scope or
                                      type(self).__name__.lower())
        self._dtype = dtype
        self._parameters: "OrderedDict[str, ParamBase]" = OrderedDict()
        self._sub_layers: "OrderedDict[str, Layer]" = OrderedDict()
        self._buffers: "OrderedDict[str, VarBase]" = OrderedDict()
        self._forward_pre_hooks: "OrderedDict[int, object]" = OrderedDict()
        self._forward_post_hooks: "OrderedDict[int, object]" = OrderedDict()
        self.training = True

    # -- registration through the attribute protocol ------------------------
    def __setattr__(self, name, value):
        if isinstance(value, ParamBase):
            self.__dict__.setdefault("_parameters", OrderedDict())[name] = value
        elif isinstance(value, Layer):
            self.__dict__.setdefault("_sub_layers", OrderedDict())[name] = value
        object.__setattr__(self, name, value)

    def add_parameter(self, name, parameter):
        self._parameters[name] = parameter
        object.__setattr__(self, name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[name] = sublayer
        object.__setattr__(self, name, sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        """State that is not trained, under ``name``: a VarBase that stops
        gradients (anything else goes through ``to_variable`` first)."""
        if tensor is not None and not isinstance(tensor, VarBase):
            tensor = to_variable(tensor)
        if tensor is not None:
            tensor.persistable = persistable
            tensor.stop_gradient = True
        self._buffers[name] = tensor
        object.__setattr__(self, name, tensor)
        return tensor

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None):
        """A parameter named under this layer's full name, made as
        ``LayerHelper.create_parameter`` makes it (not registered: assign
        it to an attribute)."""
        from ..fluid.layer_helper import LayerHelper
        helper = LayerHelper(self.full_name())
        return helper.create_parameter(attr, shape, dtype or self._dtype,
                                       is_bias, default_initializer)

    # -- traversal ----------------------------------------------------------
    def parameters(self, include_sublayers=True) -> List[ParamBase]:
        out = list(self._parameters.values())
        if include_sublayers:
            for sub in self._sub_layers.values():
                out.extend(sub.parameters())
        return out

    def named_parameters(self, prefix="") -> Iterator[Tuple[str, ParamBase]]:
        for name, p in self._parameters.items():
            yield f"{prefix}{name}", p
        for lname, sub in self._sub_layers.items():
            yield from sub.named_parameters(prefix=f"{prefix}{lname}.")

    def sublayers(self, include_self=False) -> List["Layer"]:
        """Every layer below this one, depth first in registration
        order."""
        out = [self] if include_self else []
        for sub in self._sub_layers.values():
            out.append(sub)
            out.extend(sub.sublayers())
        return out

    def named_sublayers(self, prefix="", include_self=False):
        if include_self:
            yield prefix.rstrip("."), self
        for name, sub in self._sub_layers.items():
            yield f"{prefix}{name}", sub
            yield from sub.named_sublayers(prefix=f"{prefix}{name}.")

    def buffers(self) -> List[VarBase]:
        out = list(self._buffers.values())
        for sub in self._sub_layers.values():
            out.extend(sub.buffers())
        return out

    # -- modes --------------------------------------------------------------
    def train(self):
        self.training = True
        tracer = _dygraph_tracer()
        if tracer:
            tracer._train_mode = True
        for sub in self._sub_layers.values():
            sub.train()
        return self

    def eval(self):
        self.training = False
        tracer = _dygraph_tracer()
        if tracer:
            tracer._train_mode = False
        for sub in self._sub_layers.values():
            sub.eval()
        return self

    # -- state dict ---------------------------------------------------------
    def state_dict(self, destination=None, include_sublayers=True,
                   prefix="") -> Dict[str, np.ndarray]:
        dest = destination if destination is not None else OrderedDict()
        for name, p in self._parameters.items():
            dest[prefix + name] = p.numpy()
        for name, b in self._buffers.items():
            if b is not None:
                dest[prefix + name] = b.numpy()
        if include_sublayers:
            for lname, sub in self._sub_layers.items():
                sub.state_dict(dest, True, prefix=f"{prefix}{lname}.")
        return dest

    def set_state_dict(self, state_dict, include_sublayers=True):
        """Set each parameter and buffer named in ``state_dict``; names it
        lacks keep their values."""
        for name, value in self._named_leaves():
            if name in state_dict:
                value.set_value(np.asarray(state_dict[name]))

    set_dict = set_state_dict
    load_dict = set_state_dict

    def _named_leaves(self, prefix=""):
        for name, p in self._parameters.items():
            yield prefix + name, p
        for name, b in self._buffers.items():
            if b is not None:
                yield prefix + name, b
        for lname, sub in self._sub_layers.items():
            yield from sub._named_leaves(prefix=f"{prefix}{lname}.")

    def full_name(self):
        return self._full_name

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    # -- call, with the forward hooks ---------------------------------------
    def __call__(self, *args, **kwargs):
        """``forward`` between the hooks: a pre-hook ``hook(layer, args)``
        may return new args (a tuple, or one value), a post-hook
        ``hook(layer, args, outputs)`` new outputs."""
        for hook in list(self._forward_pre_hooks.values()):
            out = hook(self, args)
            if out is not None:
                args = out if isinstance(out, tuple) else (out,)
        outputs = self.forward(*args, **kwargs)
        for hook in list(self._forward_post_hooks.values()):
            out = hook(self, args, outputs)
            if out is not None:
                outputs = out
        return outputs

    def register_forward_pre_hook(self, hook):
        return _HookRemoveHelper(self._forward_pre_hooks, hook)

    def register_forward_post_hook(self, hook):
        return _HookRemoveHelper(self._forward_post_hooks, hook)

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (list, tuple)) and \
                layers[0] and isinstance(layers[0][0], (list, tuple)):
            layers = [sub for _, sub in layers[0]]
        for i, sub in enumerate(layers):
            self.add_sublayer(str(i), sub)

    def forward(self, x):
        for sub in self._sub_layers.values():
            x = sub(x)
        return x

    def __getitem__(self, i):
        return list(self._sub_layers.values())[i]

    def __len__(self):
        return len(self._sub_layers)


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        for i, sub in enumerate(sublayers or []):
            self.add_sublayer(str(i), sub)

    def append(self, sublayer):
        self.add_sublayer(str(len(self._sub_layers)), sublayer)
        return self

    def __getitem__(self, i):
        return list(self._sub_layers.values())[i]

    def __iter__(self):
        return iter(self._sub_layers.values())

    def __len__(self):
        return len(self._sub_layers)


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        for i, p in enumerate(parameters or []):
            self.add_parameter(str(i), p)

    def append(self, p):
        self.add_parameter(str(len(self._parameters)), p)
        return self

    def __getitem__(self, i):
        return list(self._parameters.values())[i]

    def __iter__(self):
        return iter(self._parameters.values())

    def __len__(self):
        return len(self._parameters)
