"""Layer base class and containers (counterpart of
``paddle_tpu/dygraph/layers.py``; reference
python/paddle/fluid/dygraph/layers.py).

Parameters and sublayers register through attribute assignment, in
assignment order, so ``named_parameters`` and ``state_dict`` name and
order them as the reference does (``bert.encoder.layers.0.linear1.weight``
and so on).  Buffers (``register_buffer``: a batch norm's moving
statistics) are state that is not trained; ``state_dict`` carries them
after each layer's parameters, as the reference's does.  ``state_dict``
gives host numpy arrays; ``set_state_dict`` puts values back on each
tensor's own device and dtype.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..fluid.framework import unique_name, _dygraph_tracer
from .base import ParamBase, VarBase, to_variable


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self._full_name = unique_name(name_scope or
                                      type(self).__name__.lower())
        self._dtype = dtype
        self._parameters: "OrderedDict[str, ParamBase]" = OrderedDict()
        self._sub_layers: "OrderedDict[str, Layer]" = OrderedDict()
        self._buffers: "OrderedDict[str, VarBase]" = OrderedDict()
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

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

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
