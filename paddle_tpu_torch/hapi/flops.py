"""FLOP counting (counterpart of ``paddle_tpu/hapi/flops.py``).

The reference asks XLA's ``cost_analysis`` of the compiled forward; the
port counts with ``torch.utils.flop_counter.FlopCounterMode`` over the
functionalized forward.  The two count different things: PyTorch's
counter counts the products (matmul, convolution, attention), two FLOP
a multiply-add, and nothing else, while XLA's also counts the
elementwise work after fusion (biases, activations, pooling, softmax).
So the port's number is the products' exact count, and below XLA's by
the elementwise share.
"""
from __future__ import annotations

import torch

__all__ = ["flops"]


def _count(fn, *args):
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        fn(*args)
    return float(counter.get_total_flops())


def flops(net, input_size, custom_ops=None, print_detail=False):
    """The forward FLOP of ``net`` (a dygraph Layer, or a hapi Model over
    one) for one batch of ``input_size`` (batch included), counted in
    the network's current train or eval state.  ``custom_ops``
    (``{LayerClass: fn(layer, input_shape) -> flops}``) replaces the
    count of matching leaf layers; ``print_detail`` prints a table a
    leaf layer."""
    from ..dygraph import base as dybase
    from ..dygraph.functional import functionalize
    from ..fluid import core

    network = getattr(net, "network", net)
    params = network.parameters()
    if params and not hasattr(params[0], "_value"):
        raise TypeError(
            "flops() needs a dygraph-built network (its parameters hold "
            "values); construct the model under paddle.disable_static()")
    device = params[0]._value.device if params else torch.device("cpu")
    entered = dybase._dygraph_tracer() is None
    if entered:
        dybase.enable_dygraph(core.CPUPlace() if device.type == "cpu"
                              else core.CUDAPlace(device.index or 0))
    try:
        x = torch.zeros(tuple(int(d) for d in input_size), device=device)
        values, fn = functionalize(network)
        total = _count(fn, values, x)
        if print_detail or custom_ops:
            total = _per_leaf(network, x, total, custom_ops or {},
                              print_detail)
        return total
    finally:
        if entered:
            dybase.disable_dygraph()


def _per_leaf(network, x, total, custom_ops, print_detail):
    """One recorded forward gives each leaf layer's input shape; a
    ``custom_ops`` formula replaces that leaf's own count."""
    from ..dygraph import base as dybase
    from ..dygraph.functional import functionalize
    from ..dygraph.layers import Layer

    shapes = {}
    orig_call = Layer.__call__

    def recording_call(self, *args, **kwargs):
        if id(self) not in shapes and args:
            shape = getattr(args[0], "shape", None)
            if shape is not None:
                shapes[id(self)] = tuple(int(d) for d in shape)
        return orig_call(self, *args, **kwargs)

    Layer.__call__ = recording_call
    try:
        with dybase.no_grad():
            network(dybase.to_variable(x))
    finally:
        Layer.__call__ = orig_call

    rows = []
    for name, layer in network.named_sublayers():
        if layer.sublayers():
            continue
        in_shape = shapes.get(id(layer))
        if not in_shape:
            continue
        lvalues, lfn = functionalize(layer)
        own = _count(lfn, lvalues, torch.zeros(in_shape, device=x.device))
        if type(layer) in custom_ops:
            custom = float(custom_ops[type(layer)](layer, in_shape))
            total += custom - own
            rows.append((name, type(layer).__name__, custom, "custom"))
        elif print_detail:
            rows.append((name, type(layer).__name__, own, "counted"))
    if print_detail:
        print(f"{'layer':40s} {'type':20s} flops")
        for name, t, fl, src in rows:
            print(f"{name:40s} {t:20s} {fl:.3e} ({src})")
        print(f"Total FLOPs: {total:.3e}")
    return total
