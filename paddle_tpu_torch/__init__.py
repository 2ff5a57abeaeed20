"""paddle_tpu_torch — paddle_tpu ported to PyTorch and CUDA on Hopper.

The JAX package ``paddle_tpu`` is the reference; this package is its
counterpart module for module (``paddle_tpu_torch/fluid/executor.py`` is
the counterpart of ``paddle_tpu/fluid/executor.py``, and so on).  It
imports torch and numpy, never jax and never ``paddle_tpu``.  Plain
tensor code is PyTorch; every Pallas kernel of the reference on a ported
path is a kernel written by hand for ``sm_90a`` (``csrc/``).

Entry points run on the card unless the caller asks for the host:
``fluid.Executor()`` is ``fluid.Executor(fluid.CUDAPlace(0))``, a dygraph
tracer, ``to_tensor`` and ``Model`` take the card unless
``set_device("cpu")`` or an explicit place names the host.

Ported so far: the static BERT and CTR programs, served and trained;
dygraph training of BERT, ResNet, Transformer NMT, MobileNet, the PTB
LSTM and the dygraph CTR models; decode over a block-paged KV cache; the
BoxPS CTR trainer; the 2.0 dygraph loop; the inference deployment path
(``fluid.io.save_inference_model``, ``inference.create_predictor`` and
the ``torch.export`` artifact of ``inference.save_aot_model``); and the
2.0 API surface:
``paddle.tensor``, ``nn.functional``, ``nn``'s activations and losses,
``nn.initializer``, ``grad`` (first and second order), ``metric`` and
``hapi.Model`` through both adapters.  The reference's top-level names
that wait for later work are listed, each with its ROADMAP queue A item,
in ``tests/test_torch_namespace.py``.
"""
__version__ = "0.1.0"

from . import fluid
from .fluid import (CPUPlace, CUDAPlace, Executor, Program, program_guard,
                    default_main_program, default_startup_program,
                    ParamAttr, set_flags, get_flags)
from .fluid.framework import (Variable, in_dygraph_mode, set_default_dtype,
                              get_default_dtype)
from .fluid.reader import batch, shuffle

from . import nn
from . import utils
from . import tensor
from .tensor import *  # noqa: F401,F403
from . import optimizer
from . import regularizer
from . import metric
from . import vision
from . import models
from . import amp
from . import serving
from . import inference
from . import interop
from . import dygraph
from . import hapi
from . import jit
from .hapi import Model, callbacks
from .hapi.flops import flops
from .dygraph.base import to_variable, no_grad, grad
from .dygraph import save_dygraph as save, load_dygraph as load
from .dygraph.base import VarBase as Tensor
from .fluid.layers import create_parameter
from .fluid.layers import crop_tensor as crop
from .fluid.framework import in_dygraph_mode as in_dynamic_mode


def disable_static(place=None):
    """Dygraph mode on ``place`` (the expected place when None: the card
    unless ``set_device`` named another)."""
    from .dygraph.base import enable_dygraph
    enable_dygraph(place)


def enable_static():
    from .dygraph.base import disable_dygraph
    disable_dygraph()


def set_device(device: str):
    """The place entry points default to: "cpu", or "gpu" / "gpu:N"."""
    from .fluid.framework import _set_expected_place
    kind, _, idx = str(device).lower().partition(":")
    if kind == "cpu":
        place = CPUPlace()
    elif kind in ("gpu", "cuda"):
        place = CUDAPlace(int(idx or 0))
    else:
        raise ValueError(f"set_device: unknown device {device!r}; the "
                         f"port runs on 'cpu' or 'gpu:N'")
    _set_expected_place(place)
    return place


def get_device():
    """Where eager work runs: the tracer's place, else the expected
    place, as "gpu:N" or "cpu"."""
    from .fluid.framework import _dygraph_tracer, _current_expected_place
    t = _dygraph_tracer()
    place = t.place if t is not None else _current_expected_place()
    return "cpu" if isinstance(place, CPUPlace) \
        else f"gpu:{place.device_id}"


def is_compiled_with_cuda():
    """Whether this torch build has CUDA (not whether a card is seen)."""
    import torch
    return torch.version.cuda is not None


def is_compiled_with_xpu():
    return False


def get_cudnn_version():
    import torch
    return torch.backends.cudnn.version()


def seed(value: int):
    """Seed every stream the package draws from: numpy's global one (the
    dygraph ops' seeds), the default programs' ``random_seed``, and the
    tracer's base seed, so two runs after ``seed(n)`` draw the same
    dropout masks."""
    import numpy as _np
    from .fluid.framework import _dygraph_tracer
    value = int(value)
    _np.random.seed(value & 0x7FFFFFFF)
    for prog in (default_main_program(), default_startup_program()):
        prog.random_seed = value
    t = _dygraph_tracer()
    if t is not None:
        t._seed, t._seed_ctr = value, 0
    return value


def get_cuda_rng_state():
    """The restorable random state: numpy's global state (the dygraph
    ops' seeds) and the default programs' seeds."""
    import numpy as _np
    return [_np.random.get_state(),
            default_main_program().random_seed,
            default_startup_program().random_seed]


def set_cuda_rng_state(state):
    import numpy as _np
    np_state, main_seed, startup_seed = state
    _np.random.set_state(np_state)
    default_main_program().random_seed = main_seed
    default_startup_program().random_seed = startup_seed


def monkey_patch_variable():
    """The operators live on Variable itself; this checks they are
    there."""
    assert hasattr(Variable, "__add__") and hasattr(Variable, "__mul__")


def monkey_patch_math_varbase():
    assert hasattr(Tensor, "__add__") and hasattr(Tensor, "numpy")


def summary(net, input_size=None, dtypes=None):
    """A table of the parameters and their totals; with ``input_size`` a
    probe forward records each sublayer's output shape through forward
    post hooks."""
    import numpy as _np
    lines = [f"Layer: {type(net).__name__}"]
    total = trainable = 0
    for name, p in net.named_parameters():
        n = int(_np.prod(p.shape))
        total += n
        if getattr(p, "trainable", True):
            trainable += n
        lines.append(f"  {name:50s} {str(p.shape):20s} {n}")
    out_shapes = {}
    if input_size is not None:
        def _shape_of(o):
            o = o[0] if isinstance(o, (list, tuple)) and o else o
            return tuple(getattr(o, "shape", ()))

        handles = [
            layer.register_forward_post_hook(
                lambda l, i, o, nm=name:
                out_shapes.__setitem__(nm, _shape_of(o)))
            for name, layer in net.named_sublayers()]
        try:
            sizes = input_size if isinstance(input_size, (list, tuple)) \
                and input_size and isinstance(input_size[0],
                                              (list, tuple)) \
                else [input_size]
            dts = list(dtypes) if isinstance(dtypes, (list, tuple)) \
                else [dtypes or "float32"] * len(sizes)
            if len(dts) < len(sizes):
                dts += [dts[-1] if dts else "float32"] * \
                    (len(sizes) - len(dts))
            with no_grad():
                net(*[to_variable(_np.zeros(tuple(sz), dt))
                      for sz, dt in zip(sizes, dts)])
            for nm, shp in out_shapes.items():
                lines.append(f"  {nm:50s} -> output {shp}")
        finally:
            for h in handles:
                h.remove()
    lines.append(f"Total params: {total:,}  (trainable {trainable:,})")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable,
            "output_shapes": out_shapes}
