"""paddle_tpu_torch.fluid — the fluid front end over PyTorch.

Counterpart of ``paddle_tpu.fluid``, the static-graph slices: Program /
layers (control flow and the learning-rate schedules among them) /
backward / optimizer (the 20 optimizers, the BoxPS facade) /
regularizer / clip / Executor and its async window / CompiledProgram /
passes (AMP among them) / Scope / io / DataFeeder / the dataset tier /
``fluid.contrib`` (its layers).
"""
from .. import ops as _ops  # registers all lowering rules

from . import core
from .core import (CPUPlace, CUDAPlace, Scope, global_scope, scope_guard,
                   set_flags, get_flags)
from .framework import (Program, Variable, Parameter, program_guard,
                        default_main_program, default_startup_program,
                        in_dygraph_mode, convert_dtype, cuda_places,
                        device_guard)
from .executor import Executor
from . import async_pipeline
from .async_pipeline import AsyncStepRunner, FetchHandle, StepFuture
from . import initializer
from .initializer import (Constant, Uniform, Normal, Xavier, MSRA,
                          set_global_initializer)
from .param_attr import ParamAttr, WeightNormParamAttr
from . import layers
from .layers.tensor import data
from . import nets
from . import unique_name
from .compiler import CompiledProgram, BuildStrategy, ExecutionStrategy
from . import backward
from .backward import append_backward, gradients
from . import optimizer
from . import regularizer
from . import clip
from . import io
from .io import (save_vars, load_vars, save_persistables, load_persistables,
                 save_params, load_params)
from .data_feeder import DataFeeder
from . import passes
from . import trace
from . import goodput
from . import flight_recorder
from . import dataset
from .dataset import DatasetFactory, InMemoryDataset, QueueDataset
from .. import contrib                            # fluid.contrib alias

# the metrics export plane (fluid/metrics_export.py), started from the
# environment as the trace is: `FLAGS_metrics_port=9090 python serve.py`
# serves /metrics, and a snapshot path starts the JSONL writer.  The
# module is imported only when a flag asks for it
if core.get_flag("metrics_port") or core.get_flag("metrics_snapshot_path"):
    from . import metrics_export as _metrics_export
    _metrics_export.apply_flags()


def name_scope(prefix=None):
    """A context that names nothing: the ops' names do not carry scopes
    here, as in the reference."""
    import contextlib
    return contextlib.nullcontext()


embedding = layers.embedding
one_hot = layers.one_hot
