"""paddle_tpu_torch.fluid — the fluid front end over PyTorch.

Counterpart of ``paddle_tpu.fluid``, the static-graph slices: Program /
layers / backward / optimizer (SGD, Momentum, Adam, the BoxPS facade) /
clip / Executor and its async window / CompiledProgram / passes (AMP
among them) / Scope / io / the dataset tier.
"""
from .. import ops as _ops  # registers all lowering rules

from . import core
from .core import (CPUPlace, CUDAPlace, Scope, global_scope, set_flags,
                   get_flags)
from .framework import (Program, Variable, Parameter, program_guard,
                        default_main_program, default_startup_program,
                        convert_dtype)
from .executor import Executor
from . import async_pipeline
from .async_pipeline import AsyncStepRunner, FetchHandle, StepFuture
from . import initializer
from .initializer import Constant, Uniform, Normal, Xavier
from .param_attr import ParamAttr
from . import layers
from .layers.tensor import data
from . import unique_name
from .compiler import CompiledProgram, BuildStrategy
from . import backward
from .backward import append_backward
from . import optimizer
from . import clip
from . import io
from .io import save_vars, load_vars, save_persistables, load_persistables
from . import passes
from . import trace
from . import dataset
from .dataset import DatasetFactory, InMemoryDataset, QueueDataset
