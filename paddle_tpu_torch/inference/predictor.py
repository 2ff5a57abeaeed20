"""Inference predictor (counterpart of ``paddle_tpu/inference/predictor.py``;
reference paddle/fluid/inference/api/analysis_predictor.cc).

AnalysisPredictor analog: load an exported model (``__model__`` + params,
fluid/io.py) -> the inference pass preset (``serving.freeze_program``:
constant folding, BN folded into the conv or fc before it, fusion,
identity pruning, fetch-seeded dead-code elimination) -> ZeroCopyRun =
one ``Executor.run`` of the loaded program on the predictor's place.

The place is the card, ``CUDAPlace(0)`` (or ``enable_use_gpu``'s
device), unless ``disable_gpu()`` asks for the host; where torch sees no
CUDA device the predictor raises instead of serving on the CPU.

Config knobs with effects:

* ``switch_ir_optim(False)`` -> no pass preset (the executor still runs
  only the ops the fetches need);
* ``switch_shape_bucketing`` (default on) -> a request batch pads to a
  bucket edge, the padded rows masked out of batch reductions and sliced
  off the fetches (fluid/compile_cache.py);
* precision ``Half`` / ``Bfloat16`` -> this model's float32 persistables
  and float feeds in bfloat16;
* ``enable_profile()`` -> a ``torch.profiler`` trace around each run,
  kept as the predictor's ``_last_profile``.

The rest (memory pool size, memory optim, mkldnn, TensorRT's engine
options beyond its precision, CPU math threads, the optimisation cache
directory, the pass builder) is accepted for API parity and changes nothing: the executor
runs the ops eagerly and compiles nothing per shape.
"""
from __future__ import annotations

import copy
import os

import numpy as np
import torch

from ..fluid import core
from ..fluid.core import global_scope
from ..fluid.executor import Executor
from ..fluid.io import load_inference_model

__all__ = ["PrecisionType", "AnalysisConfig", "Config", "AnalysisPredictor",
           "create_paddle_predictor", "create_predictor", "PredictorPool"]


class PrecisionType:
    # integer values match the reference paddle_analysis_config.h:89
    # Precision {kFloat32=0, kInt8=1, kHalf=2}; Bfloat16 is the
    # reference's TPU build's half type, kept under its number
    Float32 = 0
    Int8 = 1
    Half = 2
    Bfloat16 = 3


_HALF = (PrecisionType.Half, PrecisionType.Bfloat16)


class AnalysisConfig:
    Precision = PrecisionType

    def __init__(self, model_dir=None, prog_file=None, params_file=None):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.params_file = params_file
        self._use_gpu = True
        self._device_id = 0
        self._mem_pool_mb = 0
        self._ir_optim = True
        self._memory_optim = False
        self._precision = PrecisionType.Float32
        self._profile = False
        self._cpu_math_threads = 1
        # shape bucketing (fluid/compile_cache.py), on by default: a
        # request batch pads to a bucket edge
        self._shape_bucketing = True
        self._bucket_edges = None

    # -- device ------------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_gpu = True
        self._device_id = int(device_id)
        self._mem_pool_mb = memory_pool_init_size_mb

    def enable_use_tpu(self, device_id=0):
        raise ValueError("this package serves on CUDA cards: call "
                         "enable_use_gpu(device_id=...) or disable_gpu()")

    def disable_gpu(self):
        self._use_gpu = False

    def use_gpu(self):
        return self._use_gpu

    def gpu_device_id(self):
        return self._device_id

    def _place(self):
        """The place this config serves on."""
        return core.CUDAPlace(self._device_id) if self._use_gpu \
            else core.CPUPlace()

    # -- optimisation knobs --------------------------------------------------
    def switch_ir_optim(self, flag=True):
        self._ir_optim = bool(flag)

    def ir_optim(self):
        return self._ir_optim

    def enable_memory_optim(self):
        self._memory_optim = True

    def switch_shape_bucketing(self, flag=True, edges=None):
        """Pad request batches up to a bucket edge; ``edges`` pins explicit
        bucket sizes (default powers of two)."""
        self._shape_bucketing = bool(flag)
        self._bucket_edges = edges

    def set_optim_cache_dir(self, opt_cache_dir):
        pass                  # nothing is compiled per shape to cache

    def enable_profile(self):
        self._profile = True

    def set_cpu_math_library_num_threads(self, n):
        self._cpu_math_threads = int(n)

    def cpu_math_library_num_threads(self):
        return self._cpu_math_threads

    # -- precision ----------------------------------------------------------
    def enable_tensorrt_engine(self, workspace_size=1 << 30,
                               max_batch_size=1, min_subgraph_size=3,
                               precision_mode=PrecisionType.Float32,
                               use_static=False, use_calib_mode=False):
        # no TensorRT here; a half-precision request is honoured in bf16
        if precision_mode in _HALF:
            self._precision = PrecisionType.Bfloat16

    def enable_mkldnn(self):
        pass

    def set_precision(self, precision):
        self._precision = precision

    def precision(self):
        return self._precision

    # -- misc parity ---------------------------------------------------------
    def switch_use_feed_fetch_ops(self, flag=False):
        pass                  # feed/fetch ops are stripped at load

    def switch_specify_input_names(self, flag=True):
        pass

    def pass_builder(self):
        return _PassBuilder()


class _PassBuilder:
    """The pass preset is serving.freeze_program's; an inert builder for
    API parity."""

    def __init__(self):
        self._passes = ["inference pass preset (serving.freeze_program)"]

    def all_passes(self):
        return list(self._passes)

    def delete_pass(self, name):
        pass

    def insert_pass(self, idx, name):
        pass


Config = AnalysisConfig


class _ZeroCopyTensor:
    def __init__(self, predictor, name, is_input):
        self._p = predictor
        self._name = name
        self._is_input = is_input

    def copy_from_cpu(self, arr):
        self._p._feed[self._name] = np.ascontiguousarray(arr)

    def copy_to_cpu(self):
        return self._p._results[self._name]

    def reshape(self, shape):
        pass

    def shape(self):
        store = self._p._feed if self._is_input else self._p._results
        v = store.get(self._name)
        return list(np.shape(v)) if v is not None else []


class AnalysisPredictor:
    def __init__(self, config: AnalysisConfig):
        self._config = config
        self._exe = Executor(config._place())
        model_dir = config.model_dir
        model_file = params_file = None
        if model_dir is None and config.prog_file:
            # combined form: AnalysisConfig(prog_file=..., params_file=...)
            model_dir = os.path.dirname(config.prog_file) or "."
            model_file = os.path.basename(config.prog_file)
        if model_dir is None:
            raise ValueError("AnalysisConfig needs model_dir or prog_file")
        if config.params_file:
            # honoured in both forms: an explicit params_file selects the
            # combined (save_combine) file, which must sit in model_dir
            # (the loader resolves names against it)
            pdir = os.path.dirname(config.params_file)
            if pdir and os.path.abspath(pdir) != os.path.abspath(model_dir):
                raise ValueError(
                    f"params_file {config.params_file!r} is outside "
                    f"model_dir {model_dir!r}; the combined params file "
                    f"must sit next to the model")
            params_file = os.path.basename(config.params_file)
        self._program, self._feed_names, self._fetch_vars = \
            load_inference_model(model_dir, self._exe,
                                 model_filename=model_file,
                                 params_filename=params_file)
        self._fetch_names = [v.name for v in self._fetch_vars]
        if config._ir_optim:
            # OptimizeInferenceProgram: the inference pass preset
            from ..serving.freeze import freeze_program
            self._program = freeze_program(
                self._program, self._feed_names, self._fetch_names)
        else:
            self._program._hints["is_test"] = True
        if config._shape_bucketing:
            self._program._hints["shape_bucketing"] = True
            if config._bucket_edges is not None:
                from ..fluid import compile_cache
                self._program._hints["bucket_edges"] = \
                    compile_cache.normalize_edges(config._bucket_edges)
        if config._precision in _HALF:
            self._cast_params_bf16()
        self._feed = {}
        self._results = {}
        self._last_profile = None

    def _cast_params_bf16(self):
        """Half/bf16 precision: THIS model's float32 persistables held in
        bfloat16 (other models' vars in the shared scope stay as they
        are), and its float32 feed vars declared bfloat16 so the executor
        keeps the feeds' bfloat16."""
        scope = global_scope()
        block = self._program.global_block()
        for var in block.vars.values():
            if var.persistable:
                v = scope.find_var(var.name)
                if isinstance(v, torch.Tensor) and v.dtype == torch.float32:
                    scope.set_var(var.name, v.to(torch.bfloat16))
                    var.dtype = "bfloat16"
        for name in self._feed_names:
            var = block._find_var_recursive(name)
            if var is not None and var.dtype == "float32":
                var.dtype = "bfloat16"

    # -- API ----------------------------------------------------------------
    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def get_input_tensor(self, name):
        return _ZeroCopyTensor(self, name, True)

    get_input_handle = get_input_tensor

    def get_output_tensor(self, name):
        return _ZeroCopyTensor(self, name, False)

    get_output_handle = get_output_tensor

    def _run(self, feed):
        return self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetch_names)

    def zero_copy_run(self):
        feed = self._feed
        if self._config._precision in _HALF:
            feed = {k: (torch.from_numpy(np.asarray(v)).to(torch.bfloat16)
                        if np.asarray(v).dtype == np.float32 else v)
                    for k, v in feed.items()}
        if self._config._profile:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self._exe.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts) as prof:
                outs = self._run(feed)
            self._last_profile = prof
        else:
            outs = self._run(feed)
        self._results = dict(zip(self._fetch_names, outs))

    ZeroCopyRun = zero_copy_run
    run = zero_copy_run

    def compiled_op_count(self):
        """Ops in the last run's plan (introspection for ir_optim)."""
        plans = list(self._exe._plans.values())
        return plans[-1].n_ops if plans else None


def create_paddle_predictor(config):
    return AnalysisPredictor(config)


create_predictor = create_paddle_predictor


class PredictorPool:
    """paddle_infer.PredictorPool: N handles over ONE loaded model — the
    program, weights and executor are shared; each handle keeps its own
    feed/result buffers."""

    def __init__(self, config, size=1):
        base = AnalysisPredictor(config)
        self._predictors = [base]
        for _ in range(max(1, size) - 1):
            clone = copy.copy(base)           # share program/exe/config
            clone._feed, clone._results = {}, {}
            self._predictors.append(clone)

    def retrieve(self, idx):
        return self._predictors[idx]
