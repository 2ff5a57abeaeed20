"""paddle_tpu_torch stands alone: no JAX, no paddle_tpu, no silent CPU.

The port and ``chip_smoke.py`` import torch and numpy only; importing
every module of the package (and ``chip_smoke`` as a module) in a fresh
interpreter leaves ``jax``, ``paddle_tpu``, ``google.protobuf`` and
``ml_dtypes`` out of ``sys.modules`` (the card's machine has neither of
the last two), and no source file names them (or any ``google``
package) in an import.  Entry points default to the
card and raise, naming ``fluid.CPUPlace()``, where torch sees no CUDA
device.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.models.static_graphs import build_bert_train_program
from paddle_tpu_torch.serving import ServingEngine, freeze_program

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "paddle_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu", "google", "ml_dtypes")

_PROBE = r"""
import importlib, json, pkgutil, sys
import paddle_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                              "paddle_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "paddle_tpu", "ml_dtypes")
             or n.startswith("google.protobuf"))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_import_leaves_jax_and_reference_out():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert "paddle_tpu_torch.ops.cuda_kernels" in report["modules"]
    assert "paddle_tpu_torch.serving.engine" in report["modules"]
    assert "paddle_tpu_torch.dygraph.base" in report["modules"]
    assert "paddle_tpu_torch.models.bert" in report["modules"]
    assert "paddle_tpu_torch.serving.decode" in report["modules"]
    assert "paddle_tpu_torch.fluid.layers.control_flow" in report["modules"]
    assert "paddle_tpu_torch.vision.models" in report["modules"]
    for m in ("distributed.ps.box", "distributed.ps.table",
              "distributed.trainer", "native", "fluid.dataset",
              "fluid.async_pipeline", "fluid.passes.amp", "utils.prefetch",
              "optimizer.lr", "dygraph.learning_rate_scheduler",
              "dygraph.checkpoint", "dygraph.rnn", "amp.auto_cast",
              "amp.grad_scaler", "fluid.layers.rnn", "models.language",
              "models.ctr", "tensor", "nn.functional", "nn.layer",
              "nn.initializer", "nn.initializer.assign",
              "nn.initializer.constant", "nn.initializer.kaiming",
              "nn.initializer.normal", "nn.initializer.uniform",
              "nn.initializer.xavier", "nn.clip", "nn.utils",
              "nn.utils.weight_norm_hook", "fluid.reader", "fluid.metrics",
              "fluid.layers.extras", "metric", "metric.metrics", "hapi",
              "hapi.model", "hapi.callbacks", "hapi.progressbar",
              "hapi.flops", "ops.catalog_tail_ops", "ops.plumbing_ops",
              "fluid.proto", "fluid.proto.framework_pb2",
              "fluid.proto_serde", "fluid.op_version_registry",
              "utils.op_version", "inference", "inference.predictor",
              "inference.aot", "fluid.trace", "fluid.flight_recorder",
              "fluid.goodput", "fluid.metrics_export"):
        assert "paddle_tpu_torch." + m in report["modules"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_source_imports_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, (path, node.lineno, n)


@pytest.fixture
def no_cuda(monkeypatch):
    """Whatever the host, torch sees no CUDA device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_executor_defaults_to_the_card_and_raises_without_one(no_cuda):
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        tfluid.Executor()
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        tfluid.Executor(tfluid.CUDAPlace(0))
    assert tfluid.Executor(tfluid.CPUPlace()).device.type == "cpu"


def test_serving_engine_defaults_to_the_card(no_cuda):
    tframework.reset_unique_name()
    main, _, logits = build_bert_train_program(layers=1, train=False)
    frozen = freeze_program(main, ["ids", "attn_mask"], [logits],
                            scope=tfluid.Scope())
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        ServingEngine(frozen)


def test_cuda_place_needs_a_device_for_scope_values(no_cuda):
    from paddle_tpu_torch import interop
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        interop.scope_from_numpy({"w": np.zeros(2, "float32")},
                                 tfluid.Scope(), tfluid.CUDAPlace(0))


def test_2_0_entry_points_default_to_the_card(no_cuda, monkeypatch):
    """``disable_static`` (a tracer), ``to_tensor`` under it, a static
    ``Model``'s Executor and a ``DataLoader`` batch placed on the card
    all take CUDAPlace(0) by default and raise without a card; none
    gives way to the host."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import hapi, nn
    from paddle_tpu_torch.fluid.reader import DataLoader
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        paddle.disable_static()
    monkeypatch.setattr(tframework, "_dygraph_tracer_", None)
    monkeypatch.setattr(tframework, "_main_program", tfluid.Program())
    monkeypatch.setattr(tframework, "_startup_program", tfluid.Program())
    model = paddle.Model(nn.Linear(4, 2), inputs=[hapi.Input([-1, 4])])
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        model.predict_batch([np.zeros((1, 4), "float32")])
    loader = DataLoader([np.zeros(4, "float32")] * 2, batch_size=2,
                        places=tfluid.CUDAPlace(0))
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        next(iter(loader))
