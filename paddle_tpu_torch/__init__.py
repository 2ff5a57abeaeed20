"""paddle_tpu_torch — paddle_tpu ported to PyTorch and CUDA on Hopper.

The JAX package ``paddle_tpu`` is the reference; this package is its
counterpart module for module (``paddle_tpu_torch/fluid/executor.py`` is
the counterpart of ``paddle_tpu/fluid/executor.py``, and so on).  It
imports torch and numpy, never jax and never ``paddle_tpu``.  Plain
tensor code is PyTorch; every Pallas kernel of the reference on a ported
path is a kernel written by hand for ``sm_90a`` (``csrc/``).

Entry points run on the card unless the caller asks for the host:
``fluid.Executor()`` is ``fluid.Executor(fluid.CUDAPlace(0))``.

Ported so far: the static BERT and CTR programs, served
(``serving.freeze_program``, the kernel-tier passes,
``serving.ServingEngine``) and trained (``Executor.run``), and dygraph
training of ``models.bert.BertForPretraining`` (``dygraph``,
``dygraph.functional``, ``optimizer.fused``) and of
``vision.models.resnet50`` (functionally, or by ``loss.backward()`` and
``fluid.optimizer``'s ``minimize``), and autoregressive decode over a
block-paged KV cache (``serving.DecodeEngine``), the BoxPS CTR trainer,
and the 2.0 dygraph loop (``optimizer``'s schedulers and eager
optimizers, ``amp.auto_cast`` and ``GradScaler``, ``save_dygraph``) over
the recurrent layers and the PTB, skip-gram and dygraph CTR models; see
ROADMAP.md for what comes next.
"""
from . import fluid
from . import serving
from . import interop

__version__ = "0.1.0"
