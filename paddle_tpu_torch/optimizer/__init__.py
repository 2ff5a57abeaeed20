"""Optimizers for dygraph training (counterpart of
``paddle_tpu/optimizer``): the coalesced Adam of ``fused.py``; the eager
per-parameter optimizers come with a later slice."""
from .fused import FlatSpec, make_fused_adam
