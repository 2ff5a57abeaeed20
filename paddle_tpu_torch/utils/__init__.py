"""Shared helpers (counterpart of ``paddle_tpu/utils``): the background
prefetch iterator."""
