from . import quantization  # noqa: F401
