from ...fluid.initializer import NumpyArrayInitializer

__all__ = ["Assign"]


class Assign(NumpyArrayInitializer):
    def __init__(self, value, name=None):
        import numpy as np
        super().__init__(np.asarray(value))
