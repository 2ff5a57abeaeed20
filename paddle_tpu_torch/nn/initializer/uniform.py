from ...fluid.initializer import UniformInitializer

__all__ = ["Uniform"]


class Uniform(UniformInitializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        super().__init__(low, high)
