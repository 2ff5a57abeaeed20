from ...fluid.initializer import ConstantInitializer

__all__ = ["Constant"]


class Constant(ConstantInitializer):
    def __init__(self, value=0.0, name=None):
        super().__init__(value)
