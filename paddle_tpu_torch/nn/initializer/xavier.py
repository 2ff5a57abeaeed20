from ...fluid.initializer import XavierInitializer

__all__ = ["XavierNormal", "XavierUniform"]


class XavierNormal(XavierInitializer):
    def __init__(self, fan_in=None, fan_out=None, name=None):
        super().__init__(uniform=False, fan_in=fan_in, fan_out=fan_out)


class XavierUniform(XavierInitializer):
    def __init__(self, fan_in=None, fan_out=None, name=None):
        super().__init__(uniform=True, fan_in=fan_in, fan_out=fan_out)
