from ...fluid.initializer import MSRAInitializer

__all__ = ["KaimingNormal", "KaimingUniform"]


class KaimingNormal(MSRAInitializer):
    def __init__(self, fan_in=None, name=None):
        super().__init__(uniform=False, fan_in=fan_in)


class KaimingUniform(MSRAInitializer):
    def __init__(self, fan_in=None, name=None):
        super().__init__(uniform=True, fan_in=fan_in)
