from ...fluid.initializer import (NormalInitializer,
                                  TruncatedNormalInitializer)

__all__ = ["Normal", "TruncatedNormal"]


class Normal(NormalInitializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        super().__init__(mean, std)


class TruncatedNormal(TruncatedNormalInitializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        super().__init__(mean, std)
