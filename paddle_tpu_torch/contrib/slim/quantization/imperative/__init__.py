from . import qat  # noqa: F401
from .qat import ImperativeQuantAware, ImperativeCalcOutScale  # noqa: F401
from . import quant_nn  # noqa: F401
