"""paddle.distributed analog (counterpart of ``paddle_tpu/distributed``):
the BoxPS tier (``ps``) and the dataset-driven trainer (``trainer``).
Fleet, launch, the collectives and the elastic runtime are not ported
yet."""
from . import ps
from . import trainer

__all__ = ["ps", "trainer"]
