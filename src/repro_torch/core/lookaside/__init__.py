from repro_torch.core.lookaside.control import ControlMsg, FIFO, StatusMsg  # noqa: F401
from repro_torch.core.lookaside.registry import (  # noqa: F401
    LCContext, LCKernel, LookasideBlock,
)
