from repro_torch.core.rdma.autotune import (  # noqa: F401
    AutoTuner, BucketLearner, TransportTuning, TuningGrid,
)
from repro_torch.core.rdma.doorbell import (  # noqa: F401
    DoorbellCoalescer, coalesce_plan, plan_buckets, schedule_plan,
)
from repro_torch.core.rdma.engine import RDMAEngine  # noqa: F401
from repro_torch.core.rdma.reliability import (  # noqa: F401
    FaultInjector, FaultProfile, LoadShedder, ReliabilityConfig,
    ReliabilityLayer,
)
from repro_torch.core.rdma.verbs import (  # noqa: F401
    CQE, CQEStatus, MemoryRegion, Opcode, Placement, QPState, QueuePair,
    WQE,
)
