from repro_torch.core.streaming.classifier import (  # noqa: F401
    TrafficClass, TrafficRouter, TransferDesc, classify_headers,
    default_ingress_table, make_roce_header,
)
from repro_torch.core.streaming.compress import (  # noqa: F401
    GradEgressChain, compress_bucket, compressed_all_reduce,
    compressed_all_reduce_group,
    compression_ratio, decompress_bucket, init_error_state,
)
from repro_torch.core.streaming.dispatch import (  # noqa: F401
    ACTION_DROP, ACTION_RDMA, ACTION_STREAM, Action, Chain, Drop,
    Forward, Handler, MatchEntry, MatchTable, Stream, StreamDispatcher,
    as_action,
)
from repro_torch.core.streaming.rx_ring import (  # noqa: F401
    RXRing, percentile_us, record_latency_us,
)
