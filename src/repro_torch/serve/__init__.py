from repro_torch.serve.inputs import (  # noqa: F401
    model_inputs, step_inputs,
)
from repro_torch.serve.kv_cache import (  # noqa: F401
    FetchTicket, KVFetchError, KVTenant, Page, PagedKVPool,
    RemoteKVClient, migrate_sequence,
)
from repro_torch.serve.serve_step import (  # noqa: F401
    decode_step, greedy_generate, prefill_step,
)
