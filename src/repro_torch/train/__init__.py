from repro_torch.train.collectives import (  # noqa: F401
    CollectiveError, RDMACollective, ideal_wire_words)
from repro_torch.train.optimizer import (  # noqa: F401
    AdamState, adamw_update, init_adam, zero1_init)
from repro_torch.train.train_step import (  # noqa: F401
    make_bucketed_train_step, make_train_step)
