from repro_torch.models.convert import params_from_jax  # noqa: F401
from repro_torch.models.transformer import (  # noqa: F401
    cross_entropy, forward, init_caches, init_params, layer_windows,
    loss_fn,
)
