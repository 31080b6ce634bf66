from repro_torch.configs.base import (  # noqa: F401
    MeshConfig, MLAConfig, ModelConfig, MoEConfig, MULTI_POD_MESH, RunConfig,
    SHAPES, ShapeConfig, SINGLE_POD_MESH, SSMConfig, ServeConfig, TrainConfig,
    reduce_for_smoke,
)
