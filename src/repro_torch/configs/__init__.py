from .base import (  # noqa: F401
    ARCH_IDS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    all_configs,
    canonical_id,
    get_config,
    get_smoke_config,
    runnable_shapes,
)
