from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS, SHAPES, ModelConfig, ShapeSpec, all_configs, get_config,
    input_specs, mixed_shape)
