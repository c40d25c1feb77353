from repro_torch.configs.base import (ARCH_IDS, ArchConfig, LayerSpec, ShapeSpec,
                                all_configs, get_config, reduced_config)

__all__ = ["ARCH_IDS", "ArchConfig", "LayerSpec", "ShapeSpec",
           "all_configs", "get_config", "reduced_config"]
