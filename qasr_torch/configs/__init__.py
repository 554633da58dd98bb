from qasr_torch.configs.config import (
    PRESETS,
    Config,
    DataConfig,
    DecodeConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
    get_config,
)

__all__ = [
    "Config",
    "DataConfig",
    "DecodeConfig",
    "MeshConfig",
    "ModelConfig",
    "TrainConfig",
    "PRESETS",
    "get_config",
]
