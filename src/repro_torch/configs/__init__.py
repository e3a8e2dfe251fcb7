from repro_torch.configs.base import (
    ARCH_IDS,
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
    XLSTMConfig,
    get_config,
    smoke_config,
)

__all__ = [
    "ARCH_IDS", "MLAConfig", "MoEConfig", "ModelConfig", "SSMConfig",
    "XLSTMConfig", "get_config", "smoke_config",
]
