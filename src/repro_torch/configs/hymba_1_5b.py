"""hymba-1.5b: parallel attention + SSM (mamba) heads per block [arXiv:2411.13676].

SWA(1024) everywhere except 3 full-attention layers (first / middle / last),
matching Hymba's global-local mix. ssm_state=16 per the assignment.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab_size=32001, head_dim=64,
    block="hymba", window=1024, global_layers=(0, 15, 31),
    ssm=SSMConfig(d_state=16, d_conv=4, n_ssm_heads=25, head_dim=64, chunk=256),
)
