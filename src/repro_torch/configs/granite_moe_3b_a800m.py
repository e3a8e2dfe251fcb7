"""granite-moe-3b-a800m: 40 experts top-8, expert width 512 [hf:ibm-granite]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab_size=49155, head_dim=64,
    moe=MoEConfig(n_experts=40, top_k=8, expert_d_ff=512, group_size=512),
)
