"""qwen2.5-14b: GQA with QKV bias [hf:Qwen/Qwen2.5]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13824,
    vocab_size=152064, head_dim=128, qkv_bias=True,
)
