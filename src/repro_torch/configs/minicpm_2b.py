"""minicpm-2b: llama-like dense; trained with the WSD schedule [arXiv:2404.06395]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_ff=5760,
    vocab_size=122753, head_dim=64,
)
