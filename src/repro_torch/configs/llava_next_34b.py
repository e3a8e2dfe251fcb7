"""llava-next-34b backbone [hf:llava-hf/llava-v1.6]. anyres tiling frontend is a
stub: the caller provides precomputed patch embeddings for img_tokens positions."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab_size=64000, head_dim=128, img_tokens=576,
)
