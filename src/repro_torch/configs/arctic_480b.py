"""arctic-480b: 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic].

group_size=4096: one dispatch group per 4096-token sequence. Adafactor with
bf16 optimizer state, as the JAX package's config has it.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab_size=32000, head_dim=128,
    moe=MoEConfig(n_experts=128, top_k=2, expert_d_ff=4864, dense_residual=True,
                  group_size=4096),
    optimizer="adafactor", opt_state_dtype="bfloat16", fsdp_decode=True,
)
