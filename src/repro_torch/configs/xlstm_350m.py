"""xlstm-350m: interleaved sLSTM + mLSTM blocks [arXiv:2405.04517]."""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304, head_dim=256,
    block="xlstm", xlstm=XLSTMConfig(n_heads=4, chunk=256),
)
