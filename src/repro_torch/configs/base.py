"""Config system: architecture configs and the registry.

A copy of the JAX package's ``configs/base.py`` (the port imports nothing
of that package). ``get_config(name)`` returns the full-size config;
``smoke_config(name)`` returns a reduced same-family config for CPU tests.
Only the architectures this package can run are registered.
"""
from __future__ import annotations

import importlib
import math
from dataclasses import dataclass, replace
from typing import Any, Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    expert_d_ff: int
    dense_residual: bool = False      # Arctic: dense FFN residual in parallel with MoE
    capacity_factor: float = 1.25
    group_size: int = 512             # tokens per dispatch group (GShard-style)
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int


@dataclass(frozen=True)
class SSMConfig:
    """SSD / Mamba-2-style mixer (scalar per-head decay, chunked GLA form)."""
    d_state: int = 16
    d_conv: int = 4
    n_ssm_heads: int = 8
    head_dim: int = 64
    chunk: int = 256


@dataclass(frozen=True)
class XLSTMConfig:
    n_heads: int = 4
    m_proj_factor: float = 2.0        # mLSTM up-projection factor
    s_ff_factor: float = 4.0 / 3.0    # sLSTM gated FFN factor
    chunk: int = 256
    d_conv: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    block: str = "attn"               # attn | xlstm | hymba
    window: Optional[int] = None      # sliding-window size (None = full attention)
    global_layers: tuple = ()         # layer indices with full attention (hymba)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    n_codebooks: int = 1              # musicgen: EnCodec codebooks
    img_tokens: int = 0               # llava: patch-embedding positions (stub frontend)
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 256
    # numerics / memory policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    cache_dtype: str = "bfloat16"     # KV-cache storage ("float8_e4m3fn" to halve HBM)
    optimizer: str = "adamw"          # adamw | adafactor
    opt_state_dtype: str = "float32"
    remat: bool = True
    # attention lowering schedule: 'masked' (baseline: scan all KV chunks w/ mask)
    # or 'triangular' (optimized: only visit needed KV chunks)
    attn_schedule: str = "masked"
    q_chunk: int = 1024
    kv_chunk: int = 2048
    # decode sharding: shard params over ('data','model') instead of 'model' only
    fsdp_decode: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return int(math.ceil(self.vocab_size / m) * m)

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k decode (O(1)/windowed state, no full-attn cache)."""
        return self.block in ("xlstm", "hymba")

    @property
    def kv_cache_width(self) -> int:
        """Per-token KV cache width (fused heads) for one of K/V."""
        if self.mla is not None:
            # latent cache: kv_lora + rope (single fused cache, no separate V)
            return self.mla.kv_lora_rank + self.mla.qk_rope_dim
        return self.n_kv_heads * self.resolved_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS = 6*N*D roofline term)."""
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        V = self.padded_vocab
        n = V * d  # embed
        if not self.tie_embeddings:
            n += V * d * self.n_codebooks
        if self.block == "xlstm":
            x = self.xlstm or XLSTMConfig()
            di = int(d * x.m_proj_factor)
            per_m = 2 * d * di + di * d + 3 * di  # up(x2), down, gates
            dff = int(d * x.s_ff_factor)
            per_s = 4 * d * d + 4 * d * d // x.n_heads + 2 * d * dff
            n += (L // 2) * (per_m + per_s)
            return n
        for i in range(L):
            attn = d * self.n_heads * hd  # q
            attn += 2 * d * self.kv_cache_width if self.mla is None else 0
            if self.mla is not None:
                m = self.mla
                attn += d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                attn += d * (m.kv_lora_rank + m.qk_rope_dim)
                attn += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                attn += self.n_heads * m.v_head_dim * d
            else:
                attn += self.n_heads * hd * d  # o
            n += attn
            if self.block == "hymba" and self.ssm is not None:
                s = self.ssm
                dss = s.n_ssm_heads * s.head_dim
                n += d * dss * 2 + dss * s.d_state * 2 + dss * d + dss * s.d_conv
            if self.moe is not None:
                n += d * self.moe.n_experts  # router
                n += self.moe.n_experts * 3 * d * self.moe.expert_d_ff
                if self.moe.dense_residual:
                    n += 3 * d * self.d_ff
            elif self.d_ff:
                n += 3 * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts) for 6*N_active*D."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        moe_total = self.n_layers * self.moe.n_experts * 3 * self.d_model * self.moe.expert_d_ff
        moe_active = self.n_layers * self.moe.top_k * 3 * self.d_model * self.moe.expert_d_ff
        return full - moe_total + moe_active


ARCH_IDS = ["granite-3-2b", "hymba-1.5b"]

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


@dataclass(frozen=True)
class CkptIOConfig:
    """Checkpoint I/O engine knobs (the JAX package's ``CkptIOConfig``).

    Conservative defaults (lossless, non-incremental) keep raw Cluster
    behavior bit-stable.  ``io_workers=0`` -> min(world_size, cpu).  The
    snapshot is always the pipelined one (``core.ckpt_pipeline``)."""
    codec: str = "none"               # none | zlib | lz4 | int8 (lossy)
    incremental: bool = False         # delta checkpoints (full every keep-th)
    io_workers: int = 0               # writer/reader pool size (0 = auto)
    keep: int = 3                     # completed checkpoints retained by GC
    chunk_bytes: int = 4 << 20        # raw bytes per streamed chunk
    snapshot_batch_mb: float = 8.0    # raw MB per batch of copies
    drain_backoff: float = 5e-5       # first quiesce poll sleep (s); doubles
    drain_timeout: float = 10.0       # shared quiesce deadline (s); a blown
                                      # slice raises DrainStallError


def get_config(name: str) -> ModelConfig:
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MOD[name]}")
    return mod.CONFIG


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: tiny dims, few layers/experts, CPU-steppable."""
    cfg = get_config(name)
    kw: dict[str, Any] = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.block == "xlstm" else 3),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        vocab_pad_multiple=64,
        img_tokens=min(cfg.img_tokens, 8),
        q_chunk=16,
        kv_chunk=16,
        param_dtype="float32",
        compute_dtype="float32",
        opt_state_dtype="float32",
        cache_dtype="float32",
        window=min(cfg.window, 32) if cfg.window else None,
    )
    if cfg.block == "xlstm":
        kw["xlstm"] = XLSTMConfig(n_heads=2, chunk=8)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=8, d_conv=4, n_ssm_heads=2, head_dim=32, chunk=8)
    if cfg.moe is not None:
        # capacity_factor 8 => no token drops at smoke scale, so the prefill
        # (capacity-dispatch) and decode (gather) paths agree exactly
        kw["moe"] = replace(cfg.moe, n_experts=4, top_k=2, expert_d_ff=64,
                            group_size=32, capacity_factor=8.0)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16,
                              qk_rope_dim=8, v_head_dim=16)
    if cfg.global_layers:
        kw["global_layers"] = (1,)
    return replace(cfg, **kw)
