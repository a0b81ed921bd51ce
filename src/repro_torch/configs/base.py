"""Config system: architecture configs, shape specs, SPION settings.

A field-for-field copy of the JAX package's `configs/base.py`, so that a
config's `dataclasses.asdict` is the same in both packages. Reduced configs
for CPU tests come from `ModelConfig.reduced()`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Shape specs (assigned per the task: same 4 shapes for every LM arch)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int = 2
    # arctic keeps a small dense FFN residual branch in parallel with the MoE
    dense_residual_ff: int = 0


@dataclass(frozen=True)
class SSMConfig:
    state_size: int = 64       # N (d_state)
    head_dim: int = 64         # P (mamba2 head dim) / rwkv head size
    expand: int = 2            # d_inner = expand * d_model
    chunk: int = 128           # chunked-scan block length


@dataclass(frozen=True)
class SpionConfig:
    """Paper hyper-parameters (§5): F=31 conv filter, B∈{32,64} blocks,
    alpha-quantile threshold, Frobenius transition tolerance."""
    enabled: bool = False
    variant: str = "cf"            # "c" | "f" | "cf" (paper's SPION-C/F/CF)
    conv_filter_size: int = 31     # F
    block_size: int = 64           # B (avg-pool/upsample block)
    alpha_quantile: float = 0.96   # threshold t = alpha-quantile of pool_out
    transition_tol: float = 0.05   # α in Alg. 2 line 10 (Frobenius criterion)
    min_dense_epochs: int = 1
    max_dense_epochs: int = 8      # force transition even if criterion unmet
    # kernel-side: max active column-blocks per row-block (padded BCSR width).
    # None -> derived from the generated pattern at transition time.
    max_blocks_per_row: Optional[int] = None
    # sparse-phase attention implementation: CUDA tensors always take the
    # Hopper block-sparse kernel ("jnp" raises there); on CPU tensors "auto"
    # and "jnp" take the BCSR gather and "fused" the kernel's plain PyTorch
    # version.
    kernel: str = "auto"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense|moe|ssm|hybrid|encdec|vlm|audio|encoder
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // num_heads
    qkv_bias: bool = False                  # qwen2 family uses QKV bias
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None    # mixtral SWA
    norm_eps: float = 1e-5
    causal: bool = True                     # decoder LMs; encoder-only = False
    act: str = "silu"                       # "silu" (gated) | "relu" | "gelu"
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): apply a shared attention block every k-th ssm layer
    hybrid_attn_every: int = 0
    # enc-dec (whisper backbone): encoder layer count (decoder = num_layers)
    encoder_layers: int = 0
    encoder_causal: bool = False
    # vlm stub frontend: number of precomputed patch embeddings prepended
    num_patch_tokens: int = 0
    # SPION
    spion: SpionConfig = field(default_factory=SpionConfig)
    # which shapes are inapplicable for this arch ("skip:<reason>")
    shape_skips: Tuple[Tuple[str, str], ...] = ()
    dtype: str = "bfloat16"
    # KV-cache storage dtype (None -> dtype). float8_e4m3fn halves decode
    # cache memory; compute stays in `dtype` (cast on read).
    cache_dtype: "Optional[str]" = None
    remat: bool = True          # activation checkpointing in scan-over-layers
    # activation sharding between blocks: None | "d" (model-shard d_model) |
    # "seq" (Megatron-SP style: model-shard the sequence dim)
    act_shard: Optional[str] = None
    # pin the per-layer partial-sum all-reduces to bf16 (an optimization
    # barrier stops XLA hoisting the norm's fp32 upcast above the AR, which
    # doubles wire bytes)
    ar_bf16: bool = False
    # scan unroll factor (layers & ssm chunk scans). The dry-run sets this to
    # full unroll so compiled.cost_analysis() counts every layer (XLA counts a
    # while-loop body once); production training keeps 1 for compile speed.
    scan_unroll: int = 1

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    def skip_reason(self, shape_name: str) -> Optional[str]:
        for s, reason in self.shape_skips:
            if s == shape_name:
                return reason
        return None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests (one fwd/train step)."""
        kw = dict(
            num_layers=min(self.num_layers, 2),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads < self.num_heads else 4,
            d_ff=128,
            vocab_size=128,
            head_dim=16,
            sliding_window=64 if self.sliding_window else None,
            remat=False,
        )
        if self.moe is not None:
            kw["moe"] = MoEConfig(
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                dense_residual_ff=32 if self.moe.dense_residual_ff else 0,
            )
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(state_size=8, head_dim=16, expand=2, chunk=16)
        if self.encoder_layers:
            kw["encoder_layers"] = min(self.encoder_layers, 2)
        if self.num_patch_tokens:
            kw["num_patch_tokens"] = 4
        if self.hybrid_attn_every:
            kw["hybrid_attn_every"] = 2
        return self.replace(**kw)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs in roofline)."""
        d, ff, L = self.d_model, self.d_ff, self.num_layers
        hd = self.resolved_head_dim
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        attn = q + kv + o
        if self.act in ("silu", "swiglu"):
            mlp = 3 * d * ff  # gated
        else:
            mlp = 2 * d * ff
        if self.moe is not None:
            mlp = self.moe.num_experts * mlp + d * self.moe.num_experts
            if self.moe.dense_residual_ff:
                mlp += 3 * d * self.moe.dense_residual_ff
        if self.family == "ssm":  # rwkv6: tokenshift/wkv/gates approximated by zoo layer defs
            inner = self.ssm.expand * d if self.ssm else 2 * d
            attn = 4 * d * inner  # r,k,v,g projections
            mlp = 2 * d * ff
        block = attn + mlp + 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = L * block + emb + d
        if self.encoder_layers:
            total += self.encoder_layers * block + self.encoder_layers * attn  # cross-attn
        if self.hybrid_attn_every:
            total += attn + 2 * d  # one shared attention block
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts instead of all)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        d, ff, L = self.d_model, self.d_ff, self.num_layers
        per_expert = 3 * d * ff
        inactive = L * (self.moe.num_experts - self.moe.top_k) * per_expert
        return int(full - inactive)


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (ensures the arch modules are imported)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> dict:
    import repro_torch.configs  # noqa: F401
    return dict(_REGISTRY)
