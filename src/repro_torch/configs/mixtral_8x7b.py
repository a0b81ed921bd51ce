"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention. [arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SpionConfig, register

MIXTRAL_8X7B = register(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4_096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=32_000,
    sliding_window=4_096,
    rope_theta=1e6,
    act="silu",
    moe=MoEConfig(num_experts=8, top_k=2),
    spion=SpionConfig(enabled=True, variant="cf", block_size=128),
    # SWA makes decode attention O(window) -> long_500k IS runnable
))
