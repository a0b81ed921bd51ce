"""arctic-480b [moe] — 128 experts top-2 + dense FFN residual. [hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SpionConfig, register

ARCTIC_480B = register(ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7_168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4_864,
    vocab_size=32_000,
    rope_theta=1e4,
    act="silu",
    moe=MoEConfig(num_experts=128, top_k=2, dense_residual_ff=7_168),
    spion=SpionConfig(enabled=True, variant="cf", block_size=128),
    shape_skips=(
        ("long_500k", "pure full-attention arch (DESIGN.md §4)"),
    ),
))
