"""mistral-large-123b [dense] — 88L GQA. [hf:mistralai/Mistral-Large-Instruct-2407]"""
from repro_torch.configs.base import ModelConfig, SpionConfig, register

MISTRAL_LARGE_123B = register(ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12_288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28_672,
    vocab_size=32_768,
    head_dim=128,
    rope_theta=1e6,
    act="silu",
    spion=SpionConfig(enabled=True, variant="cf", block_size=128),
    shape_skips=(
        ("long_500k", "pure full-attention arch (DESIGN.md §4)"),
    ),
))
