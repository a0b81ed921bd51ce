"""qwen2-7b [dense] — GQA kv=4, QKV bias. [arXiv:2407.10671; hf]"""
from repro_torch.configs.base import ModelConfig, SpionConfig, register

QWEN2_7B = register(ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3_584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18_944,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1e6,
    act="silu",
    spion=SpionConfig(enabled=True, variant="cf", block_size=128),
    shape_skips=(
        ("long_500k", "pure full-attention arch (DESIGN.md §4)"),
    ),
))
