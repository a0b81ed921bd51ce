"""qwen2.5-14b [dense] — GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B family; hf]"""
from repro_torch.configs.base import ModelConfig, SpionConfig, register

QWEN2_5_14B = register(ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5_120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=13_824,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1e6,
    act="silu",
    spion=SpionConfig(enabled=True, variant="cf", block_size=128),
    shape_skips=(
        ("long_500k", "pure full-attention arch; 512k dense-KV decode is "
                      "quadratic with no sub-quadratic mechanism (DESIGN.md §4)"),
    ),
))
