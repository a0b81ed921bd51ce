"""command-r-35b [dense] — GQA, no bias, large vocab. [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.configs.base import ModelConfig, SpionConfig, register

COMMAND_R_35B = register(ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8_192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22_528,
    vocab_size=256_000,
    tie_embeddings=True,
    rope_theta=8e6,
    act="silu",
    spion=SpionConfig(enabled=True, variant="cf", block_size=128),
    shape_skips=(
        ("long_500k", "pure full-attention arch (DESIGN.md §4)"),
    ),
))
