"""internvl2-2b [vlm] — InternLM2-1.8B decoder backbone; InternViT STUB frontend.

input_specs() provides 256 precomputed patch embeddings at d_model (the ViT +
mlp1 projector is stubbed per the assignment spec). [arXiv:2404.16821]
"""
from repro_torch.configs.base import ModelConfig, SpionConfig, register

INTERNVL2_2B = register(ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2_048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8_192,
    vocab_size=92_553,
    tie_embeddings=False,
    rope_theta=1e6,
    act="silu",
    num_patch_tokens=256,
    spion=SpionConfig(enabled=True, variant="cf", block_size=64),
    shape_skips=(
        ("long_500k", "pure full-attention arch (DESIGN.md §4)"),
    ),
))
