"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block. [arXiv:2411.15242]

SPION applies to the shared attention blocks only (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, SpionConfig, SSMConfig, register

ZAMBA2_1_2B = register(ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2_048,
    num_heads=32,
    num_kv_heads=32,        # GQA kv=32 == MHA
    d_ff=8_192,
    vocab_size=32_000,
    act="gelu",
    ssm=SSMConfig(state_size=64, head_dim=64, expand=2, chunk=128),
    hybrid_attn_every=6,    # shared attention block applied every 6th layer
    spion=SpionConfig(enabled=True, variant="cf", block_size=128),
    # hybrid: mamba2 state decode is O(1)/token -> long_500k runnable
))
