"""rwkv6-7b [ssm] — Finch, attention-free, data-dependent decay. [arXiv:2404.05892]

SPION inapplicable: no attention-score matrix exists (DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig, SpionConfig, SSMConfig, register

RWKV6_7B = register(ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4_096,
    num_heads=64,           # wkv heads = d_model / head_dim
    num_kv_heads=64,
    d_ff=14_336,
    vocab_size=65_536,
    act="relu",             # rwkv channel-mix uses squared relu
    ssm=SSMConfig(state_size=64, head_dim=64, expand=1, chunk=128),
    spion=SpionConfig(enabled=False),  # attention-free
    # sub-quadratic by construction: all 4 shapes runnable
))
