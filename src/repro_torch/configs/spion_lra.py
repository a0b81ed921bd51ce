"""The paper's own model: encoder-only Transformer for LRA (§5).

D=64 embedding, post-split head dim 64/H; the paper uses small LRA-standard
encoders. Three task presets share this family with different (L, B, alpha):
image classification L=1024 B=32 alpha=.96; ListOps L=2048 B=64 alpha=.98;
document retrieval L=4096 B=64 alpha=.99.
"""
from repro_torch.configs.base import ModelConfig, SpionConfig, register

SPION_LRA = register(ModelConfig(
    name="spion-lra",
    family="encoder",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=512,          # byte/pixel-level vocab upper bound across tasks
    causal=False,
    act="relu",
    rope_theta=0.0,          # learned positions, as in LRA encoders
    spion=SpionConfig(enabled=True, variant="cf", conv_filter_size=31,
                      block_size=64, alpha_quantile=0.98, transition_tol=0.05),
    shape_skips=(
        ("decode_32k", "encoder-only model has no decode step"),
        ("long_500k", "encoder-only model has no decode step"),
    ),
))

# task presets (paper §5 hyper-parameters)
LRA_TASKS = {
    "image": dict(seq_len=1_024, batch=256, block_size=32, alpha=0.96, classes=10),
    "listops": dict(seq_len=2_048, batch=128, block_size=64, alpha=0.98, classes=10),
    "retrieval": dict(seq_len=4_096, batch=32, block_size=64, alpha=0.99, classes=2),
}
