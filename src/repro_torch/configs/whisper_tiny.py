"""whisper-tiny [audio] — enc-dec backbone, conv frontend STUB. [arXiv:2212.04356]

input_specs() provides precomputed frame embeddings (B, S_enc, 384); the
conv1d+GELU mel frontend is stubbed per the assignment spec.
"""
from repro_torch.configs.base import ModelConfig, SpionConfig, register

WHISPER_TINY = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,            # decoder layers
    encoder_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1_536,
    vocab_size=51_865,
    act="gelu",
    rope_theta=0.0,          # whisper uses learned/sinusoidal positions
    spion=SpionConfig(enabled=True, variant="cf", block_size=64),
    shape_skips=(
        ("long_500k", "pure full-attention enc-dec (DESIGN.md §4)"),
    ),
))
