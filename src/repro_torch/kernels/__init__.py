"""Hopper kernels of the SPION sparse attention.

block_sparse_attn: the block-sparse flash-attention forward (CUDA C++ in
csrc/, built at first use) with its plain PyTorch version; ops: the wrapper
that groups heads and clamps tables; ref: plain oracles of the paper's
three-step pipeline.
"""
from repro_torch.kernels.ops import spion_attention_kernel  # noqa: F401
