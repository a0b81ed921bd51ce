"""Hopper kernels of the SPION sparse attention.

block_sparse_attn: the block-sparse flash-attention forward, dQ and dK/dV
(CUDA C++ in csrc/, built at first use) with their plain PyTorch versions;
dispatch: KernelConfig, the kernels' tuning knobs; autotune: the sweep, the
on-disk cache of tuned configs and its lookup; ops: the wrapper that groups
heads and clamps tables; ref: plain oracles of the paper's three-step
pipeline.
"""
from repro_torch.kernels.dispatch import (DEFAULT_CONFIG,  # noqa: F401
                                          KernelConfig)
from repro_torch.kernels.ops import spion_attention_kernel  # noqa: F401
