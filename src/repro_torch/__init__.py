"""PyTorch/CUDA port of the SPION reproduction.

The package mirrors the JAX package `repro` module for module, so each
module here has one reference module to be checked against. It imports
torch, numpy and the standard library only. The one TPU kernel of the
serving path, the block-sparse attention forward, is a CUDA C++ kernel for
Hopper (`kernels/csrc/`), built at first use.

Entry points run on the card unless the caller passes `device="cpu"`;
without a card and without that argument they raise.
"""
from __future__ import annotations


def resolve_device(device=None):
    """The device an entry point runs on (a torch.device): `device` when
    given, else the first CUDA card. Raises when no card is present and no
    device was asked for, so nothing falls back to the CPU unasked. torch
    is imported here, not with the package, so the fleet supervisor
    (distributed/supervisor.py) runs without it."""
    import torch
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:   # "cuda" -> "cuda:N"
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return torch.device("cuda", torch.cuda.current_device())
