"""`KernelConfig`, the tuning knobs of the Hopper kernels, and the name of
the compiled lane a tensor runs on.

The counterpart of the JAX package's `kernels/dispatch.py`. It lives apart
from `autotune.py` for the same reason as there: block_sparse_attn needs
the type and autotune imports block_sparse_attn.

Of the reference's fields two keep their meaning on the card:

  depth      stages of the ring each bf16 kernel streams its tiles through:
             K/V in the forward and dQ, Q/dO/lse/delta in dK/dV (the
             reference's DMA pipeline depth); 1 is a synchronous fetch, 2
             the double buffer the kernels always had. The wrappers clamp it
             to the table width, as the reference's `_depth` does; at most
             MAX_DEPTH, the most stages the kernels' shared memory is laid
             out for.
  num_warps  threads of a forward or dQ program over 32: 4 (one warpgroup
             of 64 query rows) or 8 (two); None keeps the kernels' own rule
             (two warpgroups when G * block >= 128). dK/dV ignores it: its
             warpgroups set the keys a program holds, which the plan block
             fixes.

`dimension_semantics` (Mosaic) and `num_stages` (Triton) have no
counterpart in a hand-written CUDA kernel and are left out, so `from_json`
refuses them as it refuses any unknown field.

A config changes speed only: each field moves loads or the grouping of
rows into programs, never the order of a row's arithmetic, so every
config's o, lse, dq, dk and dv are bitwise the default's
(tests/test_torch_autotune.py on the CPU; chip_smoke.py on the card). The
fp32 scalar kernels have no ring and take only the default.
"""
from __future__ import annotations

import dataclasses

MAX_DEPTH = 4
NUM_WARPS = (4, 8)


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One point of the kernels' tuning space (kernels/autotune.py);
    frozen and hashable. See the module docstring for the fields."""
    depth: int = 2
    num_warps: int | None = None

    def __post_init__(self):
        if not isinstance(self.depth, int) or isinstance(self.depth, bool) \
                or not 1 <= self.depth <= MAX_DEPTH:
            raise ValueError(f"KernelConfig.depth must be an int in [1, "
                             f"{MAX_DEPTH}], got {self.depth!r}")
        if self.num_warps is not None and (
                isinstance(self.num_warps, bool)
                or self.num_warps not in NUM_WARPS):
            raise ValueError(f"KernelConfig.num_warps must be None or one of "
                             f"{NUM_WARPS}, got {self.num_warps!r}")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "KernelConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown KernelConfig fields: {sorted(unknown)}")
        return cls(**d)


DEFAULT_CONFIG = KernelConfig()


def compiled_backend(device) -> str | None:
    """The compiled lane a tensor on `device` (a tensor, a torch.device or
    its name) runs on: "cuda" for the card, None for the CPU, where the
    wrappers run the kernels' plain versions."""
    import torch
    dev = device.device if isinstance(device, torch.Tensor) \
        else torch.device(device)
    return "cuda" if dev.type == "cuda" else None
