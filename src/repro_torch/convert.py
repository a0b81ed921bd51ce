"""Parameters of the JAX package, as numpy arrays, into the port.

`params_from_numpy(tree, cfg, device)` takes the tree that
`jax.tree_util.tree_map(np.asarray, params)` gives and returns the port's
ParamTree: the same keys, shapes and dtypes, identity per leaf. numpy has no
bfloat16 of its own; JAX's bf16 leaves come out as `ml_dtypes.bfloat16`,
which `torch.from_numpy` refuses, so they cross as their uint16 bit pattern.
With `mesh=` (a mesh with a 'model' axis) each leaf is cut to this rank's
shard first (distributed/sharding.param_pspecs and local_index: Mamba2's
packed in_proj by segment and head where the scan splits by heads, the
reference's contiguous cut under its fallback), so no rank holds more
than its shard on its device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed.sharding import (best_spec, local_index,
                                              model_size)
from repro_torch.models.layers import ParamTree


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """One array -> tensor with the same dtype and bits (bf16 included)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_numpy(tree, cfg, device=None, mesh=None) -> ParamTree:
    """The JAX package's parameter tree (numpy leaves) of a `cfg` model as
    the port's ParamTree on `device` (None: the first CUDA card); with
    `mesh`, this rank's shard of it."""
    dev = resolve_device(device)
    split = mesh is not None and model_size(mesh) > 1

    def conv(node, path=()):
        if isinstance(node, dict):
            return {k: conv(v, path + (k,)) for k, v in node.items()}
        a = np.asarray(node)
        if split:
            spec = best_spec(mesh, "/".join(path), a)
            a = a[local_index(mesh, ".".join(path), spec, a.shape, cfg)]
        return tensor_from_numpy(a, dev)
    return ParamTree(conv(tree))
