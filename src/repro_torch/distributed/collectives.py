"""Explicit gradient syncs over mesh axes: the JAX package's
`distributed/collectives.py` for ranks that each hold their partial
gradients.

  - `compressed_grad_sync`: the int8-compressed sum over one or several
    axes (several form one group, as the reference's psum over a tuple).
  - `hierarchical_grad_sync`: a plain sum over 'data', then the compressed
    sum over 'pod' where the mesh has one.

Each rank passes its own tree of partial gradients and gets the synced
tree back; the input is left as it was. As in the reference, no config
field or trainer path calls them. The compressed sum moves int32 payloads:
4 bytes an element, as fp32 (`optim/grad.py`).
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.distributed import runtime
from repro_torch.optim.grad import compressed_psum


def axes_group(mesh, axes):
    """The process group of this rank's line along `axes`, None where the
    line holds one rank."""
    return mesh.group(axes) if mesh.axis_size(axes) > 1 else None


def compressed_grad_sync(mesh, grads, axes=("data",)):
    """Sum `grads` over the line of `axes` through int8 (`compressed_psum`):
    every rank of the line gets the same synced tree."""
    return compressed_psum(grads, axes_group(mesh, tuple(axes)))


def hierarchical_grad_sync(mesh, grads):
    """Sum `grads` over 'data' (in fp32, back in each leaf's dtype), then
    through int8 over 'pod' where the mesh has that axis."""
    leaves, spec = tree_flatten(grads)
    group = axes_group(mesh, "data")
    if group is not None:
        sums = runtime.all_reduce_sum(
            [x.to(torch.float32, copy=True) for x in leaves], group=group)
        leaves = [s.to(x.dtype) for s, x in zip(sums, leaves)]
    else:
        leaves = [x.clone() for x in leaves]
    out = tree_unflatten(leaves, spec)
    if "pod" in mesh.shape:
        out = compressed_psum(out, axes_group(mesh, "pod"))
    return out
