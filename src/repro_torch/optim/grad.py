"""Gradient utilities: global-norm clipping (the train step accumulates its
microbatches itself: launch/steps.make_loss_and_grads) and the int8
compressed sum of the explicit gradient sync (distributed/collectives.py).

Gradients are {name: tensor} dicts keyed like ParamTree.named_parameters().
On a 'model' axis the leaves named in `sharded` are this rank's shards:
their squares are summed over the model line (`group`), and the
replicated leaves, equal on every rank of the line, count once.

The compressed sum keeps the reference's arithmetic
(`src/repro/optim/grad.py:42-64`): each rank's int8 payload is summed as
int32 and the scales are averaged. An int32 element is 4 bytes on the
wire, as an fp32 one is: the sum saves no bytes.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.distributed import runtime


def global_norm(grads, sharded=(), group=None):
    """sqrt of the sum of every leaf's squares; with `group`, the leaves in
    `sharded` summed over it (one fp32 all-reduce)."""
    sq = [(g.float() ** 2).sum() for g in grads.values()]
    if group is None or not sharded:
        return torch.sqrt(sum(sq))
    zero = torch.zeros((), dtype=torch.float32, device=sq[0].device)
    rep = sum((s for n, s in zip(grads, sq) if n not in sharded), zero)
    shard = sum((s for n, s in zip(grads, sq) if n in sharded), zero)
    dist.all_reduce(shard, group=group)
    return torch.sqrt(rep + shard)


def clip_by_global_norm(grads, max_norm, sharded=(), group=None):
    n = global_norm(grads, sharded, group)
    scale = torch.clamp(max_norm / (n + 1e-6), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}, n


# -- int8 compression -------------------------------------------------------

def quantize_int8(x):
    """Symmetric per-tensor int8 quantisation: (q int8, scale fp32 0-d),
    scale the fp32 amax over 127 (1 where amax is 0), q = x / scale in
    fp32 rounded half to even and clipped to +-127."""
    xf = x.float()
    amax = xf.abs().max()
    # a divisor on x's device: CUDA divides by a host scalar as a product
    # with its reciprocal, which is not amax / 127 rounded once
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def line_mean(values, group):
    """The mean over `group` of each rank's fp32 `values` (a 1-d tensor),
    summed in the group's rank order, so every rank holds the same bits:
    each rank writes its row of an (n, len) matrix, one all_reduce joins
    the rows (a sum with zeros is exact), and the rows are added first to
    last."""
    if group is None:
        return values
    n = dist.get_world_size(group)
    rows = values.new_zeros((n, values.numel()))
    rows[dist.get_group_rank(group, dist.get_rank())] = values
    dist.all_reduce(rows, group=group)
    total = rows[0]
    for r in range(1, n):
        total = total + rows[r]
    return total / total.new_tensor(float(n))


def compressed_psum(tree, group):
    """Sum a tree of tensors over `group` through int8: each leaf is
    quantised (`quantize_int8`), the payloads are summed as int32 (one
    bucketed all_reduce, `runtime.all_reduce_sum`), the scales averaged
    (`line_mean`), and the leaf comes back as total * mean scale in its
    own dtype. `group` None: one rank, the leaf quantised and restored.
    The input is left as it was."""
    leaves, spec = tree_flatten(tree)
    qs, scales = zip(*(quantize_int8(x) for x in leaves))
    totals = [q.to(torch.int32) for q in qs]
    if group is not None:
        runtime.all_reduce_sum(totals, group=group)
    s_mean = line_mean(torch.stack(scales), group)
    return tree_unflatten([(t.float() * s).to(x.dtype) for t, s, x in
                           zip(totals, s_mean, leaves)], spec)
