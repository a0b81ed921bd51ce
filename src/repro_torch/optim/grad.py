"""Gradient utilities: global-norm clipping (the train step accumulates its
microbatches itself: launch/steps.make_loss_and_grads).

Gradients are {name: tensor} dicts keyed like ParamTree.named_parameters().
On a 'model' axis the leaves named in `sharded` are this rank's shards:
their squares are summed over the model line (`group`), and the
replicated leaves, equal on every rank of the line, count once. The JAX
package's int8-compressed all-reduce belongs to multi-GPU training
(ROADMAP.md item 12b.3) and is not here.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


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
