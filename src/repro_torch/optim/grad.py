"""Gradient utilities: global-norm clipping (the train step accumulates its
microbatches itself: launch/steps.make_loss_and_grads).

Gradients are {name: tensor} dicts keyed like ParamTree.named_parameters().
The JAX package's int8-compressed all-reduce belongs to multi-GPU training
(ROADMAP.md item A12b) and is not here.
"""
from __future__ import annotations

import torch


def global_norm(grads):
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))


def clip_by_global_norm(grads, max_norm):
    n = global_norm(grads)
    scale = torch.clamp(max_norm / (n + 1e-6), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}, n
