"""Gradient utilities: global-norm clipping and microbatch accumulation.

Gradients are {name: tensor} dicts keyed like ParamTree.named_parameters().
The JAX package's int8-compressed all-reduce belongs to multi-GPU training
(ROADMAP.md item A12) and is not here.
"""
from __future__ import annotations

import torch


def global_norm(grads):
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))


def clip_by_global_norm(grads, max_norm):
    n = global_norm(grads)
    scale = torch.clamp(max_norm / (n + 1e-6), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}, n


def accumulate_microbatches(loss_fn, params, batches, n_micro):
    """Mean loss and mean gradients over `n_micro` microbatches (a list of
    batches); returns (mean_loss, mean_grads, aux_last). `loss_fn(params,
    batch)` returns (loss, aux); gradients are taken with respect to every
    parameter of `params` that requires grad and summed in fp32."""
    names = [n for n, p in params.named_parameters() if p.requires_grad]
    leaves = [p for _, p in params.named_parameters() if p.requires_grad]
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in zip(names, leaves)}
    aux = None
    for mb in batches[:n_micro]:
        loss, aux = loss_fn(params, mb)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for n, g in zip(names, grads):
            if g is not None:
                acc[n] = acc[n] + g.float()
        total = total + loss.detach().float()
    scale = 1.0 / n_micro
    return total * scale, {n: g * scale for n, g in acc.items()}, aux
