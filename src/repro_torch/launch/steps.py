"""Step makers: the train step (single device), the fused prefill step and
the decode step.

PyTorch runs eagerly, so a step is a plain closure over the model bundle;
the JAX package's jit, shardings and donation have no counterpart here (the
port updates parameters, optimizer state and caches in place instead of
donating them).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention_exec import SparseAttentionExec
from repro_torch.core.sparse_attention import PLAN_TABLE_KEYS
from repro_torch.models.layers import tree_map
from repro_torch.models.registry import build
from repro_torch.optim import (accumulate_microbatches, adamw_update,
                               clip_by_global_norm, cosine_schedule)


def causal_band_tables(layers: int, nrb: int, width: Optional[int] = None):
    """Stacked causal stand-in forward tables (host numpy) for serving
    demos, benches and tests: each row-block lists its last `width` column
    blocks (width=None -> all of them: full causal coverage, the
    sparse-equals-dense case). Clamped padding past the valid prefix,
    matching the JAX package's function of the same name."""
    K = nrb if width is None else width
    col = np.zeros((layers, nrb, K), np.int32)
    nval = np.zeros((layers, nrb), np.int32)
    for r in range(nrb):
        lo = 0 if width is None else max(r - width + 1, 0)
        cs = list(range(lo, r + 1))
        col[:, r, : len(cs)] = cs
        col[:, r, len(cs):] = cs[-1]
        nval[:, r] = len(cs)
    return {"col_idx": col, "nvalid": nval}


def _coerce_step_tables(tables, *, block, phase):
    """Normalise a step's sparse-tables argument to a SparseAttentionExec:
    an exec passes through; a dict payload gets the step's block."""
    if tables is None:
        return None
    if isinstance(tables, SparseAttentionExec):
        return tables
    arrays = {k: tables[k] for k in PLAN_TABLE_KEYS if k in tables}
    return SparseAttentionExec(arrays, block=block, phase=phase)


def compute_params(params, dtype):
    """The forward's view of fp32 masters: tensors with ndim >= 2 in fp32
    cast to `dtype` (the cast is differentiable, so gradients reach the
    masters in fp32), the others as they are. Nested dicts."""
    return tree_map(lambda x: x.to(dtype)
                    if x.dtype == torch.float32 and x.ndim >= 2 else x, params)


def make_loss_and_grads(cfg: ModelConfig, *, n_micro=1, block=None,
                        sparse_kernel=None):
    """Returns f(params, batch, tables=None) -> (loss, grads): the forward
    and backward of the train step, without the update.

    The forward sees the fp32 masters of `params` (a ParamTree that requires
    grad) cast to cfg.dtype (ndim >= 2 only); the gradients are with respect
    to the masters, as {name: fp32 tensor}. `n_micro` > 1 splits the batch
    into microbatches and averages their losses and gradients. `tables` is
    a SparseAttentionExec or a tables dict payload (its block is `block` or
    cfg.spion.block_size), or None for dense attention; on CUDA tensors the
    sparse attention forward and backward are the Hopper kernels, and
    `sparse_kernel` overrides cfg.spion.kernel, which chooses between the
    gather and the kernels' plain versions on CPU tensors."""
    if sparse_kernel is not None:
        cfg = cfg.replace(spion=dataclasses.replace(cfg.spion,
                                                    kernel=sparse_kernel))
    bundle = build(cfg)
    compute_dtype = getattr(torch, cfg.dtype)
    static_block = block or cfg.spion.block_size

    def loss_and_grads(params, batch, tables=None):
        ex = _coerce_step_tables(tables, block=static_block, phase="train")

        def loss_fn(p, mb):
            return bundle.loss(compute_params(p, compute_dtype), mb,
                               spion=ex)

        if n_micro > 1:
            mbs = [{k: v.reshape(n_micro, v.shape[0] // n_micro,
                                 *v.shape[1:])[i] for k, v in batch.items()}
                   for i in range(n_micro)]
            loss, grads, _ = accumulate_microbatches(loss_fn, params, mbs,
                                                     n_micro)
            return loss, grads
        loss, _aux = loss_fn(params, batch)
        named = list(params.named_parameters())
        gs = torch.autograd.grad(loss, [p for _, p in named],
                                 allow_unused=True)
        return loss, {n: torch.zeros_like(p) if g is None else g
                      for (n, p), g in zip(named, gs)}

    return loss_and_grads


def make_train_step(cfg: ModelConfig, *, spion=False, lr=3e-4,
                    total_steps=10_000, n_micro=1, block=None,
                    sparse_kernel=None):
    """Returns f(params, opt_state, batch, step[, tables]) -> (params,
    opt_state, metrics) for one device.

    `params` is a ParamTree of fp32 masters that require grad and
    `opt_state` comes from optim.adamw_init; both are updated in place and
    returned. Loss and gradients come from `make_loss_and_grads` (the
    forward casts the masters to cfg.dtype; `n_micro` microbatches); then
    global-norm clipping at 1.0, the cosine schedule (warmup 200) and
    AdamW. Metrics: loss, gnorm and lr (0-d tensors).

    `spion=True` adds the sparse-tables argument (see `make_loss_and_grads`
    for it and for `block` and `sparse_kernel`)."""
    loss_and_grads = make_loss_and_grads(cfg, n_micro=n_micro, block=block,
                                         sparse_kernel=sparse_kernel)

    def step_fn(params, opt_state, batch, step, tables=None):
        loss, grads = loss_and_grads(params, batch, tables)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        lr_t = cosine_schedule(step, peak=lr, warmup_steps=200,
                               total_steps=total_steps)
        params, opt_state = adamw_update(params, grads, opt_state, lr=lr_t)
        metrics = {"loss": loss.detach().float(), "gnorm": gnorm, "lr": lr_t}
        return params, opt_state, metrics

    if spion:
        return step_fn
    return functools.partial(step_fn, tables=None)


def make_prefill_step(cfg: ModelConfig, *, spion=False, block=None,
                      with_cache=False):
    """Prefill step: logits over the full prompt. `with_cache=True` builds
    the FUSED serving prefill instead — (params, batch[, tables]) ->
    (logits, ks, vs) with ks/vs the per-layer RoPE'd K/V stacked
    (L, B, S, KV, hd), ready for direct insertion into decode-cache pages
    (launch/serve.ServeEngine)."""
    bundle = build(cfg)
    static_block = block or cfg.spion.block_size

    def prefill(params, batch, tables=None):
        ex = _coerce_step_tables(tables, block=static_block, phase="prefill")
        if with_cache:
            return bundle.prefill_kv(params, batch, spion=ex)
        logits, _ = bundle.forward(params, batch, spion=ex)
        return logits

    if spion:
        return prefill
    return functools.partial(prefill, tables=None)


def make_serve_step(cfg: ModelConfig, *, spion=False, block=None):
    """Decode step: (params, cache, tokens, pos[, tables]) -> (logits,
    cache). `pos` may be a scalar or per-row (B,) vector; with `spion` the
    decode is sparse over the pattern-listed cache blocks. The cache may be
    the contiguous dict or a core.kv_pool.PagedKVCache."""
    bundle = build(cfg)
    static_block = block or cfg.spion.block_size

    def serve_step(params, cache, tokens, pos, tables=None):
        ex = _coerce_step_tables(tables, block=static_block, phase="decode")
        return bundle.decode_step(params, cache, tokens, pos, spion=ex)

    if spion:
        return serve_step
    return functools.partial(serve_step, tables=None)
