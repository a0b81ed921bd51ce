"""Step makers: the train step (one device, or every rank of a mesh), the
fused prefill step and the decode step, and the dry-run SPION patterns.

PyTorch runs eagerly, so a step is a plain closure over the model bundle;
the JAX package's jit, shardings and donation have no counterpart here (the
port updates parameters, optimizer state and caches in place instead of
donating them). Under a mesh (`mesh=`) each rank runs the step on its
shard of the batch, and of the sequence on a 'seq' axis: the loss is the
global mean and the gradients are summed over the mesh's data (and 'seq')
lines, so every rank applies the same update to its parameters. On a
'model' axis those are the rank's shards (distributed/sharding.py): the
ranks of a model line hold the same batch and compute the same loss, so
neither the loss nor the gradients are summed over it.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention_exec import SparseAttentionExec
from repro_torch.core.sparse_attention import PLAN_TABLE_KEYS
from repro_torch.distributed.sharding import (check_model_layout,
                                              mesh_context, model_size,
                                              sharded_dim)
from repro_torch.models.layers import tree_map
from repro_torch.models.registry import build
from repro_torch.optim import (adamw_update, clip_by_global_norm,
                               cosine_schedule)

def spion_dryrun_tables(cfg: ModelConfig, seq_len: int,
                        layers: Optional[int] = None,
                        max_extent: Optional[int] = None):
    """Deterministic SPION-shaped pattern (diagonal band + verticals) at the
    configured alpha density, as the full SparsityPlan payload: forward
    tables plus the transposed tables, 'block', 'kt_star' and the 'halo'
    pair. `max_extent` clips the off-diagonal verticals to [r - max_extent,
    r + max_extent]: the default global verticals make the pattern's extent
    ~nrb (a 'seq' axis then falls back to batch sharding by design); a
    bounded band stands in for the near-diagonal flood-fill patterns the
    halo exchange targets. The reference's tables, bitwise."""
    from repro_torch.core.sparse_attention import build_sparsity_plan
    cols, nval, blk, nrb = _dryrun_pattern(cfg, seq_len, layers, max_extent)
    plan = build_sparsity_plan(cols, nval, blk, ncb=nrb)
    return dict(plan.tables, kt_star=plan.kt_star, halo=plan.stats["halo"])


def spion_dryrun_halo(cfg: ModelConfig, seq_len: int,
                      layers: Optional[int] = None,
                      max_extent: Optional[int] = None):
    """Just the [left, right] halo of the dry-run pattern, from the forward
    tables alone (no host transpose)."""
    from repro_torch.core.sparse_attention import pattern_col_extents
    cols, nval, _, nrb = _dryrun_pattern(cfg, seq_len, layers, max_extent)
    ext_l, ext_r = pattern_col_extents(cols, nval, ncb=nrb)
    return [int(ext_l.max()), int(ext_r.max())]


def _dryrun_pattern(cfg: ModelConfig, seq_len: int, layers, max_extent):
    """The deterministic dry-run pattern's forward tables (host numpy)."""
    sp = cfg.spion
    blk = sp.block_size
    nrb = max(seq_len // blk, 1)
    Ly = layers if layers is not None else cfg.num_layers
    keep = max(1.0 - sp.alpha_quantile, 1.0 / nrb)
    K = max(int(np.ceil(nrb * keep)) + 1, 2)
    K = min(K, nrb)
    rng = np.random.default_rng(0)
    cols = np.zeros((Ly, nrb, K), np.int32)
    nval = np.full((Ly, nrb), K, np.int32)
    for l in range(Ly):
        for r in range(nrb):
            c = {r}  # forced diagonal
            c.add(max(r - 1, 0))                       # band
            verts = rng.integers(0, nrb, size=K)
            for v0 in verts:
                if len(c) >= K:
                    break
                if max_extent is not None:
                    v0 = int(np.clip(v0, r - max_extent, r + max_extent))
                    v0 = int(np.clip(v0, 0, nrb - 1))
                    c.add(min(v0, r) if cfg.causal else v0)
                else:
                    c.add(int(v0 if not cfg.causal else min(v0 % (r + 1), r)))
            cs = sorted(c)[:K]
            cols[l, r, : len(cs)] = cs
            nval[l, r] = len(cs)
            if len(cs) < K:
                cols[l, r, len(cs):] = cs[-1]          # clamped padding
    return cols, nval, blk, nrb


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


def _coerce_step_tables(tables, *, block, phase, halo=None,
                        kernel_config=None, dtype=None):
    """Normalise a step's sparse-tables argument to a SparseAttentionExec:
    an exec passes through with its own halo and kernel config; a dict
    payload gets the step's block, `halo` and `kernel_config`, or, when that
    is None, the config the autotune cache holds for it under `dtype`."""
    if tables is None:
        return None
    if isinstance(tables, SparseAttentionExec):
        return tables
    arrays = {k: tables[k] for k in PLAN_TABLE_KEYS if k in tables}
    return SparseAttentionExec(arrays, block=block, halo=halo, phase=phase,
                               kernel_config=kernel_config, dtype=dtype)


def compute_params(params, dtype):
    """The forward's view of fp32 masters: tensors with ndim >= 2 in fp32
    cast to `dtype` (the cast is differentiable, so gradients reach the
    masters in fp32), the others as they are. Nested dicts."""
    return tree_map(lambda x: x.to(dtype)
                    if x.dtype == torch.float32 and x.ndim >= 2 else x, params)


def reduce_axes(mesh):
    """The axes the loss terms and the gradients are summed over: every
    axis but 'model', whose ranks hold the same batch."""
    return tuple(a for a in mesh.axis_names if a != "model")


def make_loss_and_grads(cfg: ModelConfig, *, n_micro=1, block=None,
                        sparse_kernel=None, kernel_config=None, mesh=None,
                        halo=None):
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
    gather and the kernels' plain versions on CPU tensors. `kernel_config`
    is a kernels.dispatch.KernelConfig for dict payloads; an exec carries
    its own, resolved from the autotune cache at construction.

    `mesh` (launch/mesh.Mesh of more than one rank): `batch` is this rank's
    shard (batch over the data axes, the sequence over 'seq'); the loss is
    the global mean (the nll sums and token counts, masked ones too,
    all-reduced: not a mean of the ranks' means) and the gradients are
    summed over the mesh's data (and 'seq') lines in buckets, so they are
    the global batch's on every rank. On a 'model' axis `params` holds the
    rank's shards (`distributed.sharding.shard_params`) and the gradients
    are the shards'; a head count |model| does not divide takes the
    reference's fallback (models/attention.py), and what the port cannot
    split (a scan family's width |model| does not divide) raises here,
    before any collective (`check_model_layout`). 'seq' composes with
    'model': the sums run over 'seq' and the data axes, never 'model'. `halo` is the plan's (left, right)
    column extent for dict payloads (an exec carries its own): with it a
    'seq' axis shards the sparse attention's rows. Under a 'seq' axis the loss is still the
    global mean (the sums and counts all-reduced over 'seq' too) and the
    gradients are summed over the whole mesh, for every family: the
    recurrent ones carry their scan state and conv / token-shift rows
    across the shards, whisper gathers its encoder output for the
    cross-attention."""
    if sparse_kernel is not None:
        cfg = cfg.replace(spion=dataclasses.replace(cfg.spion,
                                                    kernel=sparse_kernel))
    bundle = build(cfg)
    compute_dtype = getattr(torch, cfg.dtype)
    static_block = block or cfg.spion.block_size
    nranks = 1 if mesh is None else mesh.size
    nred = 1
    if nranks > 1:
        from repro_torch.distributed import runtime
        check_model_layout(cfg, mesh)
        all_reduce_sum = runtime.all_reduce_sum      # bound when made
        axes = reduce_axes(mesh)
        nred = mesh.axis_size(axes)

    def loss_and_grads(params, batch, tables=None):
        ex = _coerce_step_tables(tables, block=static_block, phase="train",
                                 halo=halo, kernel_config=kernel_config,
                                 dtype=cfg.dtype)
        group = mesh.group(axes) if nred > 1 else None
        named = list(params.named_parameters())
        leaves = [p for _, p in named]
        mbs = [batch] if n_micro == 1 else [
            {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(n_micro)]
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        grads = None
        with mesh_context(mesh):
            for mb in mbs:
                nll, count, extra, _ = bundle.loss_parts(
                    compute_params(params, compute_dtype), mb, spion=ex)
                extra = torch.as_tensor(extra, dtype=torch.float32,
                                        device=loss.device)
                # under a mesh one all-reduce: the nll sum and the MoE's aux
                # terms (for the loss value) and the token count (the
                # divisor of every rank's share)
                tot = torch.stack([nll.detach().float(), count.float(),
                                   extra.detach()])
                if group is not None:
                    dist.all_reduce(tot, group=group)
                denom = tot[1].clamp(min=1.0)
                share = nll / denom + extra / nred
                gs = torch.autograd.grad(share, leaves, allow_unused=True)
                gs = [torch.zeros_like(p) if g is None else g.float()
                      for p, g in zip(leaves, gs)]
                grads = gs if grads is None else \
                    [a + b for a, b in zip(grads, gs)]
                loss = loss + tot[0] / denom + tot[2] / nred
        if group is not None:
            # the ranks' shares sum to the global batch's gradient
            all_reduce_sum(grads, group=group)
        if n_micro == 1:
            return loss, dict(zip((n for n, _ in named), grads))
        scale = 1.0 / n_micro
        return loss * scale, {n: g * scale for (n, _), g in zip(named, grads)}

    return loss_and_grads


def make_train_step(cfg: ModelConfig, *, spion=False, lr=3e-4,
                    total_steps=10_000, n_micro=1, block=None,
                    sparse_kernel=None, kernel_config=None, mesh=None,
                    halo=None, specs=None):
    """Returns f(params, opt_state, batch, step[, tables]) -> (params,
    opt_state, metrics) for one device.

    `params` is a ParamTree of fp32 masters that require grad and
    `opt_state` comes from optim.adamw_init; both are updated in place and
    returned. Loss and gradients come from `make_loss_and_grads` (the
    forward casts the masters to cfg.dtype; `n_micro` microbatches); then
    global-norm clipping at 1.0, the cosine schedule (warmup 200) and
    AdamW. Metrics: loss, gnorm and lr (0-d tensors).

    `spion=True` adds the sparse-tables argument (see `make_loss_and_grads`
    for it and for `block`, `sparse_kernel`, `kernel_config`, `mesh` and
    `halo`). Under a mesh every rank clips and updates with the same
    global gradients. On a 'model' axis `specs` is the whole tree's
    `param_pspecs` (the ones `params` was cut by): the norm sums the
    shards' squares over the model line and counts the replicated leaves
    once."""
    loss_and_grads = make_loss_and_grads(cfg, n_micro=n_micro, block=block,
                                         sparse_kernel=sparse_kernel,
                                         kernel_config=kernel_config,
                                         mesh=mesh, halo=halo)
    sharded = frozenset()
    if mesh is not None and model_size(mesh) > 1:
        if specs is None:
            raise ValueError("make_train_step on a 'model' mesh needs the "
                             "parameters' specs (param_pspecs of the whole "
                             "tree)")
        sharded = frozenset(n for n, spec in specs.items()
                            if sharded_dim(spec) is not None)

    def step_fn(params, opt_state, batch, step, tables=None):
        loss, grads = loss_and_grads(params, batch, tables)
        grads, gnorm = clip_by_global_norm(
            grads, 1.0, sharded, mesh.group("model") if sharded else None)
        lr_t = cosine_schedule(step, peak=lr, warmup_steps=200,
                               total_steps=total_steps)
        params, opt_state = adamw_update(params, grads, opt_state, lr=lr_t)
        metrics = {"loss": loss.detach().float(), "gnorm": gnorm, "lr": lr_t}
        return params, opt_state, metrics

    if spion:
        return step_fn
    return functools.partial(step_fn, tables=None)


def make_prefill_step(cfg: ModelConfig, *, spion=False, block=None,
                      with_cache=False, kernel_config=None):
    """Prefill step: logits over the full prompt. `with_cache=True` builds
    the FUSED serving prefill instead — (params, batch[, tables]) ->
    (logits, ks, vs) with ks/vs the per-layer RoPE'd K/V stacked
    (L, B, S, KV, hd), ready for direct insertion into decode-cache pages
    (launch/serve.ServeEngine). Families without a plain KV cache have
    no fused prefill (bundle.prefill_kv is None) and raise here.
    `kernel_config` as in `make_loss_and_grads`."""
    bundle = build(cfg)
    if with_cache and bundle.prefill_kv is None:
        raise NotImplementedError(
            f"make_prefill_step(with_cache=True): family {cfg.family!r} has "
            f"no fused KV prefill; serve it via stepwise prefill instead")
    static_block = block or cfg.spion.block_size

    def prefill(params, batch, tables=None):
        ex = _coerce_step_tables(tables, block=static_block, phase="prefill",
                                 kernel_config=kernel_config,
                                 dtype=cfg.dtype)
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
    the family's contiguous form or its paged form (a
    core.kv_pool.PagedKVCache, alone or under a "kv" key beside the hybrid
    family's recurrent states).

    spion=True on a family without an attention KV cache (ssm) raises
    here, at step construction (the registry's supports_sparse_decode)."""
    bundle = build(cfg)
    if spion and not bundle.supports_sparse_decode:
        raise NotImplementedError(
            f"make_serve_step(spion=True): family {cfg.family!r} (arch "
            f"{cfg.name!r}) keeps recurrent state, not an attention KV "
            f"cache — registry supports_sparse_decode is False for it. "
            f"Build the step with spion=False and serve densely.")
    static_block = block or cfg.spion.block_size

    def serve_step(params, cache, tokens, pos, tables=None):
        ex = _coerce_step_tables(tables, block=static_block, phase="decode")
        return bundle.decode_step(params, cache, tokens, pos, spion=ex)

    if spion:
        return serve_step
    return functools.partial(serve_step, tables=None)
