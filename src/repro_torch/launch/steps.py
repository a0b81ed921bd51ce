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

The prefill and decode steps take a mesh too, with the reference's batch
and cache layouts (`batch_pspecs`, `cache_pspecs`, the dry run's specs
as tuples): each rank runs on its shards of the parameters, the batch and
the cache, and the outputs come in the dry run's out-shardings.
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
from repro_torch.distributed.sharding import (CacheLayout, batch_spec,
                                              data_axes, decode_context,
                                              heads_split,
                                              live_axes, mesh_context,
                                              model_size, param_pspecs,
                                              reshard, sanitize_spec,
                                              sharded_dim, zero1_pspecs)
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


def batch_pspecs(cfg: ModelConfig, batch, mesh):
    """{name: spec} of a batch (leaves need only .shape and .ndim: meta
    tensors from registry.input_specs, numpy arrays): the batch dim over
    the data axes and, on a mesh with a 'seq' axis, the token dim over
    'seq', through `sanitize_spec`. The reference's rules, as tuples."""
    daxes = data_axes(mesh)
    seq_ax = "seq" if mesh.shape.get("seq", 1) > 1 else None

    def one(x):
        if x.ndim == 0:
            return ()
        rest = [seq_ax] + [None] * (x.ndim - 2) if x.ndim >= 2 else []
        return sanitize_spec(mesh, (daxes, *rest), x.shape)
    return {k: one(x) for k, x in batch.items()}


def cache_pspecs(cfg: ModelConfig, cache, mesh, batch_size: int):
    """{name: spec} of a decode cache keyed by the port's names (leaves
    need only .shape), the reference's rules as tuples through
    `sanitize_spec`: K/V caches k, v, ck, cv (L, B, S, KV, hd) split their
    KV heads over 'model' where |model| divides them, else head_dim,
    else neither, and B over the data axes when `batch_size` (the global
    batch) covers them, else S (the long_500k layout, B 1). SSM states:
    'ssm' (L, B, H, N, P) and rwkv's 'S' (L, B, H, hd, hd) their heads over
    'model', 'conv' (L, B, W-1, conv_dim) its last dim, 'tm_prev' /
    'cm_prev' (L, B, d) no 'model' split; their B over the data axes
    when the batch covers them.

    A paged pool (core.kv_pool.PagedKVCache, the cache itself or under
    "kv" beside the hybrid's states) is replicated: its leaves, named
    "pool.kp", "pool.vp", "pool.pt" (or "kv.kp", ... under "kv"), get
    (). The reference's rules match no pool leaf (a pytree of kp, vp, pt
    under flattened-index keys), so its spec is P() for each."""
    from repro_torch.core.kv_pool import PagedKVCache
    if isinstance(cache, PagedKVCache):
        cache = {"pool": cache}
    daxes = data_axes(mesh)
    ndata = mesh.axis_size(daxes) if daxes else 1
    batch_big = batch_size >= ndata
    m = mesh.shape.get("model", 1)
    rows = daxes if batch_big else None

    def one(name, x):
        if name in ("k", "v", "ck", "cv"):           # (L, B, S, KV, hd)
            KV, hd = x.shape[3], x.shape[4]
            kv_ax, hd_ax = ("model", None) if KV % m == 0 else \
                (None, "model") if hd % m == 0 else (None, None)
            if batch_big:
                return (None, daxes, None, kv_ax, hd_ax)
            return (None, None, daxes, kv_ax, hd_ax)
        if name in ("S", "ssm"):
            return (None, rows, "model", None, None)
        if name == "conv":
            return (None, rows, None, "model")
        if name in ("tm_prev", "cm_prev"):
            return (None, rows, None)
        return ()
    out = {}
    for n, x in cache.items():
        if isinstance(x, PagedKVCache):
            out.update({f"{n}.{leaf}": () for leaf in ("kp", "vp", "pt")})
        else:
            out[n] = sanitize_spec(mesh, one(n, x), x.shape)
    return out


def spion_table_pspecs(tables):
    """Replicated specs (the empty tuple) for every array of a sparse
    tables payload (a dict, or a SparseAttentionExec's tables), None for
    its static ints (block, kt_star) and pairs (halo): the plan tables are
    kilobytes and every rank reads the whole of them (the kernels index
    the unsharded sequence). The reference's specs, as tuples."""
    if isinstance(tables, SparseAttentionExec):
        return {k: () for k in tables.tables}
    return {k: (() if hasattr(v, "shape") else None)
            for k, v in tables.items()}


def train_shardings(cfg, mesh, params_tree, opt_tree, batch_tree, *,
                    zero1=True):
    """(param specs, optimizer-state specs, batch specs) of the reference's
    train-step signature, as spec tuples: the parameters' unsanitised
    `param_pspecs`, the moments' `zero1_pspecs` (or the parameter specs
    with zero1=False), the batch's `batch_pspecs`. The port's Trainer keeps
    the moments under the parameter spec (zero1=False's layout); no path
    of the port runs ZeRO-1's."""
    psp = param_pspecs(params_tree)
    osp = {"mu": zero1_pspecs(params_tree, mesh) if zero1 else psp,
           "nu": zero1_pspecs(params_tree, mesh) if zero1 else psp,
           "count": ()}
    return psp, osp, batch_pspecs(cfg, batch_tree, mesh)


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
    are the shards'; a head count or a scan width |model| does not
    divide takes the reference's fallback (models/attention.py,
    models/mamba.py, models/rwkv.py). 'seq' composes with 'model': the
    sums run over 'seq' and the data axes, never 'model'. `halo` is the
    plan's (left, right)
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


def _mesh_of(mesh):
    """`mesh` when it spans more than one rank, else None."""
    return mesh if mesh is not None and mesh.size > 1 else None


def _vocab_axis(cfg, mesh):
    """'model' where it splits the vocabulary (the logits a rank holds are
    its shard of it), else None."""
    m = model_size(mesh)
    return "model" if m > 1 and cfg.vocab_size % m == 0 else None


def make_prefill_step(cfg: ModelConfig, *, spion=False, block=None,
                      halo=None, with_cache=False, kernel_config=None,
                      mesh=None, specs=None):
    """Prefill step: logits over the full prompt. `with_cache=True` builds
    the FUSED serving prefill instead — (params, batch[, tables]) ->
    (logits, ks, vs) with ks/vs the per-layer RoPE'd K/V stacked
    (L, B, S, KV, hd), ready for direct insertion into decode-cache pages
    (launch/serve.ServeEngine). Families without a plain KV cache have
    no fused prefill (bundle.prefill_kv is None) and raise here.
    `halo` and `kernel_config` as in `make_loss_and_grads`.

    `mesh` (of more than one rank): `params` are this rank's shards and
    `batch` its shard in the layout of `specs` (the global batch's
    `batch_pspecs`; default: the batch over every data axis and the
    tokens over 'seq', as a train step's). The forward runs without
    autograd; a data axis the batch does not split holds copies of it,
    and the layers do not see that axis. The logits come out in the
    reference's dry-run out-sharding, the batch over the data axes and
    the vocabulary over 'model' where it divides (one gather over the
    'seq' line under 'seq'); ks / vs in `cache_pspecs`' layout for the
    global batch, as `make_serve_step` takes the cache (a gather over the
    'seq' line and cuts over 'model' or the data axes: the port's choice,
    the reference compiles no prefill with a cache under a mesh)."""
    bundle = build(cfg)
    if with_cache and bundle.prefill_kv is None:
        raise NotImplementedError(
            f"make_prefill_step(with_cache=True): family {cfg.family!r} has "
            f"no fused KV prefill; serve it via stepwise prefill instead")
    static_block = block or cfg.spion.block_size
    mesh = _mesh_of(mesh)

    def prefill(params, batch, tables=None):
        ex = _coerce_step_tables(tables, block=static_block, phase="prefill",
                                 halo=halo, kernel_config=kernel_config,
                                 dtype=cfg.dtype)
        if mesh is None:
            if with_cache:
                return bundle.prefill_kv(params, batch, spion=ex)
            return bundle.forward(params, batch, spion=ex)[0]
        return _mesh_prefill(cfg, bundle, mesh, specs, with_cache, params,
                             batch, ex)

    if spion:
        return prefill
    return functools.partial(prefill, tables=None)


def _mesh_prefill(cfg, bundle, mesh, specs, with_cache, params, batch, ex):
    """`make_prefill_step`'s step on this rank of `mesh`."""
    tok = specs["tokens"] if specs is not None else batch_spec(mesh, 2)
    tok = tuple(tok) + (None,) * (2 - len(tok))
    rows, seq = live_axes(mesh, tok[0]), live_axes(mesh, tok[1])
    # the layers see the axes the batch splits over and 'model'
    seen = set(rows or ()) | set(seq or ()) | {"model"}
    with torch.no_grad(), mesh_context(mesh.sub(seen)):
        if with_cache:
            logits, ks, vs = bundle.prefill_kv(params, batch, spion=ex)
        else:
            logits = bundle.forward(params, batch, spion=ex)[0]
        kv_split = heads_split(cfg)
    B = logits.shape[0] * mesh.axis_size(rows)
    S = logits.shape[1] * mesh.axis_size(seq)
    logits = reshard(logits, (rows, seq, _vocab_axis(cfg, mesh)),
                     sanitize_spec(mesh, (data_axes(mesh), None, "model"),
                                   (B, S, cfg.vocab_size)), mesh)
    if not with_cache:
        return logits
    hd = cfg.resolved_head_dim
    whole = torch.empty((ks.shape[0], B, S, cfg.num_kv_heads, hd),
                        device="meta")
    dst = cache_pspecs(cfg, {"k": whole}, mesh, B)["k"]
    src = (None, rows, seq, "model" if kv_split else None)
    return logits, reshard(ks, src, dst, mesh), reshard(vs, src, dst, mesh)


def make_serve_step(cfg: ModelConfig, *, spion=False, block=None,
                    halo=None, kernel_config=None, mesh=None, specs=None):
    """Decode step: (params, cache, tokens, pos[, tables]) -> (logits,
    cache). `pos` may be a scalar or per-row (B,) vector; with `spion` the
    decode is sparse over the pattern-listed cache blocks (`halo` and
    `kernel_config` as in `make_prefill_step`, for a dict payload). The
    cache may be the family's contiguous form or its paged form (a
    core.kv_pool.PagedKVCache, alone or under a "kv" key beside the hybrid
    family's recurrent states).

    `mesh` (of more than one rank): `params` are this rank's shards and
    `cache` its shard under `specs`, the whole cache's `cache_pspecs`
    (required: the reference's jit takes that layout as its
    in_shardings); `tokens` are its rows of the batch (`batch_pspecs`),
    `pos` is replicated. The step runs without autograd on the model line
    alone, replicated over 'seq' (a (B, 1) token does not split) and over
    the data axes the cache does not split its rows over: KV heads over
    'model' decode on the rank's heads; head_dim over 'model' sums the
    partial q·k over the line in fp32 and gathers the context's columns;
    positions over the data axes combine per-rank partial softmaxes by
    log-sum-exp in fp32, the sparse decode's zero correction once, after
    the combine (core/sparse_attention.py). The new token is written by
    the rank that holds its slot; the cache is updated in place. The
    logits come out in the reference's dry-run decode out-sharding (the
    rows over the data axes for B > 1, the vocabulary over 'model' where
    it divides). A paged cache's pool and page table are replicated, as
    the reference's cache_pspecs leave them (`specs` "pool.kp", ... or
    "kv.kp", ...: ()): the rank decodes its rows of the batch
    (`batch_pspecs`'s, or the hybrid states' rows) with its KV heads or
    head_dim columns of the pool, and every rank writes the new token's
    K/V for every row and KV head, gathered over the model line and the
    rows' line (core/kv_pool.py), so that the pools stay equal.

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
    mesh = _mesh_of(mesh)
    if mesh is not None:
        if specs is None:
            raise ValueError("make_serve_step on a mesh needs the cache's "
                             "specs (cache_pspecs of the whole cache)")
        layout = CacheLayout(mesh, specs)

    def serve_step(params, cache, tokens, pos, tables=None):
        ex = _coerce_step_tables(tables, block=static_block, phase="decode",
                                 halo=halo, kernel_config=kernel_config,
                                 dtype=cfg.dtype)
        if mesh is None:
            return bundle.decode_step(params, cache, tokens, pos, spion=ex)
        return _mesh_decode(cfg, bundle, layout, params, cache, tokens, pos,
                            ex)

    if spion:
        return serve_step
    return functools.partial(serve_step, tables=None)


def _mesh_decode(cfg, bundle, layout, params, cache, tokens, pos, ex):
    """`make_serve_step`'s step on this rank of `layout.mesh`."""
    from repro_torch.core.kv_pool import PagedKVCache
    mesh = layout.mesh
    daxes = data_axes(mesh)
    pool = cache if isinstance(cache, PagedKVCache) else None
    states = [x for x in ([] if pool is not None else cache.values())
              if not isinstance(x, PagedKVCache)]
    pool = pool or next((x for x in cache.values()
                         if isinstance(x, PagedKVCache)), None)
    # the tokens' rows as batch_pspecs cuts them
    B = pool.pt.shape[0] if pool is not None else \
        states[0].shape[1] * mesh.axis_size(layout.rows)
    spec = sanitize_spec(mesh, (daxes,), (B,))
    tok_rows = live_axes(mesh, spec[0] if spec else None)
    if not states:
        # a replicated pool alone: the step decodes the tokens' rows
        layout = CacheLayout(mesh, {}, rows=tok_rows)
    rows = layout.rows
    B_loc = B // mesh.axis_size(rows)
    tokens = reshard(tokens, (tok_rows,), (rows,), mesh)
    pos = torch.as_tensor(pos, device=tokens.device)
    if pos.dim() == 1 and pos.shape[0] == B and B_loc < B:
        pos = reshard(pos, (None,), (rows,), mesh)
    with torch.no_grad(), decode_context(layout):
        logits, cache = bundle.decode_step(params, cache, tokens, pos,
                                           spion=ex)
    out = sanitize_spec(mesh, (daxes if B > 1 else None, "model"),
                        (B, cfg.vocab_size))
    return reshard(logits, (rows, _vocab_axis(cfg, mesh)), out, mesh), cache
