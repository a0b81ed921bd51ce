"""The mesh context and the sharding decisions of the sparse-attention
kernels (the JAX package's `distributed/sharding.py`, the parts the
kernels need).

`mesh_context(mesh)` makes a mesh current, so model code reaches the
sharded kernels without carrying a mesh argument. On a mesh with a 'seq'
axis every rank holds a contiguous shard of the sequence: `seq_start` is
its first row's global position (`seq_positions` its rows' and the whole
sequence's positions), `gather_seq` the differentiable gather
of the whole sequence (the dense attention's, the gather path's and the
capture's K/V: `gather_kv`; the MoE's rows; whisper's encoder output; the
kernels' too-wide fallback), `sum_over_seq` the sum of a statistic over
the shards. The recurrent families cross a shard boundary in two ways:
`seq_left_rows` hands a shard the previous shard's last rows (Mamba2's
causal conv, RWKV6's token shift) and `carried_combine` runs the chunked
scans' state combine (Mamba2's and WKV6's) from the state that enters it
(`seq_carry`), both differentiable.
`kernel_shard_axes` and
`kernel_seq_axis` decide, exactly as the reference does and with its
reasons, which mesh axes the kernels' batch, KV heads and query rows split
over; `kernel_pspecs_from_axes` states that layout per tensor dimension,
as tuples where the reference has PartitionSpecs.

The 'model' axis (tensor, expert and vocabulary parallelism) is GSPMD
layout in the reference; PyTorch has none, so the port writes out what the
compiler inserts (Megatron-style). The layout contract:

  - **Which shard each rank holds.** Of every parameter a rank holds
    exactly the slice that `param_pspecs(params, mesh)` gives it
    (`local_slices`; the reference's `_RULES`, `_FALLBACKS`, `sanitize_spec`
    and `best_spec`, bitwise, with specs as tuples and paths the
    `named_parameters()` names joined by '/'). Its AdamW moments have the
    same spec, as the reference's Trainer keeps mu and nu under the
    parameter spec (`launch/train.py` `_restore_shardings`). `zero1_pspecs`
    states the ZeRO-1 specs for the dry run; no trainer path runs them.
    `shard_params` and `gather_params` go between the whole tree and the
    rank's shard.
  - **Heads.** Where |model| divides both the attention heads and the
    KV heads (`heads_split`), each rank runs its H/|model| query heads and
    KV/|model| KV heads: column-parallel projections, the attention on the
    rank's heads, a row-parallel output projection. Where it does not
    (whisper-tiny's 6 heads on |model| 4, 2 KV heads on 4), the leaves keep
    the reference's spec shards all the same (`sanitize_spec` keeps a
    column rule wherever the merged width divides: 384 columns of wq on 4
    ranks are 96 a rank, 1.5 heads) and the layer takes the reference's
    fallback (`kernel_shard_axes` with `kv_ax` None): each rank computes
    its columns of q, k and v, `gather_model` joins them into the whole
    merged widths, RoPE follows, the attention runs on every head on every
    rank of the line, and the output projection takes the rank's rows of
    the context (models/attention.py). A merged width |model| does not
    divide keeps its leaf whole, as `sanitize_spec` does.
  - **Scan widths.** Where |model| divides every width a scan splits by
    (`scan_split`: the hybrid's SSM heads and B‖C columns, the ssm
    family's heads) each rank runs its heads of the scan. Where it does
    not (zamba2 with `state_size` 5 on 4 ranks, rwkv6 with 6 heads on 4)
    the leaves are the reference's spec shards all the same, contiguous
    and mid-head where they fall so, and the layer takes the reference's
    fallback (models/mamba.py, models/rwkv.py): each rank computes its
    columns of the input projections, `gather_model` joins them over the
    line, the conv, the scan and the whole-width norm run on every head,
    and the output projection is row-parallel over the rank's rows where
    its leaf is split, whole where it is not (then the layer runs wholly
    replicated). Where `sanitize_spec` drops a rule because the
    dimension does not divide, the leaf is replicated, as in the reference
    (internvl2-2b's vocabulary of 92,553 keeps `tok_embed` and `lm_head`
    whole, whisper's 51,865 its tied `tok_embed`). 'seq' and 'model'
    compose: the 'seq' collectives run on this rank's 'seq' line (the
    ranks of its data and model index), the model-line ones on its model
    line.
  - **Packed leaves.** Mamba2's `in_proj` packs z (inner), x (inner), B
    and C (N each) and dt (H) in its columns. The rule splits the columns
    over 'model' as the reference's does, with the reference's shard
    shape, but a contiguous cut would not fall on heads (zamba2 on
    |model| 2: rank 0 would hold all of z), so where the scan splits by
    heads (`scan_split`) rank r holds the r-th |model|-th of each
    segment, in order: [z heads r | x heads r | the r-th part of B‖C |
    dt heads r] (`packed_segments`); under the scan fallback it holds the
    reference's contiguous shard. The cut by segment is a fixed
    permutation of the reference's shard (a departure of layout, not of
    arithmetic): still a partition, so the moments, the global norm and
    the specs need no special case. `local_index` gives a leaf's shard
    index (a slice, or those columns) and is the one function that every
    site cutting or joining a leaf calls: `shard_params`, `gather_params`
    (which puts the columns back), the Trainer's restore and
    `convert.params_from_numpy(mesh=)`.
  - **Replicated leaves used in part.** A leaf the rules keep whole but
    that each rank uses only in part (Mamba2's `conv_w`, `conv_b`,
    `A_log`, `D`, `dt_bias` and `out_norm` scale; RWKV6's `w0`,
    `w_lora_b`, `u` and `ln_x`) enters through `model_part`: its
    gradient is summed over the line, so it is whole and equal on every
    rank. A norm over the whole inner width (Mamba2's `out_norm`, RWKV6's
    `ln_x`) sums the rank's statistic over the line in fp32 forward and
    backward (`model_line_sum`); the B‖C stream that every head reads is
    gathered over the line (`gather_model`), its backward summed. Under
    the scan fallback every rank reads every replicated leaf whole; where
    the output projection is row-parallel each rank's backward carries
    only its rows' share of the output gradient, so those leaves enter
    through `copy_to_model` too, and where it is whole no sum is taken.
  - **The collectives are explicit.** `copy_to_model` (identity forward,
    all-reduce backward) enters every region whose work differs across
    the model line, `reduce_from_model` (all-reduce forward, identity
    backward) leaves it, `model_mean` averages a statistic over the line.
    Every model-line sum runs in fp32 and is cast afterwards (the
    row-parallel partial outputs, the MoE's partial combine, the
    vocab-parallel embedding and loss); the partial products themselves
    are GEMMs in the activation dtype (fp32 accumulation, bf16 out on a
    bf16 model). The reference leaves the reduction dtype to XLA.
  - **One decision.** Whether a layer runs split is `model_split(dim)` of
    the config's full dimension on the active mesh: the same divisibility
    that `sanitize_spec` applies to the leaf's rule, so a layer's code and
    its leaves' shards agree; for the attention heads it is `heads_split`
    (both head counts), which every site asks: the projections, the
    output projection, the capture's line mean and the kernels' KV count.
    `constrain` has no counterpart: the layout is explicit.
  - **Caches.** A decode cache's leaves split as launch/steps.
    cache_pspecs says (`shard_cache`, `gather_cache`; the hybrid's conv
    state by segment where the scan splits by heads, as in_proj). A paged
    KV pool (core/kv_pool.py) is replicated, as the reference's specs
    leave it: `shard_cache` and `gather_cache` pass it through whole. A
    decode step on a shard runs in
    `decode_context`: the layers see the model line alone and the
    active `CacheLayout` names the axes the cache's rows and positions
    split over (`position_shard`, `gather_rows`). `reshard` moves a step's
    output from the layout it was computed in to the dry run's
    out-sharding.
"""
from __future__ import annotations

import contextlib
import contextvars
import re
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


@contextlib.contextmanager
def mesh_context(mesh):
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


def current_mesh():
    return _MESH.get()


def active_mesh():
    """The current mesh when it spans more than one rank, else None."""
    mesh = current_mesh()
    return mesh if mesh is not None and mesh.size > 1 else None


def data_axes(mesh):
    """All data-parallel axes present in the mesh (pod composes with data)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def seq_size(mesh) -> int:
    return 1 if mesh is None else int(mesh.shape.get("seq", 1))


# ---------------------------------------------------------------------------
# sequence shards
# ---------------------------------------------------------------------------

def seq_start(rows: int) -> int:
    """Global position of this rank's first row when each rank of the
    active mesh's 'seq' line holds `rows` consecutive positions (0 without
    a 'seq' axis)."""
    mesh = active_mesh()
    return mesh.axis_index("seq") * rows if seq_size(mesh) > 1 else 0


def seq_positions(rows: int, device):
    """(this shard's first row's global position, its `rows` rows' global
    positions, the whole sequence's positions) on the active mesh's 'seq'
    line; 0 and one tensor twice without a 'seq' axis."""
    start, n = seq_start(rows), seq_size(active_mesh())
    positions = torch.arange(start, start + rows, device=device)
    return start, positions, (positions if n == 1 else
                              torch.arange(n * rows, device=device))


class GatherSeq(torch.autograd.Function):
    """x (..., S_loc, ...) -> (..., n * S_loc, ...) along `dim`: the
    shards of a line (the 'seq' line's, or the model line's B‖C columns:
    `gather_model`) in order. The backward sums the gradient over the line in
    fp32 (a bf16 sum would round each partial sum) and keeps this shard's
    rows (gloo has no reduce-scatter); with `summed` False it keeps them
    without the sum (every rank's gradient is already the whole one).
    CUDA tensors on a gloo group cross through the host, since gloo
    gathers only CPU tensors."""

    @staticmethod
    def forward(ctx, x, group, n, idx, dim, summed=True):
        ctx.group, ctx.idx, ctx.dim, ctx.summed = group, idx, dim, summed
        ctx.rows = x.shape[dim]
        staged = x.is_cuda and dist.get_backend(group) == "gloo"
        src = (x.detach().to("cpu") if staged else x.detach()).contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=dim)
        return out.to(x.device) if staged else out

    @staticmethod
    def backward(ctx, g):
        if not ctx.summed:
            return (g.narrow(ctx.dim, ctx.idx * ctx.rows, ctx.rows),
                    None, None, None, None, None)
        total = g.float().contiguous()
        if total is g:
            total = g.clone()
        dist.all_reduce(total, group=ctx.group)
        return (total.narrow(ctx.dim, ctx.idx * ctx.rows, ctx.rows)
                .to(g.dtype), None, None, None, None, None)


def gather_seq(x, dim: int, mesh=None):
    """The whole sequence along `dim` from every rank's shard of the 'seq'
    line (differentiable: `GatherSeq`); `x` itself without a 'seq' axis."""
    mesh = active_mesh() if mesh is None else mesh
    n = seq_size(mesh)
    if n == 1:
        return x
    return GatherSeq.apply(x, mesh.group("seq"), n, mesh.axis_index("seq"),
                           dim)


def gather_kv(k, v):
    """k, v (B, S_loc, KV, hd) of a 'seq' shard -> the whole sequence's
    (B, S, KV, hd) each, in one differentiable gather (whose backward sums
    the K/V gradients over the line); k, v themselves without a 'seq'
    axis."""
    if seq_size(active_mesh()) == 1:
        return k, v
    kv = gather_seq(torch.stack([k, v]), 2)
    return kv[0], kv[1]


def seq_left_rows(x, rows: int):
    """The `rows` rows that precede this 'seq' shard along dim 1 of x (B,
    S_loc, ...): the previous shard's last rows, zeros on the first shard
    (the reference's zero padding at the sequence start). None without a
    'seq' axis. One differentiable gather of every shard's last rows, whose
    backward sums their gradient over the line."""
    mesh = active_mesh()
    n = seq_size(mesh)
    if n == 1:
        return None
    if rows > x.shape[1]:
        raise ValueError(f"a left halo of {rows} rows reaches past the "
                         f"previous shard of {x.shape[1]} rows")
    i = mesh.axis_index("seq")
    tails = gather_seq(x[:, x.shape[1] - rows:][None], 0)   # (n, B, rows, ..)
    # every rank reads the gather, so every rank's backward runs its
    # all-reduce; the first shard's rows are zeros
    first = torch.tensor(i == 0, device=x.device)
    return torch.where(first, 0.0, tails[max(i - 1, 0)])


def seq_carry(decay, final):
    """The state entering this 'seq' shard of a linear recurrence
    S_{t+1} = decay_t * S_t + delta_t whose shards each ran it from zero:
    `final` (B, ...) is this shard's final state from a zero start, `decay`
    (B, ...) the product of its steps' decays, broadcastable to `final`. Both go over the line in one gather; the earlier
    shards' summaries combine in rank order, S = S * decay_s + final_s,
    from zeros (the first shard gets zeros). fp32, differentiable: the
    gather's backward sums the summaries' gradients over the line."""
    mesh = active_mesh()
    n = seq_size(mesh)
    B = final.shape[0]
    kd = decay[0].numel()
    summary = torch.cat([decay.reshape(B, -1), final.reshape(B, -1)], dim=1)
    lines = gather_seq(summary[None], 0)                    # (n, B, kd + kf)
    dec = lines[..., :kd].reshape(
        n, *decay.shape, *(1,) * (final.dim() - decay.dim()))
    fin = lines[..., kd:].reshape(n, *final.shape)
    i = mesh.axis_index("seq")
    before = torch.arange(n, device=final.device) < i
    state = torch.zeros_like(final)
    for s in range(n):
        # where, not a Python branch: every rank's state reads the whole
        # gather, so every rank's backward runs its all-reduce
        state = torch.where(before[s], state * dec[s] + fin[s], state)
    return state


def carried_combine(decay, delta):
    """The state entering each chunk, (B, n, ...), of the chunked linear
    recurrence S_{j+1} = decay_j * S_j + delta_j over this shard's n chunks:
    delta (B, n, ...) fp32, decay (B, n, ...) broadcast over delta's
    trailing dims. A sequential combine from zeros; on a 'seq' shard the
    combine runs again from the state the earlier shards hand on
    (`seq_carry` of this shard's total decay and final state)."""
    def combine(state):
        incoming = []
        for j in range(decay.shape[1]):
            incoming.append(state)
            state = state * decay[:, j] + delta[:, j]
        return torch.stack(incoming, dim=1), state
    S_in, final = combine(torch.zeros_like(delta[:, 0]))
    if seq_size(active_mesh()) > 1:
        S_in, _ = combine(seq_carry(decay.prod(dim=1), final))
    return S_in


def sum_over_seq(x):
    """Sum of `x` over the ranks of the active mesh's 'seq' line (in
    place; statistics only, no gradient)."""
    mesh = active_mesh()
    if seq_size(mesh) > 1:
        dist.all_reduce(x, group=mesh.group("seq"))
    return x


# ---------------------------------------------------------------------------
# sparse-attention kernel sharding
# ---------------------------------------------------------------------------

def kernel_shard_axes(mesh, batch: int, kv_heads: int):
    """Mesh axes of the kernels' (batch, KV) dims: (batch_axes, kv_axis).

      - batch over the data axes ('pod', 'data'), greedily keeping every
        axis whose size still divides the (global) batch exactly;
      - KV heads over 'model' when KV % |model| == 0, else replicated.
    Both None means nothing shards."""
    acc, chosen = 1, []
    for a in data_axes(mesh):
        if mesh.shape[a] > 1 and batch % (acc * mesh.shape[a]) == 0:
            chosen.append(a)
            acc *= mesh.shape[a]
    baxes = tuple(chosen) if chosen else None
    model = mesh.shape.get("model", 1)
    kv_ax = "model" if model > 1 and kv_heads % model == 0 else None
    return baxes, kv_ax


def kernel_seq_axis(mesh, nrb, halo):
    """'seq'-axis decision of the kernels (DESIGN.md §10): (axis or None,
    reason). `nrb` is the global row-block count; `halo` the pattern's
    (left, right) column extent in blocks (SparsityPlan stats["halo"]).
    Q row-blocks shard over 'seq' with a single-neighbour halo exchange
    when

      - nrb % n == 0; W = nrb // n;
      - halo_left <= W and halo_right <= W (one step to the adjacent
        shard);
      - halo_left + halo_right <= (n - 1) * W (the halo-extended window must
        not alias global column-blocks across the ring wrap, or the dK/dV
        halo sum would count a block twice).

    Otherwise the caller falls back to batch sharding, loudly."""
    n = mesh.shape.get("seq", 1)
    if n <= 1:
        return None, "mesh has no 'seq' axis (or |seq| == 1)"
    if halo is None:
        return None, ("no pattern halo supplied — seq sharding needs the "
                      "SparsityPlan's column-extent stats (stats['halo'], "
                      "threaded as the static spion tables key 'halo')")
    if nrb is None or nrb % n != 0:
        return None, f"nrb={nrb} row-blocks not divisible by |seq|={n}"
    W = nrb // n
    h_l, h_r = int(halo[0]), int(halo[1])
    if h_l > W or h_r > W:
        return None, (f"pattern halo ({h_l},{h_r}) blocks exceeds the shard "
                      f"width W={W} — the exchange would need more than the "
                      f"adjacent shard's edge")
    if h_l + h_r > (n - 1) * W:
        return None, (f"halo window {h_l}+{W}+{h_r} blocks exceeds the "
                      f"global {nrb} — local storage would alias "
                      f"column-blocks across the ring wrap")
    return "seq", f"W={W} halo=({h_l},{h_r})"


def kernel_pspecs_from_axes(baxes, kv_ax, seq_ax=None):
    """(qspec, kvspec, table_spec): the mesh axes of each dimension of q
    (B, KV, G, S, hd), k / v (B, KV, S, hd) and the tables (replicated, the
    empty tuple), as the reference's PartitionSpecs list them."""
    return ((baxes, kv_ax, None, seq_ax, None),
            (baxes, kv_ax, seq_ax, None), ())


def kernel_pspecs(mesh, batch: int, kv_heads: int):
    """(qspec, kvspec, table_spec) of the kernels' tensors on `mesh` for a
    global `batch` and `kv_heads`: `kernel_pspecs_from_axes` of
    `kernel_shard_axes`, a one-axis tuple written as that axis (as a
    PartitionSpec normalises it)."""
    def one(spec):
        return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in spec)
    return tuple(one(s) for s in kernel_pspecs_from_axes(
        *kernel_shard_axes(mesh, batch, kv_heads)))


def local_slices(mesh, spec, shape, rank: Optional[int] = None):
    """The slices of a global tensor of `shape` that `rank` (default: this
    process) holds under `spec` (one entry per leading dimension: None, an
    axis name or a tuple of names)."""
    out = []
    for d, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        n = mesh.axis_size(e)
        if n == 1:
            out.append(slice(None))
            continue
        if d % n:
            raise ValueError(f"dimension {d} does not split over {e} "
                             f"({n} ranks)")
        i = mesh.flat_index(e, rank)
        out.append(slice(i * (d // n), (i + 1) * (d // n)))
    return tuple(out)


def batch_spec(mesh, ndim: int):
    """Spec of a (B, S, ...) batch tensor: the batch over the data axes,
    the sequence over 'seq' when the mesh has one (launch/steps.
    batch_pspecs in the reference)."""
    daxes = data_axes(mesh) or None
    if ndim == 0:
        return ()
    seq_ax = "seq" if seq_size(mesh) > 1 else None
    return (daxes,) + ((seq_ax,) if ndim >= 2 else ())


def mean_over_data(x):
    """Mean of `x` over the ranks of the data axes (in place; statistics
    only, no gradient): the capture's batch average of a data-parallel
    run."""
    mesh = active_mesh()
    if mesh is None:
        return x
    n = mesh.axis_size(data_axes(mesh))
    if n == 1:
        return x
    dist.all_reduce(x, group=mesh.group(data_axes(mesh)))
    return x.div_(n)


# ---------------------------------------------------------------------------
# parameter rules (path-name driven): the reference's, specs as tuples
# ---------------------------------------------------------------------------

def sanitize_spec(mesh, spec, shape) -> tuple:
    """Drop (or shrink) spec entries whose mesh-axis product does not divide
    the corresponding dim; axis names the mesh does not have are dropped
    first. Trailing None entries go, as the reference's do."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for d, e in zip(shape, entries):
        if isinstance(e, str) and e not in mesh.shape:
            e = None
        elif isinstance(e, (tuple, list)):
            e = tuple(a for a in e if a in mesh.shape) or None
        if e is None:
            out.append(None)
            continue
        if d % mesh.axis_size(e) == 0:
            out.append(e)
            continue
        if isinstance(e, tuple):
            kept = None
            for k in range(len(e) - 1, 0, -1):
                if d % mesh.axis_size(e[:k]) == 0:
                    kept = e[:k]
                    break
            out.append(kept)
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    # a one-axis tuple is that axis, as PartitionSpec normalises it
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in out)


# (regex over the '/'-joined parameter path, the spec as a function of
# ndim), for the unstacked tensor; a leading layer dim is padded with None
# (`_pad`)
_RULES = [
    # attention projections
    (r"(wq|wk|wv|wqkv)$", lambda nd: (None, "model")),
    (r"wo$", lambda nd: ("model", None)),
    (r"(bq|bk|bv)$", lambda nd: ("model",)),
    # MoE expert weights (experts, d, ff) / (experts, ff, d), before the
    # generic mlp rules (first match wins)
    (r"experts/(w_in|w_gate)$", lambda nd: ("model", None, None)),
    (r"experts/w_out$", lambda nd: ("model", None, None)),
    (r"router/w$", lambda nd: (None, None)),
    # gated mlp
    (r"(w_in|w_gate)$", lambda nd: (None, "model")),
    (r"w_out$", lambda nd: ("model", None)),
    # embeddings and head
    (r"(tok_embed|lm_head)/w$",
     lambda nd: ("model", None) if nd == 2 else ("model",)),
    (r"pos_embed/w$", lambda nd: (None, None)),
    # ssm (rwkv / mamba) projections: the inner dim over model
    (r"(w_r|w_k|w_v|w_g|w_xbc|w_dt|in_proj)$", lambda nd: (None, "model")),
    (r"(out_proj)$", lambda nd: ("model", None)),
    # patch projector (vlm)
    (r"patch_proj/w$", lambda nd: (None, "model") if nd == 2 else ()),
]

# fallbacks when the primary rule does not divide (mixtral's 8 experts on a
# 16-way model axis: d_ff split within each expert instead)
_FALLBACKS = [
    (r"experts/(w_in|w_gate)$", lambda nd: (None, None, "model")),
    (r"experts/w_out$", lambda nd: (None, "model", None)),
]


def _pad(spec, ndim: int) -> tuple:
    extra = ndim - len(spec)
    if extra > 0:
        return (None,) * extra + tuple(spec)
    if extra < 0:      # a rule wider than the tensor: replicate
        return ()
    return tuple(spec)


def spec_for_path(path: str, ndim: int) -> tuple:
    for pat, fn in _RULES:
        if re.search(pat, path):
            return _pad(fn(ndim), ndim)
    return ()      # replicated (norm scales, small biases, decay params, ...)


def spec_candidates(path: str, ndim: int):
    """The primary spec followed by the divisibility fallbacks."""
    out = [spec_for_path(path, ndim)]
    for pat, fn in _FALLBACKS:
        if re.search(pat, path):
            out.append(_pad(fn(ndim), ndim))
    return out


def best_spec(mesh, path: str, leaf) -> tuple:
    """The first candidate whose sanitised form still carries a sharding."""
    cands = spec_candidates(path, getattr(leaf, "ndim", 0))
    best = sanitize_spec(mesh, cands[0], leaf.shape)
    for c in cands:
        s = sanitize_spec(mesh, c, leaf.shape)
        if any(e is not None for e in s):
            return s
    return best


def named_leaves(params) -> list:
    """[(dotted name, leaf)] of a ParamTree (`named_parameters()`), a nested
    dict, or a flat {dotted name: leaf} dict."""
    if hasattr(params, "named_parameters"):
        return list(params.named_parameters())
    out = []
    for k, v in params.items():
        if isinstance(v, dict) or hasattr(v, "named_parameters"):
            out += [(f"{k}.{n}", x) for n, x in named_leaves(v)]
        else:
            out.append((k, v))
    return out


def _path(name: str) -> str:
    return name.replace(".", "/")


def param_pspecs(params, mesh=None) -> dict:
    """{dotted name: spec} of `params` (leaves need only .shape and .ndim:
    meta tensors, numpy arrays). With `mesh` the specs are sanitised
    against the leaves' shapes."""
    def one(name, leaf):
        if mesh is not None:
            return best_spec(mesh, _path(name), leaf)
        return spec_for_path(_path(name), getattr(leaf, "ndim", 0))
    return {n: one(n, x) for n, x in named_leaves(params)}


def zero1_pspecs(params, mesh) -> dict:
    """ZeRO-1 optimizer-state specs: the parameter spec plus the largest
    still-unsharded dim over the data axes (falls back to the parameter
    spec). Specs only: the port's trainers keep the moments under the
    parameter spec, as the reference's Trainer does."""
    daxes = data_axes(mesh)

    def one(name, leaf):
        spec = best_spec(mesh, _path(name), leaf)
        entries = list(spec) + [None] * (leaf.ndim - len(spec))
        cand, size = None, 0
        for i, (e, d) in enumerate(zip(entries, leaf.shape)):
            if e is None and d > size and daxes and \
                    d % mesh.axis_size(daxes) == 0:
                cand, size = i, d
        if cand is not None:
            entries[cand] = daxes if len(daxes) > 1 else daxes[0]
        return sanitize_spec(mesh, tuple(entries), leaf.shape)
    return {n: one(n, x) for n, x in named_leaves(params)}


# ---------------------------------------------------------------------------
# the 'model' axis: layout checks, shards, collectives
# ---------------------------------------------------------------------------

# the hybrid family's packed leaf: Mamba2's in_proj (z, x, B‖C, dt)
_PACKED = re.compile(r"mamba/in_proj$")


def model_size(mesh=None) -> int:
    """|model| of `mesh` (default: the active mesh); 1 without one."""
    mesh = active_mesh() if mesh is None else mesh
    return 1 if mesh is None else int(mesh.shape.get("model", 1))


def model_split(dim: int) -> bool:
    """Whether the active mesh's 'model' axis splits a dimension of full
    size `dim` (heads, d_ff, experts, vocabulary): |model| > 1 and divides
    it, as `sanitize_spec` keeps a rule's 'model' entry. The one test every
    layer makes; False without a mesh."""
    m = model_size()
    return m > 1 and dim % m == 0


def model_offset(local: int) -> int:
    """First global index of this rank's shard of a dimension split over
    the active mesh's 'model' axis into shards of `local`."""
    return active_mesh().axis_index("model") * local


def model_widths(cfg) -> dict:
    """{name: full width} of every dimension a 'model' axis splits in
    `cfg`'s layers: the attention heads and KV heads (every family with
    attention), the hybrid family's Mamba2 SSM heads, inner width and B
    and C columns (2N, one group), the ssm family's heads and d_ff, the
    encdec family's d_ff."""
    out = {}
    if cfg.family != "ssm":
        out.update(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads)
    if cfg.family == "hybrid":
        inner = cfg.ssm.expand * cfg.d_model
        out.update({"ssm heads": inner // cfg.ssm.head_dim, "inner": inner,
                    "2N (B and C)": 2 * cfg.ssm.state_size})
    if cfg.family == "ssm":
        out.update(num_heads=cfg.num_heads, d_ff=cfg.d_ff)
    if cfg.family in ("audio", "encdec"):
        out["d_ff"] = cfg.d_ff
    return out


def heads_split(cfg) -> bool:
    """Whether the active mesh's 'model' axis splits `cfg`'s attention
    heads: |model| > 1 divides both the query heads and the KV heads, so
    each rank holds whole heads of both (a contiguous split keeps query
    head h with KV head h // G). False under the reference's fallback
    (either count indivisible: every rank computes every head) and
    without a 'model' axis."""
    m = model_size()
    return m > 1 and cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0


# the widths of `model_widths` that a scan family's layers split by heads
# (the inner width follows from the heads; the ssm family's d_ff is its
# channel mix's, an MLP that asks `model_split` itself)
_SCAN_WIDTHS = {"hybrid": ("ssm heads", "inner", "2N (B and C)"),
                "ssm": ("num_heads",)}


def scan_split(cfg, mesh=None) -> bool:
    """Whether `mesh`'s 'model' axis (default: the active mesh's) splits
    `cfg`'s scans by heads: |model| > 1 divides every width the family's
    scan splits (the hybrid's SSM heads, inner width and B and C columns;
    the ssm family's heads), so each rank runs whole heads. False under
    the reference's fallback (the scan runs on every head on every rank,
    from the rank's columns gathered over the line), for the families
    without a scan and without a 'model' axis. Every Mamba2 and WKV6
    layer asks it, as the attention asks `heads_split`."""
    m = model_size(mesh)
    names = _SCAN_WIDTHS.get(cfg.family)
    if m <= 1 or not names:
        return False
    widths = model_widths(cfg)
    return all(widths[k] % m == 0 for k in names)


def packed_segments(name: str, cfg):
    """The widths of the segments that leaf `name` packs in its sharded
    dimension, in order (Mamba2's in_proj: z, x, B‖C, dt; the hybrid
    cache's conv state: x, B‖C), or None for a leaf that packs nothing. A
    packed leaf without `cfg` raises: its cut depends on the widths."""
    conv = name == "conv"
    if not conv and not _PACKED.search(_path(name)):
        return None
    if cfg is None:
        raise ValueError(f"{name} packs several segments in its columns; "
                         f"cutting or joining it needs the model's config")
    inner = cfg.ssm.expand * cfg.d_model
    if conv:
        return (inner, 2 * cfg.ssm.state_size)
    return (inner, inner, 2 * cfg.ssm.state_size, inner // cfg.ssm.head_dim)


def _segments(mesh, name: str, cfg):
    """`packed_segments` where `mesh`'s scans split by heads
    (`scan_split`), else None: under the scan fallback a packed leaf is
    cut as the reference cuts it, contiguously."""
    seg = packed_segments(name, cfg)
    return seg if seg is not None and scan_split(cfg, mesh) else None


def local_index(mesh, name: str, spec, shape, cfg=None,
                rank: Optional[int] = None):
    """The index of `rank`'s shard (default: this process's) of the whole
    leaf `name` of `shape` under `spec`: `local_slices`, except for a
    packed leaf (`packed_segments`) on a mesh whose scans split by heads
    (`scan_split`), whose sharded dimension takes the rank-th |model|-th
    of each segment (an int64 numpy array of columns,
    which indexes numpy arrays and tensors on any device alike). Every
    site that cuts a leaf, or joins its shards, uses this."""
    sl = local_slices(mesh, spec, shape, rank)
    dim = sharded_dim(spec)
    seg = None if dim is None else _segments(mesh, name, cfg)
    if seg is None:
        return sl
    if sum(seg) != shape[dim]:
        raise ValueError(f"{name}: segments {seg} do not make up its "
                         f"{shape[dim]} columns")
    n, i = mesh.axis_size(spec[dim]), mesh.flat_index(spec[dim], rank)
    cols, at = [], 0
    for w in seg:
        if w % n:
            raise ValueError(f"{name}: a segment of {w} columns does not "
                             f"split over {n} ranks")
        cols.append(np.arange(at + i * (w // n), at + (i + 1) * (w // n)))
        at += w
    return sl[:dim] + (np.concatenate(cols),)


def shard_params(params, mesh, specs=None, cfg=None):
    """The whole tree `params` -> this rank's shard of every leaf (`specs`
    default: `param_pspecs(params, mesh)`; `local_index`, so a packed leaf
    needs `cfg`), as {dotted name: tensor} (contiguous copies)."""
    specs = param_pspecs(params, mesh) if specs is None else specs
    return {n: x.detach()[local_index(mesh, n, specs[n], x.shape, cfg)]
            .clone(memory_format=torch.contiguous_format)
            for n, x in named_leaves(params)}


def sharded_dim(spec):
    """The dimension a parameter spec splits over 'model', or None."""
    for i, e in enumerate(spec):
        if e == "model" or (isinstance(e, tuple) and "model" in e):
            return i
    return None


def gather_params(local, specs, mesh, cfg=None) -> dict:
    """{dotted name: this rank's shard} -> {dotted name: the whole leaf}:
    each leaf that `specs` splits over 'model' is gathered over the model
    line (host-staged on gloo, as GatherSeq is) and a packed leaf's
    columns put back in order (`local_index` of each rank of the line; it
    needs `cfg`); the others are returned as they are. A collective of the
    model line."""
    out = {}
    m = model_size(mesh)
    for n, x in local.items():
        dim = sharded_dim(specs[n])
        if dim is None or m == 1:
            out[n] = x
            continue
        whole = _all_gather(x.detach(), mesh.group("model"), m, dim)
        shape = whole.shape
        if _segments(mesh, n, cfg) is not None:
            order = np.concatenate([local_index(mesh, n, specs[n], shape,
                                                cfg, rank=r)[dim]
                                    for r in mesh.line("model")])
            whole = whole.index_select(
                dim, torch.as_tensor(np.argsort(order), device=whole.device))
        out[n] = whole
    return out


def _all_gather(x, group, n, dim):
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    src = (x.to("cpu") if staged else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


# ---------------------------------------------------------------------------
# caches and step outputs: shards of whole tensors under specs
# ---------------------------------------------------------------------------

def live_axes(mesh, entry) -> Optional[tuple]:
    """A spec entry (None, an axis name or a tuple of names) as the tuple
    of its axes of more than one rank, or None: what a tensor dimension
    is actually split over."""
    if entry is None:
        return None
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    axes = tuple(a for a in axes if mesh.shape.get(a, 1) > 1)
    return axes or None


def _entries(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def shard_cache(cache, specs, mesh, cfg=None):
    """The whole decode cache {name: tensor} -> this rank's shard of every
    leaf under `specs` (launch/steps.cache_pspecs), as contiguous copies.
    The hybrid family's conv state packs x and B‖C in its columns: where
    the scan splits by heads rank r holds its x heads and the r-th part of
    B‖C (`local_index`, as Mamba2's in_proj), the columns its conv
    computes, so it needs `cfg`. A paged KV pool (core.kv_pool.
    PagedKVCache, the cache itself or under "kv") is replicated, as the
    reference's specs leave it: it passes through whole, not copied."""
    if not isinstance(cache, dict):
        return cache
    return {n: x[local_index(mesh, n, specs[n], x.shape, cfg)]
            .clone(memory_format=torch.contiguous_format)
            if isinstance(x, torch.Tensor) else x
            for n, x in cache.items()}


def gather_cache(shards, specs, mesh, cfg=None):
    """{name: this rank's shard} -> the whole cache: every dimension that
    `specs` splits gathered over its line (host-staged on gloo), the conv
    state's columns put back in the reference's order where they were cut
    by segment (`local_index` of each rank of the model line). Copies
    only; a paged pool passes through whole (`shard_cache`). A collective
    of every rank of the mesh."""
    if not isinstance(shards, dict):
        return shards
    out = {}
    for n, x in shards.items():
        if not isinstance(x, torch.Tensor):
            out[n] = x
            continue
        for dim, e in enumerate(_entries(specs[n], x.dim())):
            axes = live_axes(mesh, e)
            if axes is not None:
                x = _all_gather(x, mesh.group(axes), mesh.axis_size(axes),
                                dim)
        dim = sharded_dim(specs[n])
        if dim is not None and model_size(mesh) > 1 and \
                _segments(mesh, n, cfg) is not None:
            order = np.concatenate([local_index(mesh, n, specs[n], x.shape,
                                                cfg, rank=r)[dim]
                                    for r in mesh.line("model")])
            x = x.index_select(
                dim, torch.as_tensor(np.argsort(order), device=x.device))
        out[n] = x
    return out


def reshard(x, src, dst, mesh):
    """`x`, this rank's shard of a tensor under spec `src`, as its shard
    under `dst`: every dimension whose split differs is gathered over the
    `src` line (host-staged on gloo) and then cut to this rank's part of
    the `dst` line. Contiguous splits only; no gradient."""
    for dim, (s, d) in enumerate(zip(_entries(src, x.dim()),
                                     _entries(dst, x.dim()))):
        s, d = live_axes(mesh, s), live_axes(mesh, d)
        if s == d:
            continue
        if s is not None:
            x = _all_gather(x, mesh.group(s), mesh.axis_size(s), dim)
        if d is not None:
            n = mesh.axis_size(d)
            rows = x.shape[dim] // n
            x = x.narrow(dim, mesh.flat_index(d) * rows, rows)
    return x.contiguous()


# ---------------------------------------------------------------------------
# decode on a cache shard
# ---------------------------------------------------------------------------

class CacheLayout:
    """Where a decode step's cache shard sits in the whole cache: `rows`
    and `positions` are the axes (tuples, or None) of `mesh`, the whole
    mesh, that the cache's batch rows and its positions split over (dims
    1 and 2 of `cache_pspecs`' K/V spec, or of the cross K/V's beside a
    pool; the ssm family's and the hybrid's states split their rows
    only). A replicated paged pool has no rows of its own: `rows` (given)
    are the rows the step decodes, the tokens' (`batch_pspecs`). The
    heads and head_dim splits over 'model' need no record: the layer sees
    them in its shards' shapes."""

    def __init__(self, mesh, specs, rows=None):
        key = next((k for k in ("k", "ck", "S", "ssm") if k in specs),
                   None)
        e = _entries(specs[key], 3) if key is not None else (None,) * 3
        self.mesh = mesh
        self.rows = live_axes(mesh, e[1]) if key is not None else rows
        self.positions = live_axes(mesh, e[2]) if key in ("k", "ck") \
            else None


_LAYOUT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_cache_layout", default=None)


@contextlib.contextmanager
def decode_context(layout: CacheLayout):
    """Decode on this rank's cache shard: the layer code sees only the
    layout's mesh's model line (`Mesh.sub`), so a token of a 'seq' line or
    a data line runs as it does in one process there, and the cache's row
    and position splits are the active `layout`, which the cache writes,
    the attention's softmax combine and the MoE's rows read."""
    tok = _LAYOUT.set(layout)
    try:
        with mesh_context(layout.mesh.sub(("model",))):
            yield
    finally:
        _LAYOUT.reset(tok)


def cache_layout() -> Optional[CacheLayout]:
    return _LAYOUT.get()


def position_shard(rows: int):
    """(this rank's first cache position, the ranks the positions split
    over, their process group) for a cache shard of `rows` positions under
    the active `CacheLayout`; (0, 1, None) where every rank holds every
    position."""
    lay = _LAYOUT.get()
    if lay is None or lay.positions is None:
        return 0, 1, None
    m, axes = lay.mesh, lay.positions
    return m.flat_index(axes) * rows, m.axis_size(axes), m.group(axes)


def gather_rows(x):
    """x (B_loc, ...), this rank's batch rows under the active
    `CacheLayout` -> every row, over the rows' line (no gradient); `x`
    where the rows are whole."""
    lay = _LAYOUT.get()
    if lay is None or lay.rows is None:
        return x
    m = lay.mesh
    return _all_gather(x, m.group(lay.rows), m.axis_size(lay.rows), 0)


def whole_token(x, kv_heads: int):
    """x (B_loc, 1, KV_loc, hd), one decode token's K or V on this rank,
    -> (B, 1, KV, hd) for every row and every KV head: gathered over the
    model line where it splits the `kv_heads` (`heads_split`) and over the
    rows' line of the active `CacheLayout`; no gradient. What every rank
    writes into a replicated paged pool, so that the pools stay equal;
    `x` without a mesh."""
    mesh = active_mesh()
    m = model_size(mesh)
    if m > 1 and x.shape[2] != kv_heads:
        x = _all_gather(x, mesh.group("model"), m, 2)
    return gather_rows(x)


def pool_shard(x):
    """The part of a replicated pool tensor x (..., KV, hd) that this rank
    of the active mesh's model line attends with: its KV heads where
    |model| divides them, else its head_dim columns where |model| divides
    those, else all of it: the shard `cache_pspecs` gives a contiguous
    cache (a view)."""
    m = model_size()
    if m == 1:
        return x
    KV, hd = x.shape[-2], x.shape[-1]
    if KV % m == 0:
        return x.narrow(-2, model_offset(KV // m), KV // m)
    if hd % m == 0:
        return x.narrow(-1, model_offset(hd // m), hd // m)
    return x


def own_rows(x):
    """The inverse of `gather_rows`: this rank's rows of x (B, ...)."""
    lay = _LAYOUT.get()
    if lay is None or lay.rows is None:
        return x
    rows = x.shape[0] // lay.mesh.axis_size(lay.rows)
    return x.narrow(0, lay.mesh.flat_index(lay.rows) * rows, rows)


def _sum_fp32(x, group):
    """x summed over `group` in fp32 (a new tensor)."""
    total = x.float().contiguous()
    if total is x:
        total = x.clone()
    dist.all_reduce(total, group=group)
    return total


class CopyToModel(torch.autograd.Function):
    """Enters a region whose work differs across the model line: identity
    forward, the gradient summed over the line (fp32) backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_fp32(g, ctx.group).to(g.dtype), None


class ReduceFromModel(torch.autograd.Function):
    """Leaves such a region: the ranks' partial results summed over the
    line in fp32 forward (cast to `dtype`), identity backward."""

    @staticmethod
    def forward(ctx, x, group, dtype):
        ctx.dtype = x.dtype
        return _sum_fp32(x, group).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


def copy_to_model(x):
    """`CopyToModel` on the active mesh's model line; `x` without one."""
    mesh = active_mesh()
    if model_size(mesh) == 1:
        return x
    return CopyToModel.apply(x, mesh.group("model"))


def reduce_from_model(x, dtype=None):
    """`ReduceFromModel` on the active mesh's model line, cast to `dtype`
    (default x's); `x` without one."""
    mesh = active_mesh()
    dtype = x.dtype if dtype is None else dtype
    if model_size(mesh) == 1:
        return x.to(dtype)
    return ReduceFromModel.apply(x, mesh.group("model"), dtype)


def model_max(x):
    """Elementwise max of `x` over the active mesh's model line (in place;
    no gradient): the vocab-parallel loss's shift."""
    mesh = active_mesh()
    if model_size(mesh) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group("model"))
    return x


def model_mean(x):
    """Mean of `x` over the active mesh's model line (in place; statistics
    only, no gradient): the capture's average over the heads when each
    rank holds |model|-th of them."""
    mesh = active_mesh()
    m = model_size(mesh)
    if m == 1:
        return x
    dist.all_reduce(x, group=mesh.group("model"))
    return x.div_(m)


def gather_model(x, dim: int, summed: bool = True):
    """The whole of a dimension split over the active mesh's model line,
    from every rank's part of `x` along `dim` (the rank-th part is this
    rank's; differentiable: `GatherSeq`, whose backward sums the gradient
    over the line in fp32 and keeps this rank's part, or, with `summed`
    False, where each rank's gradient of the whole is already the whole
    one, keeps this rank's part alone); `x` without a 'model' axis."""
    mesh = active_mesh()
    m = model_size(mesh)
    if m == 1:
        return x
    return GatherSeq.apply(x, mesh.group("model"), m,
                           mesh.axis_index("model"), dim, summed)


def model_line_sum(x):
    """A statistic summed over the active mesh's model line in fp32 that
    every rank then reads for its own part of the work (a norm over the
    whole width): the sum forward (`reduce_from_model`) and, since each
    rank's use adds to its gradient, the gradient summed backward too
    (`copy_to_model`). `x` without a 'model' axis."""
    return copy_to_model(reduce_from_model(x))


def model_whole(leaf, partial: bool):
    """A leaf the rules keep whole that every rank of the model line reads
    whole (the scan fallback's conv, decay and norm leaves): where each
    rank's output gradient is its share (`partial`: a row-parallel output
    projection follows), through `copy_to_model`, so its gradient is
    summed over the line; where the layer runs wholly replicated, as it
    is (a sum would count the gradient |model| times)."""
    return copy_to_model(leaf) if partial else leaf


def model_part(leaf, index):
    """This rank's part, `leaf[index]`, of a leaf that the rules keep whole
    but that the rank uses only in part (its heads' slice, its conv
    channels): the leaf enters through `copy_to_model`, so its gradient is
    summed over the line and whole on every rank. `leaf[index]` without a
    'model' axis."""
    return copy_to_model(leaf)[index]
