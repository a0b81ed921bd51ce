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

The parameter rules (`_RULES`, `best_spec`, `param_pspecs`,
`zero1_pspecs`) belong to the 'model' axis and wait in ROADMAP.md item
A12b: parameters are replicated on every rank here.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

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
    """x (..., S_loc, ...) -> (..., n * S_loc, ...) along `dim`: the 'seq'
    line's shards in order. The backward sums the gradient over the line in
    fp32 (a bf16 sum would round each partial sum) and keeps this shard's
    rows (gloo has no reduce-scatter). CUDA tensors on a gloo group cross
    through the host, since gloo gathers only CPU tensors."""

    @staticmethod
    def forward(ctx, x, group, n, idx, dim):
        ctx.group, ctx.idx, ctx.dim = group, idx, dim
        ctx.rows = x.shape[dim]
        staged = x.is_cuda and dist.get_backend(group) == "gloo"
        src = (x.detach().to("cpu") if staged else x.detach()).contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts, dim=dim)
        return out.to(x.device) if staged else out

    @staticmethod
    def backward(ctx, g):
        total = g.float().contiguous()
        if total is g:
            total = g.clone()
        dist.all_reduce(total, group=ctx.group)
        return (total.narrow(ctx.dim, ctx.idx * ctx.rows, ctx.rows)
                .to(g.dtype), None, None, None, None)


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
