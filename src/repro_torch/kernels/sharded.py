"""Mesh-aware dispatch of the block-sparse attention kernels: the JAX
package's `kernels/sharded.py` for ranks that each hold their shard.

`sharded_fused_attention(mesh, q, k, v, ...)` takes THIS rank's shards,
q (B_loc, KV_loc, G, S_loc, hd) and k, v (B_loc, KV_loc, S_loc, hd), with
the batch split over the data axes ('pod', 'data'), the KV heads over
'model' where it divides them (KV_loc = KV / |model|) and, on a mesh with a 'seq' axis, the
sequence split over 'seq' (`distributed.sharding.kernel_pspecs_from_axes`
states the layout). The tables are replicated: they index the global
sequence.

  - **Batch and KV-head sharding.** Every (batch*kv-head) row of the
    kernels' grid is independent, so a rank's shard runs the unchanged op
    on its N = B_loc * KV_loc rows.
  - **Sequence sharding** (DESIGN.md §10), when the pattern's column extent
    fits (`kernel_seq_axis`): a rank's rows read K/V blocks at most h_l
    blocks to the left of its shard and h_r to the right, so only the
    adjacent shards' edge blocks move (`halo_forward`, point-to-point on
    the 'seq' group, a ring as in the reference). The replicated tables are
    rebased into halo-local storage coordinates (`local_tables`: the
    forward BCSR and the transposed tables of the dK/dV kernel, from the
    plan or built here), and the same three kernels run over the local rows
    with global `offsets` and `seq_len`. Each row reads the same tiles in
    the same order as the unsharded kernel, so o, lse and dQ are the
    unsharded ones; the backward (`halo_backward`) sends the dK/dV of the
    halo blocks back in fp32 and adds them on the shard that owns them
    (`_SeqShardAttention`).
  - **Fallback.** A pattern too wide for the halo (or no halo) on a mesh
    with a 'seq' axis gathers the sequence over 'seq' (`distributed.
    sharding.gather_seq`) and runs the kernels on it, replicated |seq|
    times, with the reference's warning (once, on
    the coordinator); with no data or KV axis to fall back to it raises, as
    the reference does.
  - **Whole heads on a model line.** Under the reference's head fallback
    (`heads_split=False`: |model| does not divide the heads) every rank
    of a model line holds every head, and the kernels run on them on each
    rank of the line, with whatever data and 'seq' split the mesh still
    gives.

Transport (`runtime.transport`, `runtime.send_recv`): each rank sends its
packed edge blocks to its two neighbours with `dist.batch_isend_irecv` on
the 'seq' group, one message a neighbour (a peer that is both neighbours
gets one). NCCL moves them card to card; gloo (the CPU, or ranks sharing
one card) moves CUDA tensors only for broadcast and all_reduce, so there
they go through pinned host buffers. The kernels run on the card either
way.
"""
from __future__ import annotations

import time
import warnings

import torch

from repro_torch.distributed import runtime
from repro_torch.distributed.sharding import (data_axes, gather_seq,
                                              kernel_seq_axis,
                                              kernel_shard_axes, model_size,
                                              seq_size)
from repro_torch.kernels.block_sparse_attn import (
    _config, block_sparse_fwd, fused_backward, fused_block_sparse_attention)

_warned = set()
halo_seconds = 0.0     # host seconds in halo exchanges (forward + backward)


def _flat(ts):
    return torch.cat([t.reshape(-1) for t in ts])


def _split(buf, likes):
    """`buf` cut into views shaped like `likes`, in order."""
    out, off = [], 0
    for t in likes:
        out.append(buf[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out


def _swap(halo, to_right, to_left):
    """Send the tensors `to_right` to the right neighbour and `to_left` to
    the left one; returns (what the left neighbour sent right, what the
    right neighbour sent left), shaped alike. What goes to one peer
    travels as one flat buffer (with 2 ranks both neighbours are one peer:
    one message each way, right-bound part first)."""
    global halo_seconds
    to_right, to_left = list(to_right), list(to_left)
    if not to_right and not to_left:
        return [], []      # halo (0, 0): no row reads a neighbour's blocks
    t0 = time.perf_counter()
    if halo.left == halo.right:
        out = [(to_right + to_left, halo.left)]
        inn = out
    else:
        out = [(to_right, halo.right), (to_left, halo.left)]
        inn = [(to_right, halo.left), (to_left, halo.right)]
    out = [(_flat(ts), p) for ts, p in out if ts]
    inn = [(ts, p) for ts, p in inn if ts]
    like = out[0][0]
    recvs = [(like.new_empty(sum(t.numel() for t in ts)), p)
             for ts, p in inn]
    runtime.send_recv(halo.group, out, recvs,
                      halo.transport == "host-p2p")
    parts = []
    for (b, _), (ts, _) in zip(recvs, inn):
        parts += _split(b, ts)
    halo_seconds += time.perf_counter() - t0
    return parts[:len(to_right)], parts[len(to_right):]


def halo_peers(mesh):
    """(group, left, right) of this rank's halo exchange: its 'seq' line
    (the ranks of its data and model index: their K/V are the same heads
    of the neighbouring shards of the sequence) and its neighbours on that
    ring, as global ranks."""
    line = mesh.line("seq")
    i = mesh.axis_index("seq")
    n = len(line)
    return mesh.group("seq"), line[(i - 1) % n], line[(i + 1) % n]


class Halo:
    """The halo exchange of one rank: its 'seq' group, its left and right
    neighbours on the ring (global ranks: `halo_peers`), the halo widths in
    rows and the transport."""

    def __init__(self, mesh, h_l_rows, h_r_rows, like):
        self.group, self.left, self.right = halo_peers(mesh)
        self.h_l, self.h_r = int(h_l_rows), int(h_r_rows)
        self.transport = runtime.transport(self.group, like)


def halo_forward(halo, k, v):
    """k, v (N, S, hd) -> (N, h_l + S + h_r, hd) each: the left neighbour's
    last h_l rows, this shard, the right neighbour's first h_r rows."""
    S = k.shape[1]
    # my last rows are my right neighbour's left halo, my first rows my
    # left neighbour's right halo
    lh, rh = _swap(halo,
                   [x[:, S - halo.h_l:] for x in (k, v)] if halo.h_l else [],
                   [x[:, :halo.h_r] for x in (k, v)] if halo.h_r else [])
    out = []
    for i, x in enumerate((k, v)):
        parts = ([lh[i]] if lh else []) + [x] + ([rh[i]] if rh else [])
        out.append(torch.cat(parts, dim=1) if len(parts) > 1 else x)
    return out


def halo_backward(halo, gk, gv):
    """The transpose of `halo_forward`: the halo rows' gradients go back to
    the shards that own them, and what arrives is added onto this shard's
    edge rows (in the gradients' dtype)."""
    S = gk.shape[1] - halo.h_l - halo.h_r
    gs = (gk, gv)
    # my left halo's gradient belongs to my left neighbour's last rows, my
    # right halo's to my right neighbour's first rows
    from_left, from_right = _swap(
        halo, [g[:, halo.h_l + S:] for g in gs] if halo.h_r else [],
        [g[:, :halo.h_l] for g in gs] if halo.h_l else [])
    out = []
    for i, g in enumerate(gs):
        d = g[:, halo.h_l:halo.h_l + S].clone()
        if halo.h_l:
            d[:, S - halo.h_l:] += from_right[i]
        if halo.h_r:
            d[:, :halo.h_r] += from_left[i]
        out.append(d)
    return out


class _SeqShardAttention(torch.autograd.Function):
    """The sequence-sharded op: the halo exchange and the three kernels on
    the halo storage. One Function, so the halo blocks' dK/dV cross back
    and are added in fp32, and round to the inputs' dtype once, as the
    unsharded op's do (adding two bf16 partial sums would round each)."""

    @staticmethod
    def forward(ctx, q, k, v, col_l, nv_l, row_l, nvt_l, halo, kw):
        kh, vh = halo_forward(halo, k, v)
        kh, vh = kh.contiguous(), vh.contiguous()
        o, lse = block_sparse_fwd(q, kh, vh, col_l, nv_l, **kw)
        ctx.save_for_backward(q, kh, vh, o, lse, col_l, nv_l, row_l, nvt_l)
        ctx.halo, ctx.kw = halo, kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, kh, vh, o, lse, col_l, nv_l, row_l, nvt_l = ctx.saved_tensors
        dq, dkh, dvh = fused_backward(q, kh, vh, o, lse, do, col_l, nv_l,
                                      row_l, nvt_l, ctx.kw)
        dk, dv = halo_backward(ctx.halo, dkh, dvh)
        return (dq.to(q.dtype), dk.to(kh.dtype), dv.to(vh.dtype), None,
                None, None, None, None, None)


# ---------------------------------------------------------------------------
# tables in halo-local storage coordinates
# ---------------------------------------------------------------------------

def local_tables(col_idx, nvalid, row_idx, nvalid_t, *, r0, W, h_l, h_r):
    """The replicated tables of one layer rebased for the shard whose rows
    are the global row-blocks [r0, r0 + W) and whose K/V storage holds the
    global column-blocks r0 - h_l .. r0 + W + h_r - 1 (M blocks).

    Returns (col_l (W, K), nv_l (W,), row_l, nvt_l): the forward BCSR in
    storage coordinates (every valid entry lands in [0, M), padding is
    clamped), and the transposed tables of the storage blocks over the
    local rows: with the plan's `row_idx` / `nvalid_t` the run of local rows
    is located and shifted (width KT*; wrapped storage blocks list none of
    them); without them they are built from the local BCSR (width W)."""
    M = h_l + W + h_r
    dev = col_idx.device
    base = r0 - h_l
    col_l = (col_idx[r0:r0 + W].long() - base).clamp(0, M - 1)
    nv_l = nvalid[r0:r0 + W].to(torch.int32).contiguous()
    if row_idx is not None:
        ncb, KT = row_idx.shape
        cg = (base + torch.arange(M, device=dev)) % ncb
        rig = row_idx.long()[cg]                        # (M, KT) global rows
        nvtg = nvalid_t.long()[cg]
        tpos = torch.arange(KT, device=dev)[None, :]
        valid = tpos < nvtg[:, None]
        # the valid prefix lists rows ascending: the local ones are a run
        lo = (valid & (rig < r0)).sum(dim=1)
        cnt = (valid & (rig >= r0) & (rig < r0 + W)).sum(dim=1)
        gat = (lo[:, None] + tpos).clamp(max=KT - 1)
        ril = torch.gather(rig, 1, gat) - r0
        row_l, nvt_l = ril.clamp(0, W - 1), cnt
    else:
        K = col_l.shape[1]
        live = torch.arange(K, device=dev)[None, None, :] < \
            nv_l.long()[None, :, None]
        mm = (col_l[None, :, :] ==
              torch.arange(M, device=dev)[:, None, None]) & live
        mm = mm.any(-1)                                 # (M, W) transposed mask
        cs = torch.cumsum(mm.long(), dim=1)             # actives <= row
        tpos = torch.arange(W, device=dev)
        ril = (cs[:, :, None] <= tpos[None, None, :]).sum(dim=1)
        row_l, nvt_l = ril.clamp(0, W - 1), mm.sum(dim=1)
    return (col_l.to(torch.int32).contiguous(), nv_l,
            row_l.to(torch.int32).contiguous(),
            nvt_l.to(torch.int32).contiguous())


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

def seq_plan(mesh, S_loc, block, halo):
    """(n_seq, h_l, h_r) when the kernels shard the sequence on `mesh` for
    shards of S_loc rows, else (None, reason)."""
    n = seq_size(mesh)
    total = n * S_loc
    nrb = total // block if total % block == 0 else None
    ax, reason = kernel_seq_axis(mesh, nrb, halo)
    if ax is None:
        return None, reason
    return (n, int(halo[0]), int(halo[1])), reason


def sharded_fused_attention(mesh, q, k, v, col_idx, nvalid, *, block,
                            causal=False, sliding_window=None, row_idx=None,
                            nvalid_t=None, halo=None, config=None,
                            heads_split=True):
    """`fused_block_sparse_attention` over `mesh`, on this rank's shards:
    q (B_loc, KV, G, S_loc, hd), k / v (B_loc, KV, S_loc, hd) -> o of q's
    shape. The tables are one layer's, replicated (col_idx (nrb, K), nvalid
    (nrb,), the plan's row_idx (ncb, KT*) / nvalid_t (ncb,) or None), with
    nrb the GLOBAL row-block count. `halo` is the pattern's (left, right)
    column extent in blocks (plan stats["halo"]): it unlocks the 'seq'
    sharding. `config` is the dispatch.KernelConfig of the three kernels.
    `heads_split` says whether q, k and v are this rank's KV/|model| heads
    on a 'model' axis (`distributed.sharding.heads_split` of the model);
    False is the reference's head fallback, where every rank of a model
    line holds every head: the kernels then run on the whole heads on each
    rank of the line, keeping the data and 'seq' splits (a departure: the
    reference's "auto" takes its gather path there, which GSPMD runs
    replicated). Differentiable in q, k and v."""
    B_loc, KV, G, S_loc, hd = q.shape
    daxes = data_axes(mesh)
    # the reference's decision on the global counts
    m = model_size(mesh)
    baxes, kv_ax = kernel_shard_axes(mesh, B_loc * mesh.axis_size(daxes),
                                     KV * m if heads_split else KV)
    # replicated over the model line by design (the head fallback)
    on_line = m > 1 and not heads_split
    seq, reason = seq_plan(mesh, S_loc, block, halo)
    kw = dict(block=block, causal=causal, sliding_window=sliding_window,
              config=config)
    n_seq = seq_size(mesh)
    if seq is None and n_seq > 1:
        if baxes is None and kv_ax is None and not on_line:
            raise RuntimeError(
                f"sharded_fused_attention: mesh {dict(mesh.shape)} has a "
                f"'seq' axis but the kernel cannot seq-shard ({reason}) "
                f"and no batch/KV axis divides either (batch="
                f"{B_loc * mesh.axis_size(daxes)}, kv_heads={KV}). Narrow the "
                f"pattern (or supply the SparsityPlan halo), fix the "
                f"divisibility, or use kernel='jnp' (the GSPMD path).")
        key = (tuple(mesh.shape.items()), reason)
        if runtime.is_coordinator() and key not in _warned:
            _warned.add(key)
            warnings.warn(
                f"sharded_fused_attention: mesh {dict(mesh.shape)} has a "
                f"'seq' axis but the kernel falls back to batch/KV sharding "
                f"— {reason}. The kernel work is replicated |seq|="
                f"{n_seq}x; narrow the pattern or drop the 'seq' axis.",
                stacklevel=2)
        idx = mesh.axis_index("seq")
        qg = gather_seq(q, 3, mesh)
        kg = gather_seq(k, 2, mesh)
        vg = gather_seq(v, 2, mesh)
        S = n_seq * S_loc
        o = fused_block_sparse_attention(
            qg.reshape(B_loc * KV, G, S, hd), kg.reshape(B_loc * KV, S, hd),
            vg.reshape(B_loc * KV, S, hd), col_idx, nvalid, row_idx=row_idx,
            nvalid_t=nvalid_t, **kw)
        return o.reshape(B_loc, KV, G, S, hd).narrow(3, idx * S_loc, S_loc)
    if seq is None:
        if baxes is None and kv_ax is None and not on_line:
            raise RuntimeError(
                f"sharded_fused_attention: no mesh axis shards the kernel on "
                f"mesh {dict(mesh.shape)} — batch="
                f"{B_loc * mesh.axis_size(daxes)} is indivisible by the data "
                f"axes and kv_heads={KV * m if heads_split else KV} by "
                f"'model'. The shard_map would run "
                f"the full kernel replicated on every device; use "
                f"kernel='jnp' (the GSPMD path) or fix the batch/head "
                f"divisibility.")
        N = B_loc * KV
        o = fused_block_sparse_attention(
            q.reshape(N, G, S_loc, hd).contiguous(),
            k.reshape(N, S_loc, hd).contiguous(),
            v.reshape(N, S_loc, hd).contiguous(), col_idx, nvalid,
            row_idx=row_idx, nvalid_t=nvalid_t, **kw)
        return o.reshape(B_loc, KV, G, S_loc, hd)

    n, h_l, h_r = seq
    W = S_loc // block
    r0 = mesh.axis_index("seq") * W
    N = B_loc * KV
    ex = Halo(mesh, h_l * block, h_r * block, k)
    col_l, nv_l, row_l, nvt_l = local_tables(
        col_idx, nvalid, row_idx, nvalid_t, r0=r0, W=W, h_l=h_l, h_r=h_r)
    kkw = dict(block=int(block), causal=bool(causal),
               sliding_window=None if sliding_window is None
               else int(sliding_window), offsets=(r0, r0 - h_l),
               seq_len=n * S_loc, config=_config(config))
    o = _SeqShardAttention.apply(
        q.reshape(N, G, S_loc, hd).contiguous(), k.reshape(N, S_loc, hd),
        v.reshape(N, S_loc, hd), col_l, nv_l, row_l, nvt_l, ex, kkw)
    return o.reshape(B_loc, KV, G, S_loc, hd)
