"""Attention: dense GQA (train/prefill), KV-cache decode with scalar or
PER-ROW positions — the continuous-batching engine decodes every cache slot
at its own offset — and the SPION pattern capture, which streams pooled
diagonal-conv scores without ever holding the L x L attention matrix.

Sparse-phase execution is owned by core.attention_exec.SparseAttentionExec.

Under a mesh with a 'seq' axis q, k and v are this rank's shard of the
sequence with global positions: the dense attention reads the whole
sequence's K/V (`distributed.sharding.gather_kv`), and the capture
gathers K, reads the next shard's first rows for its last panel's filter
(`next_shard_rows`) and gathers the pooled rows, so every rank ends with
the whole map.

Under a mesh with a 'model' axis that divides both head counts
(`distributed.sharding.heads_split`) each rank holds H/|model| query heads
and KV/|model| KV heads (a contiguous split keeps query head h with KV
head h // G): the projections are column-parallel, the output projection
row-parallel, and the capture averages its heads over the model line.
Where |model| does not divide them (the reference's fallback: whisper-
tiny's 6 heads on 4 ranks, 2 KV heads on 4) the leaves are still the
reference's spec shards, which may end mid-head: each rank computes its
columns of q, k and v, `gather_columns` joins them over the model line
into the whole merged widths (its backward sums the ranks' partial
gradients), RoPE follows on whole heads, the attention runs on every
head on every rank, and the output projection is row-parallel over the
rank's rows of the context. The capture then holds every head and takes
no line mean.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.sparse_attention import shard_decode
from repro_torch.distributed.sharding import (active_mesh, copy_to_model,
                                              gather_model, gather_seq,
                                              heads_split, mean_over_data,
                                              model_mean, model_offset,
                                              model_size, model_split,
                                              pool_shard, position_shard,
                                              seq_size, seq_start,
                                              sum_over_seq)
from repro_torch.models.layers import he_init, rope, row_parallel


def attn_init(gen, cfg, dtype, device, layers=None):
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": he_init(gen, (d, H * hd), d, dtype, device, layers),
        "wk": he_init(gen, (d, KV * hd), d, dtype, device, layers),
        "wv": he_init(gen, (d, KV * hd), d, dtype, device, layers),
        "wo": he_init(gen, (H * hd, d), H * hd, dtype, device, layers),
    }
    if cfg.qkv_bias:
        lead = () if layers is None else (layers,)
        for name, width in (("bq", H * hd), ("bk", KV * hd), ("bv", KV * hd)):
            p[name] = torch.zeros((*lead, width), dtype=dtype, device=device)
    return p


def _merged_widths(cfg):
    hd = cfg.resolved_head_dim
    return {"q": cfg.num_heads * hd, "k": cfg.num_kv_heads * hd,
            "v": cfg.num_kv_heads * hd}


def head_fallback(cfg) -> bool:
    """The reference's fallback for head counts: a 'model' axis that does
    not divide both of them (`heads_split` False) but divides the merged
    query width, so wq's columns and wo's rows are split (`sanitize_spec`)
    while the attention needs whole heads."""
    return (model_size() > 1 and not heads_split(cfg)
            and model_split(_merged_widths(cfg)["q"]))


def _project(p, x, n, whole_leaf=False):
    """x @ w{n} (+ b{n}). `whole_leaf`: a replicated leaf in a region whose
    work differs across the model line enters through `copy_to_model`, so
    its gradient is summed over the line."""
    w, b = p[f"w{n}"], p[f"b{n}"] if f"b{n}" in p else None
    if whole_leaf:
        w = copy_to_model(w)
        b = None if b is None else copy_to_model(b)
    y = x @ w.to(x.dtype)
    return y if b is None else y + b.to(x.dtype)


def gather_columns(parts):
    """[this rank's columns of q, k, v, or None] -> the whole merged
    widths: one differentiable gather over the model line
    (`gather_model`, whose backward sums the ranks' gradients in fp32 and
    keeps this rank's columns) of the parts' columns side by side."""
    live = [t for t in parts if t is not None]
    m = model_size()
    widths = [t.shape[-1] for t in live]
    lines = gather_model(torch.cat(live, dim=-1)[None], 0)   # (m, .., cols)
    out, at = [], 0
    for w in widths:
        piece = lines[..., at:at + w]                        # (m, B, S, w)
        out.append(piece.permute(*range(1, piece.dim() - 1), 0,
                                 piece.dim() - 1)
                   .reshape(*piece.shape[1:-1], m * w))
        at += w
    it = iter(out)
    return [None if t is None else next(it) for t in parts]


def rope_heads(cfg, q, k, positions):
    """RoPE on whole heads of q and k (B, S, heads, hd)."""
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k


def qkv(cfg, p, x, positions):
    """x (B,S,d) -> q (B,S,H,hd), k/v (B,S,KV,hd), RoPE applied. On a
    'model' axis that splits the heads (`heads_split`) this rank's
    H/|model| and KV/|model| heads; under the fallback (`head_fallback`)
    every head, from the rank's columns gathered over the line."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    if heads_split(cfg):
        x = copy_to_model(x)
        q, k, v = (_project(p, x, n) for n in "qkv")
    elif head_fallback(cfg):
        x = copy_to_model(x)
        split = {n: model_split(w) for n, w in _merged_widths(cfg).items()}
        cols = gather_columns([_project(p, x, n) if split[n] else None
                               for n in "qkv"])
        q, k, v = (c if split[n] else _project(p, x, n, whole_leaf=True)
                   for c, n in zip(cols, "qkv"))
    else:
        q, k, v = (_project(p, x, n) for n in "qkv")
    q = q.reshape(B, S, -1, hd)
    k = k.reshape(B, S, -1, hd)
    v = v.reshape(B, S, -1, hd)
    q, k = rope_heads(cfg, q, k, positions)
    return q, k, v


def _mask_bias(cfg, q_pos, k_pos):
    """additive mask (Sq, Sk): 0 allowed / -inf blocked, fp32."""
    ok = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                    device=q_pos.device)
    if cfg.causal:
        ok = ok & (q_pos[:, None] >= k_pos[None, :])
    if cfg.sliding_window:
        ok = ok & (q_pos[:, None] - k_pos[None, :] < cfg.sliding_window)
    return torch.where(ok, 0.0, -math.inf)


def _attn_chunk(cfg, qc, k, v, qp, k_pos):
    """One query chunk: qc (B,c,KV,G,hd) vs full k/v -> (B,c,KV,G,hd)."""
    hd = qc.shape[-1]
    scores = torch.einsum("bqkgh,bskh->bkgqs", qc, k).float()
    scores = scores / math.sqrt(hd) + _mask_bias(cfg, qp, k_pos)
    probs = torch.softmax(scores, dim=-1).to(qc.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v)


def attn_q_chunk(Sq, Sk):
    """Query-chunk size: bound the transient scores tensor (flash-style)."""
    if Sq * Sk <= 2**22:
        return Sq
    c = max(128, 2**20 // Sk)
    while Sq % c:
        c //= 2
    return max(c, 1)


def dense_attention(cfg, q, k, v, q_pos, k_pos):
    """softmax(q k^T / sqrt(hd) + mask) v with GQA head grouping.

    q (B,Sq,H,hd); k,v (B,Sk,KV,hd) -> (B,Sq,H,hd). On a 'seq' shard q is
    the shard's rows with their global `q_pos` and k, v are the whole
    sequence (`distributed.sharding.gather_kv`) with its `k_pos`. Chunked
    over query rows so the S x S score matrix is never resident; under
    autograd each chunk is recomputed in the backward (the JAX package's
    per-chunk jax.checkpoint), so only one chunk's scores are held at a
    time."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    c = attn_q_chunk(Sq, k.shape[1])
    chunk = functools.partial(_attn_chunk, cfg)
    if c < Sq and torch.is_grad_enabled():
        chunk = functools.partial(checkpoint, chunk, use_reentrant=False)
    outs = [chunk(qg[:, i:i + c], k, v, q_pos[i:i + c], k_pos)
            for i in range(0, Sq, c)]
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd)


def attn_out(cfg, p, ctx):
    """ctx (B,S,H,hd) @ wo; on a 'model' axis row-parallel over the rank's
    heads (`heads_split`) or, under the fallback, over the rank's rows of
    wo, the same columns of the whole context (mid-head where they fall
    so)."""
    B, S = ctx.shape[:2]
    flat = ctx.reshape(B, S, -1)
    if heads_split(cfg):
        return row_parallel(flat, p["wo"])
    if head_fallback(cfg):
        rows = p["wo"].shape[0]
        return row_parallel(flat.narrow(-1, model_offset(rows), rows),
                            p["wo"])
    return flat @ p["wo"].to(ctx.dtype)


# ---------------------------------------------------------------------------
# KV-cache decode
# ---------------------------------------------------------------------------

def decode_positions(pos, batch: int, device=None):
    """Normalise a decode position argument — a scalar (every batch row at
    the same position) or a (B,) vector (the serving engine's per-slot
    positions) — to a (B,) int32 tensor."""
    p = torch.as_tensor(pos, device=device).reshape(-1)
    return p.expand(batch).to(torch.int32)


def decode_attention(cfg, q, k_cache, v_cache, pos, kpos=None):
    """One-token decode: q (B,1,H,hd); caches (B,S_cache,KV,hd); pos scalar
    or (B,) per-row current token indices. `kpos` gives the absolute
    position stored in each cache slot, (S,) or (B,S) (defaults to arange —
    plain append cache)."""
    B, _, _, hd = q.shape
    S = k_cache.shape[1]
    posb = decode_positions(pos, B, q.device)
    start, n, group = position_shard(S)
    if n > 1 or k_cache.shape[-1] != hd:
        # a shard of the cache: its positions from `start`, or its head_dim
        # columns (`kpos` is the whole cache's)
        if kpos is None:
            kpos = torch.arange(start, start + S, device=q.device)
        elif kpos.shape[-1] != S:
            kpos = kpos.narrow(-1, start, S)
        return shard_decode(q, k_cache, v_cache,
                            _visible(cfg, kpos.expand(B, S), posb), group)
    if kpos is None:
        kpos = torch.arange(S, device=q.device)
    return _whole_decode(cfg, q, k_cache, v_cache, posb, kpos)


def _visible(cfg, kpos, posb):
    """(B, S): the cache positions `kpos` (B, S) a token at `posb` sees."""
    ok = (kpos >= 0) & (kpos <= posb[:, None])
    if cfg.sliding_window:
        ok = ok & (kpos > posb[:, None] - cfg.sliding_window)
    return ok


def _whole_decode(cfg, q, k_cache, v_cache, posb, kpos):
    """`decode_attention` on a cache of every position the token sees,
    k/v (B, S, KV, hd) with the heads of q, at `kpos` (S,) or (B, S)."""
    B, _, H, hd = q.shape
    KV, S = k_cache.shape[2], k_cache.shape[1]
    qg = q.reshape(B, KV, H // KV, hd)
    k_cache = k_cache.to(q.dtype)
    v_cache = v_cache.to(q.dtype)
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).float() / \
        math.sqrt(hd)
    ok = _visible(cfg, kpos.expand(B, S), posb)
    scores = torch.where(ok[:, None, None, :], scores, -math.inf)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", probs, v_cache)
    return out.reshape(B, 1, H, hd)


def paged_decode_attention(cfg, q, kp, vp, layer, pos, page_table, *,
                           page: int):
    """Dense one-token decode over a paged KV pool (core.kv_pool): gather
    layer `layer`'s mapped pages through the page table, flatten to the
    contiguous (B, S, KV, hd) layout, and reuse `decode_attention` with
    per-position kpos. kp/vp (L, num_pages, page, KV, hd); page_table
    (B, NB) of physical page ids, -1 = unmapped (those positions get
    kpos=-1 and are masked; the gather clamps them to the scratch page).

    Sliding-window rings store position p in table slot (p//page) % NB, so
    kpos must be per-position ring arithmetic (`ring_kpos`), not
    block-granular — within the active page, offsets past pos % page still
    hold the PREVIOUS rotation's tokens. Where every block is mapped this
    is bitwise-identical to the contiguous dense decode.

    Under a mesh the pool is replicated and `page_table` is this rank's
    rows of it: the rank reads its KV heads, or its head_dim columns, of
    the pool (`pool_shard`, the contiguous cache's shard under
    launch/steps.cache_pspecs); head_dim columns' partial q·k products
    are summed over the model line (`shard_decode`), as the contiguous
    path does. Every position of a row is on every rank."""
    B, _, _, hd = q.shape
    NB = page_table.shape[1]
    kl, vl = pool_shard(kp[layer]), pool_shard(vp[layer])
    KV, hdl = kl.shape[2], kl.shape[3]
    S = NB * page
    posb = decode_positions(pos, B, q.device)
    phys = page_table.clamp(min=0).long()
    kflat = kl[phys].reshape(B, S, KV, hdl)
    vflat = vl[phys].reshape(B, S, KV, hdl)
    if cfg.sliding_window:
        base = ring_kpos(posb, S)
    else:
        base = torch.arange(S, device=q.device).expand(B, S)
    mapped = (page_table >= 0).repeat_interleave(page, dim=1)
    kpos = torch.where(mapped, base, -1)
    if hdl != hd:
        out = shard_decode(q, kflat, vflat, _visible(cfg, kpos, posb), None)
    else:
        out = _whole_decode(cfg, q, kflat, vflat, posb, kpos)
    # a fully-unmapped row (reclaimed serving slot parked on the scratch
    # page) softmaxes over all -inf -> NaN; that NaN would be scattered into
    # the SHARED scratch page next layer and 0*NaN-poison every other row's
    # clamped gathers. Force such rows to zero context (mapped rows pick
    # their already-computed value — bitwise-neutral).
    any_ok = (page_table >= 0).any(dim=1)
    return torch.where(any_ok[:, None, None, None], out, 0.0)


def cache_slot(cfg, pos, cache_len):
    """Ring-buffer slot for the token at absolute position `pos` (scalar or
    per-row vector)."""
    return pos % cache_len


def ring_kpos(pos, cache_len):
    """Absolute positions held by each ring-buffer slot at decode step `pos`
    (after inserting token `pos`): slot s -> pos - ((pos - s) mod cache_len).
    pos scalar -> (cache_len,); pos (B,) -> (B, cache_len)."""
    pos = torch.as_tensor(pos)
    s = torch.arange(cache_len, device=pos.device)
    p = pos if pos.dim() == 0 else pos[:, None]
    return p - torch.remainder(p - s, cache_len)


def cache_length(k_cache):
    """The whole cache's positions, of which k_cache (B, S, KV, hd) holds S
    (a shard of them under a decode layout that splits the positions)."""
    S = k_cache.shape[1]
    return S * position_shard(S)[1]


def owned_slot(slot, start: int, rows: int):
    """(the local slot (B,), whether this rank holds it (B,)) of global
    cache slots `slot` (B,) on a shard of `rows` positions from `start`."""
    local = slot.long() - start
    mine = (local >= 0) & (local < rows)
    return local.clamp(0, rows - 1), mine


def update_cache(k_cache, v_cache, k_new, v_new, slot):
    """Insert one token's k/v at index `slot`, in place. Caches (B,S,KV,hd);
    new (B,1,KV,hd). `slot` scalar writes every row at the same index; a
    (B,) vector writes each row at its own slot, so one slot's decode can
    never touch another slot's cache row.

    On a cache shard: where head_dim splits over 'model' (k_new whole
    heads, the cache the rank's columns) the rank writes its columns; where
    the positions split over the data axes only the rank that holds a
    row's slot writes it (`owned_slot`; the others write back what their
    clamped slot holds)."""
    hdl = k_cache.shape[-1]
    if k_new.shape[-1] != hdl:
        off = model_offset(hdl)
        k_new, v_new = k_new.narrow(-1, off, hdl), v_new.narrow(-1, off, hdl)
    start, n, _ = position_shard(k_cache.shape[1])
    if n > 1:
        B = k_cache.shape[0]
        slot = torch.as_tensor(slot, device=k_cache.device).reshape(-1) \
            .expand(B)
        local, mine = owned_slot(slot, start, k_cache.shape[1])
        rows = torch.arange(B, device=k_cache.device)
        keep = mine[:, None, None]
        k_cache.index_put_((rows, local), torch.where(
            keep, k_new[:, 0].to(k_cache.dtype), k_cache[rows, local]))
        v_cache.index_put_((rows, local), torch.where(
            keep, v_new[:, 0].to(v_cache.dtype), v_cache[rows, local]))
        return k_cache, v_cache
    slot = torch.as_tensor(slot, device=k_cache.device)
    if slot.dim() == 0:
        k_cache[:, slot] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, slot] = v_new[:, 0].to(v_cache.dtype)
        return k_cache, v_cache
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)
    slot = slot.long()
    k_cache.index_put_((rows, slot), k_new[:, 0].to(k_cache.dtype))
    v_cache.index_put_((rows, slot), v_new[:, 0].to(v_cache.dtype))
    return k_cache, v_cache


# ---------------------------------------------------------------------------
# SPION pattern capture: pooled diagonal-conv of A^s, streamed (exact Eq. 3+4)
# ---------------------------------------------------------------------------

def next_shard_rows(q, nf: int):
    """The first `nf` rows of the next 'seq' shard's q (B, nf, H, hd), which
    the conv rows at the end of this shard read (Eq. 3: A(i + f, j + f));
    zeros on the last shard (Eq. 3's zero padding) and without a 'seq'
    axis. One all_gather of every shard's first rows."""
    mesh = active_mesh()
    n = seq_size(mesh)
    if n == 1:
        return q.new_zeros((q.shape[0], nf, *q.shape[2:]))
    if nf > q.shape[1]:
        raise ValueError(f"capture: a conv filter of {nf} rows reaches past "
                         f"the next shard of {q.shape[1]} rows")
    heads = gather_seq(q[:, :nf], 1)
    i = mesh.axis_index("seq")
    if i + 1 == n:
        return torch.zeros_like(heads[:, :nf])
    return heads[:, (i + 1) * nf:(i + 2) * nf]


@torch.no_grad()
def capture_pooled_scores(cfg, q, k, q_pos, k_pos, filt, block: int):
    """Return (pooled, frob_sq):
      pooled  = avgpool_BxB( diagconv_F(A^s) ) of the *head-and-batch-averaged*
                attention probabilities, shape (L/B, L/B), streamed one block
                row at a time so peak memory is O(block x L), not O(L^2);
      frob_sq = sum(A^s ** 2) of the averaged scores (Eq. 2 transition term).

    Under a data-parallel mesh each rank holds a shard of the batch: each
    panel of the averaged scores is averaged over the ranks (one all-reduce
    a panel), so every rank gets the whole batch's statistics, as the
    reference's replicated capture does; on a 'model' axis that splits the
    heads the rank's heads' average is averaged over the model line first
    (under the fallback every rank holds every head). Under a 'seq' axis q is this
    rank's shard of the rows (global `q_pos`) and k its shard too, with
    `k_pos` the whole sequence's positions: K is gathered, the last panel
    reads the next shard's first rows, the pooled rows are gathered and
    the Frobenius term summed over 'seq', so every rank returns the
    one-process capture's (L/B, L/B) map and term.

    Matches paper Eq. 3 (conv_out(i,j) = sum_f A(i+f, j+f) filter(f)) with
    zero padding, then Eq. 4 average pooling. Statistics only: no gradient.
    """
    B_, Sq, H, hd = q.shape
    nf = int(filt.shape[0])
    # this shard's first row and the whole sequence's rows (one process:
    # 0 and Sq)
    row0, Sq_all = seq_start(Sq), Sq * seq_size(active_mesh())
    k = gather_seq(k, 1)
    L = k.shape[1]
    filt = filt.to(device=q.device, dtype=torch.float32)
    nb, nbk = Sq // block, L // block
    KV = k.shape[2]
    G = H // KV
    panel = block  # one block row of conv output per step; needs nf halo rows
    # q rows extended by nf so every panel is in bounds: the next shard's
    # first rows, or zero rows past the sequence, zeroed after the softmax
    # (Eq. 3 zero padding)
    qp_ = torch.cat([q, next_shard_rows(q, nf)], dim=1)
    qpos_ = torch.cat([q_pos, q_pos[-1] + 1 +
                       torch.arange(nf, device=q_pos.device)])
    rows = panel + nf
    outs, frob = [], torch.zeros((), dtype=torch.float32, device=q.device)
    for i in range(nb):
        r0 = i * block
        qg = qp_[:, r0:r0 + rows].reshape(B_, rows, KV, G, hd)
        s = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() / math.sqrt(hd)
        s = s + _mask_bias(cfg, qpos_[r0:r0 + rows], k_pos)
        a = torch.softmax(s, dim=-1).mean(dim=(0, 1, 2))        # (rows, L)
        # model ranks that split the heads: the average over every head
        # (under the fallback every rank holds them all); data-parallel
        # ranks: over the whole batch; both before the square of the
        # Frobenius term
        if heads_split(cfg):
            a = model_mean(a)
        a = mean_over_data(a)
        valid = (row0 + r0 + torch.arange(rows, device=q.device)) < Sq_all
        a = torch.where(valid[:, None], a, 0.0)
        frob = frob + (a[:panel] ** 2).sum()
        # conv rows r0..r0+block: sum_f w_f * A[r + f, columns shifted by f]
        padded = F.pad(a, (0, nf))
        conv = torch.zeros((panel, L), dtype=torch.float32, device=q.device)
        for f in range(nf):
            conv = conv + filt[f] * padded[f:f + panel, f:f + L]
        outs.append(conv.reshape(block, nbk, block).mean(dim=(0, 2)))
    pooled = gather_seq(torch.stack(outs), 0)
    return pooled, sum_over_seq(frob)       # (L/B, L/B), scalar
