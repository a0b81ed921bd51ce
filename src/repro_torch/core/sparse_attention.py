"""Block-sparse (padded-BCSR) multi-head attention — the SPION sparse phase.

The sparsity pattern is a per-layer table:
    col_idx : (nrb, K) int32   active column-block ids per row-block, pad = -1
    nvalid  : (nrb,)   int32   number of valid entries per row (b_cnt / B)
K is the padded max-blocks-per-row.

Semantics are the paper's (Alg. 5/6): S = softmax_P(QK^T/sqrt(hd)) V where the
softmax denominator counts pruned positions as exp(0 - max) each (Alg. 6
line 15: sum += exp(-max) * (L - b_cnt)). Causal archs count only pruned
*causal* positions.

Host-side planning is numpy, as in the JAX package, and its tables become
int32 torch tensors. Two executions of the sparse attention, both
differentiable:
  - `bcsr_attention` — the plain PyTorch gather path (CPU tensors);
  - kernels/ops.py   — the Hopper kernels (CUDA tensors), same signature.
Sparse decode is a gather here too: the query position's row-block selects
its listed cache blocks.

Decode on a shard of a cache (a serve step under a mesh, distributed.
sharding.decode_context) goes through `shard_decode`: with head_dim over
'model' the rank's partial q·k products are summed over the model line in
fp32 (`head_dim_sum`) and the context's columns gathered; with the
cache's positions over the data axes each rank's softmax max, sum and
p·v over its positions (fp32) are combined by log-sum-exp over the line
(`merge_partials`), where the sparse decode's zero correction enters once,
after the combine, since its row total is the whole row's.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import (gather_model, model_offset,
                                              pool_shard, position_shard,
                                              reduce_from_model)


class BCSR(NamedTuple):
    col_idx: torch.Tensor  # (nrb, K) int32, -1 padded
    nvalid: torch.Tensor   # (nrb,) int32
    block: int             # B
    seq_len: int           # L


def bcsr_from_blockmask(mask: np.ndarray, block: int, max_k: int | None = None) -> BCSR:
    """Host-side: dense block mask (nrb, ncb) bool -> padded BCSR."""
    mask = np.asarray(mask, bool)
    nrb, ncb = mask.shape
    counts = mask.sum(axis=1)
    K = int(max_k if max_k is not None else max(int(counts.max()), 1))
    col = np.full((nrb, K), -1, np.int32)
    for r in range(nrb):
        idx = np.nonzero(mask[r])[0][:K]
        col[r, : len(idx)] = idx
    return BCSR(torch.from_numpy(col),
                torch.from_numpy(np.minimum(counts, K).astype(np.int32)),
                block, nrb * block)


def bcsr_transpose(col_idx, nvalid, ncb: int | None = None,
                   max_k: int | None = None):
    """Transpose a padded-BCSR table on its device: (col_idx (nrb, K),
    nvalid (nrb,)) -> (row_idx (ncb, KT), nvalid_t (ncb,)) int32.

    `row_idx[c]` lists, ascending, the row-blocks whose active set contains
    column-block `c`; the entries past `nvalid_t[c]` are the other row ids,
    ascending (in range, never read by the kernels). The default KT = nrb is
    the only always-safe width: a vertical stripe appears in every
    row-block. This is the backward's fallback when no SparsityPlan supplies
    the transposed tables at their true width KT*."""
    col_idx = torch.as_tensor(col_idx).to(torch.int64)
    nvalid = torch.as_tensor(nvalid, device=col_idx.device).to(torch.int64)
    nrb, K = col_idx.shape
    ncb = int(ncb) if ncb is not None else nrb
    dev = col_idx.device
    valid = torch.arange(K, device=dev)[None, :] < nvalid[:, None]
    # scatter into a dense block mask; invalid entries land in a spill column
    colc = torch.where(valid, col_idx.clamp(0, ncb - 1), ncb)
    mask = torch.zeros((nrb, ncb + 1), dtype=torch.bool, device=dev)
    mask[torch.arange(nrb, device=dev)[:, None], colc] = True
    mask_t = mask[:, :ncb].T                                   # (ncb, nrb)
    KT = int(max_k) if max_k is not None else nrb
    # active rows first (ascending), inactive ones after them
    keys = torch.where(mask_t, torch.arange(nrb, device=dev)[None, :], nrb)
    row_idx = torch.argsort(keys, dim=1, stable=True)[:, :KT]
    nvalid_t = mask_t.sum(dim=1).clamp(max=KT)
    return (row_idx.to(torch.int32).contiguous(),
            nvalid_t.to(torch.int32).contiguous())


# the SparsityPlan's array payload (the executor filters on these keys)
PLAN_TABLE_KEYS = ("col_idx", "nvalid", "row_idx", "nvalid_t")


class SparsityPlan(NamedTuple):
    """Host-built sparse-phase plan.

    `tables`: col_idx (Ly, nrb, K), nvalid (Ly, nrb), row_idx (Ly, ncb, KT*),
    nvalid_t (Ly, ncb) as int32 tensors, and the int `block`. `kt_star` is
    the true max column population across layers (the width of the
    transposed tables, which the training backward streams); `stats` holds
    host-only occupancy numbers."""
    tables: dict
    kt_star: int
    stats: dict


def host_transpose_tables(col_idx, nvalid, ncb: int | None = None,
                          max_kt: int | None = None):
    """Host-side (numpy) transpose of padded-BCSR tables, stacked or single.

    col_idx (Ly, nrb, K) / nvalid (Ly, nrb)  ->
        (row_idx (Ly, ncb, KT), nvalid_t (Ly, ncb), KT)
    with KT = the true max column population across layers unless `max_kt`
    pins it. Entries past `nvalid_t[l, c]` are clamped in-range row ids, and
    the valid prefix lists row-blocks ascending."""
    col = np.asarray(col_idx)
    nv = np.asarray(nvalid)
    squeeze = col.ndim == 2
    if squeeze:
        col, nv = col[None], nv[None]
    Ly, nrb, K = col.shape
    ncb = int(ncb) if ncb is not None else nrb
    counts = np.zeros((Ly, ncb), np.int64)
    entries = []
    for layer in range(Ly):
        rows, ks = np.nonzero(np.arange(K)[None, :] < nv[layer][:, None])
        cols = np.clip(col[layer, rows, ks], 0, ncb - 1).astype(np.int64)
        # duplicate/clamped (row, col) entries count once
        pairs = np.unique(rows.astype(np.int64) * ncb + cols)
        rows_u = (pairs // ncb).astype(np.int32)
        cols_u = (pairs % ncb).astype(np.int32)
        np.add.at(counts[layer], cols_u, 1)
        entries.append((rows_u, cols_u))
    KT = int(max_kt) if max_kt is not None else max(int(counts.max()), 1)
    row_idx = np.zeros((Ly, ncb, KT), np.int32)
    nvalid_t = np.minimum(counts, KT).astype(np.int32)
    for layer in range(Ly):
        rows_u, cols_u = entries[layer]
        order = np.lexsort((rows_u, cols_u))     # column-major, rows ascending
        rows_s, cols_s = rows_u[order], cols_u[order]
        starts = np.zeros(ncb + 1, np.int64)
        np.cumsum(counts[layer], out=starts[1:])
        pos = np.arange(len(rows_s)) - starts[cols_s]   # rank within column
        keep = pos < KT
        row_idx[layer, cols_s[keep], pos[keep]] = rows_s[keep]
        # clamped padding: repeat each column's last valid row id (0 if empty)
        nvt = nvalid_t[layer]
        fill = np.where(nvt > 0,
                        row_idx[layer, np.arange(ncb), np.maximum(nvt - 1, 0)],
                        0)
        tail = np.arange(KT)[None, :] >= nvt[:, None]
        row_idx[layer] = np.where(tail, fill[:, None], row_idx[layer])
    if squeeze:
        return row_idx[0], nvalid_t[0], KT
    return row_idx, nvalid_t, KT


def pattern_col_extents(col_idx, nvalid, *, ncb: int | None = None):
    """Host-side (numpy) per-layer column extents of a padded-BCSR pattern,
    in block units: left[l] = max over rows r of (r - min valid col of r),
    right[l] = max over rows r of (max valid col of r - r), both >= 0.
    Rows with no valid entries contribute 0."""
    col = np.asarray(col_idx, np.int64)
    nv = np.asarray(nvalid, np.int64)
    squeeze = col.ndim == 2
    if squeeze:
        col, nv = col[None], nv[None]
    Ly, nrb, K = col.shape
    ncb_ = int(ncb) if ncb is not None else nrb
    valid = np.arange(K)[None, None, :] < nv[:, :, None]          # (Ly,nrb,K)
    colc = np.clip(col, 0, ncb_ - 1)
    rows = np.arange(nrb)[None, :, None]
    left = np.where(valid, rows - colc, 0).max(axis=(1, 2))
    right = np.where(valid, colc - rows, 0).max(axis=(1, 2))
    left = np.maximum(left, 0).astype(np.int64)
    right = np.maximum(right, 0).astype(np.int64)
    if squeeze:
        return left[:1], right[:1]
    return left, right


def build_sparsity_plan(col_idx, nvalid, block: int, *, ncb: int | None = None,
                        max_kt: int | None = None) -> SparsityPlan:
    """Build the SparsityPlan from (stacked or single-layer) forward BCSR
    tables, host-side in numpy. Always returns stacked tables (single-layer
    inputs get Ly=1)."""
    # copies: the tables become tensors that share these arrays' memory
    col = np.array(col_idx, np.int32)
    nv = np.array(nvalid, np.int32)
    if col.ndim == 2:
        col, nv = col[None], nv[None]
    Ly, nrb, K = col.shape
    ncb_ = int(ncb) if ncb is not None else nrb
    row_idx, nvalid_t, kt = host_transpose_tables(col, nv, ncb=ncb_,
                                                  max_kt=max_kt)
    ext_l, ext_r = pattern_col_extents(col, nv, ncb=ncb_)
    stats = {
        "kt_star": int(kt),
        "nrb": int(nrb),
        "ncb": int(ncb_),
        "K": int(K),
        "per_layer_max_col_population": nvalid_t.max(axis=1).astype(int).tolist(),
        "per_layer_density": [round(float(d), 6)
                              for d in nv.sum(axis=1) / float(nrb * ncb_)],
        "dkv_grid_shrink": round(float(nrb) / float(kt), 4),
        "col_extent_left": ext_l.astype(int).tolist(),
        "col_extent_right": ext_r.astype(int).tolist(),
        "halo": [int(ext_l.max()), int(ext_r.max())],
    }
    tables = {
        "col_idx": torch.from_numpy(col),
        "nvalid": torch.from_numpy(nv),
        "row_idx": torch.from_numpy(row_idx),
        "nvalid_t": torch.from_numpy(nvalid_t),
        "block": int(block),
    }
    return SparsityPlan(tables, int(kt), stats)


def full_bcsr(seq_len: int, block: int) -> BCSR:
    """All-blocks-active BCSR (sparse path must equal dense attention)."""
    nrb = seq_len // block
    col = np.tile(np.arange(nrb, dtype=np.int32), (nrb, 1))
    return BCSR(torch.from_numpy(col), torch.full((nrb,), nrb, dtype=torch.int32),
                block, seq_len)


def bcsr_attention(cfg, q, k, v, bcsr: BCSR, *, row_chunk=None,
                   row_offset: int = 0):
    """q (B,S,H,hd); k,v (B,S,KV,hd); returns (B,S,H,hd).

    Padded-BCSR attention with the paper's sparse-softmax zero-correction,
    gathered in plain PyTorch and chunked over row-blocks so the gathered
    block tensors of all rows are never resident at once. Validity comes
    from `col_idx >= 0`, as in the JAX package's gather path.

    `row_offset`: q holds the rows of a sequence shard whose first
    row-block is the global row-block `row_offset`, k and v the whole
    sequence, and the tables are the global ones (the gather of a 'seq'
    shard, core/attention_exec)."""
    nrb_total = q.shape[1] // bcsr.block
    rc = row_chunk or max(1, min(nrb_total, 2**21 // (bcsr.block * bcsr.block *
                                                      max(bcsr.col_idx.shape[1], 1))))

    def rows_of(r, n):
        return BCSR(bcsr.col_idx[r:r + n], bcsr.nvalid[r:r + n], bcsr.block,
                    bcsr.seq_len)
    if nrb_total and rc < nrb_total and nrb_total % rc == 0:
        rows = rc * bcsr.block
        outs = [_bcsr_rows(cfg, q[:, i * rows:(i + 1) * rows], k, v,
                           rows_of(row_offset + i * rc, rc),
                           row_offset + i * rc)
                for i in range(nrb_total // rc)]
        return torch.cat(outs, dim=1)
    return _bcsr_rows(cfg, q, k, v, rows_of(row_offset, nrb_total),
                      row_offset)


def _bcsr_rows(cfg, q, k, v, bcsr: BCSR, row_offset: int):
    """BCSR attention for the row-blocks covered by q (absolute row-block
    index of q's first block = row_offset)."""
    B, Sq, H, hd = q.shape
    L = k.shape[1]
    KV = k.shape[2]
    G = H // KV
    Bb = bcsr.block
    nrb = Sq // Bb          # row-blocks in THIS chunk
    K = bcsr.col_idx.shape[1]
    dev = q.device
    col = bcsr.col_idx.to(dev).long()      # (nrb, K)
    colc = col.clamp(min=0)

    qb = q.reshape(B, nrb, Bb, KV, G, hd)
    kb = k.reshape(B, L // Bb, Bb, KV, hd)
    vb = v.reshape(B, L // Bb, Bb, KV, hd)
    # gather active key/value blocks per row-block: (B, nrb, K, Bb, KV, hd)
    kg = kb[:, colc]
    vg = vb[:, colc]

    # scores: (B, KV, G, nrb, Bb, K, Bb)
    s = torch.einsum("brpkgh,brcqkh->bkgrpcq", qb, kg).float()
    s = s / math.sqrt(hd)

    # masks: padded blocks, causal / sliding-window within active blocks
    ar = torch.arange(Bb, device=dev)
    abs_rows = (row_offset + torch.arange(nrb, device=dev)) * Bb
    qpos = abs_rows[:, None, None, None] + ar[None, :, None, None]
    kpos = (colc * Bb)[:, None, :, None] + ar[None, None, None, :]
    ok = (col >= 0)[:, None, :, None]
    if cfg.causal:
        ok = ok & (qpos >= kpos)
    if cfg.sliding_window:
        ok = ok & (qpos - kpos < cfg.sliding_window)
    s = torch.where(ok[None, None, None], s, -math.inf)

    sflat = s.reshape(B, KV, G, nrb, Bb, K * Bb)
    mx = sflat.amax(dim=-1, keepdim=True).clamp(min=-1e30)  # empty rows
    ex = torch.where(torch.isneginf(sflat), 0.0, torch.exp(sflat - mx))
    denom = ex.sum(dim=-1, keepdim=True)

    # paper Alg. 6 line 15: pruned positions contribute exp(0 - max) each.
    ok_full = ok.expand(nrb, Bb, K, Bb)
    stored = ok_full.sum(dim=(-2, -1)).reshape(1, 1, 1, nrb, Bb, 1)
    if cfg.causal:
        abs_pos = abs_rows[:, None] + ar[None, :]
        row_total = (abs_pos + 1)[None, None, None, ..., None]
        if cfg.sliding_window:
            row_total = row_total.clamp(max=cfg.sliding_window)
    else:
        row_total = torch.full((1, 1, 1, nrb, Bb, 1), L, device=dev)
    zeros_cnt = (row_total - stored).clamp(min=0).float()
    denom = denom + zeros_cnt * torch.exp(-mx)

    probs = (ex / denom).to(q.dtype)
    probs = probs.reshape(B, KV, G, nrb, Bb, K, Bb)
    out = torch.einsum("bkgrpcq,brcqkh->brpkgh", probs, vg)
    return out.reshape(B, Sq, H, hd)


def _decode_pattern_cols(pos, col_idx, nvalid, batch: int, block: int):
    """Per-row pattern columns for one-token decode: the query position's
    row-block selects its (K,) column blocks. Returns (posb (B,), colc (B,K)
    clipped column-block ids, valid (B,K) table-validity mask). Rows past
    the table clamp to the last row-block."""
    nrb, Kp = col_idx.shape
    dev = col_idx.device
    posb = torch.as_tensor(pos, device=dev).reshape(-1).expand(batch) \
        .to(torch.int32)
    rb = (posb // block).clamp(0, nrb - 1).long()
    cols = col_idx[rb]                                      # (B, K)
    nval = nvalid[rb]                                       # (B,)
    valid = (torch.arange(Kp, device=dev)[None, :] < nval[:, None]) & \
        (cols >= 0)
    return posb, cols.clamp(min=0), valid


def _gathered_mask(cfg, posb, colc, valid, *, block: int, ring_len=None):
    """(ok (B, K, block): the gathered slots a decode at `posb` may see,
    row_total (B,): the positions its row sees in all, which the Alg. 6
    zero correction counts against the stored ones)."""
    # absolute positions the gathered slots are *supposed* to hold
    kpos = (colc * block)[:, :, None] + \
        torch.arange(block, device=colc.device)[None, None, :]
    ok = valid[:, :, None] & (kpos >= 0) & (kpos <= posb[:, None, None])
    if cfg.sliding_window:
        ok = ok & (kpos > posb[:, None, None] - cfg.sliding_window)
    if ring_len is not None:
        # the ring holds only the last ring_len positions; older ones were
        # overwritten
        ok = ok & (kpos > posb[:, None, None] - ring_len)
    row_total = posb + 1
    if cfg.sliding_window:
        row_total = row_total.clamp(max=cfg.sliding_window)
    if ring_len is not None:
        # positions that rotated out of the ring are GONE, not pruned: the
        # dense ring decode renormalises over what the cache holds
        row_total = row_total.clamp(max=ring_len)
    return ok, row_total


def _decode_gathered(cfg, q, kg, vg, posb, colc, valid, *, block: int,
                     ring_len=None):
    """Attend q over gathered pattern blocks kg/vg (B, K, block, KV, hd)
    with the Alg. 6 zero-corrected softmax. `colc`/`valid` are the logical
    column-block ids and validity from `_decode_pattern_cols` (possibly
    further masked by the caller, e.g. unmapped page-table entries);
    `ring_len` is the ring-buffer length for sliding-window caches (None
    for append caches). Shared by the contiguous and paged decode paths,
    which therefore agree bitwise when they gather the same blocks."""
    B, _, H, hd = q.shape
    KV = kg.shape[3]
    G = H // KV
    Kp = colc.shape[1]
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bcqkh->bkgcq", qg, kg).float() / math.sqrt(hd)
    ok, row_total = _gathered_mask(cfg, posb, colc, valid, block=block,
                                   ring_len=ring_len)
    s = torch.where(ok[:, None, None], s, -math.inf)
    sflat = s.reshape(B, KV, G, Kp * block)
    mx = sflat.amax(dim=-1, keepdim=True).clamp(min=-1e30)
    ex = torch.where(torch.isneginf(sflat), 0.0, torch.exp(sflat - mx))
    denom = ex.sum(dim=-1, keepdim=True)
    # Alg. 6 zero-correction: pruned visible positions count exp(-max) each
    stored = ok.sum(dim=(1, 2)).to(torch.int32)            # (B,)
    zeros_cnt = (row_total - stored).clamp(min=0)[:, None, None, None].float()
    denom = denom + zeros_cnt * torch.exp(-mx)
    probs = (ex / denom).to(q.dtype).reshape(B, KV, G, Kp, block)
    out = torch.einsum("bkgcq,bcqkh->bkgh", probs, vg)
    return out.reshape(B, 1, H, hd)


def head_dim_sum(s):
    """Partial q·k products over this rank's head_dim columns -> the whole
    products: summed over the model line in fp32."""
    return reduce_from_model(s, torch.float32)


def merge_partials(m, l, o, group, stored=None, total=None):
    """The attention context from each rank's partial softmax over its
    cache positions: m (B, KV, G, 1) its max, l the sum of exp(s - m), o
    (B, KV, G, hd) the sum of exp(s - m) v, all fp32, combined by
    log-sum-exp over `group` (the ranks holding the other positions; None
    where this rank holds every one). `stored` / `total` (B,): the
    positions a sparse decode gathered on this rank and the row's visible
    positions in all: the Alg. 6 zero correction counts the pruned ones,
    exp(-max) each, once, after the combine."""
    if group is not None:
        M = m.clone()
        dist.all_reduce(M, op=dist.ReduceOp.MAX, group=group)
        scale = torch.exp(m - M)
        parts = [(l * scale).reshape(-1), (o * scale).reshape(-1)]
        if stored is not None:
            parts.append(stored.float())
        flat = torch.cat(parts)
        dist.all_reduce(flat, group=group)
        l = flat[:l.numel()].reshape(l.shape)
        o = flat[l.numel():l.numel() + o.numel()].reshape(o.shape)
        if stored is not None:
            stored = flat[l.numel() + o.numel():]
        m = M
    if stored is not None:
        zeros = (total.float() - stored.float()).clamp(min=0)
        l = l + zeros[:, None, None, None] * torch.exp(-m)
    return o / l


def shard_decode(q, kg, vg, ok, group, total=None):
    """One-token attention over this rank's shard of a cache: q (B, 1, H,
    hd) whole heads; kg / vg (B, N, KV, hd_loc) its N cache positions
    (hd_loc < hd: its head_dim columns, head_dim over 'model'); ok (B, N)
    the ones the token sees; `group` the ranks holding the other positions
    (None: none). The partial q·k over the rank's columns summed over the
    model line (`head_dim_sum`), the softmax's max, sum and p·v over its
    positions in fp32, combined over `group` (`merge_partials`, with the
    sparse decode's row `total` (B,) for its zero correction). Returns
    (B, 1, H, hd) in q's dtype, the context's columns gathered over the
    model line."""
    B, _, H, hd = q.shape
    KV, hdl = kg.shape[2], kg.shape[3]
    qg = q.reshape(B, KV, H // KV, hd)
    if hdl != hd:
        qg = qg.narrow(-1, model_offset(hdl), hdl)
    s = torch.einsum("bkgh,bnkh->bkgn", qg.float(), kg.float())
    if hdl != hd:
        s = head_dim_sum(s)
    s = torch.where(ok[:, None, None, :], s / math.sqrt(hd), -math.inf)
    m = s.amax(dim=-1, keepdim=True).clamp(min=-1e30)
    e = torch.where(torch.isneginf(s), 0.0, torch.exp(s - m))
    o = torch.einsum("bkgn,bnkh->bkgh", e, vg.float())
    stored = None if total is None else ok.sum(dim=1)
    out = merge_partials(m, e.sum(dim=-1, keepdim=True), o, group,
                         stored, total).to(q.dtype)
    if hdl != hd:
        out = gather_model(out, -1)
    return out.reshape(B, 1, H, hd)


def sparse_decode_attention(cfg, q, k_cache, v_cache, pos, col_idx, nvalid,
                            *, block: int, ring: bool = False):
    """One-token sparse decode: attend over ONLY the KV-cache blocks the
    pattern lists for the query position's row-block.

    q (B,1,H,hd); caches (B,S,KV,hd); pos scalar or (B,) per-row absolute
    positions; col_idx (nrb, K) / nvalid (nrb,) — one layer's forward BCSR.
    Semantics match the sparse prefill row (Alg. 6 line 15); where the listed
    blocks cover every visible position this equals dense decode. Decode is
    causal by construction, so the row total is pos + 1 (clipped by the
    sliding window).

    ring=True for sliding-window ring-buffer caches (cache slot of absolute
    position p is p % S; S must be a multiple of `block`): listed column
    blocks wrap into storage blocks mod S/block, and positions that have
    rotated out of the ring are masked."""
    B, _, _H, hd = q.shape
    KV, S = k_cache.shape[2], k_cache.shape[1]
    nbc = S // block
    posb, colc, valid = _decode_pattern_cols(pos, col_idx, nvalid, B, block)
    start, n, group = position_shard(S)
    if n > 1 or k_cache.shape[-1] != hd:
        return _shard_sparse_decode(cfg, q, k_cache, v_cache, posb, colc,
                                    valid, block=block, ring=ring,
                                    start=start, n=n, group=group)
    if ring:
        sb = (colc % nbc).long()
    else:
        # append cache: blocks beyond the cache don't exist — mask, never
        # alias
        valid = valid & (colc < nbc)
        sb = colc.clamp(max=nbc - 1).long()
    kb = k_cache.reshape(B, nbc, block, KV, hd)
    vb = v_cache.reshape(B, nbc, block, KV, hd)
    rows = torch.arange(B, device=q.device)[:, None]
    kg = kb[rows, sb].to(q.dtype)                          # (B,K,blk,KV,hd)
    vg = vb[rows, sb].to(q.dtype)
    return _decode_gathered(cfg, q, kg, vg, posb, colc, valid, block=block,
                            ring_len=S if ring else None)


def _shard_sparse_decode(cfg, q, k_cache, v_cache, posb, colc, valid, *,
                         block, ring, start, n, group):
    """`sparse_decode_attention` on this rank's shard of the cache: its S
    positions from `start` of the n * S the data line holds (the listed
    blocks it holds are gathered, the others masked), or its head_dim
    columns; the partial softmaxes meet in `shard_decode`, the zero
    correction once after their combine."""
    B, S = k_cache.shape[0], k_cache.shape[1]
    KV, hdl = k_cache.shape[2], k_cache.shape[3]
    nbc, nbc_all = S // block, S * n // block
    if ring:
        sb = (colc % nbc_all).long()
    else:
        valid = valid & (colc < nbc_all)
        sb = colc.clamp(max=nbc_all - 1).long()
    first = start // block
    valid = valid & (sb >= first) & (sb < first + nbc)
    sb = (sb - first).clamp(0, nbc - 1)
    rows = torch.arange(B, device=q.device)[:, None]
    kg = k_cache.reshape(B, nbc, block, KV, hdl)[rows, sb]
    vg = v_cache.reshape(B, nbc, block, KV, hdl)[rows, sb]
    ok, total = _gathered_mask(cfg, posb, colc, valid, block=block,
                               ring_len=S * n if ring else None)
    Kp = colc.shape[1]
    return shard_decode(q, kg.reshape(B, Kp * block, KV, hdl),
                        vg.reshape(B, Kp * block, KV, hdl),
                        ok.reshape(B, Kp * block), group, total=total)


def paged_sparse_decode_attention(cfg, q, kp, vp, layer, pos, page_table,
                                  col_idx, nvalid, *, page: int,
                                  ring: bool = False):
    """`sparse_decode_attention` over a paged KV pool (core.kv_pool): the
    pattern's column blocks resolve through the request's page-table row.

    q (B,1,H,hd); kp/vp (L, num_pages, page, KV, hd) with page == the BCSR
    block; `layer` the pool layer index; page_table (B, NB) of physical page
    ids, -1 = unmapped (masked — reads clamp to the scratch page). Where
    every pattern-listed block is mapped the result is bitwise-identical to
    the contiguous path. ring=True recycles table slots mod NB exactly like
    the contiguous ring recycles storage blocks.

    Under a mesh the pool is replicated and `page_table` is this rank's
    rows of it: the rank gathers its KV heads, or its head_dim columns
    (`pool_shard`), and the head_dim columns' partial q·k products meet in
    `shard_decode`, the zero correction once, as the contiguous path's."""
    B, _, _, hd = q.shape
    NB = page_table.shape[1]
    posb, colc, valid = _decode_pattern_cols(pos, col_idx, nvalid, B, page)
    if ring:
        sb = (colc % NB).long()
    else:
        valid = valid & (colc < NB)
        sb = colc.clamp(max=NB - 1).long()
    praw = torch.gather(page_table, 1, sb)                 # (B, K)
    valid = valid & (praw >= 0)
    phys = praw.clamp(min=0).long()
    kg = pool_shard(kp[layer])[phys]                       # (B,K,page,KV,hd)
    vg = pool_shard(vp[layer])[phys]
    ring_len = NB * page if ring else None
    if kg.shape[-1] != hd:
        KV, hdl, Kp = kg.shape[3], kg.shape[4], colc.shape[1]
        ok, total = _gathered_mask(cfg, posb, colc, valid, block=page,
                                   ring_len=ring_len)
        return shard_decode(q, kg.reshape(B, Kp * page, KV, hdl),
                            vg.reshape(B, Kp * page, KV, hdl),
                            ok.reshape(B, Kp * page), None, total=total)
    return _decode_gathered(cfg, q, kg.to(q.dtype), vg.to(q.dtype), posb,
                            colc, valid, block=page, ring_len=ring_len)


def bcsr_attention_ops(cfg, bcsr: BCSR) -> int:
    """Analytic op count of the sparse path (paper §4.4 formula, per head):
    2*C*(2*hd+1) - L*(hd+1) with C = stored element count."""
    C = int(torch.as_tensor(bcsr.nvalid).sum()) * bcsr.block * bcsr.block
    L = bcsr.seq_len
    hd = cfg.resolved_head_dim
    return 2 * C * (2 * hd + 1) - L * (hd + 1)
