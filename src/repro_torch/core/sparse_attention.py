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
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


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


def bcsr_attention(cfg, q, k, v, bcsr: BCSR, *, row_chunk=None):
    """q (B,S,H,hd); k,v (B,S,KV,hd); returns (B,S,H,hd).

    Padded-BCSR attention with the paper's sparse-softmax zero-correction,
    gathered in plain PyTorch and chunked over row-blocks so the gathered
    block tensors of all rows are never resident at once. Validity comes
    from `col_idx >= 0`, as in the JAX package's gather path."""
    nrb_total = q.shape[1] // bcsr.block
    rc = row_chunk or max(1, min(nrb_total, 2**21 // (bcsr.block * bcsr.block *
                                                      max(bcsr.col_idx.shape[1], 1))))
    if nrb_total and rc < nrb_total and nrb_total % rc == 0:
        rows = rc * bcsr.block
        outs = [_bcsr_rows(cfg, q[:, i * rows:(i + 1) * rows], k, v,
                           BCSR(bcsr.col_idx[i * rc:(i + 1) * rc],
                                bcsr.nvalid[i * rc:(i + 1) * rc],
                                bcsr.block, bcsr.seq_len), i * rc)
                for i in range(nrb_total // rc)]
        return torch.cat(outs, dim=1)
    return _bcsr_rows(cfg, q, k, v, bcsr, 0)


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


def _decode_gathered(cfg, q, kg, vg, posb, colc, valid, *, block: int):
    """Attend q over gathered pattern blocks kg/vg (B, K, block, KV, hd)
    with the Alg. 6 zero-corrected softmax. `colc`/`valid` are the logical
    column-block ids and validity from `_decode_pattern_cols` (possibly
    further masked by the caller, e.g. unmapped page-table entries). Shared
    by the contiguous and paged decode paths, which therefore agree bitwise
    when they gather the same blocks."""
    B, _, H, hd = q.shape
    KV = kg.shape[3]
    G = H // KV
    Kp = colc.shape[1]
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bcqkh->bkgcq", qg, kg).float() / math.sqrt(hd)
    # absolute positions the gathered slots are *supposed* to hold
    kpos = (colc * block)[:, :, None] + \
        torch.arange(block, device=q.device)[None, None, :]
    ok = valid[:, :, None] & (kpos >= 0) & (kpos <= posb[:, None, None])
    if cfg.sliding_window:
        ok = ok & (kpos > posb[:, None, None] - cfg.sliding_window)
    s = torch.where(ok[:, None, None], s, -math.inf)
    sflat = s.reshape(B, KV, G, Kp * block)
    mx = sflat.amax(dim=-1, keepdim=True).clamp(min=-1e30)
    ex = torch.where(torch.isneginf(sflat), 0.0, torch.exp(sflat - mx))
    denom = ex.sum(dim=-1, keepdim=True)
    # Alg. 6 zero-correction: pruned visible positions count exp(-max) each
    stored = ok.sum(dim=(1, 2)).to(torch.int32)            # (B,)
    row_total = posb + 1
    if cfg.sliding_window:
        row_total = row_total.clamp(max=cfg.sliding_window)
    zeros_cnt = (row_total - stored).clamp(min=0)[:, None, None, None].float()
    denom = denom + zeros_cnt * torch.exp(-mx)
    probs = (ex / denom).to(q.dtype).reshape(B, KV, G, Kp, block)
    out = torch.einsum("bkgcq,bcqkh->bkgh", probs, vg)
    return out.reshape(B, 1, H, hd)


def sparse_decode_attention(cfg, q, k_cache, v_cache, pos, col_idx, nvalid,
                            *, block: int):
    """One-token sparse decode: attend over ONLY the KV-cache blocks the
    pattern lists for the query position's row-block.

    q (B,1,H,hd); caches (B,S,KV,hd); pos scalar or (B,) per-row absolute
    positions; col_idx (nrb, K) / nvalid (nrb,) — one layer's forward BCSR.
    Semantics match the sparse prefill row (Alg. 6 line 15); where the listed
    blocks cover every visible position this equals dense decode. Decode is
    causal by construction, so the row total is pos + 1 (clipped by the
    sliding window)."""
    B, _, _H, hd = q.shape
    KV, S = k_cache.shape[2], k_cache.shape[1]
    nbc = S // block
    posb, colc, valid = _decode_pattern_cols(pos, col_idx, nvalid, B, block)
    # append cache: blocks beyond the cache don't exist — mask, never alias
    valid = valid & (colc < nbc)
    sb = colc.clamp(max=nbc - 1).long()
    kb = k_cache.reshape(B, nbc, block, KV, hd)
    vb = v_cache.reshape(B, nbc, block, KV, hd)
    rows = torch.arange(B, device=q.device)[:, None]
    kg = kb[rows, sb].to(q.dtype)                          # (B,K,blk,KV,hd)
    vg = vb[rows, sb].to(q.dtype)
    return _decode_gathered(cfg, q, kg, vg, posb, colc, valid, block=block)


def paged_sparse_decode_attention(cfg, q, kp, vp, layer, pos, page_table,
                                  col_idx, nvalid, *, page: int):
    """`sparse_decode_attention` over a paged KV pool (core.kv_pool): the
    pattern's column blocks resolve through the request's page-table row.

    q (B,1,H,hd); kp/vp (L, num_pages, page, KV, hd) with page == the BCSR
    block; `layer` the pool layer index; page_table (B, NB) of physical page
    ids, -1 = unmapped (masked — reads clamp to the scratch page). Where
    every pattern-listed block is mapped the result is bitwise-identical to
    the contiguous path."""
    B = q.shape[0]
    NB = page_table.shape[1]
    posb, colc, valid = _decode_pattern_cols(pos, col_idx, nvalid, B, page)
    valid = valid & (colc < NB)
    sb = colc.clamp(max=NB - 1).long()
    praw = torch.gather(page_table, 1, sb)                 # (B, K)
    valid = valid & (praw >= 0)
    phys = praw.clamp(min=0).long()
    kg = kp[layer][phys].to(q.dtype)                       # (B,K,page,KV,hd)
    vg = vp[layer][phys].to(q.dtype)
    return _decode_gathered(cfg, q, kg, vg, posb, colc, valid, block=page)
