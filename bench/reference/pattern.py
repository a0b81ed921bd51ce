"""Frozen copies of the SPION pattern generation (the paper's Alg. 3 and 4,
variant "cf" from the streamed pooled map) and of the plan's tables: the
padded BCSR rows, their transpose at the true column population KT*.
Copied from the program's core/pattern.py and core/sparse_attention.py, so
that the same pooled map gives the same tables bit for bit, and a change
there cannot move the reference."""
from __future__ import annotations

import numpy as np


def flood_fill(pool_out, fl_out, t):
    """Alg. 3 lines 5-8 + Alg. 4 with an explicit stack: seeds along the
    top row and the left column; from (r, c) the neighbours down, right
    and down-right that equal their maximum, are unvisited and exceed t
    are marked and explored."""
    n = pool_out.shape[0]
    for seed in [(0, i) for i in range(n)] + [(j, 0) for j in range(n)]:
        stack = [seed]
        while stack:
            r, c = stack.pop()
            if r + 1 >= n or c + 1 >= n:
                continue
            nb = ((r + 1, c), (r, c + 1), (r + 1, c + 1))
            vals = [pool_out[x] for x in nb]
            m = max(vals)
            for x, v in zip(nb, vals):
                if v == m and fl_out[x] == 0 and v > t:
                    fl_out[x] = 1
                    stack.append(x)
    return fl_out


def block_mask(pooled, alpha, causal):
    """(n, n) int8 block pattern of one layer's pooled map: flood fill above
    the alpha-quantile, the diagonal always on, lower triangle if causal."""
    pooled = np.asarray(pooled, np.float64)
    n = pooled.shape[0]
    if causal:
        pooled = np.where(np.tril(np.ones_like(pooled, bool)), pooled,
                          -np.inf)
    t = float(np.quantile(pooled[np.isfinite(pooled)], alpha))
    fl = np.zeros((n, n), np.int8)
    flood_fill(pooled, fl, t)
    np.fill_diagonal(fl, 1)
    if causal:
        fl = np.tril(fl)
    return fl


def forward_tables(masks):
    """Stacked padded BCSR of the layers' masks at the widest row's K:
    col_idx (Ly, nrb, K) int32 padded with -1, nvalid (Ly, nrb) int32."""
    K = max(int(m.sum(axis=1).max()) for m in masks)
    Ly, nrb = len(masks), masks[0].shape[0]
    col = np.full((Ly, nrb, K), -1, np.int32)
    nv = np.zeros((Ly, nrb), np.int32)
    for layer, m in enumerate(masks):
        for r in range(nrb):
            idx = np.nonzero(m[r])[0][:K]
            col[layer, r, :len(idx)] = idx
            nv[layer, r] = len(idx)
    return col, nv


def transposed_tables(col, nv):
    """row_idx (Ly, ncb, KT*) and nvalid_t (Ly, ncb): for each column block
    the row blocks that list it, ascending, then the last of them repeated
    (0 for an empty column); KT* the most any column has."""
    Ly, nrb, K = col.shape
    ncb = nrb
    lists = []
    for layer in range(Ly):
        per_col = [[] for _ in range(ncb)]
        for r in range(nrb):
            for c in sorted(set(int(x) for x in col[layer, r, :nv[layer, r]])):
                per_col[min(max(c, 0), ncb - 1)].append(r)
        lists.append(per_col)
    kt = max(1, max(len(rows) for per_col in lists for rows in per_col))
    row_idx = np.zeros((Ly, ncb, kt), np.int32)
    nvalid_t = np.zeros((Ly, ncb), np.int32)
    for layer, per_col in enumerate(lists):
        for c, rows in enumerate(per_col):
            nvalid_t[layer, c] = len(rows)
            fill = rows + [rows[-1] if rows else 0] * (kt - len(rows))
            row_idx[layer, c] = fill
    return row_idx, nvalid_t


def plan_tables(pooled, alpha, causal):
    """{col_idx, nvalid, row_idx, nvalid_t} numpy int32 of the stacked
    pooled maps (Ly, n, n), and each layer's block mask."""
    masks = [block_mask(p, alpha, causal) for p in np.asarray(pooled)]
    col, nv = forward_tables(masks)
    row_idx, nvalid_t = transposed_tables(col, nv)
    return {"col_idx": col, "nvalid": nv, "row_idx": row_idx,
            "nvalid_t": nvalid_t}, masks
