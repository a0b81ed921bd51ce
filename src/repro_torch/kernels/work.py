"""The work of the three block-sparse kernels, counted from their tables.

A kernel's work depends on what its tables list, not on their shapes: the
(q, k) pairs of the listed tiles that the causal / sliding-window mask
keeps, and the distinct K/V (or Q/dO) blocks those tiles read. One count
serves both readers: the kernels' bound on the card (chip_smoke.py's
`bound`) and the dry run's FLOPs and bytes (launch/dryrun.py), where it is
each op's `torch.utils.flop_counter` formula (kernels/block_sparse_attn.py
registers it) and the op's bytes beside it.

Tables are read through `table_values`: a real tensor gives its own
values, and a meta one holds none and raises. So the dry run keeps
the tables real on the host beside its meta activations (`table_device`),
and the count is the same on the card's real step and in the dry run.
"""
from __future__ import annotations

import numpy as np
import torch


def table_device(q) -> torch.device:
    """Where the kernels' tables for activations `q` live: q's own device,
    except for the dry run's meta tensors (launch/dryrun.py), whose tables
    stay real on the host so that each kernel's work is counted from what
    they list."""
    return torch.device("cpu") if q.device.type == "meta" else q.device


def table_values(t) -> np.ndarray:
    """The values of table `t` as a numpy array; raises for a meta table
    (a count from shapes alone would be wrong)."""
    from torch.utils._python_dispatch import _disable_current_modes
    if t.device.type == "meta":
        raise ValueError(
            f"table {tuple(t.shape)} {t.dtype} has no host values: the "
            f"kernels' work depends on what the tables list, so a meta "
            f"pass keeps its tables real (table_device)")
    with _disable_current_modes():     # a real tensor read inside a pass
        return t.detach().cpu().numpy()


def masked_pairs(col, nvalid, block, kw, transposed=False):
    """The (q, k) pairs of the listed tiles that the causal / sliding-window
    mask keeps (the work the function needs), the listed tiles holding any,
    and the distinct listed blocks among those (column blocks; row blocks
    of the transposed tables, `transposed=True`: row r of `col` then lists
    the row blocks of column block r). A tile at block distance d = row -
    col holds block - |t| pairs at position distance d * block + t, t in
    (-block, block). `kw` holds causal, sliding_window and offsets (row0,
    col0), as the kernels' keywords do."""
    nv = np.asarray(table_values(nvalid)).astype(np.int64).reshape(-1)
    ids = np.asarray(table_values(col)).astype(np.int64)
    ids = ids.reshape(len(nv), -1)
    row0, col0 = kw.get("offsets") or (0, 0)
    sw = kw.get("sliding_window")
    live = np.arange(ids.shape[1])[None, :] < nv[:, None]
    rows = np.broadcast_to(np.arange(len(nv))[:, None], ids.shape)
    dist = (ids - rows) if transposed else (rows - ids)
    dist, listed = dist[live], ids[live]
    if not dist.size:
        return 0, 0, 0
    # the pairs a tile keeps depend on its block distance alone
    du, inv = np.unique(dist, return_inverse=True)
    t = np.arange(1 - block, block)
    weight = block - np.abs(t)
    delta = (du[:, None] + row0 - col0) * block + t[None, :]
    ok = np.ones(delta.shape, dtype=bool)
    if kw.get("causal"):
        ok &= delta >= 0
    if sw:
        ok &= delta < sw
    n = (weight[None, :] * ok).sum(axis=1)[inv.reshape(-1)]
    kept = n > 0
    return int(n.sum()), int(kept.sum()), int(np.unique(listed[kept]).size)


def _kw(block, causal, sliding_window, offsets):
    return dict(block=block, causal=causal, sliding_window=sliding_window,
                offsets=offsets)


def fwd_work(q, k, col_idx, nvalid, *, block, causal=False,
             sliding_window=None, offsets=None):
    """(flops, bytes) of the forward kernel on these inputs: 4 flops a kept
    (q, k) pair per head dim (q k^T and p v); q and o, lse, the listed K and
    V blocks and the tables, each read or written once."""
    N, G, S, hd = q.shape
    es = q.element_size()
    pairs, _, distinct = masked_pairs(
        col_idx, nvalid, block, _kw(block, causal, sliding_window, offsets))
    flops = 4 * N * G * pairs * hd
    nbytes = (2 * q.numel() * es + N * G * S * 4           # q, o, lse
              + 2 * N * distinct * block * hd * es          # listed K, V
              + col_idx.numel() * 4 + nvalid.numel() * 4)
    return flops, nbytes


def dq_work(q, k, col_idx, nvalid, *, block, causal=False,
            sliding_window=None, offsets=None):
    """(flops, bytes) of the dQ kernel: 6 flops a kept pair per head dim
    (q k^T, dO v^T, ds k); q and dO, lse and delta, dq in fp32, the K and V
    blocks that hold any kept pair, and the tables."""
    N, G, S, hd = q.shape
    es = q.element_size()
    pairs, _, kblocks = masked_pairs(
        col_idx, nvalid, block, _kw(block, causal, sliding_window, offsets))
    flops = 6 * N * G * pairs * hd
    nbytes = (2 * q.numel() * es                  # q, dO
              + 2 * N * G * S * 4                 # lse, delta
              + q.numel() * 4                     # dq (fp32)
              + 2 * N * kblocks * block * hd * es     # needed K, V
              + 4 * (col_idx.numel() + nvalid.numel()))
    return flops, nbytes


def dkv_work(q, k, row_idx, nvalid_t, *, block, causal=False,
             sliding_window=None, offsets=None):
    """(flops, bytes) of the dK/dV kernel over the transposed tables: 8
    flops a kept pair per head dim (q k^T, dO v^T, p^T dO, ds^T q); k and
    v, dk and dv in fp32, the Q, dO blocks (and their lse, delta) that hold
    any kept pair, and the tables."""
    N, G, S, hd = q.shape
    es = q.element_size()
    pairs_t, _, qblocks = masked_pairs(
        row_idx, nvalid_t, block, _kw(block, causal, sliding_window, offsets),
        transposed=True)
    rowvec = N * G * block * 4                    # one row block's lse, delta
    flops = 8 * N * G * pairs_t * hd
    nbytes = (2 * k.numel() * es                  # k, v
              + 2 * k.numel() * 4                 # dk, dv (fp32)
              + 2 * N * G * qblocks * block * hd * es   # needed Q, dO
              + 2 * qblocks * rowvec              # their lse, delta
              + 4 * (row_idx.numel() + nvalid_t.numel()))
    return flops, nbytes
