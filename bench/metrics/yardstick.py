"""The benchmark's yardstick: the H100's published peaks, frozen copies of
the three block-sparse kernels' work formulas (the program's
kernels/work.py), and the model FLOPs a train step needs.

Peaks: NVIDIA H100 SXM data sheet, dense bf16 tensor cores 989 TFLOP/s,
HBM3 3.35 TB/s, at the full 700 W power limit.
"""
from __future__ import annotations

import numpy as np

PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12

KERNELS = ("block_sparse_fwd", "block_sparse_dq", "block_sparse_dkv")


# -- the kernels' work (frozen from the program's kernels/work.py) ------------

def masked_pairs(col, nvalid, block, causal, transposed=False):
    """(kept (q, k) pairs, tiles holding any, distinct listed blocks among
    those) of one layer's tables under the causal mask. Row r of `col`
    lists column blocks (row blocks of column block r if `transposed`)."""
    nv = np.asarray(nvalid).astype(np.int64).reshape(-1)
    ids = np.asarray(col).astype(np.int64).reshape(len(nv), -1)
    live = np.arange(ids.shape[1])[None, :] < nv[:, None]
    rows = np.broadcast_to(np.arange(len(nv))[:, None], ids.shape)
    dist = (ids - rows) if transposed else (rows - ids)
    dist, listed = dist[live], ids[live]
    if not dist.size:
        return 0, 0, 0
    du, inv = np.unique(dist, return_inverse=True)
    t = np.arange(1 - block, block)
    weight = block - np.abs(t)
    delta = du[:, None] * block + t[None, :]
    ok = delta >= 0 if causal else np.ones(delta.shape, dtype=bool)
    n = (weight[None, :] * ok).sum(axis=1)[inv.reshape(-1)]
    kept = n > 0
    return int(n.sum()), int(kept.sum()), int(np.unique(listed[kept]).size)


def kernel_work(kind, N, G, S, hd, col, nvalid, row_idx, nvalid_t, block,
                causal, es=2):
    """(flops, bytes) of one launch of `kind` on q (N, G, S, hd), k and v
    (N, S, hd) of element size `es`, with one layer's tables: each input
    byte read once, each output byte written once, kept pairs only."""
    if kind == "block_sparse_fwd":
        pairs, _, distinct = masked_pairs(col, nvalid, block, causal)
        flops = 4 * N * G * pairs * hd
        nbytes = (2 * N * G * S * hd * es + N * G * S * 4
                  + 2 * N * distinct * block * hd * es
                  + np.size(col) * 4 + np.size(nvalid) * 4)
    elif kind == "block_sparse_dq":
        pairs, _, kblocks = masked_pairs(col, nvalid, block, causal)
        flops = 6 * N * G * pairs * hd
        nbytes = (2 * N * G * S * hd * es + 2 * N * G * S * 4
                  + N * G * S * hd * 4
                  + 2 * N * kblocks * block * hd * es
                  + 4 * (np.size(col) + np.size(nvalid)))
    else:
        pairs, _, qblocks = masked_pairs(row_idx, nvalid_t, block, causal,
                                         transposed=True)
        flops = 8 * N * G * pairs * hd
        nbytes = (2 * N * S * hd * es + 2 * N * S * hd * 4
                  + 2 * N * G * qblocks * block * hd * es
                  + 2 * qblocks * N * G * block * 4
                  + 4 * (np.size(row_idx) + np.size(nvalid_t)))
    return flops, nbytes


def bound_s(flops, nbytes):
    """The card's least time for the work: the larger of the two terms."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / HBM_BW)


def launch_bounds(model, traffic, tables):
    """{kernel: mean bound seconds of one launch over the layers} of the
    cell's sparse step on the plan's numpy `tables` (with its "block")."""
    B, S = traffic["batch"], traffic["seq_len"]
    H, KV = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or model["d_model"] // H
    block = tables["block"]
    causal = model.get("causal", True)
    out = {}
    for kind in KERNELS:
        per_layer = [bound_s(*kernel_work(
            kind, B * KV, H // KV, S, hd, tables["col_idx"][layer],
            tables["nvalid"][layer], tables["row_idx"][layer],
            tables["nvalid_t"][layer], block, causal))
            for layer in range(len(tables["col_idx"]))]
        out[kind] = float(np.mean(per_layer))
    return out


# -- the model FLOPs of a train step --------------------------------------------

def matmul_params(model):
    """(parameters of the layers' linear maps, parameters of the head)."""
    L, d = model["num_layers"], model["d_model"]
    H, KV = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or d // H
    attn = d * H * hd * 2 + d * KV * hd * 2
    mlp = (3 if model["act"] == "silu" else 2) * d * model["d_ff"]
    return L * (attn + mlp), model["vocab_size"] * d


def attention_pairs(model, traffic, tables):
    """(q, k) pairs a step's attention computes, summed over layers, for one
    sequence and one query head: the plan's kept pairs, or with `tables`
    None every pair the mask allows."""
    S, causal = traffic["seq_len"], model.get("causal", True)
    L = model["num_layers"]
    if tables is None:
        return L * (S * (S + 1) // 2 if causal else S * S)
    block = tables["block"]
    return sum(masked_pairs(tables["col_idx"][layer],
                            tables["nvalid"][layer], block, causal)[0]
               for layer in range(len(tables["col_idx"])))


def step_flops(model, traffic, tables, loss_positions=None):
    """Model FLOPs of one train step, recompute not counted: 6 per position
    and parameter of the linear maps over every position, of the head over
    the `loss_positions` the loss covers (None: every text position), and
    12 * head_dim per (q, k) pair and query head of the attention (q k^T
    and p v, forward and backward)."""
    B, S = traffic["batch"], traffic["seq_len"]
    if loss_positions is None:
        loss_positions = B * (S - traffic.get("patches", 0))
    layers, head = matmul_params(model)
    hd = model.get("head_dim") or model["d_model"] // model["num_heads"]
    attn = 12 * hd * model["num_heads"] * B * \
        attention_pairs(model, traffic, tables)
    return 6 * B * S * layers + 6 * loss_positions * head + attn
