"""Plain PyTorch oracles of the paper's three-step sparse attention.

The semantics are the paper's (Alg. 5/6): SDDMM computes only the P-active
blocks; the sparse softmax counts pruned positions as exp(0 - max) in the
denominator (Alg. 6 line 15); SpMM multiplies active blocks by V.
"""
from __future__ import annotations

import math

import torch


def _block_positions(col_idx, block, nrb):
    """(qpos, kpos, valid): per (r, p, c, q) absolute positions + validity."""
    dev = col_idx.device
    ar = torch.arange(block, device=dev)
    qpos = (torch.arange(nrb, device=dev) * block)[:, None, None, None] + \
        ar[None, :, None, None]
    colc = col_idx.long().clamp(min=0)
    kpos = (colc * block)[:, None, :, None] + ar[None, None, None, :]
    valid = (col_idx >= 0)[:, None, :, None]
    return qpos, kpos, valid


def _mask(col_idx, block, nrb, causal, sliding_window):
    qpos, kpos, valid = _block_positions(col_idx, block, nrb)
    ok = valid
    if causal:
        ok = ok & (qpos >= kpos)
    if sliding_window:
        ok = ok & (qpos - kpos < sliding_window)
    return ok.expand(nrb, block, col_idx.shape[1], block)


def sddmm_ref(q, k, col_idx, *, block, causal=False, sliding_window=None):
    """q (N, S, hd); k (N, S, hd); col_idx (nrb, K) ->
    s_blocks (N, nrb, K, block, block) fp32 = (Q K^T / sqrt(hd)) on active
    blocks, -inf on masked positions."""
    N, S, hd = q.shape
    nrb = S // block
    qb = q.reshape(N, nrb, block, hd)
    kb = k.reshape(N, S // block, block, hd)
    kg = kb[:, col_idx.long().clamp(min=0)]                # (N, nrb, K, blk, hd)
    s = torch.einsum("nrph,nrcqh->nrpcq", qb, kg).float() / math.sqrt(hd)
    ok = _mask(col_idx, block, nrb, causal, sliding_window)   # (r, p, c, q)
    s = torch.where(ok[None], s, -math.inf)
    return s.movedim(2, 3)  # (N, nrb, K, blk_q, blk_k)


def row_total_ref(S, block, causal, sliding_window, device=None):
    """Total positions each row would attend to densely (for the correction)."""
    if causal:
        rt = torch.arange(S, device=device) + 1
        if sliding_window:
            rt = rt.clamp(max=sliding_window)
        return rt
    return torch.full((S,), S, device=device)


def sparse_softmax_ref(s_blocks, col_idx, *, block, seq_len, causal=False,
                       sliding_window=None):
    """s_blocks (N, nrb, K, blk, blk) fp32 with -inf at masked positions ->
    probs, same shape, with the Alg. 6 zero-correction."""
    N, nrb, K, b, _ = s_blocks.shape
    flat = s_blocks.movedim(2, 3).reshape(N, nrb, b, K * b)  # rows together
    mx = flat.amax(-1, keepdim=True).clamp(min=-1e30)
    neg = torch.isneginf(flat)
    ex = torch.where(neg, 0.0, torch.exp(flat - mx))
    denom = ex.sum(-1, keepdim=True)
    stored = (~neg).sum(-1, keepdim=True)
    rt = row_total_ref(seq_len, block, causal, sliding_window,
                       s_blocks.device).reshape(nrb, b)[None, :, :, None]
    denom = denom + (rt - stored).clamp(min=0) * torch.exp(-mx)
    p = ex / denom
    return p.reshape(N, nrb, b, K, b).movedim(3, 2)


def spmm_ref(p_blocks, v, col_idx):
    """p_blocks (N, nrb, K, blk, blk); v (N, S, hd) -> out (N, S, hd)."""
    N, nrb, K, b, _ = p_blocks.shape
    S, hd = v.shape[1], v.shape[2]
    vb = v.reshape(N, S // b, b, hd)
    vg = vb[:, col_idx.long().clamp(min=0)]                # (N, nrb, K, blk, hd)
    out = torch.einsum("nrcpq,nrcqh->nrph", p_blocks.to(v.dtype), vg)
    return out.reshape(N, S, hd)


def fused_ref(q, k, v, col_idx, *, block, causal=False, sliding_window=None):
    """Fused oracle = sddmm -> sparse softmax -> spmm."""
    s = sddmm_ref(q, k, col_idx, block=block, causal=causal,
                  sliding_window=sliding_window)
    p = sparse_softmax_ref(s, col_idx, block=block, seq_len=q.shape[1],
                           causal=causal, sliding_window=sliding_window)
    return spmm_ref(p, v, col_idx).to(q.dtype)
