"""Attention: dense GQA (train/prefill), KV-cache decode with scalar or
PER-ROW positions — the continuous-batching engine decodes every cache slot
at its own offset — and the SPION pattern capture, which streams pooled
diagonal-conv scores without ever holding the L x L attention matrix.

Sparse-phase execution is owned by core.attention_exec.SparseAttentionExec.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import he_init, rope


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


def qkv(cfg, p, x, positions):
    """x (B,S,d) -> q (B,S,H,hd), k/v (B,S,KV,hd), RoPE applied."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.rope_theta:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
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

    q (B,Sq,H,hd); k,v (B,Sk,KV,hd) -> (B,Sq,H,hd). Chunked over query rows
    so the S x S score matrix is never resident; under autograd each chunk
    is recomputed in the backward (the JAX package's per-chunk
    jax.checkpoint), so only one chunk's scores are held at a time."""
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
    B, S = ctx.shape[:2]
    return ctx.reshape(B, S, -1) @ p["wo"].to(ctx.dtype)


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
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    S = k_cache.shape[1]
    posb = decode_positions(pos, B, q.device)
    qg = q.reshape(B, KV, G, hd)
    k_cache = k_cache.to(q.dtype)
    v_cache = v_cache.to(q.dtype)
    scores = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).float() / \
        math.sqrt(hd)
    if kpos is None:
        kpos = torch.arange(S, device=q.device)
    kpos = kpos.expand(B, S)
    ok = (kpos >= 0) & (kpos <= posb[:, None])
    if cfg.sliding_window:
        ok = ok & (kpos > posb[:, None] - cfg.sliding_window)
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
    Where every block is mapped this is bitwise-identical to the contiguous
    dense decode."""
    B = q.shape[0]
    NB = page_table.shape[1]
    KV, hd = kp.shape[3], kp.shape[4]
    S = NB * page
    posb = decode_positions(pos, B, q.device)
    phys = page_table.clamp(min=0).long()
    kflat = kp[layer][phys].reshape(B, S, KV, hd)
    vflat = vp[layer][phys].reshape(B, S, KV, hd)
    base = torch.arange(S, device=q.device).expand(B, S)
    mapped = (page_table >= 0).repeat_interleave(page, dim=1)
    kpos = torch.where(mapped, base, -1)
    out = decode_attention(cfg, q, kflat, vflat, posb, kpos=kpos)
    # a fully-unmapped row (reclaimed serving slot parked on the scratch
    # page) softmaxes over all -inf -> NaN; that NaN would be scattered into
    # the SHARED scratch page next layer and 0*NaN-poison every other row's
    # clamped gathers. Force such rows to zero context (mapped rows pick
    # their already-computed value — bitwise-neutral).
    any_ok = (page_table >= 0).any(dim=1)
    return torch.where(any_ok[:, None, None, None], out, 0.0)


def update_cache(k_cache, v_cache, k_new, v_new, slot):
    """Insert one token's k/v at index `slot`, in place. Caches (B,S,KV,hd);
    new (B,1,KV,hd). `slot` scalar writes every row at the same index; a
    (B,) vector writes each row at its own slot, so one slot's decode can
    never touch another slot's cache row."""
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

@torch.no_grad()
def capture_pooled_scores(cfg, q, k, q_pos, k_pos, filt, block: int):
    """Return (pooled, frob_sq):
      pooled  = avgpool_BxB( diagconv_F(A^s) ) of the *head-and-batch-averaged*
                attention probabilities, shape (L/B, L/B), streamed one block
                row at a time so peak memory is O(block x L), not O(L^2);
      frob_sq = sum(A^s ** 2) of the averaged scores (Eq. 2 transition term).

    Matches paper Eq. 3 (conv_out(i,j) = sum_f A(i+f, j+f) filter(f)) with
    zero padding, then Eq. 4 average pooling. Statistics only: no gradient.
    """
    B_, Sq, H, hd = q.shape
    L = k.shape[1]
    nf = int(filt.shape[0])
    filt = filt.to(device=q.device, dtype=torch.float32)
    nb, nbk = Sq // block, L // block
    KV = k.shape[2]
    G = H // KV
    panel = block  # one block row of conv output per step; needs nf halo rows
    # q rows padded by nf so every panel is in bounds; padded rows are
    # zeroed after the softmax (Eq. 3 zero padding)
    qp_ = F.pad(q, (0, 0, 0, 0, 0, nf))
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
        valid = (r0 + torch.arange(rows, device=q.device)) < Sq
        a = torch.where(valid[:, None], a, 0.0)
        frob = frob + (a[:panel] ** 2).sum()
        # conv rows r0..r0+block: sum_f w_f * A[r + f, columns shifted by f]
        padded = F.pad(a, (0, nf))
        conv = torch.zeros((panel, L), dtype=torch.float32, device=q.device)
        for f in range(nf):
            conv = conv + filt[f] * padded[f:f + panel, f:f + L]
        outs.append(conv.reshape(block, nbk, block).mean(dim=(0, 2)))
    return torch.stack(outs), frob      # (Sq/B, L/B), scalar
