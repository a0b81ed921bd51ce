"""Transformer with a loop over stacked layers: the decoder LM (the dense
family) and the encoder (spion-lra: LayerNorm, relu MLP, learned positions,
non-causal).

SPION hooks: `spion` (per-layer BCSR tables or a SparseAttentionExec)
switches self-attention to the block-sparse path; `capture` streams pooled
conv scores for pattern generation during the dense phase. With cfg.remat
each layer is recomputed in the backward (torch.utils.checkpoint), as the
JAX package's jax.checkpoint of the scanned layer.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.attention_exec import SparseAttentionExec
from repro_torch.core.kv_pool import PagedKVCache, scatter_token, write_target
from repro_torch.models import attention as A
from repro_torch.models import layers as Lyr


MAX_POS = 65_536  # learned-position table bound (largest non-RoPE shape)


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def init(cfg, generator, device):
    """Random parameters with the JAX package's keys, shapes and init
    scales, drawn from `generator` on `device`, per-layer tensors stacked
    on a leading layer axis."""
    dtype = _dtype(cfg)
    L, d = cfg.num_layers, cfg.d_model
    layers = {
        "attn_norm": Lyr.norm_init(cfg, device, layers=L),
        "attn": A.attn_init(generator, cfg, dtype, device, layers=L),
        "mlp_norm": Lyr.norm_init(cfg, device, layers=L),
        "mlp": Lyr.mlp_init(generator, cfg, dtype, device, layers=L),
    }

    def embed_init():
        w = torch.randn((cfg.vocab_size, d), generator=generator,
                        device=device)
        return {"w": (w * 0.02).to(dtype)}
    params = {
        "tok_embed": embed_init(),
        "layers": layers,
        "final_norm": Lyr.norm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init()
    if not cfg.rope_theta:
        w = torch.randn((MAX_POS, d), generator=generator, device=device)
        params["pos_embed"] = {"w": (w * 0.02).to(dtype)}
    return Lyr.ParamTree(params)


def _head(params):
    return params["lm_head" if "lm_head" in params else "tok_embed"]


def _block(cfg, lp, h, positions, ex, sp, capture=None):
    """One layer; returns (h, (k, v), captured) with the layer's RoPE'd k/v
    and, with `capture`, its (pooled, frob_sq) scores (else None)."""
    x = Lyr.norm(cfg, lp["attn_norm"], h)
    q, k, v = A.qkv(cfg, lp["attn"], x, positions)
    cap = None
    if capture is not None:
        cap = A.capture_pooled_scores(cfg, q, k, positions, positions,
                                      capture["filt"], capture["block"])
    if sp is not None:
        ctx = ex.attend(cfg, q, k, v, sp)
    else:
        ctx = A.dense_attention(cfg, q, k, v, positions, positions)
    h = h + A.attn_out(cfg, lp["attn"], ctx)
    x = Lyr.norm(cfg, lp["mlp_norm"], h)
    return h + Lyr.mlp(cfg, lp["mlp"], x), (k, v), cap


def _block_h(cfg, lp, positions, ex, sp, h):
    return _block(cfg, lp, h, positions, ex, sp)[0]


def _embed_inputs(cfg, params, batch, dtype):
    h = Lyr.embed(params["tok_embed"], batch["tokens"], dtype)
    S = h.shape[1]
    positions = torch.arange(S, device=h.device)
    if not cfg.rope_theta and "pos_embed" in params:
        h = h + params["pos_embed"]["w"][:S].to(dtype)
    return h, positions


def forward(params, cfg, batch, *, spion=None, capture=None,
            collect_kv=False):
    """batch: {'tokens': (B,S)} -> (logits (B,S,V), aux).

    spion: None | SparseAttentionExec | tables dict payload.
    capture: None | {'filt': (F,), 'block': int} -> aux["captured"] is
             ((Ly, S/B, S/B) pooled conv scores, (Ly,) Frobenius terms) for
             pattern generation.
    collect_kv: also return the per-layer RoPE'd K/V, stacked
             (L,B,S,KV,hd) — the fused serving prefill writes them into
             cache pages. Return becomes (logits, aux, (ks, vs))."""
    dtype = _dtype(cfg)
    ex = SparseAttentionExec.coerce(spion)
    h, positions = _embed_inputs(cfg, params, batch, dtype)
    tabs = None if ex is None else ex.scan_tables()
    remat = cfg.remat and torch.is_grad_enabled() and capture is None \
        and not collect_kv
    ks, vs, caps = [], [], []
    for li in range(cfg.num_layers):
        lp = Lyr.layer_view(params["layers"], li)
        sp = None if tabs is None else {k: t[li] for k, t in tabs.items()}
        if remat:
            # the layer is run again in the backward: bind this layer's
            # arguments now, not the loop variables
            h = checkpoint(functools.partial(_block_h, cfg, lp, positions,
                                             ex, sp), h, use_reentrant=False)
            continue
        h, (k, v), cap = _block(cfg, lp, h, positions, ex, sp, capture)
        if collect_kv:
            ks.append(k)
            vs.append(v)
        if capture is not None:
            caps.append(cap)
    h = Lyr.norm(cfg, params["final_norm"], h)
    logits = Lyr.unembed(_head(params), h)
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    aux = {"lb_loss": zero, "z_loss": zero}
    if capture is not None:
        aux["captured"] = (torch.stack([c[0] for c in caps]),
                           torch.stack([c[1] for c in caps]))
    if collect_kv:
        return logits, aux, (torch.stack(ks), torch.stack(vs))
    return logits, aux


# ---------------------------------------------------------------------------
# decode (KV cache)
# ---------------------------------------------------------------------------

def init_cache(cfg, batch_size, max_len, dtype=None, device="cpu"):
    dtype = dtype or getattr(torch, cfg.cache_dtype or cfg.dtype)
    hd = cfg.resolved_head_dim
    shape = (cfg.num_layers, batch_size, max_len, cfg.num_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _decode_layers(params, cfg, tokens, pos, attend):
    """The decode layer loop shared by the contiguous and paged caches:
    `attend(li, q, k_new, v_new, posb)` writes the new token into layer
    li's cache and returns the attention context."""
    dtype = _dtype(cfg)
    B = tokens.shape[0]
    posb = A.decode_positions(pos, B, tokens.device)
    h = Lyr.embed(params["tok_embed"], tokens, dtype)
    positions = posb[:, None]
    for li in range(cfg.num_layers):
        lp = Lyr.layer_view(params["layers"], li)
        x = Lyr.norm(cfg, lp["attn_norm"], h)
        q, k_new, v_new = A.qkv(cfg, lp["attn"], x, positions)
        ctx = attend(li, q, k_new, v_new, posb)
        h = h + A.attn_out(cfg, lp["attn"], ctx)
        x = Lyr.norm(cfg, lp["mlp_norm"], h)
        h = h + Lyr.mlp(cfg, lp["mlp"], x)
    h = Lyr.norm(cfg, params["final_norm"], h)
    return Lyr.unembed(_head(params), h)[:, 0]


def decode_step(params, cfg, cache, tokens, pos, *, spion=None):
    """tokens (B,1) at absolute position `pos` — a scalar (every row at the
    same position) or a (B,) vector of per-row positions (the
    continuous-batching engine). Returns (logits (B,V), cache); the cache is
    updated in place.

    spion: None | SparseAttentionExec (phase "decode") | tables payload —
    when present, attention gathers only the cache blocks the query
    position's pattern row lists.

    The cache is either the contiguous per-slot dict {"k","v"} from
    `init_cache` or a core.kv_pool.PagedKVCache, whose pool takes an O(B)
    scatter per layer (kv_pool.scatter_token)."""
    if cfg.sliding_window:
        raise NotImplementedError(
            "sliding-window ring caches are not ported yet (ROADMAP A9)")
    if isinstance(cache, PagedKVCache):
        return _paged_decode_step(params, cfg, cache, tokens, pos,
                                  spion=spion)
    ex = SparseAttentionExec.coerce(spion, phase="decode")
    tabs = None if ex is None else ex.scan_tables()

    def attend(li, q, k_new, v_new, posb):
        kc, vc = A.update_cache(cache["k"][li], cache["v"][li], k_new, v_new,
                                posb)
        if tabs is not None:
            return ex.decode(cfg, q, kc, vc, posb,
                             {k: t[li] for k, t in tabs.items()})
        return A.decode_attention(cfg, q, kc, vc, posb)

    return _decode_layers(params, cfg, tokens, pos, attend), cache


def _paged_decode_step(params, cfg, cache, tokens, pos, *, spion=None):
    """`decode_step` over a PagedKVCache: each layer scatter-writes the new
    token into the row's active physical page, and attention gathers
    through the page table — sparse (exec.decode_paged) or dense
    (attention.paged_decode_attention)."""
    ex = SparseAttentionExec.coerce(spion, phase="decode")
    tabs = None if ex is None else ex.scan_tables()
    pt = cache.pt
    posb = A.decode_positions(pos, tokens.shape[0], tokens.device)
    phys_w, off_w = write_target(pt, posb, cache.page)

    def attend(li, q, k_new, v_new, posb):
        scatter_token(cache.kp, cache.vp, li, k_new, v_new, phys_w, off_w)
        if tabs is not None:
            return ex.decode_paged(cfg, q, cache.kp, cache.vp, li, posb, pt,
                                   {k: t[li] for k, t in tabs.items()})
        return A.paged_decode_attention(cfg, q, cache.kp, cache.vp, li, posb,
                                        pt, page=cache.page)

    return _decode_layers(params, cfg, tokens, pos, attend), cache


def prefill_step(params, cfg, batch, *, spion=None):
    """Fused serving prefill: one full-sequence forward over the prompt that
    also returns every layer's RoPE'd K/V for direct insertion into decode
    cache pages — (logits (B,S,V), ks (L,B,S,KV,hd), vs (L,B,S,KV,hd)).

    Causality makes padding free: logits and K/V at positions < P are
    unaffected by whatever sits after the prompt, so the serving engine can
    pad prompts to a bucketed length and insert only the real positions."""
    logits, _aux, (ks, vs) = forward(params, cfg, batch, spion=spion,
                                     collect_kv=True)
    return logits, ks, vs
