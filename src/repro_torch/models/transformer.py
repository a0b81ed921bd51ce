"""Transformer with a loop over stacked layers: the decoder LM (the dense,
moe and vlm families: qwen2-7b, qwen2.5-14b, command-r-35b,
mistral-large-123b, mixtral-8x7b, arctic-480b, internvl2-2b, whose
precomputed patch embeddings precede the text) and the encoder (spion-lra:
LayerNorm, relu MLP, learned positions, non-causal).

SPION hooks: `spion` (per-layer BCSR tables or a SparseAttentionExec)
switches self-attention to the block-sparse path; `capture` streams pooled
conv scores for pattern generation during the dense phase. With cfg.remat
each layer is recomputed in the backward (torch.utils.checkpoint), as the
JAX package's jax.checkpoint of the scanned layer.

Under a mesh with a 'seq' axis (distributed.sharding.mesh_context) each
rank holds a contiguous shard of the sequence (for vlm, of the [patches,
text] concatenation): RoPE and learned positions are the shard's global
positions, the dense attention and the capture read the whole sequence's
K/V (distributed.sharding.gather_kv, models/attention.
capture_pooled_scores), the sparse
attention shards over 'seq' (kernels/sharded.py, or the gather path on
CPU tensors) and the MoE routes whole rows (models/moe.moe_apply).

Under a mesh with a 'model' axis each rank holds its shard of the leaves
that distributed/sharding.param_pspecs splits: the layers run on local
heads, d_ff and experts, the embedding and the head on the rank's slice of
the vocabulary when |model| divides it (then `forward` returns this
rank's shard of the logits, which registry.loss_parts takes as such), and
the norms, learned positions and the vlm's patch embeddings enter whole.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.attention_exec import SparseAttentionExec
from repro_torch.core.kv_pool import (PagedKVCache, rows_and_targets,
                                      write_token)
from repro_torch.distributed.sharding import (current_mesh, gather_kv,
                                              gather_rows, mesh_context,
                                              own_rows, seq_positions)
from repro_torch.models import attention as A
from repro_torch.models import layers as Lyr
from repro_torch.models.moe import moe_apply, moe_init


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
    }
    if cfg.moe is not None:
        layers["moe"] = moe_init(generator, cfg, dtype, device, layers=L)
    else:
        layers["mlp"] = Lyr.mlp_init(generator, cfg, dtype, device, layers=L)

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


def _ffn(cfg, lp, x):
    """The layer's feed-forward: (y, aux) — the MoE and its fp32 aux
    losses, or the dense MLP and None."""
    if cfg.moe is not None:
        y, aux = moe_apply(cfg, lp["moe"], x)
        return y, (aux["lb_loss"].float(), aux["z_loss"].float())
    return Lyr.mlp(cfg, lp["mlp"], x), None


def _block(cfg, lp, h, positions, kv_pos, ex, sp, capture=None):
    """One layer; returns (h, (k, v), captured, aux) with the layer's
    RoPE'd k/v, with `capture` its (pooled, frob_sq) scores (else None),
    and its MoE's (lb_loss, z_loss) (None for a dense MLP). `positions`
    are h's rows' global positions, `kv_pos` the whole sequence's (the
    same tensor without a 'seq' axis)."""
    x = Lyr.norm(cfg, lp["attn_norm"], h)
    q, k, v = A.qkv(cfg, lp["attn"], x, positions)
    cap = None
    if capture is not None:
        cap = A.capture_pooled_scores(cfg, q, k, positions, kv_pos,
                                      capture["filt"], capture["block"])
    if sp is not None:
        ctx = ex.attend(cfg, q, k, v, sp)
    else:
        kg, vg = gather_kv(k, v)
        ctx = A.dense_attention(cfg, q, kg, vg, positions, kv_pos)
    h = h + A.attn_out(cfg, lp["attn"], ctx)
    x = Lyr.norm(cfg, lp["mlp_norm"], h)
    y, aux = _ffn(cfg, lp, x)
    return h + y, (k, v), cap, aux


def _block_h(cfg, lp, positions, kv_pos, ex, sp, mesh, h):
    """The remat form of `_block` under the forward's `mesh`: the backward
    runs it again, on autograd's device thread for CUDA tensors, where the
    forward's mesh context is not set."""
    with mesh_context(mesh):
        h, _, _, aux = _block(cfg, lp, h, positions, kv_pos, ex, sp)
    return (h, *(aux or ()))


def _embed_inputs(cfg, params, batch, dtype):
    """Embeddings, their global positions and the whole sequence's
    positions. Under a 'seq' axis the batch is this rank's shard, whose
    first row sits at `seq_start` (vlm: counting the patches)."""
    h = Lyr.embed(params["tok_embed"], batch["tokens"], dtype,
                  vocab=cfg.vocab_size)
    if cfg.num_patch_tokens and "patch_embeds" in batch:
        # vlm: the frontend's patch embeddings precede the text
        h = torch.cat([batch["patch_embeds"].to(dtype), h], dim=1)
    S = h.shape[1]
    start, positions, kv_pos = seq_positions(S, h.device)
    if not cfg.rope_theta and "pos_embed" in params:
        h = h + params["pos_embed"]["w"][start:start + S].to(dtype)
    return h, positions, kv_pos


def forward(params, cfg, batch, *, spion=None, capture=None,
            collect_kv=False):
    """batch: {'tokens': (B,S') [, 'patch_embeds': (B,P,d)]} -> (logits
    (B,S,V), aux), S = P + S' with patches.

    spion: None | SparseAttentionExec | tables dict payload.
    capture: None | {'filt': (F,), 'block': int} -> aux["captured"] is
             ((Ly, S/B, S/B) pooled conv scores, (Ly,) Frobenius terms) for
             pattern generation.
    collect_kv: also return the per-layer RoPE'd K/V, stacked
             (L,B,S,KV,hd) — the fused serving prefill writes them into
             cache pages. Return becomes (logits, aux, (ks, vs))."""
    dtype = _dtype(cfg)
    ex = SparseAttentionExec.coerce(spion)
    h, positions, kv_pos = _embed_inputs(cfg, params, batch, dtype)
    tabs = None if ex is None else ex.scan_tables()
    remat = cfg.remat and torch.is_grad_enabled() and capture is None \
        and not collect_kv
    ks, vs, caps, auxs = [], [], [], []
    for li in range(cfg.num_layers):
        lp = Lyr.layer_view(params["layers"], li)
        sp = None if tabs is None else {k: t[li] for k, t in tabs.items()}
        if remat:
            # the layer is run again in the backward: bind this layer's
            # arguments now, not the loop variables
            h, *la = checkpoint(functools.partial(
                _block_h, cfg, lp, positions, kv_pos, ex, sp,
                current_mesh()), h, use_reentrant=False)
            if la:
                auxs.append(la)
            continue
        h, (k, v), cap, la = _block(cfg, lp, h, positions, kv_pos, ex, sp,
                                    capture)
        if la is not None:
            auxs.append(la)
        if collect_kv:
            ks.append(k)
            vs.append(v)
        if capture is not None:
            caps.append(cap)
    h = Lyr.norm(cfg, params["final_norm"], h)
    logits = Lyr.unembed(_head(params), h, vocab=cfg.vocab_size)
    if auxs:     # the MoE's, averaged over layers
        lb, z = (torch.stack(a).mean() for a in zip(*auxs))
    else:
        lb = z = torch.zeros((), dtype=torch.float32, device=h.device)
    aux = {"lb_loss": lb, "z_loss": z}
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
    li's cache and returns the attention context. The MoE of a decode step
    routes its B tokens as one dispatch group."""
    dtype = _dtype(cfg)
    B = tokens.shape[0]
    posb = A.decode_positions(pos, B, tokens.device)
    h = Lyr.embed(params["tok_embed"], tokens, dtype, vocab=cfg.vocab_size)
    positions = posb[:, None]
    for li in range(cfg.num_layers):
        lp = Lyr.layer_view(params["layers"], li)
        x = Lyr.norm(cfg, lp["attn_norm"], h)
        q, k_new, v_new = A.qkv(cfg, lp["attn"], x, positions)
        ctx = attend(li, q, k_new, v_new, posb)
        h = h + A.attn_out(cfg, lp["attn"], ctx)
        x = Lyr.norm(cfg, lp["mlp_norm"], h)
        h = h + _decode_ffn(cfg, lp, x)
    h = Lyr.norm(cfg, params["final_norm"], h)
    return Lyr.unembed(_head(params), h, vocab=cfg.vocab_size)[:, 0]


def _decode_ffn(cfg, lp, x):
    """A decode step's feed-forward. The MoE routes the batch's tokens as
    one dispatch group, as in one process: on a cache shard whose rows
    split over the data axes the rows are gathered for it and this rank's
    kept (`distributed.sharding.gather_rows`)."""
    if cfg.moe is None:
        return Lyr.mlp(cfg, lp["mlp"], x)
    return own_rows(moe_apply(cfg, lp["moe"], gather_rows(x))[0])


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
    scatter per layer (kv_pool.scatter_token). Sliding-window archs use
    the cache as a ring: position p lives in slot p % cache_len."""
    if isinstance(cache, PagedKVCache):
        return _paged_decode_step(params, cfg, cache, tokens, pos,
                                  spion=spion)
    ex = SparseAttentionExec.coerce(spion, phase="decode")
    tabs = None if ex is None else ex.scan_tables()
    ring = bool(cfg.sliding_window)
    # the whole cache's length (a shard holds part of its positions)
    cache_len = A.cache_length(cache["k"][0])

    def attend(li, q, k_new, v_new, posb):
        slot = A.cache_slot(cfg, posb, cache_len) if ring else posb
        kc, vc = A.update_cache(cache["k"][li], cache["v"][li], k_new, v_new,
                                slot)
        if tabs is not None:
            return ex.decode(cfg, q, kc, vc, posb,
                             {k: t[li] for k, t in tabs.items()}, ring=ring)
        kpos = A.ring_kpos(posb, cache_len) if ring else None
        return A.decode_attention(cfg, q, kc, vc, posb, kpos=kpos)

    return _decode_layers(params, cfg, tokens, pos, attend), cache


def _paged_decode_step(params, cfg, cache, tokens, pos, *, spion=None):
    """`decode_step` over a PagedKVCache: each layer scatter-writes the new
    token into the row's active physical page, and attention gathers
    through the page table — sparse (exec.decode_paged) or dense
    (attention.paged_decode_attention). Under a mesh the pool is
    replicated: the rank decodes its rows with its KV heads or head_dim
    columns, and writes every row's and head's K/V (core/kv_pool.py)."""
    ex = SparseAttentionExec.coerce(spion, phase="decode")
    tabs = None if ex is None else ex.scan_tables()
    posb = A.decode_positions(pos, tokens.shape[0], tokens.device)
    ring = bool(cfg.sliding_window)
    pt, phys_w, off_w = rows_and_targets(cache, posb, ring=ring)

    def attend(li, q, k_new, v_new, posb):
        write_token(cache.kp, cache.vp, li, k_new, v_new, phys_w, off_w)
        if tabs is not None:
            return ex.decode_paged(cfg, q, cache.kp, cache.vp, li, posb, pt,
                                   {k: t[li] for k, t in tabs.items()},
                                   ring=ring)
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
