"""Whisper-family encoder-decoder backbone (whisper-tiny). The mel/conv
frontend is a stub: batch["frames"] carries precomputed frame embeddings
(B, S_enc, d). Sinusoidal positions on the encoder, learned ones on the
decoder, LayerNorm and a GELU MLP, as in the JAX package.

The encoder runs dense, non-causal attention. SPION applies to the
decoder's causal self-attention, through `ex.attend` on the layer's tables
(the Hopper kernels on the card). The decoder's cross-attention over the
encoder output is dense and non-causal, with no RoPE, and stays the plain
`dense_attention`. With cfg.remat each encoder and decoder layer is
recomputed in the backward (torch.utils.checkpoint), as the JAX package's
jax.checkpoint of the scanned layer.

Under a mesh with a 'seq' axis each rank holds a contiguous shard of the
frames and one of the decoder tokens: positions (sinusoidal and learned)
are the shard's global ones, the encoder's and the decoder's dense
attention and the capture read the whole sequence's K/V (distributed.
sharding.gather_kv), the decoder's sparse attention shards over 'seq'
(kernels/sharded.py, or the gather path on CPU tensors), and the
cross-attention reads the whole encoder output, gathered once over the
line.

Under a mesh with a 'model' axis each rank runs its heads of every
attention (the encoder's, the decoder's and the cross-attention, whose
K/V projections read the encoder output through `copy_to_model` in
`attention.qkv`, so its gradient is whole) and its d_ff shard of every
MLP; the tied embedding and head are vocab-parallel where |model| divides
the vocabulary (whisper-tiny's 51,865 does not: replicated, as the
reference's `sanitize_spec` leaves it).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.attention_exec import SparseAttentionExec
from repro_torch.core.kv_pool import (PagedKVCache, rows_and_targets,
                                      write_token)
from repro_torch.distributed.sharding import (current_mesh, gather_kv,
                                              gather_seq, mesh_context,
                                              seq_positions)
from repro_torch.models import attention as A
from repro_torch.models import layers as Lyr
from repro_torch.models.layers import ParamTree


MAX_POS = 65_536  # learned-position table bound (largest non-RoPE shape)


def _enc_cfg(cfg):
    return cfg.replace(causal=False)


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def _ln(p, h):
    """LayerNorm with fp32 statistics, cast back to h's dtype."""
    return Lyr.layernorm(p, h.float()).to(h.dtype)


def init(cfg, generator, device):
    """Random parameters with the JAX package's keys, shapes and init
    scales, drawn from `generator` on `device`: encoder and decoder layers
    stacked on a leading layer axis, the decoder's with a cross-attention
    and its norm, the token embedding tied to the LM head."""
    dtype = _dtype(cfg)
    d = cfg.d_model

    def ln(layers=None):
        shape = (d,) if layers is None else (layers, d)
        return {"scale": torch.ones(shape, dtype=torch.float32, device=device),
                "bias": torch.zeros(shape, dtype=torch.float32, device=device)}

    def layers(n, cross):
        p = {"attn_norm": ln(n),
             "attn": A.attn_init(generator, cfg, dtype, device, layers=n),
             "mlp_norm": ln(n),
             "mlp": Lyr.mlp_init(generator, cfg, dtype, device, layers=n)}
        if cross:
            p["cross_norm"] = ln(n)
            p["cross"] = A.attn_init(generator, cfg, dtype, device, layers=n)
        return p

    def normal(rows):
        w = torch.randn((rows, d), generator=generator, device=device)
        return {"w": (w * 0.02).to(dtype)}
    return ParamTree({
        "enc_layers": layers(cfg.encoder_layers, False),
        "enc_norm": ln(),
        "tok_embed": normal(cfg.vocab_size),
        "pos_embed": normal(MAX_POS),
        "dec_layers": layers(cfg.num_layers, True),
        "final_norm": ln(),
    })


def _enc_block(cfg, lp, positions, kv_pos, mesh, h):
    """One encoder layer under the forward's `mesh` (the remat backward
    runs it again on autograd's device thread, where the forward's mesh
    context is not set)."""
    ecfg = _enc_cfg(cfg)
    with mesh_context(mesh):
        q, k, v = A.qkv(ecfg, lp["attn"], _ln(lp["attn_norm"], h), positions)
        kg, vg = gather_kv(k, v)
        ctx = A.dense_attention(ecfg, q, kg, vg, positions, kv_pos)
        h = h + A.attn_out(ecfg, lp["attn"], ctx)
        return h + Lyr.mlp(cfg, lp["mlp"], _ln(lp["mlp_norm"], h))


def encode(params, cfg, frames):
    """frames (B, S_enc, d) -> the encoder output (B, S_enc, d) in
    cfg.dtype: sinusoidal positions, dense non-causal layers. On a 'seq'
    shard the frames and the output are the shard's rows."""
    dtype = _dtype(cfg)
    h = frames.to(dtype)
    S = h.shape[1]
    start, positions, kv_pos = seq_positions(S, h.device)
    # the whole sequence's table, cut at this shard's rows
    table = Lyr.sinusoidal_positions(kv_pos.shape[0], cfg.d_model, h.device)
    h = h + table[start:start + S].to(dtype)[None]
    remat = cfg.remat and torch.is_grad_enabled()
    for li in range(cfg.encoder_layers):
        block = functools.partial(
            _enc_block, cfg, Lyr.layer_view(params["enc_layers"], li),
            positions, kv_pos, current_mesh())
        h = checkpoint(block, h, use_reentrant=False) if remat else block(h)
    return _ln(params["enc_norm"], h)


def _cross_kv(cfg, p, enc):
    """The cross-attention's K/V of the encoder output (no RoPE)."""
    positions = torch.arange(enc.shape[1], device=enc.device)
    _, kc, vc = A.qkv(_enc_cfg(cfg), p, enc, positions)
    return kc, vc


def _dec_block(cfg, lp, positions, kv_pos, ex, sp, capture, h, enc):
    """One decoder layer over the whole encoder output `enc`; `positions`
    are h's rows' global positions, `kv_pos` the whole sequence's. Returns
    (h, captured (pooled, frob_sq) or None)."""
    q, k, v = A.qkv(cfg, lp["attn"], _ln(lp["attn_norm"], h), positions)
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
    ccfg = _enc_cfg(cfg)
    qc, _, _ = A.qkv(ccfg, lp["cross"], _ln(lp["cross_norm"], h), positions)
    kc, vc = _cross_kv(cfg, lp["cross"], enc)
    enc_positions = torch.arange(enc.shape[1], device=enc.device)
    ctx = A.dense_attention(ccfg, qc, kc, vc, positions, enc_positions)
    h = h + A.attn_out(ccfg, lp["cross"], ctx)
    return h + Lyr.mlp(cfg, lp["mlp"], _ln(lp["mlp_norm"], h)), cap


def _dec_block_h(cfg, lp, positions, kv_pos, ex, sp, mesh, h, enc):
    """The remat form of `_dec_block` under the forward's `mesh` (the
    backward runs it again on autograd's device thread)."""
    with mesh_context(mesh):
        return _dec_block(cfg, lp, positions, kv_pos, ex, sp, None, h,
                          enc)[0]


def forward(params, cfg, batch, *, spion=None, capture=None):
    """batch: frames (B, S_enc, d), tokens (B, S_dec) -> (logits (B, S_dec,
    V), aux). `spion` (a SparseAttentionExec or a tables payload, stacked
    over the decoder layers) makes the decoder's self-attention
    block-sparse; cross-attention stays dense. capture: aux["captured"] is
    ((L, S/B, S/B) pooled scores, (L,) Frobenius terms), one per decoder
    layer. On a 'seq' shard `frames` and `tokens` are the shard's rows,
    the cross-attention reads the whole encoder output (one gather over
    the line) and every rank returns the whole capture."""
    dtype = _dtype(cfg)
    ex = SparseAttentionExec.coerce(spion)
    enc = gather_seq(encode(params, cfg, batch["frames"]), 1)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    start, positions, kv_pos = seq_positions(S, tokens.device)
    h = Lyr.embed(params["tok_embed"], tokens, dtype, vocab=cfg.vocab_size)
    h = h + params["pos_embed"]["w"][start:start + S].to(dtype)[None]
    remat = cfg.remat and torch.is_grad_enabled() and capture is None
    caps = []
    for li in range(cfg.num_layers):
        lp = Lyr.layer_view(params["dec_layers"], li)
        sp = None if ex is None else ex.layer(li)
        if remat:
            # the layer is run again in the backward: bind this layer's
            # arguments now, not the loop variables
            h = checkpoint(functools.partial(_dec_block_h, cfg, lp,
                                             positions, kv_pos, ex, sp,
                                             current_mesh()),
                           h, enc, use_reentrant=False)
            continue
        h, cap = _dec_block(cfg, lp, positions, kv_pos, ex, sp, capture, h,
                            enc)
        if capture is not None:
            caps.append(cap)
    h = _ln(params["final_norm"], h)
    logits = Lyr.unembed(params["tok_embed"], h, vocab=cfg.vocab_size)
    aux = {}
    if capture is not None:
        aux["captured"] = (torch.stack([c[0] for c in caps]),
                           torch.stack([c[1] for c in caps]))
    return logits, aux


# -- decode ------------------------------------------------------------------

def init_cache(cfg, batch_size, max_len, enc_len=None, dtype=None,
               device="cpu"):
    """The decoder's self-attention K/V at `max_len` and the precomputed
    cross-attention K/V ("ck", "cv") at `enc_len` (default: max_len, as in
    the JAX package), zeros in `dtype` (default cfg.dtype)."""
    dtype = dtype or _dtype(cfg)
    hd = cfg.resolved_head_dim
    enc_len = enc_len or max_len
    L, KV = cfg.num_layers, cfg.num_kv_heads

    def zeros(S):
        return torch.zeros((L, batch_size, S, KV, hd), dtype=dtype,
                           device=device)
    return {"k": zeros(max_len), "v": zeros(max_len),
            "ck": zeros(enc_len), "cv": zeros(enc_len)}


def precompute_cross(params, cfg, frames):
    """Run the encoder once; return every decoder layer's cross K/V,
    stacked (L, B, S_enc, KV, hd), for a cache's "ck" / "cv"."""
    enc = encode(params, cfg, frames)
    kvs = [_cross_kv(cfg, Lyr.layer_view(params["dec_layers"], li)["cross"],
                     enc) for li in range(cfg.num_layers)]
    return (torch.stack([k for k, _ in kvs]),
            torch.stack([v for _, v in kvs]))


def decode_step(params, cfg, cache, tokens, pos, *, spion=None):
    """tokens (B, 1) at `pos` (scalar or (B,) per-row positions) ->
    (logits (B, V), cache), the cache updated in place. `spion` (exec or
    payload) switches the decoder's self-attention to the pattern-bounded
    sparse decode; cross-attention reads the whole precomputed encoder K/V
    either way.

    Paged form: cache {"kv": core.kv_pool.PagedKVCache, "ck", "cv"} — the
    decoder's self-attention K/V live in the page pool, while the cross
    K/V stay contiguous (written once at admission, never grown)."""
    kvp = cache.get("kv")
    paged = isinstance(kvp, PagedKVCache)
    ex = SparseAttentionExec.coerce(spion, phase="decode")
    dtype = _dtype(cfg)
    B = tokens.shape[0]
    posb = A.decode_positions(pos, B, tokens.device)
    h = Lyr.embed(params["tok_embed"], tokens, dtype, vocab=cfg.vocab_size)
    h = h + params["pos_embed"]["w"][posb.long()].to(dtype)[:, None]
    positions = posb[:, None]
    ccfg = _enc_cfg(cfg)
    enc_last = A.cache_length(cache["ck"][0]) - 1
    if paged:
        pt, phys_w, off_w = rows_and_targets(kvp, posb, ring=False)

    def attend(li, q, k_new, v_new):
        if paged:
            write_token(kvp.kp, kvp.vp, li, k_new, v_new, phys_w, off_w)
            if ex is not None:
                return ex.decode_paged(cfg, q, kvp.kp, kvp.vp, li, posb,
                                       pt, ex.layer(li))
            return A.paged_decode_attention(cfg, q, kvp.kp, kvp.vp, li, posb,
                                            pt, page=kvp.page)
        kc, vc = A.update_cache(cache["k"][li], cache["v"][li], k_new, v_new,
                                posb)
        if ex is not None:
            return ex.decode(cfg, q, kc, vc, posb, ex.layer(li))
        return A.decode_attention(cfg, q, kc, vc, posb)

    for li in range(cfg.num_layers):
        lp = Lyr.layer_view(params["dec_layers"], li)
        q, k_new, v_new = A.qkv(cfg, lp["attn"], _ln(lp["attn_norm"], h),
                                positions)
        h = h + A.attn_out(cfg, lp["attn"], attend(li, q, k_new, v_new))
        qc, _, _ = A.qkv(ccfg, lp["cross"], _ln(lp["cross_norm"], h),
                         positions)
        ctx = A.decode_attention(ccfg, qc, cache["ck"][li], cache["cv"][li],
                                 enc_last)
        h = h + A.attn_out(ccfg, lp["cross"], ctx)
        h = h + Lyr.mlp(cfg, lp["mlp"], _ln(lp["mlp_norm"], h))
    h = _ln(params["final_norm"], h)
    return Lyr.unembed(params["tok_embed"], h, vocab=cfg.vocab_size)[:, 0], \
        cache
