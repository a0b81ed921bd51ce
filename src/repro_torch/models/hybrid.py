"""zamba2 hybrid: Mamba2 backbone + ONE shared attention block applied every
k-th layer (weight sharing across applications — the zamba trick). SPION
applies to the shared attention block only; each *application* gets its own
layer-wise pattern, so the plan's tables are stacked over applications
(n_attn_apps), not over layers.

The reference's lax.cond on `idx % every == every - 1` is a Python branch
here, with an application counter. With cfg.remat only the Mamba part of a
layer is recomputed in the backward, as in the reference; the shared block
is not.

Under a mesh with a 'seq' axis each rank holds a contiguous shard of the
sequence: the Mamba layers carry their conv rows and scan state across the
shards (models/mamba.py), positions are the shard's global ones, the
shared block's dense attention and the capture read the whole sequence's
K/V (distributed.sharding.gather_kv, models/attention.
capture_pooled_scores) and its sparse attention shards over 'seq'
(kernels/sharded.py, or the gather path on CPU tensors).

Under a mesh with a 'model' axis each rank runs its share of every layer:
the Mamba2 layers on their SSM heads (models/mamba.py), the shared block's
attention on its q and KV heads and its MLP on its d_ff shard
(models/attention.py, layers.mlp), the embedding and head on its
vocabulary shard (the vocab-parallel loss); the capture averages the
heads over the line. Where |model| does not divide the SSM heads or B‖C
columns the Mamba2 layers take the reference's fallback (every head on
every rank, models/mamba.py) while the shared block keeps its own
`heads_split` decision, so the kernels still run on the rank's heads.
A paged pool under a mesh is replicated (core/kv_pool.py).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.attention_exec import SparseAttentionExec
from repro_torch.core.kv_pool import (PagedKVCache, rows_and_targets,
                                      write_token)
from repro_torch.distributed.sharding import (current_mesh, gather_kv,
                                              mesh_context, seq_positions)
from repro_torch.models import attention as A
from repro_torch.models import layers as Lyr
from repro_torch.models import mamba as M
from repro_torch.models.layers import ParamTree


def n_attn_apps(cfg):
    k = cfg.hybrid_attn_every
    return cfg.num_layers // k if k else 0


def _is_attn(cfg, idx):
    k = cfg.hybrid_attn_every
    return bool(k) and idx % k == k - 1


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def init(cfg, generator, device):
    """Random parameters with the reference's keys, shapes and init
    scales: the Mamba layers stacked on a leading layer axis, the shared
    block once."""
    dtype = _dtype(cfg)
    L, d = cfg.num_layers, cfg.d_model

    def rms(lead=()):
        return {"scale": torch.ones((*lead, d), dtype=torch.float32,
                                    device=device)}

    def embed_init():
        w = torch.randn((cfg.vocab_size, d), generator=generator,
                        device=device)
        return {"w": (w * 0.02).to(dtype)}
    layers = {"norm": rms((L,)),
              "mamba": M.mamba_init(generator, cfg, dtype, device, layers=L)}
    shared = {
        "attn_norm": rms(),
        "attn": A.attn_init(generator, cfg, dtype, device),
        "mlp_norm": rms(),
        "mlp": Lyr.mlp_init(generator, cfg, dtype, device),
    }
    return ParamTree({
        "tok_embed": embed_init(),
        "layers": layers,
        "shared_attn": shared,
        "final_norm": rms(),
        "lm_head": embed_init(),
    })


def _rms(p, h):
    return Lyr.rmsnorm(p, h.float()).to(h.dtype)


def _mamba_layer(cfg, lp, h):
    y, _ = M.mamba_apply(cfg, lp["mamba"], _rms(lp["norm"], h))
    return h + y


def _mamba_layer_h(cfg, lp, mesh, h):
    """The remat form of `_mamba_layer` under the forward's `mesh`: the
    backward runs it again, on autograd's device thread for CUDA tensors,
    where the forward's mesh context is not set."""
    with mesh_context(mesh):
        return _mamba_layer(cfg, lp, h)


def _mlp_tail(cfg, sp, h):
    return h + Lyr.mlp(cfg, sp["mlp"], _rms(sp["mlp_norm"], h))


def _shared_attn_block(cfg, sp, h, positions, kv_pos, ex, app_idx,
                       capture):
    """`ex` is the SparseAttentionExec (None -> dense); the shared block's
    tables are those of application `app_idx`. `positions` are h's rows'
    global positions, `kv_pos` the whole sequence's. Returns (h, captured
    (pooled, frob_sq) or None)."""
    x = _rms(sp["attn_norm"], h)
    q, k, v = A.qkv(cfg, sp["attn"], x, positions)
    cap = None
    if capture is not None:
        cap = A.capture_pooled_scores(cfg, q, k, positions, kv_pos,
                                      capture["filt"], capture["block"])
    if ex is not None:
        ctx = ex.attend_app(cfg, q, k, v, app_idx)
    else:
        kg, vg = gather_kv(k, v)
        ctx = A.dense_attention(cfg, q, kg, vg, positions, kv_pos)
    h = h + A.attn_out(cfg, sp["attn"], ctx)
    return _mlp_tail(cfg, sp, h), cap


def forward(params, cfg, batch, *, spion=None, capture=None):
    """batch {'tokens': (B,S)} -> (logits (B,S,V), aux). spion: None | exec
    | tables payload stacked over the n_attn_apps applications. capture:
    aux["captured"] is ((L, S/B, S/B) pooled scores, (L,) Frobenius
    terms), one per LAYER as in the reference, zeros where a layer has no
    attention. Application i reads row i of the stacked tables, and the
    plan the controller stacks over the captured layers is indexed so, as
    in the reference. On a 'seq' shard `tokens` is the shard's rows and
    every rank returns the whole (L, S/B, S/B) capture; on a 'model' axis
    that splits the vocabulary the logits are this rank's shard of it."""
    dtype = _dtype(cfg)
    ex = SparseAttentionExec.coerce(spion)
    h = Lyr.embed(params["tok_embed"], batch["tokens"], dtype,
                  vocab=cfg.vocab_size)
    _, positions, kv_pos = seq_positions(h.shape[1], h.device)
    shared = params["shared_attn"]
    remat = cfg.remat and torch.is_grad_enabled()
    caps, app = [], 0
    for idx in range(cfg.num_layers):
        lp = Lyr.layer_view(params["layers"], idx)
        if remat:
            h = checkpoint(functools.partial(_mamba_layer_h, cfg, lp,
                                             current_mesh()), h,
                           use_reentrant=False)
        else:
            h = _mamba_layer(cfg, lp, h)
        cap = None
        if _is_attn(cfg, idx):
            h, cap = _shared_attn_block(cfg, shared, h, positions, kv_pos,
                                        ex, app, capture)
            app += 1
        if capture is not None:
            if cap is None:
                # the whole sequence's map, as the captured layers'
                nb = kv_pos.shape[0] // capture["block"]
                cap = (torch.zeros((nb, nb), device=h.device),
                       torch.zeros((), device=h.device))
            caps.append(cap)
    h = _rms(params["final_norm"], h)
    logits = Lyr.unembed(params["lm_head"], h, vocab=cfg.vocab_size)
    aux = {}
    if capture is not None:
        aux["captured"] = (torch.stack([c[0] for c in caps]),
                           torch.stack([c[1] for c in caps]))
    return logits, aux


# -- decode ------------------------------------------------------------------

def init_cache(cfg, batch_size, max_len, dtype=None, device="cpu"):
    """Per-layer conv and ssm states (fp32) and the shared block's K/V, one
    slab per application, in `dtype` (default cfg.dtype, as the
    reference)."""
    dtype = dtype or _dtype(cfg)
    napps = n_attn_apps(cfg)
    hd = cfg.resolved_head_dim
    st = M.init_state(cfg, batch_size, device)
    kv = (napps, batch_size, max_len, cfg.num_kv_heads, hd)
    return {
        "conv": st["conv"].expand(cfg.num_layers, *st["conv"].shape).clone(),
        "ssm": st["ssm"].expand(cfg.num_layers, *st["ssm"].shape).clone(),
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
    }


def decode_step(params, cfg, cache, tokens, pos, *, spion=None):
    """tokens (B,1) at `pos` (scalar or (B,) per-row positions) -> (logits
    (B,V), cache), the cache updated in place. `spion` (exec or payload)
    makes each shared-attention application decode over only its pattern
    row's cache blocks (per-application tables, as in the forward).

    Paged form: cache {"conv", "ssm", "kv": core.kv_pool.PagedKVCache} —
    the shared block's per-application K/V live in a page pool whose layer
    axis is the application index, while the recurrent conv/ssm states stay
    contiguous (fixed-size, no paging win). Under a mesh the pool is
    replicated and the states are the rank's shards (core/kv_pool.py)."""
    kvp = cache.get("kv")
    paged = isinstance(kvp, PagedKVCache)
    dtype = _dtype(cfg)
    ex = SparseAttentionExec.coerce(spion, phase="decode")
    h = Lyr.embed(params["tok_embed"], tokens, dtype, vocab=cfg.vocab_size)
    shared = params["shared_attn"]
    posb = A.decode_positions(pos, tokens.shape[0], tokens.device)
    positions = posb[:, None]
    if paged:
        pt, phys_w, off_w = rows_and_targets(kvp, posb, ring=False)

    def attend(app, q, k_new, v_new):
        if paged:
            write_token(kvp.kp, kvp.vp, app, k_new, v_new, phys_w, off_w)
            if ex is not None:
                return ex.decode_paged_app(cfg, q, kvp.kp, kvp.vp, app, posb,
                                           pt)
            return A.paged_decode_attention(cfg, q, kvp.kp, kvp.vp, app,
                                            posb, pt, page=kvp.page)
        kc, vc = A.update_cache(cache["k"][app], cache["v"][app], k_new,
                                v_new, posb)
        if ex is not None:
            return ex.decode_app(cfg, q, kc, vc, posb, app)
        return A.decode_attention(cfg, q, kc, vc, posb)

    app = 0
    for idx in range(cfg.num_layers):
        lp = Lyr.layer_view(params["layers"], idx)
        y, st = M.mamba_apply(cfg, lp["mamba"], _rms(lp["norm"], h),
                              state={"conv": cache["conv"][idx],
                                     "ssm": cache["ssm"][idx]})
        h = h + y
        cache["conv"][idx] = st["conv"]
        cache["ssm"][idx] = st["ssm"]
        if _is_attn(cfg, idx):
            q, k_new, v_new = A.qkv(cfg, shared["attn"],
                                    _rms(shared["attn_norm"], h), positions)
            h = h + A.attn_out(cfg, shared["attn"],
                               attend(app, q, k_new, v_new))
            h = _mlp_tail(cfg, shared, h)
            app += 1
    h = _rms(params["final_norm"], h)
    return Lyr.unembed(params["lm_head"], h, vocab=cfg.vocab_size)[:, 0], \
        cache
