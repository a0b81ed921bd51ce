"""RWKV6 (Finch) — attention-free, data-dependent per-channel decay.

WKV6 recurrence per head (K = V = head_dim):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t @ S_{t-1} + ((r_t * u) . k_t) v_t
Chunked-parallel implementation; every exponent is a *difference* of decay
cumsums and therefore <= 0 (numerically safe without clamping tricks).
SPION is inapplicable (no attention-score matrix): the registry marks the
family without sparse decode and without a paged cache.

The JAX package computes all of this in plain jnp (no Pallas kernel), so
these are PyTorch ops too; its lax.scans are loops here. Under a mesh with
a 'seq' axis each rank holds a contiguous shard of whole chunks: every
token shift reads the previous shard's last row (`distributed.sharding.
seq_left_rows`) and the WKV state combine starts from the state the
earlier shards hand on (`carried_combine`), as the reference's scan over the
whole sequence does.

Under a mesh with a 'model' axis each rank runs H/|model| of the WKV heads
(distributed/sharding.py states the layout): the token-shift mixes are
computed whole and enter through `copy_to_model`, w_r, w_k, w_v and w_g are
column-parallel on whole heads, the LoRA hidden enters through
`copy_to_model`, w0, w_lora_b, u and ln_x are cut to the rank's heads
through `model_part`, ln_x's mean and variance are the whole inner
width's (`model_line_sum`), out_proj is row-parallel; the channel mix
splits d_ff as the MLP does (column-parallel w_in, row-parallel w_out).
The decode form runs on the rank's heads too: its WKV state holds them,
and the token-shift states stay whole (the reference's cache_pspecs).

Where |model| does not divide the WKV heads (`distributed.sharding.
scan_split` False) the time mix takes the reference's fallback, where
GSPMD splits the WKV mid-head: where |model| divides the inner width,
w_r, w_k, w_v and w_g are the reference's column shards (mid-head), the
rank's columns of r, k and v are gathered over the line
(`models.attention.gather_columns`), the LoRA decay, the WKV and ln_x run
on every head, and out_proj is row-parallel over the rank's rows of the
normed output times its own columns of the gate. Each rank's backward
then carries its rows' share of the output gradient, so w0, w_lora_b, u
and ln_x enter whole through `copy_to_model`. Where |model| does not
divide the inner width the leaves are whole and the time mix runs
replicated, with no collective. The channel mix runs whole where |model|
does not divide d_ff (its leaves are then replicated). A decode state
split over heads is gathered and the rank keeps its shard of the new one.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import (active_mesh, carried_combine,
                                              copy_to_model, current_mesh,
                                              gather_model, mesh_context,
                                              model_offset, model_part,
                                              model_size, model_split,
                                              model_whole,
                                              scan_split, seq_left_rows,
                                              seq_size)
from repro_torch.models import layers as Lyr
from repro_torch.models.attention import gather_columns
from repro_torch.models.layers import (ParamTree, he_init, normal_init,
                                       row_parallel)

LORA_R = 64


def _dtype(cfg):
    return getattr(torch, cfg.dtype)


def _full(lead, shape, value, device):
    return torch.full((*lead, *shape), value, dtype=torch.float32,
                      device=device)


def _layernorm_init(d, lead, device):
    return {"scale": _full(lead, (d,), 1.0, device),
            "bias": _full(lead, (d,), 0.0, device)}


def timemix_init(gen, cfg, dtype, device, layers=None):
    d = cfg.d_model
    H = cfg.num_heads
    hd = cfg.resolved_head_dim
    inner = H * hd
    lead = () if layers is None else (layers,)
    f32 = torch.float32
    return {
        "mix": _full(lead, (4, d), 0.5, device),   # r,k,v,w token-shift mixes
        "w_r": he_init(gen, (d, inner), d, dtype, device, layers),
        "w_k": he_init(gen, (d, inner), d, dtype, device, layers),
        "w_v": he_init(gen, (d, inner), d, dtype, device, layers),
        "w_g": he_init(gen, (d, inner), d, dtype, device, layers),
        "out_proj": he_init(gen, (inner, d), inner, dtype, device, layers),
        "w0": _full(lead, (inner,), -6.0, device),   # base log-log decay
        "w_lora_a": he_init(gen, (d, LORA_R), d, f32, device, layers),
        "w_lora_b": normal_init(gen, (LORA_R, inner), 0.01, f32, device,
                                layers),
        "u": normal_init(gen, (H, hd), 0.1, f32, device, layers),   # bonus
        "ln_x": _layernorm_init(inner, lead, device),
    }


def channelmix_init(gen, cfg, dtype, device, layers=None):
    d, ff = cfg.d_model, cfg.d_ff
    lead = () if layers is None else (layers,)
    return {
        "mix": _full(lead, (1, d), 0.5, device),
        "w_in": he_init(gen, (d, ff), d, dtype, device, layers),
        "w_out": he_init(gen, (ff, d), ff, dtype, device, layers),
    }


def token_shift(x, prev=None):
    """previous token along seq: (B,S,d) -> (B,S,d). The row before the
    first is `prev` (B,1,d) (a 'seq' shard's left halo), else zero."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mix(x, xs, m):
    return x * m + xs * (1 - m)


def wkv6_chunked(r, k, v, a, u, chunk):
    """r,k: (B,S,H,K); v: (B,S,H,V); a = log decay (B,S,H,K) (<= 0);
    u: (H,K) bonus. Returns y (B,S,H,V).

    Chunk-parallel form: each chunk's state delta and decay at once, the
    O(n*H*K*V) state combine sequential, then the inter-chunk term at
    once. The intra-chunk term, whose exp(D) is (B, C, C, H, K) a chunk,
    runs one chunk at a time so that no more than one chunk's exp(D) is
    held (the reference batches it over the n chunks, the same arithmetic).
    The casts of exp(...) to the inputs' dtype are the reference's.

    On a 'seq' shard S is this shard's rows and the chunk is the whole
    sequence's, min(chunk, |seq| * S); the state combine starts from the
    state the earlier shards hand on (`carried_combine`)."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    C = min(chunk, S * seq_size(active_mesh()))
    if S % C:
        raise ValueError(f"wkv6_chunked: sequence length {S} is not a "
                         f"multiple of the chunk {C}")
    n = S // C
    rc = r.reshape(B, n, C, H, K)
    kc = k.reshape(B, n, C, H, K)
    vc = v.reshape(B, n, C, H, V)
    ac = a.reshape(B, n, C, H, K).float()

    cum = torch.cumsum(ac, dim=2)                      # inclusive
    excl = cum - ac                                    # exclusive
    last = cum[:, :, -1]                               # (B,n,H,K)

    # parallel over chunks: per-chunk state delta + decay
    k_dec = kc * torch.exp(last[:, :, None] - cum).to(kc.dtype)
    delta = torch.einsum("bnshk,bnshv->bnhkv", k_dec, vc).float()
    decay = torch.exp(last)                            # (B,n,H,K)

    # sequential state combine, each chunk reading the state that enters
    # it
    S_in = carried_combine(decay[..., None], delta)    # (B,n,H,K,V)

    # parallel: inter-chunk contribution
    r_dec = rc * torch.exp(excl).to(rc.dtype)
    y_inter = torch.einsum("bnthk,bnhkv->bnthv", r_dec, S_in.to(rc.dtype))

    # intra-chunk M_ts = sum_k r_tk k_sk exp(excl_t - cum_s), s < t
    ar = torch.arange(C, device=r.device)
    mask = (ar[:, None] > ar[None, :])[None, :, :, None, None]
    uc = u.to(rc.dtype)
    y_intra = []
    for j in range(n):
        D = excl[:, j, :, None] - cum[:, j, None, :]   # (B,C,C,H,K), <=0 s<t
        expD = torch.where(mask, torch.exp(D.clamp(max=0.0)), 0.0) \
            .to(rc.dtype)
        M = torch.einsum("bthk,bshk,btshk->btsh", rc[:, j], kc[:, j], expD)
        diag = torch.einsum("bthk,bthk,hk->bth", rc[:, j], kc[:, j], uc)
        y_intra.append(torch.einsum("btsh,bshv->bthv", M, vc[:, j])
                       + diag[..., None] * vc[:, j])
    y_intra = torch.stack(y_intra, dim=1)

    return (y_inter + y_intra).reshape(B, S, H, V)


def timemix_apply(cfg, p, x, state=None):
    """x (B,S,d). state: None (train) or dict(prev (B,d), S (B,H,K,V)) for
    decode (S=1). Returns (y, new_state). On a 'model' axis this rank's
    heads, with a state its heads' WKV state, or, where |model| does not
    divide the heads, the reference's fallback (module docstring)."""
    B, S, d = x.shape
    H = cfg.num_heads
    hd = cfg.resolved_head_dim
    m = model_size() if scan_split(cfg) else 1
    # the fallback; with the projections split mid-head (row-parallel
    # out_proj: each rank's output gradient is its rows' share), or whole
    fallback = model_size() > 1 and m == 1
    part = fallback and model_split(H * hd)
    Hl = H // m
    if state is None:
        xs = token_shift(x, seq_left_rows(x, 1))
    else:
        xs = state["prev"][:, None, :].to(x.dtype)
    mix = p["mix"].to(x.dtype)
    xr, xk, xv, xw = (_mix(x, xs, mix[i]) for i in range(4))
    w0, lora_b, u, ln_x = p["w0"], p["w_lora_b"], p["u"], p["ln_x"]
    if m > 1 or part:
        # column-parallel projections: the mixes' gradients are partial
        xr, xk, xv = (copy_to_model(t) for t in (xr, xk, xv))
    if m > 1:
        r0 = active_mesh().axis_index("model")
        heads, cols = slice(r0 * Hl, (r0 + 1) * Hl), \
            slice(r0 * Hl * hd, (r0 + 1) * Hl * hd)
        w0 = model_part(w0, cols)
        lora_b = model_part(lora_b, (Ellipsis, cols))
        u = model_part(u, heads)
        ln_x = {k: model_part(v, cols) for k, v in ln_x.items()}
    if part:
        r, k, v = (t.reshape(B, S, H, hd) for t in gather_columns(
            [t @ p[f"w_{n}"].to(x.dtype)
             for t, n in ((xr, "r"), (xk, "k"), (xv, "v"))]))
    else:
        r = (xr @ p["w_r"].to(x.dtype)).reshape(B, S, Hl, hd)
        k = (xk @ p["w_k"].to(x.dtype)).reshape(B, S, Hl, hd)
        v = (xv @ p["w_v"].to(x.dtype)).reshape(B, S, Hl, hd)
    if fallback:
        w0, lora_b, u = (model_whole(t, part) for t in (w0, lora_b, u))
        ln_x = {k_: model_whole(t, part) for k_, t in ln_x.items()}
    # the gate's mix is r's (the reference mixes with mix[0] again); under
    # the fallback the rank's columns of it
    g = F.silu(xr @ p["w_g"].to(x.dtype))
    # data-dependent decay (lora), a = -exp(.) clamped to [-8, -1e-6], in
    # fp32: the train step's cast leaves w_lora_* in cfg.dtype, which the
    # reference's fp32 @ bf16 promotes
    hidden = torch.tanh(xw.float() @ p["w_lora_a"].float())
    if m > 1 or part:
        hidden = copy_to_model(hidden)
    wlog = w0 + hidden @ lora_b.float()
    a = -torch.exp(wlog).reshape(B, S, Hl, hd)
    a = a.clamp(-8.0, -1e-6)
    S_in = None if state is None else state["S"]
    if S_in is not None and S_in.shape[1] != Hl:
        # a fallback decode: the state cache_pspecs split over heads, whole
        S_in = gather_model(S_in, 1)
    if state is None:
        y = wkv6_chunked(r, k, v, a, u, cfg.ssm.chunk)
        new_state = None
    else:
        r1, k1, v1, a1 = (t[:, 0].float() for t in (r, k, v, a))
        y = torch.einsum("bhk,bhkv->bhv", r1, S_in) + \
            torch.einsum("bhk,hk,bhk,bhv->bhv", r1, u, k1, v1)
        y = y[:, None].to(x.dtype)
        S_new = S_in * torch.exp(a1)[..., None] + \
            torch.einsum("bhk,bhv->bhkv", k1, v1)
        hl = state["S"].shape[1]
        if hl != Hl:
            S_new = S_new.narrow(1, model_offset(hl), hl)
        new_state = {"prev": x[:, -1].float(), "S": S_new}
    y = y.reshape(B, S, Hl * hd)
    # ln_x's mean and variance are the whole inner width's
    y = Lyr.layernorm(ln_x, y.float(), width=H * hd).to(x.dtype)
    if part:
        rows = p["out_proj"].shape[0]
        return row_parallel(y.narrow(-1, model_offset(rows), rows) * g,
                            p["out_proj"]), new_state
    y = y * g
    if m > 1:
        return row_parallel(y, p["out_proj"]), new_state
    return y @ p["out_proj"].to(x.dtype), new_state


def channelmix_apply(cfg, p, x, state=None):
    """The channel mix; on a 'model' axis this rank's d_ff shard:
    column-parallel w_in, row-parallel w_out, as `layers.mlp`."""
    split = model_split(cfg.d_ff)
    xs = token_shift(x, seq_left_rows(x, 1)) if state is None \
        else state["prev"][:, None, :].to(x.dtype)
    xk = _mix(x, xs, p["mix"][0].to(x.dtype))
    if split:
        xk = copy_to_model(xk)
    h = torch.square(F.relu(xk @ p["w_in"].to(x.dtype)))
    y = row_parallel(h, p["w_out"]) if split else h @ p["w_out"].to(x.dtype)
    new_state = None if state is None else {"prev": x[:, -1].float()}
    return y, new_state


def init(cfg, generator, device):
    """Random parameters with the reference's keys, shapes and init
    scales, the per-layer tensors stacked on a leading layer axis."""
    dtype = _dtype(cfg)
    L, d = cfg.num_layers, cfg.d_model

    def embed_init():
        w = torch.randn((cfg.vocab_size, d), generator=generator,
                        device=device)
        return {"w": (w * 0.02).to(dtype)}
    layers = {
        "tm_norm": _layernorm_init(d, (L,), device),
        "tm": timemix_init(generator, cfg, dtype, device, layers=L),
        "cm_norm": _layernorm_init(d, (L,), device),
        "cm": channelmix_init(generator, cfg, dtype, device, layers=L),
    }
    return ParamTree({
        "tok_embed": embed_init(),
        "in_norm": _layernorm_init(d, (), device),
        "layers": layers,
        "final_norm": _layernorm_init(d, (), device),
        "lm_head": embed_init(),
    })


def _ln(p, h):
    return Lyr.layernorm(p, h.float()).to(h.dtype)


def _layer(cfg, lp, h):
    y, _ = timemix_apply(cfg, lp["tm"], _ln(lp["tm_norm"], h))
    h2 = h + y
    y2, _ = channelmix_apply(cfg, lp["cm"], _ln(lp["cm_norm"], h2))
    return h2 + y2


def _layer_h(cfg, lp, mesh, h):
    """The remat form of `_layer` under the forward's `mesh`: the backward
    runs it again, on autograd's device thread for CUDA tensors, where the
    forward's mesh context is not set."""
    with mesh_context(mesh):
        return _layer(cfg, lp, h)


def forward(params, cfg, batch, *, spion=None, capture=None):
    """batch {'tokens': (B,S)} -> (logits (B,S,V), {}). With cfg.remat
    each layer is recomputed in the backward. On a 'seq' shard `tokens` is
    the shard's rows; on a 'model' axis that splits the vocabulary the
    logits are this rank's shard of it (module docstring)."""
    dtype = _dtype(cfg)
    h = Lyr.embed(params["tok_embed"], batch["tokens"], dtype,
                  vocab=cfg.vocab_size)
    h = _ln(params["in_norm"], h)
    remat = cfg.remat and torch.is_grad_enabled()
    for li in range(cfg.num_layers):
        lp = Lyr.layer_view(params["layers"], li)
        if remat:
            h = checkpoint(functools.partial(_layer_h, cfg, lp,
                                             current_mesh()), h,
                           use_reentrant=False)
        else:
            h = _layer(cfg, lp, h)
    h = _ln(params["final_norm"], h)
    return Lyr.unembed(params["lm_head"], h, vocab=cfg.vocab_size), {}


def init_cache(cfg, batch_size, max_len, dtype=None, device="cpu"):
    """Recurrent state: O(1) in sequence length (the SSM long-context
    win); `max_len` and `dtype` are accepted for the uniform API."""
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    L, B, d = cfg.num_layers, batch_size, cfg.d_model

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return {"tm_prev": zeros(L, B, d), "cm_prev": zeros(L, B, d),
            "S": zeros(L, B, H, hd, hd)}


def decode_step(params, cfg, cache, tokens, pos, *, spion=None):
    """tokens (B,1) -> (logits (B,V), cache), the cache updated in place.
    `pos` is accepted (scalar or per-row) for the uniform signature but
    unused: the recurrent state is position-free."""
    if spion is not None:
        raise NotImplementedError(
            "rwkv (family 'ssm') keeps recurrent state, not an attention KV "
            "cache — there is nothing for a sparsity plan to gather. Check "
            "registry.build(cfg).supports_sparse_decode before constructing "
            "a sparse serve step (launch.steps.make_serve_step and "
            "launch.serve.ServeEngine do) and serve this family densely "
            "(spion=None).")
    dtype = _dtype(cfg)
    h = Lyr.embed(params["tok_embed"], tokens, dtype, vocab=cfg.vocab_size)
    h = _ln(params["in_norm"], h)
    for li in range(cfg.num_layers):
        lp = Lyr.layer_view(params["layers"], li)
        xin = _ln(lp["tm_norm"], h)
        y, st = timemix_apply(cfg, lp["tm"], xin,
                              state={"prev": cache["tm_prev"][li],
                                     "S": cache["S"][li]})
        h = h + y
        xin2 = _ln(lp["cm_norm"], h)
        y2, _ = channelmix_apply(cfg, lp["cm"], xin2,
                                 state={"prev": cache["cm_prev"][li]})
        h = h + y2
        # the token-shift states hold the *inputs* to each mix
        cache["tm_prev"][li] = xin[:, -1].float()
        cache["cm_prev"][li] = xin2[:, -1].float()
        cache["S"][li] = st["S"]
    h = _ln(params["final_norm"], h)
    return Lyr.unembed(params["lm_head"], h, vocab=cfg.vocab_size)[:, 0], \
        cache
