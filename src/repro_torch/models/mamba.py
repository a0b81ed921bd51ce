"""Mamba2 (SSD) layer — chunked state-space dual form.

Per head h with scalar decay a_t = Δ_t·A_h (<= 0):
    h_t = exp(a_t) h_{t-1} + Δ_t (B_t ⊗ x_t)     state (N, P)
    y_t = C_t @ h_t + D_h x_t
All exponents are cumsum differences <= 0 (safe). Short causal depthwise
conv (width 4) on the xBC stream, gated output, as in the reference model.

The JAX package computes all of this in plain jnp (no Pallas kernel), so
these are PyTorch ops too; its lax.scan over chunks is a loop here.

Under a mesh with a 'seq' axis each rank holds a contiguous shard of whole
chunks: the conv reads the previous shard's last CONV_W - 1 rows
(`distributed.sharding.seq_left_rows`) and the state combine starts from
the state that the earlier shards hand on (`carried_combine`), as the
reference's scan over the whole sequence does.

Under a mesh with a 'model' axis each rank runs H/|model| of the SSM heads
(distributed/sharding.py states the layout): its shard of the packed
in_proj gives [z heads r | x heads r | its part of B‖C | dt heads r], the
B‖C columns are gathered over the line (every head reads all of B and C),
the conv runs on the rank's x channels and all of B and C, the out_norm's
mean square is the whole inner width's (`model_line_sum`), and out_proj
is row-parallel. The replicated leaves the rank uses in part enter through
`model_part`. The decode form runs on the rank's heads too: its SSM state
holds those heads and its conv state the columns its conv computes, its x
channels and its part of B‖C (`distributed.sharding.packed_segments`); the
state's B‖C rows are gathered over the line with the token's, and the
rank keeps its part of the new ones.

Where |model| does not divide the SSM heads or the B‖C columns
(`distributed.sharding.scan_split` False) the layer takes the reference's
fallback, where GSPMD splits the scan mid-head: in_proj's leaf is the
reference's contiguous column shard (where |model| divides its width)
and the rank's columns of its product are gathered over the line
(`gather_model`), the conv, the SSD and the out_norm run on every head,
and out_proj is row-parallel over the rank's rows where |model| divides
the inner width, whole otherwise. Row-parallel, each rank's backward
carries its rows' share of the output gradient alone, so every leaf the
whole scan reads enters through `copy_to_model` (its gradient summed over
the line); whole, the layer is replicated and no sum is taken. The
decode form gathers each state leaf that launch/steps.cache_pspecs splits
(the SSM state over its heads, the conv state over its columns, each
where |model| divides it), runs the whole step and keeps the rank's
shard of the new state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (active_mesh, carried_combine,
                                              copy_to_model, gather_model,
                                              model_offset, model_part,
                                              model_size, model_split,
                                              model_whole,
                                              scan_split, seq_left_rows,
                                              seq_size)
from repro_torch.models import layers as Lyr
from repro_torch.models.layers import he_init, normal_init, row_parallel

CONV_W = 4
NGROUPS = 1


def _widths(cfg):
    """(inner, heads H, head dim P, state N, conv channels)."""
    ssm = cfg.ssm
    inner = ssm.expand * cfg.d_model
    N = ssm.state_size
    return inner, inner // ssm.head_dim, ssm.head_dim, N, \
        inner + 2 * NGROUPS * N


def mamba_init(gen, cfg, dtype, device, layers=None):
    """The reference's leaves (in_proj, conv_w, conv_b, A_log, D, dt_bias,
    out_norm, out_proj), stacked over `layers` when given."""
    d = cfg.d_model
    inner, H, _, N, conv_dim = _widths(cfg)
    lead = () if layers is None else (layers,)

    def full(n, value, dt=torch.float32):
        return torch.full((*lead, n), value, dtype=dt, device=device)

    return {
        "in_proj": he_init(gen, (d, 2 * inner + 2 * NGROUPS * N + H), d,
                           dtype, device, layers),
        "conv_w": normal_init(gen, (CONV_W, conv_dim), 0.1, dtype, device,
                              layers),
        "conv_b": full(conv_dim, 0.0, dtype),
        "A_log": full(H, 0.0),             # A = -exp(A_log)
        "D": full(H, 1.0),
        "dt_bias": full(H, -2.0),          # softplus(-2) ~ .13
        "out_norm": {"scale": full(inner, 1.0)},
        "out_proj": he_init(gen, (inner, d), inner, dtype, device, layers),
    }


def _causal_conv(x, w, b, state=None):
    """depthwise causal conv: x (B,S,C), w (W,C). state (B,W-1,C) for
    decode, rounded to x's dtype on the way in as the reference does; the
    new state is returned in fp32."""
    W = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, W - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(W))
    new_state = xp[:, -(W - 1):].float() if state is not None else None
    return F.silu(y + b), new_state


def ssd_chunked(x, dt, A, B, C, D, chunk):
    """x (b,S,H,P); dt (b,S,H) (>0); A (H,) (<0); B,C (b,S,G,N); D (H,).
    Returns y (b,S,H,P). S must be a multiple of min(chunk, S): the
    reference reshapes S into whole chunks and fails otherwise; nothing is
    padded here either.

    On a 'seq' shard S is this shard's rows and the chunk is the whole
    sequence's, min(chunk, |seq| * S); the state combine starts from the
    state the earlier shards hand on (`carried_combine`). The einsums run
    once."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    Ch = min(chunk, S * seq_size(active_mesh()))
    if S % Ch:
        raise ValueError(f"ssd_chunked: sequence length {S} is not a "
                         f"multiple of the chunk {Ch}")
    n = S // Ch
    xr = x.reshape(b, n, Ch, H, P).float()
    dtr = dt.reshape(b, n, Ch, H).float()
    # NGROUPS == 1: the group axis is dropped
    Br = B.reshape(b, n, Ch, N).float()
    Cr = C.reshape(b, n, Ch, N).float()

    a = dtr * A                                     # (b,n,Ch,H) <= 0
    cum = torch.cumsum(a, dim=2)                    # inclusive
    last = cum[:, :, -1]                            # (b,n,H)

    dec_k = torch.exp(last[:, :, None] - cum) * dtr  # (b,n,Ch,H)
    delta = torch.einsum("bnsq,bnshp->bnhqp", Br, xr * dec_k[..., None])
    decay = torch.exp(last)                         # (b,n,H)

    # the sequential state combine, each chunk reading the state that
    # enters it
    S_in = carried_combine(decay[..., None, None], delta)   # (b,n,H,N,P)

    # inter-chunk: y_t += exp(cum_t) C_t @ S_in
    y_inter = torch.einsum("bntq,bnhqp->bnthp", Cr, S_in) * \
        torch.exp(cum)[..., None]

    # intra-chunk: M_ts = C_t.B_s exp(cum_t - cum_s) dt_s, s <= t
    Dm = cum[:, :, :, None] - cum[:, :, None, :]    # (b,n,Ch,Ch,H)
    ar = torch.arange(Ch, device=x.device)
    mask = (ar[:, None] >= ar[None, :])[None, None, :, :, None]
    expD = torch.where(mask, torch.exp(Dm.clamp(max=0.0)), 0.0)
    CB = torch.einsum("bntq,bnsq->bnts", Cr, Br)
    M = CB[..., None] * expD * dtr[:, :, None, :, :]
    y_intra = torch.einsum("bntsh,bnshp->bnthp", M, xr)

    y = (y_inter + y_intra).to(x.dtype).reshape(b, S, H, P)
    return y + x * D[None, None, :, None].to(x.dtype)


def mamba_apply(cfg, p, x, state=None):
    """x (B,S,d). state None | dict(conv (B,W-1,convdim), ssm (B,H,N,P)),
    the decode form (S = 1). Returns (out, new state or None). On a
    'model' axis this rank's heads, with a state the rank's shard of it,
    or, where |model| does not divide the scan's widths, the reference's
    fallback (module docstring)."""
    inner, H, _, N, _ = _widths(cfg)
    if model_size() > 1 and not scan_split(cfg):
        return _fallback_apply(cfg, p, x, state)
    m = model_size() if scan_split(cfg) else 1
    r = active_mesh().axis_index("model") if m > 1 else 0
    il, Hl, nbc = inner // m, H // m, 2 * NGROUPS * N // m
    if m > 1:
        x = copy_to_model(x)

    zxbcdt = x @ p["in_proj"].to(x.dtype)
    # split: z (inner), xBC (inner + 2GN), dt (H); on a 'model' axis each
    # segment is this rank's part (sharding.packed_segments)
    z = zxbcdt[..., :il]
    xBC = zxbcdt[..., il:2 * il + nbc]
    dt_raw = zxbcdt[..., 2 * il + nbc:]
    leaves = {k: p[k] for k in ("conv_w", "conv_b", "A_log", "D",
                                "dt_bias")}
    out_norm = p["out_norm"]
    # decode: the cached rows
    conv_state = None if state is None else state["conv"]
    if m > 1:
        # every head reads all of B and C
        if state is None:
            xBC = torch.cat([xBC[..., :il], gather_model(xBC[..., il:], -1)],
                            -1)
        else:
            # the state's rows of the rank's B‖C part gathered with the
            # token's, rounded to x's dtype first as `_causal_conv` does
            st = conv_state.to(x.dtype)
            bc = gather_model(torch.cat([st[..., il:], xBC[..., il:]], 1), -1)
            conv_state = torch.cat([st[..., :il], bc[:, :CONV_W - 1]], -1)
            xBC = torch.cat([xBC[..., :il], bc[:, CONV_W - 1:]], -1)
        ch = torch.cat([torch.arange(r * il, (r + 1) * il),
                        torch.arange(inner, inner + 2 * NGROUPS * N)]) \
            .to(x.device)
        heads = slice(r * Hl, (r + 1) * Hl)
        leaves["conv_w"] = model_part(leaves["conv_w"], (Ellipsis, ch))
        leaves["conv_b"] = model_part(leaves["conv_b"], ch)
        for k in ("A_log", "D", "dt_bias"):
            leaves[k] = model_part(leaves[k], heads)
        out_norm = {"scale": model_part(out_norm["scale"],
                                        slice(r * il, (r + 1) * il))}

    y, new_conv, new_ssm = _scan(cfg, leaves, xBC, dt_raw, conv_state,
                                 None if state is None else state["ssm"], il)
    if m > 1 and state is not None:
        # the rank keeps its x columns and its part of B‖C
        new_conv = torch.cat([new_conv[..., :il], new_conv[
            ..., il + r * nbc:il + (r + 1) * nbc]], -1)
    # the gated norm's mean square is the whole inner width's
    y = Lyr.rmsnorm(out_norm, y.float(), width=inner).to(x.dtype)
    y = y * F.silu(z)
    out = row_parallel(y, p["out_proj"]) if m > 1 else \
        y @ p["out_proj"].to(x.dtype)
    new_state = None if state is None else {"conv": new_conv, "ssm": new_ssm}
    return out, new_state


def _scan(cfg, leaves, xBC, dt_raw, conv_state, ssm_state, il):
    """The conv and the SSD of `il` // P heads: xBC (B,S,il + 2GN) the
    heads' x channels and all of B and C, dt_raw (B,S,il // P), `leaves`
    the conv's and the heads' parts of conv_w, conv_b, A_log, D and
    dt_bias. Train (`ssm_state` None): on a 'seq' shard the conv reads the
    previous shard's last rows. Decode (S = 1): one step from the states.
    Returns (y (B,S,il), the new conv state (B,W-1,il + 2GN) or None, the
    new SSM state or None)."""
    Bsz, S = xBC.shape[:2]
    P, N = cfg.ssm.head_dim, cfg.ssm.state_size
    if ssm_state is None:
        # a 'seq' shard: the previous shard's last rows
        conv_state = seq_left_rows(xBC, CONV_W - 1)
    xBC, new_conv = _causal_conv(xBC, leaves["conv_w"].to(xBC.dtype),
                                 leaves["conv_b"].to(xBC.dtype), conv_state)
    xs = xBC[..., :il].reshape(Bsz, S, il // P, P)
    Bmat = xBC[..., il:il + NGROUPS * N].reshape(Bsz, S, NGROUPS, N)
    Cmat = xBC[..., il + NGROUPS * N:].reshape(Bsz, S, NGROUPS, N)
    dt = F.softplus(dt_raw.float() + leaves["dt_bias"])
    A = -torch.exp(leaves["A_log"])
    Dp = leaves["D"]

    if ssm_state is None:
        y = ssd_chunked(xs, dt, A, Bmat, Cmat, Dp, cfg.ssm.chunk)
        new_ssm = None
    else:
        a = dt[:, 0] * A                             # (B,H)
        x1 = xs[:, 0].float()
        B1 = Bmat[:, 0, 0].float()                   # (B,N) with G=1
        C1 = Cmat[:, 0, 0].float()
        new_ssm = ssm_state * torch.exp(a)[..., None, None] + \
            torch.einsum("bn,bhp,bh->bhnp", B1, x1, dt[:, 0])
        y = torch.einsum("bn,bhnp->bhp", C1, new_ssm) + \
            x1 * Dp[None, :, None]
        y = y[:, None].to(xBC.dtype)
    return y.reshape(Bsz, S, il), new_conv, new_ssm


def _fallback_apply(cfg, p, x, state):
    """`mamba_apply` under the reference's fallback: a 'model' axis that
    does not divide the scan's widths (module docstring). Every rank runs
    the whole scan; in_proj's product comes from the rank's columns
    gathered over the line where its leaf is split, out_proj is
    row-parallel where its leaf is split."""
    inner, H, _, N, conv_dim = _widths(cfg)
    split_in = model_split(2 * inner + 2 * NGROUPS * N + H)
    split_out = model_split(inner)
    # row-parallel out_proj: each rank's output gradient is its rows' share,
    # so what the whole scan reads has its gradient summed over the line
    def whole(leaf):
        return model_whole(leaf, split_out)
    if split_in or split_out:
        x = copy_to_model(x)
    if split_in:
        zxbcdt = gather_model(x @ p["in_proj"].to(x.dtype), -1,
                              summed=split_out)
    else:
        zxbcdt = x @ whole(p["in_proj"]).to(x.dtype)
    z = zxbcdt[..., :inner]
    xBC = zxbcdt[..., inner:2 * inner + 2 * NGROUPS * N]
    dt_raw = zxbcdt[..., 2 * inner + 2 * NGROUPS * N:]
    leaves = {k: whole(p[k]) for k in ("conv_w", "conv_b", "A_log", "D",
                                       "dt_bias")}
    conv_state = ssm_state = None
    if state is not None:
        # the state leaves cache_pspecs splits, whole
        conv_state, ssm_state = state["conv"], state["ssm"]
        if conv_state.shape[-1] != conv_dim:
            conv_state = gather_model(conv_state, -1)
        if ssm_state.shape[1] != H:
            ssm_state = gather_model(ssm_state, 1)
    y, new_conv, new_ssm = _scan(cfg, leaves, xBC, dt_raw, conv_state,
                                 ssm_state, inner)
    y = Lyr.rmsnorm({"scale": whole(p["out_norm"]["scale"])},
                    y.float()).to(x.dtype)
    y = y * F.silu(z)
    if split_out:
        rows = p["out_proj"].shape[0]
        out = row_parallel(y.narrow(-1, model_offset(rows), rows),
                           p["out_proj"])
    else:
        out = y @ p["out_proj"].to(x.dtype)
    if state is None:
        return out, None
    # the rank keeps its shard of each split state leaf
    cw, hl = state["conv"].shape[-1], state["ssm"].shape[1]
    return out, {"conv": new_conv.narrow(-1, model_offset(cw), cw)
                 if cw != conv_dim else new_conv,
                 "ssm": new_ssm.narrow(1, model_offset(hl), hl)
                 if hl != H else new_ssm}


def init_state(cfg, batch_size, device="cpu"):
    """Zero decode state: conv (B, W-1, convdim) and ssm (B, H, N, P), fp32."""
    _, H, P, N, conv_dim = _widths(cfg)
    return {
        "conv": torch.zeros((batch_size, CONV_W - 1, conv_dim),
                            dtype=torch.float32, device=device),
        "ssm": torch.zeros((batch_size, H, N, P), dtype=torch.float32,
                           device=device),
    }
