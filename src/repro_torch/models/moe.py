"""GShard/Switch-style top-k MoE with einsum dispatch.

Tokens are grouped (GROUP tokens a dispatch group); the dispatch/combine
one-hots are (G, S_g, E, C) with a per-expert capacity C. Routing is the
JAX package's: per-expert positions from a cumulative count, slot-major
order across the top-k (every slot-0 assignment precedes every slot-1
assignment of an expert), top-k gates renormalised, dispatch in the
activation dtype and combine in fp32, cast to the activation dtype before
the last einsum. Aux losses: load-balance (Switch) + router z-loss.

The expert products are plain einsums (batched matmuls); the JAX package
computes them outside any Pallas kernel too.

Under a mesh (distributed.sharding.mesh_context) the reference's step is
one program over the global batch, whose T = B * S tokens it groups in
(B, S) order. Here each rank holds its shard, so the groups and their
capacity come from the global token count and every rank must hold whole
groups (`rank_groups`); under a 'seq' axis the layer first gathers its
rows over the 'seq' line, routes the whole rows and keeps its shard of the
output. The ranks of a 'seq' line thus do the MoE's work redundantly
(ROADMAP.md item 12b.1); their aux losses are identical, and the step's
mean over the ranks is the global batch's.

On a 'model' axis the experts split over the line when |model| divides E,
else d_ff splits within each expert (the reference's `_FALLBACKS`): the
router and the routing are replicated, each rank runs its experts (or its
d_ff slice of every expert) on its slice of the dispatch, and the partial
outputs (in the activation dtype) are summed over the line in fp32. The
aux losses are identical on every model rank. The gate values and the
expert input enter the rank's region through `copy_to_model`, so the
router and x get the whole gradient on every rank.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (active_mesh, copy_to_model,
                                              data_axes, gather_seq,
                                              model_offset, model_split,
                                              reduce_from_model, seq_size,
                                              seq_start)
from repro_torch.models.layers import he_init, mlp, mlp_init

GROUP = 1024            # tokens per dispatch group
CAPACITY_FACTOR = 1.25


def moe_init(gen, cfg, dtype, device, layers=None):
    """Router (fp32), stacked expert weights (E, d, ff) / (E, ff, d) and,
    for arctic, the dense residual MLP; stacked over `layers` when given."""
    d, ff = cfg.d_model, cfg.d_ff
    E = cfg.moe.num_experts
    p = {
        "router": {"w": he_init(gen, (d, E), d, torch.float32, device,
                                layers)},
        "experts": {
            "w_in": he_init(gen, (E, d, ff), d, dtype, device, layers),
            "w_gate": he_init(gen, (E, d, ff), d, dtype, device, layers),
            "w_out": he_init(gen, (E, ff, d), ff, dtype, device, layers),
        },
    }
    if cfg.moe.dense_residual_ff:
        p["dense_residual"] = mlp_init(gen, cfg, dtype, device, layers,
                                       ff=cfg.moe.dense_residual_ff)
    return p


def dispatch_groups(T: int) -> int:
    """Dispatch groups for T tokens: max(1, T // GROUP), which must divide
    T. The JAX package reshapes (T, d) to (g, T // g, d) without a check and
    fails there (T = 3200: g = 3); this raises instead of padding or
    regrouping, so the port serves no length the reference refuses."""
    g = max(1, T // GROUP)
    if T % g:
        raise ValueError(
            f"moe_apply: {T} tokens do not split into g = max(1, {T} // "
            f"GROUP) = {g} dispatch groups of GROUP = {GROUP} tokens or more "
            f"({T} % {g} = {T % g}); the JAX package's grouping fails at "
            f"this length too")
    return g


def rank_groups(T: int):
    """(g, sg): the dispatch groups among this rank's T tokens and the
    tokens of a group. One process groups its T tokens as the reference
    does; under a mesh the global batch's T * |data| tokens are grouped
    (`dispatch_groups`), and this rank's tokens must be whole groups of
    them, else ValueError (its groups would not be the reference's)."""
    mesh = active_mesh()
    n = 1 if mesh is None else mesh.axis_size(data_axes(mesh))
    T_all = T * n
    sg = T_all // dispatch_groups(T_all)
    if T % sg:
        raise ValueError(
            f"moe_apply: a rank's {T} tokens are not whole dispatch groups of "
            f"the global batch's {T_all} tokens over {n} data-parallel ranks "
            f"(groups of {sg}); choose a batch whose rank shares hold whole "
            f"groups")
    return T // sg, sg


def moe_apply(cfg, p, x):
    """x (B,S,d) -> (y (B,S,d), aux dict). On a 'seq' shard x holds this
    rank's positions of its rows; the layer gathers the whole rows, routes
    them and returns its positions' outputs."""
    x_loc = x
    x = gather_seq(x, 1)
    B, S, d = x.shape
    E = cfg.moe.num_experts
    k = cfg.moe.top_k
    g, sg = rank_groups(B * S)
    xt = x.reshape(g, sg, d)

    logits = (xt.float() @ p["router"]["w"].float()).float()   # (g, sg, E)
    probs = torch.softmax(logits, dim=-1)

    # capacity per expert; floor keeps tiny (decode) batches dropless
    C = max(int(sg * k * CAPACITY_FACTOR / E), min(sg * k, 8))

    # top-k routing with per-expert capacity via cumulative position
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)          # (g, sg, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    w = p["experts"]
    # 'model' splits the experts, else d_ff within each expert (the
    # reference's _FALLBACKS), else neither
    by_expert = model_split(E)
    split = by_expert or model_split(cfg.d_ff)
    if split:
        # the gate values enter this rank's region (its experts' slice of
        # the combine, or its d_ff slice of every expert's output)
        gate_vals = copy_to_model(gate_vals)

    dispatch = torch.zeros((g, sg, E, C), dtype=x.dtype, device=x.device)
    combine = torch.zeros((g, sg, E, C), dtype=torch.float32,
                          device=x.device)
    for slot in range(k):
        onehot = F.one_hot(gate_idx[..., slot], E).float()       # (g,sg,E)
        pos = torch.cumsum(onehot, dim=1) - onehot   # position within expert
        for prev in range(slot):
            # slot-major ordering: all of slot `prev`'s assignments precede
            # slot `slot`'s, so offset by the TOTAL per-expert count (GShard)
            prev_oh = F.one_hot(gate_idx[..., prev], E).float()
            pos = pos + prev_oh.sum(dim=1, keepdim=True)
        keep = (pos < C).float() * onehot
        # positions past capacity are dropped by `keep` (jax.nn.one_hot
        # gives them a zero row; F.one_hot refuses them, hence the clamp)
        posc = F.one_hot(pos.long().clamp(max=C - 1), C).float()
        d_oh = keep[..., None] * posc                            # (g,sg,E,C)
        dispatch = dispatch + d_oh.to(x.dtype)
        combine = combine + d_oh * gate_vals[..., slot][..., None, None]

    if split:
        # this rank's experts (or all of them, each its d_ff slice), on the
        # input that enters the rank's region; the output is partial
        if by_expert:
            E_loc = w["w_out"].shape[-3]
            e0 = model_offset(E_loc)
            dispatch = dispatch[:, :, e0:e0 + E_loc]
            combine = combine[:, :, e0:e0 + E_loc]
        xt = copy_to_model(xt)
    xe = torch.einsum("gsec,gsd->gecd", dispatch, xt)            # (g,E,C,d)
    h = torch.einsum("gecd,edf->gecf", xe, w["w_in"].to(x.dtype))
    h = h * F.silu(torch.einsum("gecd,edf->gecf", xe,
                                w["w_gate"].to(x.dtype)))
    ye = torch.einsum("gecf,efd->gecd", h, w["w_out"].to(x.dtype))
    y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), ye)
    if split:
        # the rank's partial output, summed over the model line in fp32
        y = reduce_from_model(y)

    # aux losses
    me = probs.mean(dim=1)                                       # (g,E)
    ce = F.one_hot(gate_idx[..., 0], E).float().mean(dim=1)
    lb_loss = E * (me * ce).sum(dim=-1).mean()
    z_loss = (torch.logsumexp(logits, dim=-1) ** 2).mean()

    y = y.reshape(B, S, d)
    if seq_size(active_mesh()) > 1:
        S_loc = x_loc.shape[1]
        y = y.narrow(1, seq_start(S_loc), S_loc)
    if "dense_residual" in p:
        y = y + mlp(cfg, p["dense_residual"], x_loc,
                    ff=cfg.moe.dense_residual_ff)
    return y, {"lb_loss": lb_loss, "z_loss": z_loss}
