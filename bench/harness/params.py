"""The initial parameters of a cell, made from the seed on the device.

One `torch.randn` over every random leaf at once from a generator on the
device, then each leaf scaled in place: N(0, 1) / sqrt(fan_in) for the
projections, N(0, 1) * 0.02 for the embeddings and the head, ones and
zeros for the norms. fp32, the masters' type. The program and the reference
both start from this tree; neither makes it. The layout (names, stacked
per-layer leaves, (d_in, d_out) weights) is the transformer family's, read
from the configuration file alone.
"""
from __future__ import annotations

import math

import torch

MAX_POS = 65_536            # the learned-position table's rows (encoder)
EMBED_SCALE = 0.02


def leaf_shapes(model):
    """{dotted name: shape} of the transformer family's parameters for the
    configuration file's `model` section."""
    L, d, V = model["num_layers"], model["d_model"], model["vocab_size"]
    H, KV = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or d // H
    ff = model["d_ff"]
    layernorm = model["act"] in ("gelu", "relu") and \
        model["family"] in ("encoder", "audio")
    shapes = {"tok_embed.w": (V, d), "final_norm.scale": (d,),
              "layers.attn_norm.scale": (L, d),
              "layers.mlp_norm.scale": (L, d),
              "layers.attn.wq": (L, d, H * hd),
              "layers.attn.wk": (L, d, KV * hd),
              "layers.attn.wv": (L, d, KV * hd),
              "layers.attn.wo": (L, H * hd, d),
              "layers.mlp.w_in": (L, d, ff),
              "layers.mlp.w_out": (L, ff, d)}
    if layernorm:
        for n in ("final_norm", "layers.attn_norm", "layers.mlp_norm"):
            shapes[f"{n}.bias"] = shapes[f"{n}.scale"]
    if model["act"] == "silu":
        shapes["layers.mlp.w_gate"] = (L, d, ff)
    if not model.get("tie_embeddings", False):
        shapes["lm_head.w"] = (V, d)
    if not model.get("rope_theta"):
        shapes["pos_embed.w"] = (MAX_POS, d)
    return shapes


def _scale(name, shape):
    if name.split(".")[0] in ("tok_embed", "lm_head", "pos_embed"):
        return EMBED_SCALE
    return 1.0 / math.sqrt(shape[-2])


def make_params(model, seed, device):
    """{dotted name: fp32 tensor} from `seed` on `device`."""
    shapes = leaf_shapes(model)
    random = [n for n in sorted(shapes) if not n.endswith((".scale", ".bias"))]
    total = sum(math.prod(shapes[n]) for n in random)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for n in random:
        k = math.prod(shapes[n])
        out[n] = flat[at:at + k].view(shapes[n]).mul_(_scale(n, shapes[n]))
        at += k
    for n in shapes:
        if n.endswith(".scale"):
            out[n] = torch.ones(shapes[n], device=device)
        elif n.endswith(".bias"):
            out[n] = torch.zeros(shapes[n], device=device)
    return out


def nested(named):
    """{dotted name: tensor} -> nested dicts by the name's parts."""
    out = {}
    for name, v in named.items():
        *head, last = name.split(".")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out
