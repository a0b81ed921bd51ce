"""Building blocks as plain functions on tensors. Parameters are a
`ParamTree` — an nn.Module whose nested keys and layouts are the JAX
package's: linear weights are (d_in, d_out) and applied as `x @ W`, and
per-layer tensors are stacked on a leading layer axis. Compute dtype follows
the input; norm statistics and softmax run in fp32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class ParamTree(nn.Module):
    """Nested parameter dict as an nn.Module: `tree["attn"]["wq"]` and
    `"bq" in tree` read like the JAX package's dict pytree, and
    `state_dict()` keys are its tree paths joined by dots
    ("layers.attn.wq"). Serving needs no gradients, so parameters are
    created with requires_grad=False; `trainable=True` makes every
    floating-point leaf require grad (the trainer's fp32 masters)."""

    def __init__(self, tree: dict, *, trainable: bool = False):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, ParamTree) and not trainable:
                self.add_module(key, val)
            elif isinstance(val, (dict, ParamTree)):
                self.add_module(key, ParamTree(dict(val.items()),
                                               trainable=trainable))
            else:
                grad = trainable and val.is_floating_point()
                self.register_parameter(
                    key, nn.Parameter(val.detach(), requires_grad=grad))

    def __getitem__(self, key):
        if key in self._parameters:
            return self._parameters[key]
        return self._modules[key]

    def __contains__(self, key):
        return key in self._parameters or key in self._modules

    def keys(self):
        return list(self._parameters) + list(self._modules)

    def items(self):
        return [(k, self[k]) for k in self.keys()]


def tree_map(fn, tree) -> dict:
    """`fn` applied to every tensor of a ParamTree or nested dict; returns
    nested dicts of the same keys."""
    return {k: tree_map(fn, v) if isinstance(v, (dict, ParamTree)) else fn(v)
            for k, v in tree.items()}


def layer_view(tree, i: int) -> dict:
    """Layer `i` of a tree of stacked per-layer tensors, as a dict of
    views."""
    return {k: layer_view(v, i) if isinstance(v, (dict, ParamTree)) else v[i]
            for k, v in tree.items()}


def he_init(gen, shape, fan_in, dtype, device, layers=None):
    """normal / sqrt(fan_in), drawn in fp32 and cast to `dtype`; with
    `layers`, a stacked (layers, *shape) tensor filled one layer at a time
    so the fp32 draw never exceeds one layer's size."""
    def draw():
        x = torch.randn(shape, generator=gen, device=device)
        return (x / math.sqrt(max(fan_in, 1))).to(dtype)
    if layers is None:
        return draw()
    out = torch.empty((layers, *shape), dtype=dtype, device=device)
    for i in range(layers):
        out[i] = draw()
    return out


# -- norms -------------------------------------------------------------------

def rmsnorm(p, x, eps=1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"].to(x.dtype)


def layernorm(p, x, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)   # jnp.var
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


def norm_init(cfg, device, layers=None):
    """LayerNorm (scale 1, bias 0) for the encoder and audio families with
    relu/gelu MLPs, RMSNorm (scale 1) otherwise; fp32, stacked over
    `layers` when given."""
    shape = (cfg.d_model,) if layers is None else (layers, cfg.d_model)
    p = {"scale": torch.ones(shape, dtype=torch.float32, device=device)}
    if cfg.act in ("gelu", "relu") and cfg.family in ("encoder", "audio"):
        p["bias"] = torch.zeros(shape, dtype=torch.float32, device=device)
    return p


def norm(cfg, p, x):
    if "bias" in p:
        return layernorm(p, x, cfg.norm_eps)
    return rmsnorm(p, x, cfg.norm_eps)


# -- linear / embedding ------------------------------------------------------

def linear(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embed(p, tokens, dtype):
    # F.embedding, not p["w"][tokens]: the indexed read's backward on CUDA
    # walks each run of equal tokens serially, and ListOps puts most of a
    # batch on the PAD row; embedding's backward splits long runs
    return F.embedding(tokens, p["w"]).to(dtype)


def unembed(p, x):
    """Tied or standalone LM head: x (.., d) @ w.T (vocab, d)."""
    return x @ p["w"].to(x.dtype).T


# -- positions ---------------------------------------------------------------

def rope(x, positions, theta):
    """x: (..., seq, heads, head_dim). positions: (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., :, None].float() * freqs          # (..., seq, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- mlp ---------------------------------------------------------------------

def mlp_init(gen, cfg, dtype, device, layers=None):
    d, ff = cfg.d_model, cfg.d_ff
    p = {"w_in": he_init(gen, (d, ff), d, dtype, device, layers)}
    if cfg.act == "silu":  # gated (swiglu)
        p["w_gate"] = he_init(gen, (d, ff), d, dtype, device, layers)
    p["w_out"] = he_init(gen, (ff, d), ff, dtype, device, layers)
    return p


def mlp(cfg, p, x):
    h = x @ p["w_in"].to(x.dtype)
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * h
    elif cfg.act == "relu":
        h = F.relu(h)
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return h @ p["w_out"].to(x.dtype)
