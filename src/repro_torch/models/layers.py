"""Building blocks as plain functions on tensors. Parameters are a
`ParamTree` — an nn.Module whose nested keys and layouts are the JAX
package's: linear weights are (d_in, d_out) and applied as `x @ W`, and
per-layer tensors are stacked on a leading layer axis. Compute dtype follows
the input; norm statistics and softmax run in fp32.

On a mesh with a 'model' axis a leaf may be this rank's shard
(distributed/sharding.py): where `model_split` of the config's full
dimension says so, a layer runs column-parallel (`copy_to_model` on its
input), row-parallel (`row_parallel`: partial products in the activation
dtype, summed over the line in fp32) or vocab-parallel. A norm over a
width the rank holds only part of (`rmsnorm` and `layernorm` with
`width=`) sums its statistic over the line.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.sharding import (copy_to_model, model_line_sum,
                                              model_offset, model_split,
                                              reduce_from_model)


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


def normal_init(gen, shape, scale, dtype, device, layers=None):
    """normal * scale, drawn in fp32 and cast to `dtype`; stacked over
    `layers` as `he_init` does."""
    out = torch.empty(shape if layers is None else (layers, *shape),
                      dtype=dtype, device=device)
    for view in (out if layers is not None else [out]):
        view.copy_(torch.randn(shape, generator=gen, device=device) * scale)
    return out


# -- norms -------------------------------------------------------------------

def rmsnorm(p, x, eps=1e-5, width=None):
    """RMSNorm with fp32 statistics. `width`: the whole width when x holds
    this rank's part of it on a 'model' axis (p's scale the same slice):
    the mean square is then the whole width's, the rank's sum of squares
    summed over the model line in fp32, forward and backward
    (`model_line_sum`)."""
    xf = x.float()
    if width is None or width == x.shape[-1]:
        var = (xf * xf).mean(dim=-1, keepdim=True)
    else:
        var = model_line_sum((xf * xf).sum(dim=-1, keepdim=True)) / width
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"].to(x.dtype)


def layernorm(p, x, eps=1e-5, width=None):
    """LayerNorm with fp32 statistics (jnp.var's). `width` as in `rmsnorm`:
    the mean and then the variance are the whole width's, each summed over
    the model line."""
    xf = x.float()
    if width is None or width == x.shape[-1]:
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    else:
        mu = model_line_sum(xf.sum(dim=-1, keepdim=True)) / width
        var = model_line_sum(((xf - mu) ** 2).sum(dim=-1, keepdim=True)) \
            / width
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


def row_parallel(x, w):
    """x @ w where x's last dim and w's first are this rank's shard of the
    contraction over the model line: the partial product a GEMM in x's
    dtype (fp32 accumulation), summed over the line in fp32, cast to x's
    dtype."""
    return reduce_from_model(x @ w.to(x.dtype))


def embed(p, tokens, dtype, vocab=None):
    """Token embeddings. Where 'model' splits the `vocab` rows, the table
    is this rank's shard of them: tokens outside it read zeros, and the
    rows are summed over the model line (one rank holds each)."""
    # F.embedding, not p["w"][tokens]: the indexed read's backward on CUDA
    # walks each run of equal tokens serially, and ListOps puts most of a
    # batch on the PAD row; embedding's backward splits long runs
    w = p["w"]
    if vocab is None or not model_split(vocab):
        return F.embedding(tokens, w).to(dtype)
    local = tokens - model_offset(w.shape[0])
    inside = (local >= 0) & (local < w.shape[0])
    e = F.embedding(torch.where(inside, local, 0), w)
    return reduce_from_model(torch.where(inside[..., None], e, 0), dtype)


def unembed(p, x, vocab=None):
    """Tied or standalone LM head: x (.., d) @ w.T (vocab, d). Where 'model'
    splits the `vocab` rows, this rank's shard of the logits
    (vocab-parallel: the loss never gathers them)."""
    w = p["w"]
    if vocab is not None and model_split(vocab):
        x = copy_to_model(x)
    return x @ w.to(x.dtype).T


# -- positions ---------------------------------------------------------------

def sinusoidal_positions(length, d, device="cpu"):
    """(length, d) fp32 table: sin over the first d/2 columns, cos over the
    rest. Computed in numpy float64 and cast to float32 once, as the JAX
    package does, so the two tables are bitwise equal."""
    pos = np.arange(length)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos * (1.0 / (10_000 ** (2 * dim / d)))
    table = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


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

def mlp_init(gen, cfg, dtype, device, layers=None, ff=None):
    d, ff = cfg.d_model, ff or cfg.d_ff
    p = {"w_in": he_init(gen, (d, ff), d, dtype, device, layers)}
    if cfg.act == "silu":  # gated (swiglu)
        p["w_gate"] = he_init(gen, (d, ff), d, dtype, device, layers)
    p["w_out"] = he_init(gen, (ff, d), ff, dtype, device, layers)
    return p


def mlp(cfg, p, x, ff=None):
    """The MLP of hidden width `ff` (default cfg.d_ff); where 'model'
    splits it, on this rank's d_ff shard: column-parallel w_in and w_gate,
    row-parallel w_out."""
    split = model_split(ff or cfg.d_ff)
    if split:
        x = copy_to_model(x)
    h = x @ p["w_in"].to(x.dtype)
    if "w_gate" in p:
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * h
    elif cfg.act == "relu":
        h = F.relu(h)
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    if split:
        return row_parallel(h, p["w_out"])
    return h @ p["w_out"].to(x.dtype)
