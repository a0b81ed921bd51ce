"""Uniform model API over every family: dense, moe, vlm and encoder
through models/transformer, ssm through models/rwkv, hybrid through
models/hybrid, audio / encdec through models/encdec.

build(cfg) -> ModelBundle with:
    init(generator=None, *, device=None) -> params (a ParamTree)
    forward(params, batch, *, spion=None, capture=None) -> (logits, aux)
    loss(params, batch, *, spion=None, capture=None) -> (loss, aux)
    loss_parts(params, batch, *, spion=None, capture=None) -> (nll_sum,
        count, extra, aux): the loss before its division, for a mean over
        ranks (loss = nll_sum / count + extra); on a vlm 'seq' shard the
        nll of the text it holds (0 and 0 when it holds none); the same
        three on every rank of a 'model' line (the vocab-parallel loss)
    init_cache(batch_size, max_len, *, device=None) -> cache
    decode_step(params, cache, tokens, pos, *, spion=None) -> (logits, cache)
    prefill_kv(params, batch, *, spion=None) -> (logits, ks, vs) — the fused
        serving prefill; None for the families without one (ssm, hybrid,
        audio / encdec), which the serving engine prefills stepwise
    supports_sparse_decode, supports_paged_cache — capability flags, False
        for the ssm family (recurrent state, no attention KV cache), checked
        where steps and engines are built
`device=None` means the first CUDA card (see repro_torch.resolve_device).
input_specs(cfg, shape), cache_specs(cfg, B, S), params_specs(cfg): the
dry run's shapes and dtypes as meta-device tensors (no allocation), the
reference's ShapeDtypeStruct trees.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import (active_mesh, model_max,
                                              model_offset, model_split,
                                              reduce_from_model, seq_size)
from repro_torch.models import encdec, hybrid, rwkv, transformer

MOE_LB_WEIGHT = 0.01
MOE_Z_WEIGHT = 1e-3


class ModelBundle(NamedTuple):
    cfg: ModelConfig
    init: Callable
    forward: Callable
    loss: Callable
    init_cache: Callable
    decode_step: Callable
    prefill_kv: Optional[Callable] = None
    # capability flags, checked at engine/step construction: the ssm
    # family keeps recurrent state, so there is no attention KV cache to
    # sparsify or page
    supports_sparse_decode: bool = True
    supports_paged_cache: bool = True
    loss_parts: Optional[Callable] = None


def _family_module(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm", "encoder"):
        return transformer
    if cfg.family == "ssm":
        return rwkv
    if cfg.family == "hybrid":
        return hybrid
    if cfg.family in ("audio", "encdec"):
        return encdec
    raise ValueError(cfg.family)


def nll_terms(logits, labels, mask=None):
    """(sum of the token nll, the tokens it sums over): the cross entropy
    before its division, so ranks holding shards of one batch can take the
    global mean (the mask's tokens all-reduced, not a mean of means)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return _summed(logz - gold, mask)


def vocab_parallel_nll_terms(logits, labels, mask=None):
    """`nll_terms` of logits of which this rank holds a shard of the
    vocabulary (the model line's ranks in order): the max and the sum of
    exp over the line, the target's logit from the rank that holds it, all
    in fp32. The logits are never gathered; every rank of the line gets
    the same terms."""
    logits = logits.float()
    V = logits.shape[-1]
    m = model_max(logits.detach().amax(dim=-1))
    sumexp = reduce_from_model(torch.exp(logits - m[..., None]).sum(dim=-1))
    local = labels.long() - model_offset(V)
    inside = (local >= 0) & (local < V)
    gold = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])
    gold = reduce_from_model(torch.where(inside, gold[..., 0], 0.0))
    return _summed(torch.log(sumexp) + m - gold, mask)


def _summed(nll, mask):
    """(sum of the token nll over `mask`, the tokens it sums over)."""
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum(), mask.sum()
    return nll.sum(), torch.tensor(float(nll.numel()), device=nll.device)


def cross_entropy(logits, labels, mask=None):
    nll_sum, count = nll_terms(logits, labels, mask)
    return nll_sum / count.clamp(min=1.0)


def build(cfg: ModelConfig) -> ModelBundle:
    mod = _family_module(cfg)

    def init(generator=None, *, device=None):
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return mod.init(cfg, generator, dev)

    def forward(params, batch, *, spion=None, capture=None):
        return mod.forward(params, cfg, batch, spion=spion, capture=capture)

    def text_logits(logits, batch):
        if cfg.num_patch_tokens and "patch_embeds" in batch:
            # vlm: logits cover [patch, text]; the loss is over text only.
            # A 'seq' shard holds a cut of that concatenation: its own
            # patches (maybe none) precede its text (maybe none)
            P = cfg.num_patch_tokens if seq_size(active_mesh()) == 1 \
                else batch["patch_embeds"].shape[1]
            return logits[:, P:]
        return logits

    def loss_parts(params, batch, *, spion=None, capture=None):
        logits, aux = forward(params, batch, spion=spion, capture=capture)
        # a head split over 'model' gives this rank's vocabulary shard
        terms = vocab_parallel_nll_terms if model_split(cfg.vocab_size) \
            else nll_terms
        nll_sum, count = terms(text_logits(logits, batch), batch["labels"],
                               batch.get("loss_mask"))
        extra = 0.0
        if cfg.moe is not None and "lb_loss" in aux:
            extra = MOE_LB_WEIGHT * aux["lb_loss"] + \
                MOE_Z_WEIGHT * aux["z_loss"]
        return nll_sum, count, extra, aux

    def loss(params, batch, *, spion=None, capture=None):
        nll_sum, count, extra, aux = loss_parts(params, batch, spion=spion,
                                                capture=capture)
        return nll_sum / count.clamp(min=1.0) + extra, aux

    def init_cache(batch_size, max_len, *, device=None, **kw):
        return mod.init_cache(cfg, batch_size, max_len,
                              device=resolve_device(device), **kw)

    def decode_step(params, cache, tokens, pos, *, spion=None):
        return mod.decode_step(params, cfg, cache, tokens, pos, spion=spion)

    prefill_kv = None
    if hasattr(mod, "prefill_step"):
        def prefill_kv(params, batch, *, spion=None):
            return mod.prefill_step(params, cfg, batch, spion=spion)

    has_kv = cfg.family != "ssm"
    return ModelBundle(cfg, init, forward, loss, init_cache, decode_step,
                       prefill_kv, supports_sparse_decode=has_kv,
                       supports_paged_cache=has_kv, loss_parts=loss_parts)


# ---------------------------------------------------------------------------
# dry-run specs: shapes and dtypes as meta tensors (no allocation)
# ---------------------------------------------------------------------------

def _sd(shape, dtype):
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """{'batch': ...} for train / prefill shapes (prefill without labels),
    {'cache': ..., 'tokens': ..., 'pos': ...} for decode: one new token
    against a cache of length S. vlm: the text is S less the patch
    tokens; audio / encdec: frames (B, S, d)."""
    B, S = shape.global_batch, shape.seq_len
    tok = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.family in ("audio", "encdec"):
            batch = {"frames": _sd((B, S, cfg.d_model), cfg.dtype),
                     "tokens": _sd((B, S), tok),
                     "labels": _sd((B, S), tok)}
        elif cfg.family == "vlm":
            S_text = S - cfg.num_patch_tokens
            batch = {"tokens": _sd((B, S_text), tok),
                     "patch_embeds": _sd((B, cfg.num_patch_tokens,
                                          cfg.d_model), cfg.dtype),
                     "labels": _sd((B, S_text), tok)}
        else:
            batch = {"tokens": _sd((B, S), tok), "labels": _sd((B, S), tok)}
        if shape.kind == "prefill":
            batch.pop("labels")
        return {"batch": batch}
    return {"cache": cache_specs(cfg, B, S), "tokens": _sd((B, 1), tok),
            "pos": _sd((), tok)}


def cache_specs(cfg: ModelConfig, B: int, S: int) -> dict:
    """The decode cache's leaves at batch B and length S: the ssm family's
    fp32 token-shift and WKV states; the hybrid's fp32 conv and SSM states
    per layer and its K/V per shared-block application; audio / encdec
    self and cross K/V at S; the others K/V at min(S, sliding_window)."""
    hd = cfg.resolved_head_dim
    f32 = torch.float32
    L, KV = cfg.num_layers, cfg.num_kv_heads
    cdt = cfg.cache_dtype or cfg.dtype
    if cfg.family == "ssm":
        H, d = cfg.num_heads, cfg.d_model
        return {"tm_prev": _sd((L, B, d), f32), "cm_prev": _sd((L, B, d), f32),
                "S": _sd((L, B, H, hd, hd), f32)}
    if cfg.family == "hybrid":
        from repro_torch.models.mamba import CONV_W, NGROUPS
        ssm = cfg.ssm
        inner = ssm.expand * cfg.d_model
        conv_dim = inner + 2 * NGROUPS * ssm.state_size
        napps = hybrid.n_attn_apps(cfg)
        return {"conv": _sd((L, B, CONV_W - 1, conv_dim), f32),
                "ssm": _sd((L, B, inner // ssm.head_dim, ssm.state_size,
                            ssm.head_dim), f32),
                "k": _sd((napps, B, S, KV, hd), cdt),
                "v": _sd((napps, B, S, KV, hd), cdt)}
    if cfg.family in ("audio", "encdec"):
        kv = _sd((L, B, S, KV, hd), cdt)
        return {"k": kv, "v": kv, "ck": kv, "cv": kv}
    S_eff = min(S, cfg.sliding_window) if cfg.sliding_window else S
    return {"k": _sd((L, B, S_eff, KV, hd), cdt),
            "v": _sd((L, B, S_eff, KV, hd), cdt)}


def params_specs(cfg: ModelConfig):
    """The parameters' shapes and dtypes: `build(cfg).init` on the meta
    device (a ParamTree of meta tensors; nothing is allocated)."""
    return build(cfg).init(torch.Generator().manual_seed(0), device="meta")
