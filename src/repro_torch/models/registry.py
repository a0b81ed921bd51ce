"""Uniform model API over the families ported so far (dense and encoder).

build(cfg) -> ModelBundle with:
    init(generator=None, *, device=None) -> params (a ParamTree)
    forward(params, batch, *, spion=None, capture=None) -> (logits, aux)
    loss(params, batch, *, spion=None, capture=None) -> (loss, aux)
    init_cache(batch_size, max_len, *, device=None) -> cache
    decode_step(params, cache, tokens, pos, *, spion=None) -> (logits, cache)
    prefill_kv(params, batch, *, spion=None) -> (logits, ks, vs) — the fused
        serving prefill
`device=None` means the first CUDA card (see repro_torch.resolve_device).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

# where each family waits in ROADMAP.md queue A
_PENDING = {"moe": "A11", "vlm": "A11", "ssm": "A11", "hybrid": "A11",
            "audio": "A11", "encdec": "A11"}


class ModelBundle(NamedTuple):
    cfg: ModelConfig
    init: Callable
    forward: Callable
    loss: Callable
    init_cache: Callable
    decode_step: Callable
    prefill_kv: Optional[Callable] = None


def cross_entropy(logits, labels, mask=None):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp(min=1.0)
    return nll.mean()


def build(cfg: ModelConfig) -> ModelBundle:
    if cfg.family not in ("dense", "encoder"):
        item = _PENDING.get(cfg.family, "A11")
        raise NotImplementedError(
            f"family {cfg.family!r} (arch {cfg.name!r}) is not ported yet; "
            f"it waits in ROADMAP.md item {item}")
    mod = transformer

    def init(generator=None, *, device=None):
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        return mod.init(cfg, generator, dev)

    def forward(params, batch, *, spion=None, capture=None):
        return mod.forward(params, cfg, batch, spion=spion, capture=capture)

    def loss(params, batch, *, spion=None, capture=None):
        logits, aux = forward(params, batch, spion=spion, capture=capture)
        return cross_entropy(logits, batch["labels"],
                             batch.get("loss_mask")), aux

    def init_cache(batch_size, max_len, *, device=None, **kw):
        return mod.init_cache(cfg, batch_size, max_len,
                              device=resolve_device(device), **kw)

    def decode_step(params, cache, tokens, pos, *, spion=None):
        return mod.decode_step(params, cfg, cache, tokens, pos, spion=spion)

    def prefill_kv(params, batch, *, spion=None):
        return mod.prefill_step(params, cfg, batch, spion=spion)

    return ModelBundle(cfg, init, forward, loss, init_cache, decode_step,
                       prefill_kv)
