"""Step makers for serving: the fused prefill step and the decode step.

PyTorch runs eagerly, so a step is a plain closure over the model bundle;
the JAX package's jit, shardings and donation have no counterpart here (the
port updates caches in place instead of donating them).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention_exec import SparseAttentionExec
from repro_torch.core.sparse_attention import PLAN_TABLE_KEYS
from repro_torch.models.registry import build


def causal_band_tables(layers: int, nrb: int, width: Optional[int] = None):
    """Stacked causal stand-in forward tables (host numpy) for serving
    demos, benches and tests: each row-block lists its last `width` column
    blocks (width=None -> all of them: full causal coverage, the
    sparse-equals-dense case). Clamped padding past the valid prefix,
    matching the JAX package's function of the same name."""
    K = nrb if width is None else width
    col = np.zeros((layers, nrb, K), np.int32)
    nval = np.zeros((layers, nrb), np.int32)
    for r in range(nrb):
        lo = 0 if width is None else max(r - width + 1, 0)
        cs = list(range(lo, r + 1))
        col[:, r, : len(cs)] = cs
        col[:, r, len(cs):] = cs[-1]
        nval[:, r] = len(cs)
    return {"col_idx": col, "nvalid": nval}


def _coerce_step_tables(tables, *, block, phase):
    """Normalise a step's sparse-tables argument to a SparseAttentionExec:
    an exec passes through; a dict payload gets the step's block."""
    if tables is None:
        return None
    if isinstance(tables, SparseAttentionExec):
        return tables
    arrays = {k: tables[k] for k in PLAN_TABLE_KEYS if k in tables}
    return SparseAttentionExec(arrays, block=block, phase=phase)


def make_prefill_step(cfg: ModelConfig, *, spion=False, block=None,
                      with_cache=False):
    """Prefill step: logits over the full prompt. `with_cache=True` builds
    the FUSED serving prefill instead — (params, batch[, tables]) ->
    (logits, ks, vs) with ks/vs the per-layer RoPE'd K/V stacked
    (L, B, S, KV, hd), ready for direct insertion into decode-cache pages
    (launch/serve.ServeEngine)."""
    bundle = build(cfg)
    static_block = block or cfg.spion.block_size

    def prefill(params, batch, tables=None):
        ex = _coerce_step_tables(tables, block=static_block, phase="prefill")
        if with_cache:
            return bundle.prefill_kv(params, batch, spion=ex)
        logits, _ = bundle.forward(params, batch, spion=ex)
        return logits

    if spion:
        return prefill
    return functools.partial(prefill, tables=None)


def make_serve_step(cfg: ModelConfig, *, spion=False, block=None):
    """Decode step: (params, cache, tokens, pos[, tables]) -> (logits,
    cache). `pos` may be a scalar or per-row (B,) vector; with `spion` the
    decode is sparse over the pattern-listed cache blocks. The cache may be
    the contiguous dict or a core.kv_pool.PagedKVCache."""
    bundle = build(cfg)
    static_block = block or cfg.spion.block_size

    def serve_step(params, cache, tokens, pos, tables=None):
        ex = _coerce_step_tables(tables, block=static_block, phase="decode")
        return bundle.decode_step(params, cache, tokens, pos, spion=ex)

    if spion:
        return serve_step
    return functools.partial(serve_step, tables=None)
