"""Structured LM tokens from a seed, with patch embeddings for the vlm
family: a frozen copy of the program's stream (src/repro_torch/data/
synthetic.lm_batch_iterator, structured: runs of four equal tokens with 10%
noise over the whole vocabulary).

`make_pool(traffic, model, seed)` -> `traffic["pool"]` host batches, batch
k drawn from numpy's generator seeded by (seed, k): `batch` rows of
`seq_len` positions. With `patches` > 0 the first `patches` positions are
patch embeddings, N(0, 1) * `patch_scale` at d_model (the vision frontend
is not modelled), and the rest text with next-token labels over the text.
"""
from __future__ import annotations

import numpy as np


def make_pool(traffic, model, seed):
    B, P = traffic["batch"], traffic.get("patches", 0)
    T = traffic["seq_len"] - P
    V, d = model["vocab_size"], model["d_model"]
    pool = []
    for k in range(traffic["pool"]):
        rng = np.random.default_rng([int(seed), k])
        base = rng.integers(0, V, size=(B, (T + 1) // 4 + 1))
        toks = np.repeat(base, 4, axis=1)[:, :T + 1]
        noise = rng.random((B, T + 1)) < 0.1
        toks = np.where(noise, rng.integers(0, V, size=(B, T + 1)), toks)
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        if P:
            batch["patch_embeds"] = (rng.standard_normal((B, P, d)) *
                                     traffic["patch_scale"]).astype(np.float32)
        pool.append(batch)
    return pool
