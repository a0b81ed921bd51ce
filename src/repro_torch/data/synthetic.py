"""Synthetic data generated from a seed: LM token streams (for the
assigned-arch smoke/bench paths) plus geometry-matched versions of the
paper's other two LRA tasks (pixel-sequence classification, byte-level
document matching). See DESIGN.md §6 for the validation strategy. A copy
of the JAX package's module of the same name.
"""
from __future__ import annotations

import numpy as np


def lm_batch_iterator(rng, *, batch, seq_len, vocab, structured=True):
    """Infinite synthetic LM stream. `structured` mixes short-range
    (copy/ngram) structure so losses actually go down during examples."""
    while True:
        if structured:
            base = rng.integers(0, vocab, size=(batch, seq_len // 4 + 1))
            toks = np.repeat(base, 4, axis=1)[:, :seq_len]
            noise = rng.random((batch, seq_len)) < 0.1
            toks = np.where(noise, rng.integers(0, vocab, size=(batch, seq_len)), toks)
        else:
            toks = rng.integers(0, vocab, size=(batch, seq_len))
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        yield {"tokens": tokens, "labels": labels}


def synthetic_task_batch(rng, task, *, batch, seq_len, num_classes=10):
    """Paper-geometry classification batches:
      image:     pixel sequences (L=1024 in the paper) whose class controls a
                 2-D frequency pattern — requires long-range aggregation.
      retrieval: two byte docs concatenated; label = shared-prefix parity.
    """
    if task == "image":
        cls = rng.integers(0, num_classes, size=(batch,))
        t = np.arange(seq_len)
        freq = (cls[:, None] + 1) * 2 * np.pi / seq_len
        wave = np.sin(freq * t[None, :]) + 0.3 * rng.standard_normal((batch, seq_len))
        toks = np.clip(((wave + 2) / 4 * 255), 0, 255).astype(np.int32)
        return toks, cls.astype(np.int32)
    if task == "retrieval":
        half = seq_len // 2
        a = rng.integers(0, 256, size=(batch, half))
        same = rng.random(batch) < 0.5
        b = np.where(same[:, None], a, rng.integers(0, 256, size=(batch, half)))
        toks = np.concatenate([a, b], axis=1).astype(np.int32)
        return toks, same.astype(np.int32)
    raise ValueError(task)
