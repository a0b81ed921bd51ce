"""Sparsity-pattern generation: the paper's convolutional flood fill
(Algorithms 3 & 4) plus the SPION-C / SPION-F variants and the fixed-pattern
baselines (BigBird-style) the paper compares against.

Host-side NumPy: pattern generation runs ONCE per transition, between
training steps (paper §4.1). A copy of the JAX package's module of the same
name (it is numpy there too), so the same pooled map gives the same pattern
bit for bit; its flood fill is the explicit-stack one (Alg. 4 without
recursion limits).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


# ---------------------------------------------------------------------------
# Alg. 3 components
# ---------------------------------------------------------------------------

def diagonal_filter(F: int) -> np.ndarray:
    """The (F x F) diagonal convolution filter's diagonal taps (uniform)."""
    return np.full((F,), 1.0 / F, np.float64)


def diag_conv(a: np.ndarray, filt: np.ndarray) -> np.ndarray:
    """Eq. 3: conv_out(i,j) = sum_f a(i+f, j+f) * filt(f), zero padded."""
    L = a.shape[0]
    out = np.zeros_like(a, dtype=np.float64)
    F = len(filt)
    for f in range(F):
        out[: L - f, : L - f] += filt[f] * a[f:, f:]
    return out


def avg_pool(a: np.ndarray, B: int) -> np.ndarray:
    """Eq. 4: (L,L) -> (L/B, L/B) block means."""
    L = a.shape[0]
    nb = L // B
    return a[: nb * B, : nb * B].reshape(nb, B, nb, B).mean(axis=(1, 3))


def upsample(mask: np.ndarray, B: int) -> np.ndarray:
    """Nearest-neighbour upsample: each block entry -> B x B block (Alg.3 l.11)."""
    return np.repeat(np.repeat(mask, B, axis=0), B, axis=1)


# ---------------------------------------------------------------------------
# Alg. 4: flood fill
# ---------------------------------------------------------------------------

def _neighbors(r, c):
    return ((r + 1, c), (r, c + 1), (r + 1, c + 1))


def flood_fill_iterative(pool_out: np.ndarray, fl_out: np.ndarray, t: float) -> np.ndarray:
    """Alg. 3 lines 5-8 + Alg. 4, with an explicit DFS stack.

    Seeds: every top-row element (0, i) and left-column element (j, 0).
    From (r, c): among the 3 neighbours (down, right, down-right), those
    equal to the max AND unvisited AND > t are marked and explored.
    """
    n = pool_out.shape[0]
    for seed in [(0, i) for i in range(n)] + [(j, 0) for j in range(n)]:
        stack = [seed]
        while stack:
            r, c = stack.pop()
            if r + 1 >= n or c + 1 >= n:
                continue
            nb = _neighbors(r, c)
            vals = [pool_out[x] for x in nb]
            m = max(vals)
            for (x, v) in zip(nb, vals):
                if v == m and fl_out[x] == 0 and v > t:
                    fl_out[x] = 1
                    stack.append(x)
    return fl_out


# ---------------------------------------------------------------------------
# generate_pattern (Alg. 3) + variants
# ---------------------------------------------------------------------------

def generate_pattern(
    a_s: Optional[np.ndarray],
    *,
    variant: str = "cf",
    conv_filter_size: int = 31,
    block_size: int = 64,
    alpha_quantile: float = 0.96,
    pooled: Optional[np.ndarray] = None,
    causal: bool = False,
) -> np.ndarray:
    """Return the block-level sparsity pattern fl_out (L/B x L/B) in {0,1}.

    Either `a_s` (the L x L head-averaged attention scores) or `pooled` (the
    already pooled conv output from the streaming capture path) is given.

    variant: "cf" conv+floodfill (SPION-CF) | "f" floodfill only (SPION-F)
             | "c" conv + top-(1-alpha)% blocks (SPION-C).
    causal: restrict the pattern to the lower block-triangle (decoder archs).
    """
    if pooled is None:
        if a_s is None:
            raise ValueError("generate_pattern needs a_s or pooled")
        a = np.asarray(a_s, np.float64)
        if variant in ("cf", "c"):
            a = diag_conv(a, diagonal_filter(conv_filter_size))
        pooled = avg_pool(a, block_size)
    else:
        pooled = np.asarray(pooled, np.float64)
        if variant == "f":
            # streamed capture applies the conv; SPION-F wants raw pooling.
            # The conv is linear and near-norm-preserving; with uniform taps
            # pooled-conv ~ pooled for F << B, so reuse (documented deviation).
            pass
    n = pooled.shape[0]
    if causal:
        pooled = np.where(np.tril(np.ones_like(pooled, bool)), pooled, -np.inf)

    if variant == "c":
        finite = pooled[np.isfinite(pooled)]
        t = np.quantile(finite, alpha_quantile)
        fl = (pooled > t).astype(np.int8)
    else:
        finite = pooled[np.isfinite(pooled)]
        t = float(np.quantile(finite, alpha_quantile))
        fl = np.zeros((n, n), np.int8)
        flood_fill_iterative(pooled, fl, t)

    # Alg. 3 lines 9-10: diagonal always on
    np.fill_diagonal(fl, 1)
    if causal:
        fl = np.tril(fl)
    return fl


def pattern_to_bcsr(fl_out: np.ndarray, block_size: int, max_k: Optional[int] = None):
    """Block mask -> padded BCSR tables (see core.sparse_attention.BCSR)."""
    from repro_torch.core.sparse_attention import bcsr_from_blockmask
    return bcsr_from_blockmask(fl_out.astype(bool), block_size, max_k)


# ---------------------------------------------------------------------------
# Fixed-pattern baselines (paper §5 comparison models)
# ---------------------------------------------------------------------------

def bigbird_pattern(n: int, *, window: int = 3, num_global: int = 2,
                    num_random: int = 3, seed: int = 0, causal: bool = False) -> np.ndarray:
    """BigBird block pattern: sliding window + global rows/cols + random."""
    rng = np.random.default_rng(seed)
    m = np.zeros((n, n), np.int8)
    for off in range(-(window // 2), window // 2 + 1):
        idx = np.arange(max(0, -off), min(n, n - off))
        m[idx, idx + off] = 1
    m[:num_global, :] = 1
    m[:, :num_global] = 1
    for r in range(n):
        cols = rng.choice(n, size=min(num_random, n), replace=False)
        m[r, cols] = 1
    if causal:
        m = np.tril(m)
    np.fill_diagonal(m, 1)
    return m


def window_pattern(n: int, *, window: int = 3, causal: bool = False) -> np.ndarray:
    """Plain sliding-window (Sparse Transformer / Longformer core)."""
    return bigbird_pattern(n, window=window, num_global=0, num_random=0, causal=causal)


def density(fl_out: np.ndarray) -> float:
    return float(np.mean(fl_out > 0))
