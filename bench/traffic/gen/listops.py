"""ListOps (Nangia & Bowman 2018) as the Long Range Arena generates it
(Tay et al. 2021, lra_benchmarks/data/listops.py), from a seed: a tree's
node is an operator with probability `op_p` (LRA's VALUE_P, 0.25) above
`max_depth` (10) and a digit otherwise, an operator takes 2 to `max_args`
(10) arguments, and a tree is kept when its LRA length (two tokens an
operator, "[MAX" and "]", one a digit) lies strictly between `min_len`
(500) and `max_len` (2000). The task is LRA's: the tree's value, a class
of ten, read at the CLS position in front of the tree.

`make_pool(traffic, model, seed)` -> `traffic["pool"]` host batches of
`batch` rows of `seq_len` positions, batch k drawn from numpy's generator
seeded by (seed, k): `tokens` (CLS, the tree, then PAD), `labels` (the
value's digit token at position 0, PAD elsewhere) and `loss_mask` (1 at
position 0 only), so that the non-causal encoder cannot read its target
from its input.
"""
from __future__ import annotations

import numpy as np

OPS = ["MIN", "MAX", "MED", "SM"]
# vocab: 0 PAD, 1 CLS, 3 "]", 4-7 the operators ("[MIN" ...), 8-17 digits
PAD, CLS, CLOSE = 0, 1, 3
OP0 = 4
DIG0 = 8


class _Draws:
    """Uniform draws in [0, 1) from numpy's generator, in bulk."""

    def __init__(self, rng, n=1 << 16):
        self.rng, self.n, self.buf, self.i = rng, n, [], 0

    def __call__(self):
        if self.i == len(self.buf):
            self.buf, self.i = self.rng.random(self.n).tolist(), 0
        self.i += 1
        return self.buf[self.i - 1]


class _TooLong(Exception):
    pass


def _tree(u, depth, mix, out):
    """Appends one node's tokens to `out` and returns its value; raises
    _TooLong once `out` passes `max_len` (the tree would be dropped)."""
    if depth < mix["max_depth"] and u() <= mix["op_p"]:
        n = 2 + int(u() * (mix["max_args"] - 1))
        op = int(u() * len(OPS))
        out.append(OP0 + op)
        vals = [_tree(u, depth + 1, mix, out) for _ in range(n)]
        out.append(CLOSE)
        if len(out) > mix["max_len"]:
            raise _TooLong
        return _value(op, vals)
    d = int(u() * 10)
    out.append(DIG0 + d)
    return d


def _value(op, vals):
    if OPS[op] == "MIN":
        return min(vals)
    if OPS[op] == "MAX":
        return max(vals)
    if OPS[op] == "MED":              # int(np.median(vals)), as LRA takes it
        s, n = sorted(vals), len(vals)
        return s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) // 2
    return sum(vals) % 10


def listops_row(u, mix):
    """(CLS and one tree's tokens, its value), retried until the tree's
    length lies strictly between `min_len` and `max_len`."""
    while True:
        toks = [CLS]
        try:
            val = _tree(u, 1, mix, toks)
        except _TooLong:
            continue
        if mix["min_len"] < len(toks) - 1 < mix["max_len"]:
            return toks, val


def make_pool(traffic, model, seed):
    B, S = traffic["batch"], traffic["seq_len"]
    if traffic["max_len"] > S:
        raise ValueError(f"max_len {traffic['max_len']} does not fit in "
                         f"seq_len {S} after CLS")
    pool = []
    for k in range(traffic["pool"]):
        u = _Draws(np.random.default_rng([int(seed), k]))
        tokens = np.full((B, S), PAD, np.int32)
        labels = np.full((B, S), PAD, np.int32)
        mask = np.zeros((B, S), np.float32)
        for i in range(B):
            toks, val = listops_row(u, traffic)
            tokens[i, :len(toks)] = toks
            labels[i, 0] = DIG0 + val
            mask[i, 0] = 1.0
        pool.append({"tokens": tokens, "labels": labels, "loss_mask": mask})
    return pool


def describe(pool):
    """What a run's detail line says of the pool: the share of positions
    that are PAD, and the mean tokens a row (CLS and the tree)."""
    toks = np.concatenate([b["tokens"] for b in pool])
    used = (toks != PAD).sum(axis=1)
    return {"pad_share": float(1 - used.mean() / toks.shape[1]),
            "row_tokens_mean": float(used.mean())}
