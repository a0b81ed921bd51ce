"""ListOps generator — the real task from Nangia & Bowman (2018), as used by
LRA and the paper's §5 ListOps evaluation, generated from the original
grammar and a seed rather than downloaded. A copy of the JAX package's
module of the same name: the same seed gives the same batches.

Grammar: expressions over {MIN, MAX, MED, SM (sum mod 10)} applied to digits
0-9, arbitrary nesting. Tokenised to a fixed vocab; padded to max_len.
"""
from __future__ import annotations

import numpy as np

OPS = ["MIN", "MAX", "MED", "SM"]
# vocab: 0 PAD, 1 CLS, 2 (, 3 ), 4-7 ops, 8-17 digits
PAD, CLS, OPEN, CLOSE = 0, 1, 2, 3
OP0 = 4
DIG0 = 8
VOCAB_SIZE = 18


def _sample_tree(rng, depth, max_args):
    if depth <= 0 or rng.random() < 0.3:
        return int(rng.integers(0, 10))
    op = OPS[rng.integers(0, len(OPS))]
    n = int(rng.integers(2, max_args + 1))
    return (op, [_sample_tree(rng, depth - 1, max_args) for _ in range(n)])


def _eval(node):
    if isinstance(node, int):
        return node
    op, args = node
    vals = [_eval(a) for a in args]
    if op == "MIN":
        return min(vals)
    if op == "MAX":
        return max(vals)
    if op == "MED":
        return int(np.median(vals))
    return sum(vals) % 10


def _tokens(node, out):
    if isinstance(node, int):
        out.append(DIG0 + node)
        return
    op, args = node
    out.append(OPEN)
    out.append(OP0 + OPS.index(op))
    for a in args:
        _tokens(a, out)
    out.append(CLOSE)


def generate_listops(rng, max_len, depth=6, max_args=5):
    """One (tokens, label) sample, retrying until it fits max_len."""
    while True:
        tree = _sample_tree(rng, depth, max_args)
        toks = [CLS]
        _tokens(tree, toks)
        if 8 <= len(toks) <= max_len:
            arr = np.full((max_len,), PAD, np.int32)
            arr[: len(toks)] = toks
            return arr, _eval(tree)


def make_listops_batch(rng, batch, max_len, depth=6):
    xs = np.zeros((batch, max_len), np.int32)
    ys = np.zeros((batch,), np.int32)
    for i in range(batch):
        xs[i], ys[i] = generate_listops(rng, max_len, depth)
    return xs, ys
