"""The numbers that decide `correct`, from two sides' readings of the same
checked steps, and their judgement against the cell's limits.

A side's readings (what `kinds/training.Cell.setup` reads from the
program, or `reference/follow.follow` from the reference):
  losses  [loss of each checked step]
  grad    {phase: {leaf: norm of the clipped gradient that the optimizer
           got at the phase's first checked step}}
  update  {leaf: norm of the change of the leaf over the checked steps}
  pooled  (Ly, n, n) numpy: the capture's pooled map (sparse cells)
  tables  {col_idx, nvalid, row_idx, nvalid_t} numpy (sparse cells)

The numbers (each a gap of the program, or the side in its place, from the
float32 reference):
  loss     the largest relative gap of a checked step's loss
  grad     the worst leaf's gap of gradient norms, over the phases
  grad_median  the median leaf's gap of gradient norms, the larger over
           the phases: steadier from seed to seed than the worst leaf's
  update   the worst leaf's gap of the change's norms; leaves whose
           reference gradient is under MOVED_FLOOR of the median leaf's
           move by round-off alone and are left out
  capture  the largest gap of a layer's pooled map from the reference's
           own capture, over that map's largest value
  tables   the entries in which the program's plan tables differ from the
           frozen flood fill's and transpose's of the program's own pooled
           map (an exact comparison)
A leaf's gap is |program norm - reference norm| over the larger of the
reference's norm of that leaf and of the median leaf.
"""
from __future__ import annotations

import numpy as np

MOVED_FLOOR = 1e-3


def leaf_gaps(prog, ref, skip=()):
    """{leaf: gap of its norm}, as the module's docstring says."""
    keys = [k for k in ref if k not in skip]
    median = float(np.median([ref[k] for k in keys]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
            for k in keys}


def worst_leaf(prog, ref, skip=()):
    return max(leaf_gaps(prog, ref, skip).values())


def worst_leaves(prog, ref):
    """Where `compare`'s leaf numbers come from: {"grad": [phase, leaf,
    gap], "update": [leaf, gap]} of the worst leaves."""
    grad = max(([ph, k, g] for ph in ref["grad"] for k, g in
                leaf_gaps(prog["grad"][ph], ref["grad"][ph]).items()),
               key=lambda x: x[2])
    upd = leaf_gaps(prog["update"], ref["update"], skip=unmoved(ref))
    leaf = max(upd, key=upd.get)
    return {"grad": grad, "update": [leaf, upd[leaf]]}


def unmoved(ref):
    """The leaves whose reference gradient, at the first phase's first
    checked step, is under MOVED_FLOOR of the median leaf's."""
    first = next(iter(ref["grad"].values()))
    median = float(np.median(list(first.values())))
    return {k for k, v in first.items() if v < MOVED_FLOOR * median}


def table_mismatch(got, want):
    """Entries of `got`'s tables that differ from `want`'s (a table of
    another shape counts whole, plus one)."""
    bad = 0
    for k, w in want.items():
        g = np.asarray(got.get(k))
        w = np.asarray(w)
        if g.shape != w.shape:
            bad += w.size + 1
        else:
            bad += int((g != w).sum())
    return bad


def compare(prog, ref):
    """{number: value} of `prog`'s readings against the reference's."""
    out = {
        "loss": max(abs(p - r) / abs(r)
                    for p, r in zip(prog["losses"], ref["losses"])),
        "grad": max(worst_leaf(prog["grad"][ph], ref["grad"][ph])
                    for ph in ref["grad"]),
        "grad_median": max(float(np.median(list(leaf_gaps(
            prog["grad"][ph], ref["grad"][ph]).values())))
            for ph in ref["grad"]),
        "update": worst_leaf(prog["update"], ref["update"],
                             skip=unmoved(ref)),
    }
    if len(prog["losses"]) != len(ref["losses"]):
        out["loss"] = float("inf")
    if ref.get("pooled") is not None:
        gaps = [np.abs(p - r).max() / np.abs(r).max()
                for p, r in zip(np.asarray(prog["pooled"], np.float64),
                                np.asarray(ref["pooled"], np.float64))]
        out["capture"] = float(max(gaps))
        out["tables"] = table_mismatch(prog["tables"], ref["tables"])
    return {k: float(v) for k, v in out.items()}


def judge(numbers, limits):
    """(correct, [(name, value, limit)]) for every number that has a limit:
    correct when each is finite and at most its limit."""
    rows = [(n, numbers.get(n, float("nan")), limits[n]) for n in limits]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return bool(ok), rows
