"""The reference's run of a cell's checked steps, and what it reads
(harness/check.py lists the readings).

The steps are the set-up's, in its order: `dense_steps` dense steps on the
pool's batches 0, 1, ..., the capture on the last of them (batch 0 when
there is none), the plan from a pooled map, then `sparse_steps` sparse
steps; the reference follows the first `checked_steps` of them. The plan's
tables come from the frozen flood fill (reference/pattern.py) of the
pooled map it is given: the program's, whose capture the check holds
against the reference's own, or, with none given, the reference's own.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.harness.params import make_params
from bench.reference.model import (Model, clip_and_adamw, cosine_lr,
                                   set_precision)
from bench.reference.pattern import plan_tables


def step_phases(traffic):
    """The phase of each set-up step before the window, in order."""
    return ["dense"] * traffic["dense_steps"] + \
        ["sparse"] * traffic.get("sparse_steps", 0)


def capture_index(traffic):
    """The pool index of the batch the capture reads."""
    return max(traffic["dense_steps"] - 1, 0)


def loss_count(batch, rows=None):
    """The positions the loss of a batch's first `rows` rows covers: its
    `loss_mask`'s ones, or every label."""
    if "loss_mask" in batch:
        return float(np.asarray(batch["loss_mask"])[:rows].sum())
    return float(np.asarray(batch["labels"])[:rows].size)


def leaf_norms(tensors):
    return {n: float(torch.linalg.vector_norm(t.float()))
            for n, t in tensors.items()}


def to_device(batch, device, rows=slice(None)):
    return {k: torch.as_tensor(np.asarray(v)[rows], device=device)
            for k, v in batch.items()}


def follow(config, traffic, seed, pool, device, *, precision="fp32",
           pooled_of=None, half=False):
    """Readings of the reference's checked steps. `precision` "fp8" is
    the control (reference/model.py); `half` a planted fault: each step's
    loss the mean over the first half of the rows only."""
    set_precision()
    model, spion = config["model"], config["spion"]
    net = Model(model, spion, precision)
    chunk = traffic["ref_chunk"]
    P = {n: t.detach().requires_grad_(True)
         for n, t in make_params(model, seed, device).items()}
    opt = {"count": 0, "mu": {n: torch.zeros_like(p) for n, p in P.items()},
           "nu": {n: torch.zeros_like(p) for n, p in P.items()}}
    out = {"losses": [], "grad": {}, "pooled": None, "tables": None}
    tables = None
    rows = traffic["batch"] // 2 if half else traffic["batch"]
    phases = step_phases(traffic)[:traffic["checked_steps"]]
    for i, phase in enumerate(phases):
        if phase == "sparse" and tables is None:
            cap = to_device(pool[capture_index(traffic)], device)
            own = net.capture(P, cap, spion["conv_filter_size"], chunk)
            out["pooled"] = own.cpu().numpy()
            src = out["pooled"] if pooled_of is None else pooled_of
            out["tables"] = plan_tables(src, spion["alpha_quantile"],
                                        model["causal"])[0]
            col = torch.as_tensor(out["tables"]["col_idx"], device=device)
            nv = torch.as_tensor(out["tables"]["nvalid"], device=device)
            tables = [(col[layer], nv[layer]) for layer in range(len(col))]
        batch = pool[i % len(pool)]
        count = loss_count(batch, rows)
        total = 0.0
        for r in range(0, rows, chunk):
            part = to_device(batch, device, slice(r, min(r + chunk, rows)))
            nll = net.nll(P, part, tables if phase == "sparse" else None)
            (nll / count).backward()
            total += float(nll.detach())
        out["losses"].append(total / count)
        grads = {n: p.grad for n, p in P.items()}
        lr = cosine_lr(i, traffic["lr"], traffic["total_steps"])
        clipped = clip_and_adamw({n: p.data for n, p in P.items()}, grads,
                                 opt, lr)
        if phase not in out["grad"]:
            out["grad"][phase] = leaf_norms(clipped)
        del clipped, grads
        for p in P.values():
            p.grad = None
    del opt
    init = make_params(model, seed, device)
    out["update"] = leaf_norms({n: P[n].detach() - init[n] for n in P})
    return out
