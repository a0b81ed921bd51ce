#!/usr/bin/env python3
"""Which op of the spion-lra train step is not bitwise reproducible on one
NVIDIA card, and how far a faulty restore moves the resumed losses.

    python3 chip_repro.py [--dense N] [--sparse N] [--ops N]

Trains spion-lra at LRA ListOps size into the sparse phase as
chip_smoke.py's phase 5 does (13 steps), then, from that one state and one
batch, repeats the dense step's loss and gradients N times and the sparse
step's N times, and prints, for every output that ever differs from the
first repetition, in how many it differed and by how much. The backward
runs from the loss down, so a leaf that differs while the leaves before it
in the backward do not names the op that alone feeds it. Then repeats
F.embedding's backward alone at the step's shapes and dtypes (N 0 skips
a probe; all three 0 skip the training too).

Then the restore faults: trains 20 steps with checkpoints at 7 and 14 (the
uninterrupted run), and for each planted fault restores step 14 into a
fresh Trainer, plants it (the step count one ahead, the data offset one
ahead, the first moments left at zero) and trains the 6 steps again: the
largest relative gap of those losses to the uninterrupted run's, beside
chip_smoke.py's TOL_RESUME, says whether its resume and respawn gates would
catch such a fault. The first row restores with no fault. Exits 2 without
a card.
"""
import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def repeat(label, fn, n, log):
    """fn() -> {name: tensor}, n times after a first call; per name, the
    repetitions that differ from the first and the largest |difference|."""
    import torch
    if not n:
        return {}
    first = fn()
    counts, worst = {}, {}
    t = time.perf_counter()
    for _ in range(n):
        for k, v in fn().items():
            d = (v.float() - first[k].float()).abs().max().item()
            if d:
                counts[k] = counts.get(k, 0) + 1
                worst[k] = max(worst.get(k, 0.0), d)
    torch.cuda.synchronize()
    log(f"{label}: {n} repetitions in {time.perf_counter() - t:.1f} s; "
        + (", ".join(f"{k} differs in {c} (max |diff| {worst[k]:.3e})"
                     for k, c in counts.items())
           or f"all {len(first)} outputs bitwise equal every time"))
    return counts


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dense", type=int, default=60)
    ap.add_argument("--sparse", type=int, default=150)
    ap.add_argument("--ops", type=int, default=1000)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_repro: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels.block_sparse_attn import load_library
    log = cs.log
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"{cs.card_line()}; torch {torch.__version__}")
    load_library()
    if args.dense or args.sparse or args.ops:
        repeats(cs, args, log)
    restore_faults(cs, log)
    return 0


def repeats(cs, args, log):
    """The dense and sparse steps' loss and gradients, and F.embedding's
    backward, repeated from one state (see the module's docstring)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.launch.steps import make_loss_and_grads
    tr, cfg, _ = cs.lra_trainer()
    tr.train(cs.RESUME_AT - 1, log_every=10**9, log=lambda m: None)
    cs.check(tr.spion_state.phase == "sparse", "the sparse phase not reached")
    batch, fn = tr._next_batch(), make_loss_and_grads(cfg)
    for label, tables, n in (("dense", None, args.dense),
                             ("sparse", tr._attention_exec(), args.sparse)):
        def step():
            loss, grads = fn(tr.params, batch, tables)
            return {"loss": loss.detach().reshape(1), **grads}
        repeat(f"{label} step's loss and gradients at step {tr.step}", step,
               n, log)

    # the token embedding's backward alone: the step's tokens, its fp32
    # master cast to bf16 as the step casts it, a bf16 upstream gradient
    w = tr.params["tok_embed"]["w"].detach().clone().requires_grad_(True)
    gen = torch.Generator(device=w.device).manual_seed(cs.SEED)
    up = torch.randn((*batch["tokens"].shape, w.shape[1]), generator=gen,
                     device=w.device).to(torch.bfloat16)

    def embed_backward():
        w.grad = None
        F.embedding(batch["tokens"], w.to(torch.bfloat16)).backward(up)
        return {"tok_embed.w": w.grad.clone()}
    repeat("F.embedding's backward alone", embed_backward, args.ops, log)


def restore_faults(cs, log):
    """The resumed losses' gap to the uninterrupted run's under each planted
    restore fault (see the module's docstring)."""
    import shutil
    import torch
    d = os.path.join(ROOT, "build", "chip_repro_ckpt")
    shutil.rmtree(d, ignore_errors=True)
    tr, _, _ = cs.lra_trainer(ckpt_dir=d)
    ref = tr.train(cs.TRAIN_STEPS, ckpt_every=cs.CKPT_EVERY,
                   log_every=10**9, log=lambda m: None)[cs.RESUME_AT:]
    del tr

    def count(t):
        t.opt["count"] = t.opt["count"] + 1

    def offset(t):
        t.data_offset += 1

    def first_moments(t):
        for v in t.opt["mu"].values():
            v.zero_()
    for label, plant in (("no fault", None), ("count + 1", count),
                         ("data_offset + 1", offset),
                         ("mu left at zero", first_moments)):
        tr, _, _ = cs.lra_trainer(ckpt_dir=d, sentinel=False)
        tr._restore_latest(step=cs.RESUME_AT)
        cs.check(tr.spion_state.phase == "sparse", "not a sparse checkpoint")
        if plant:
            plant(tr)
        got = tr.train(cs.TRAIN_STEPS - cs.RESUME_AT, ckpt_every=0,
                       log_every=10**9, log=lambda m: None)
        torch.cuda.synchronize()
        gap = cs.loss_gap(got, ref)
        log(f"restore fault {label!r} at step {cs.RESUME_AT}: resumed losses "
            f"{', '.join(f'{x:.6f}' for x in got)} vs the uninterrupted "
            f"{', '.join(f'{x:.6f}' for x in ref)}: max rel {gap:.3e} "
            f"({gap / cs.TOL_RESUME:.3g}x TOL_RESUME {cs.TOL_RESUME})")
        del tr


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
