#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--before DIR]

Phases (each one fails the run; nothing falls back to the CPU):
  1. print the card's name and power limit; turn TF32 off;
  2. build the Hopper kernels from src/repro_torch/kernels/csrc (timed);
  3. hold the block-sparse attention kernel against its plain PyTorch
     version on the card: a sweep over fp32/bf16, causal / non-causal /
     causal + sliding window, G in {1, 4, 7}, empty rows, clamped padded
     tables and global offsets; then the bf16 (tensor-core) kernel at every
     head dim and block it takes, with column ids outside the K range mixed
     into the tables; then the serving path's own shape in fp32 and in bf16
     (each bf16 element of o within 2 bf16 ulps of itself);
     then the dQ and dK/dV kernels likewise, with empty columns, the plan's
     and the fallback transposed tables; then the bf16 (tensor-core) dQ and
     dK/dV at every head dim and block they take, with row and column ids
     outside the range mixed into the tables; and the serving path's shape;
  4. serve qwen2-7b at full width and depth in bf16 with random weights
     from a seed: ServeEngine(slots=4, max_len=2048) over a SPION plan of
     random causal block masks, six requests of 16 new tokens; the kernel's
     launch count must rise by 28 (one per layer) for every fused prefill;
     then one 1024-token prompt prefilled through a fully covering plan
     (the kernel) and densely must give the same logits in fp32, and in
     bf16 the kernel's prefill must be no farther from the fp32 logits
     than the dense bf16 prefill is;
  5. train spion-lra at its published width under the LRA ListOps preset
     (batch 128 x 2048 tokens) through Trainer for 20 steps: dense steps,
     the flood-fill transition, then sparse steps that must each launch 8
     forward, 4 dQ and 4 dK/dV kernels; profile one sparse step;
  6. hold the three kernels against their plain versions at the training
     path's shape on the trained plan's tables, in fp32 and bf16;
  7. one train step through a fully covering plan against the dense step:
     equal in fp32, and in bf16 no farther from the fp32 gradients than
     1.1 x the dense step, leaf by leaf on each layer's attention leaves;
  8. time every kernel, its plain version and PyTorch's
     scaled_dot_product_attention (forward, or its backward for dQ and
     dK/dV) beside the kernel's bound; with --before DIR (another checkout,
     e.g. the parent commit unpacked by git archive), that checkout's dQ
     and dK/dV kernels too, in turns with these, as before_ms;
  9. resume: train spion-lra as in 5 with checkpoints under
     build/chip_smoke_ckpt (steps 7 and 14), resume a fresh Trainer from
     the sparse-phase checkpoint: step, data offset, phase, plan digest,
     masters and moments as saved; one sparse step run twice from it,
     bitwise or not (printed; chip_repro.py finds the op that is not);
     every resumed sparse step launches 8 + 4 + 4 kernels; the losses
     equal phase 5's within TOL_RESUME;
 10. rollback: NaN-poison the masters at sparse step 17 (ChaosMonkey) on a
     copy of those checkpoints: one rollback to the pinned good step 16,
     the poisoned save quarantined, the data offset advanced by the window,
     the replayed steps on the restored plan's kernels, every loss finite;
 11. respawn: FleetSupervisor (nproc 1) runs this script as the training
     worker (--train-worker DIR) from the dense checkpoint of step 7 with
     SPION_CHAOS_KILL_STEP=16: one respawn, generation 1 resumes in the
     sparse phase to bitwise the state generation 0 saved at step 14 and
     finishes, the stitched losses equal phase 5's within TOL_RESUME, the
     heartbeat payload reads back. Save, restore, respawn and rollback
     seconds are printed beside the card's name and power limit.
The line before the last is the kernels' JSON record (launches_resume,
launches_rollback and launches_respawn count each kernel's launches in
phases 9-11, each read from zero); the last line is
{"ok": true, "device": {...}}.
"""
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
DEVICE = "cuda"
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3
TOL_O = {"float32": 3e-5, "bfloat16": 6e-2}
BF16_ULPS = 2     # bf16 o: each element within 2 units in its last place
TOL_LSE = 1e-4
TOL_LOGITS = 6e-2
# bf16 prefill through the kernel vs through dense attention, each against
# the fp32 dense logits: the kernel's max and mean distance may exceed the
# dense path's by 10% (on the card they read 0.986 and 0.964 of it)
BF16_LOGITS_SLACK = 1.1
PATH = dict(N=4, G=7, S=2048, hd=128, block=128)   # qwen2-7b prefill, B=1
# spion-lra under the LRA ListOps preset: N = B * KV = 128 * 4
TRAIN_PATH = dict(N=512, G=1, S=2048, hd=16, block=64)
# dq, dk, dv (fp32 outputs) against their plain versions: fp32 inputs
# within TOL_GRAD and at most GRAD_SHARE of the mean |grad|; bf16 inputs
# within BF16_ULPS bf16 ulps of the element plus BF16_GRAD_FLOOR
TOL_GRAD = 1e-3
GRAD_SHARE = 0.01
BF16_GRAD_FLOOR = 2e-6   # over 3x the most an element needed on the card
TOL_PLAN = 1e-6     # dK/dV through the plan's tables vs bcsr_transpose's
SOURCES = "src/repro_torch/kernels/csrc/"
REPLACES = "src/repro/kernels/block_sparse_attn.py:"
KERNELS = {         # wrapper: (source, the TPU kernel it replaces)
    "block_sparse_fwd": (SOURCES + "block_sparse_fwd_sm90.cuh",
                         REPLACES + "138"),
    "block_sparse_dq": (SOURCES + "block_sparse_dq_sm90.cuh",
                        REPLACES + "281"),
    "block_sparse_dkv": (SOURCES + "block_sparse_dkv_sm90.cuh",
                         REPLACES + "377"),
}


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn() over `iters` runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_tables(rng, nrb, ncb, *, causal, empty_rows=(), empty_cols=(),
                  pad=2, diag_offset=0):
    """Seeded block mask (diagonal set) as clamped, padded BCSR tables."""
    import numpy as np
    mask = rng.random((nrb, ncb)) < 0.5
    mask[np.arange(nrb), np.arange(nrb) + diag_offset] = True
    if causal:
        mask &= np.arange(ncb)[None, :] <= np.arange(nrb)[:, None] + \
            diag_offset
    for r in empty_rows:
        mask[r] = False
    for c in empty_cols:
        mask[:, c] = False
    K = int(mask.sum(1).max()) + pad
    col = np.zeros((nrb, K), np.int32)
    nvalid = mask.sum(1).astype(np.int32)
    for r in range(nrb):
        idx = np.nonzero(mask[r])[0]
        col[r, :len(idx)] = idx
        col[r, len(idx):] = idx[-1] if len(idx) else 0
    return col, nvalid


def with_bad_ids(rng, col, nvalid, ncb):
    """Kernel tables listing the same tiles as (col, nvalid), with column
    ids outside [0, ncb) mixed in among the listed entries (the kernel
    skips them) and in the padding past nvalid (never read); the plain
    version takes (col, nvalid) itself."""
    import numpy as np
    rows = []
    for r in range(len(nvalid)):
        ids = [int(c) for c in col[r, :nvalid[r]]]
        for bad in (-3, ncb, ncb + 5):
            if rng.random() < 0.5:
                ids.insert(int(rng.integers(0, len(ids) + 1)), bad)
        rows.append(ids)
    width = max(len(ids) for ids in rows) + 2
    out = np.where(rng.random((len(rows), width)) < 0.5, -1,
                   ncb + 9).astype(np.int32)
    for r, ids in enumerate(rows):
        out[r, :len(ids)] = ids
    return out, np.array([len(ids) for ids in rows], np.int32)


def o_limit(dtype, o, ref):
    """Limit on |o - plain|, element by element. Kernel and plain version
    both compute in fp32 and round once to o's dtype, so in bf16 an element
    may differ by one rounding step of its own magnitude: the limit is
    BF16_ULPS bf16 ulps of it, plus 1e-6 for fp32 summation order (capped at
    TOL_O). Long causal rows average many values to a typical |o| near
    0.05, while the first rows keep |o| near 3; a limit taken from the
    largest |o| would be as large as the typical value."""
    if dtype == "float32":
        return TOL_O[dtype]
    import torch
    top = torch.maximum(o.float().abs(), ref.float().abs())
    _, e = torch.frexp(top)                   # top = m * 2**e, m in [0.5, 1)
    ulp = torch.where(top > 0, torch.ldexp(torch.ones_like(top), e - 8), 0.0)
    return (BF16_ULPS * ulp + 1e-6).clamp(max=TOL_O[dtype])


def compare_kernel(case, gen, rng, tables=None):
    """Kernel vs plain version on one case; returns (max |do|, the limit of
    that element, the largest |do| / limit, mean |plain o|, max |dlse|,
    inputs). `tables` = (col_idx, nvalid) numpy replaces the random ones."""
    import torch
    from repro_torch.kernels.block_sparse_attn import (
        block_sparse_fwd, fused_forward_reference)
    dt = getattr(torch, case["dtype"])
    N, G, S, hd, block = (case[k] for k in ("N", "G", "S", "hd", "block"))
    offsets = case.get("offsets")
    extra = 0 if offsets is None else block
    nrb = S // block
    col, nvalid = tables if tables is not None else random_tables(
        rng, nrb, (S + extra) // block, causal=case["causal"],
        empty_rows=case.get("empty_rows", ()), pad=case.get("pad", 2),
        diag_offset=extra // block)
    dev = DEVICE
    q = torch.randn((N, G, S, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((N, S + extra, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((N, S + extra, hd), generator=gen, device=dev).to(dt)
    colt = torch.as_tensor(col, device=dev)
    nvt = torch.as_tensor(nvalid, device=dev)
    kcol, knvt = colt, nvt
    if case.get("bad_ids"):
        bad_col, bad_nv = with_bad_ids(rng, col, nvalid, (S + extra) // block)
        kcol = torch.as_tensor(bad_col, device=dev)
        knvt = torch.as_tensor(bad_nv, device=dev)
    kw = dict(block=block, causal=case["causal"],
              sliding_window=case.get("sw"), offsets=offsets,
              seq_len=None if offsets is None else 2 * (S + extra))
    o, lse = block_sparse_fwd(q, k, v, kcol, knvt, **kw)
    torch.cuda.synchronize()
    ro, rlse = fused_forward_reference(q, k, v, colt, nvt, **kw)
    diff = (o.float() - ro.float()).abs()
    limit = o_limit(case["dtype"], o, ro)
    share = (diff / limit).max().item()       # 1 is the limit
    err = diff.max().item()
    tol = limit if isinstance(limit, float) else \
        limit.flatten()[diff.argmax()].item()
    typical = ro.float().abs().mean().item()
    check(math.isfinite(share) and share <= 1.0,
          f"kernel o differs by up to {err} (up to {share:.3g} of the "
          f"limit; mean |o| {typical}) on {case}")
    inf, rinf = torch.isinf(lse), torch.isinf(rlse)
    check(torch.equal(inf, rinf), f"lse +inf pattern differs on {case}")
    lerr = (lse[~inf] - rlse[~rinf]).abs().max().item() if (~inf).any() \
        else 0.0
    check(lerr <= TOL_LSE, f"kernel lse differs by {lerr} on {case}")
    return err, tol, share, typical, lerr, (q, k, v, colt, nvt, kw)


def phase_kernel_sweep(gen, rng):
    sweep = []
    shapes = [(16, 16), (32, 32), (64, 64), (128, 128), (64, 32), (128, 64)]
    i = 0
    for dtype in ("float32", "bfloat16"):
        for causal, sw in ((True, None), (False, None), (True, 48)):
            for G in (1, 4, 7):
                hd, block = shapes[i % len(shapes)]
                i += 1
                sweep.append(dict(dtype=dtype, causal=causal, sw=sw, G=G,
                                  N=2, S=256, hd=hd, block=block,
                                  empty_rows=(1,)))
    sweep.append(dict(dtype="float32", causal=True, G=4, N=2, S=256, hd=64,
                      block=32, offsets=(3, 2), empty_rows=(0,)))
    sweep.append(dict(dtype="bfloat16", causal=False, G=7, N=2, S=256,
                      hd=128, block=64, offsets=(2, 1), pad=4))
    worst = {"float32": 0.0, "bfloat16": 0.0}
    most = 0.0         # the largest |do| / limit of a bf16 element
    for case in sweep:
        err, _, share, _, _, _ = compare_kernel(case, gen, rng)
        worst[case["dtype"]] = max(worst[case["dtype"]], err)
        if case["dtype"] == "bfloat16":
            most = max(most, share)
    log(f"kernel sweep: {len(sweep)} cases pass; worst |o - plain| "
        f"fp32 {worst['float32']:.3e} (tol {TOL_O['float32']}), bf16 "
        f"{worst['bfloat16']:.3e} (no bf16 element past {most:.3f} of its "
        f"limit of {BF16_ULPS} bf16 ulps of itself)")
    phase_bf16_shapes()
    # the path's shape in fp32 (the same kernel template, held at 3e-5),
    # then in bf16 as the serving prefill runs it
    for dtype in ("float32", "bfloat16"):
        path = dict(dtype=dtype, causal=True, pad=0, **PATH)
        err, tol, share, typical, _, inputs = compare_kernel(path, gen,
                                                             rng)
        log(f"kernel at the path's shape {PATH} {dtype} causal: "
            f"|o - plain| = {err:.3e} (that element's limit {tol:.3e}; "
            f"no element past {share:.3f} of its limit; mean |o| "
            f"{typical:.3e})")
    return err, tol, inputs


def bf16_shape_cases():
    """Every head dim and block the bf16 (tensor-core) forward takes, each
    pair once, cycling through causal / non-causal / sliding window 48, G 1,
    4 and 7, global offsets and out-of-range column ids, then K/V of fewer
    rows (N x Sk = 32) than one key tile reads; every case has an empty row
    and clamped padding."""
    from repro_torch.kernels.block_sparse_attn import _HEAD_DIMS
    cases = []
    modes = ((True, None), (False, None), (True, 48))
    for i, (hd, block) in enumerate(
            (hd, block) for hd in _HEAD_DIMS
            for block in (16, 32, 64, 80, 96, 128)):
        causal, sw = modes[i % 3]
        cases.append(dict(dtype="bfloat16", causal=causal, sw=sw,
                          G=(1, 4, 7)[(i // 3) % 3], N=2,
                          S=480 if block in (80, 96) else 256, hd=hd,
                          block=block, empty_rows=(1,), bad_ids=i % 2 == 0,
                          offsets=(2, 1) if i % 4 == 1 else None))
    cases.append(dict(dtype="bfloat16", causal=True, sw=None, G=4, N=1, S=32,
                      hd=16, block=16, empty_rows=(1,), bad_ids=False,
                      offsets=None))
    return cases


def phase_bf16_shapes():
    """The cases of bf16_shape_cases, from random streams of their own (the
    later phases draw what they drew before these cases existed)."""
    import numpy as np
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    rng = np.random.default_rng(SEED + 1)
    cases = bf16_shape_cases()
    most, worst = 0.0, 0.0
    for case in cases:
        err, _, share, _, _, _ = compare_kernel(case, gen, rng)
        most, worst = max(most, share), max(worst, err)
    log(f"bf16 kernel at every head dim x block: {len(cases)} cases pass "
        f"(causal, non-causal, window 48; G 1/4/7; offsets; out-of-range "
        f"column ids; empty rows); worst |o - plain| {worst:.3e}, no element "
        f"past {most:.3f} of its limit of {BF16_ULPS} bf16 ulps of itself")


# -- the backward kernels ----------------------------------------------------

def grad_limit(dtype, got, ref):
    """Limit on |grad - plain|, element by element. Kernel and plain version
    both compute in fp32 from the same inputs and return fp32, so they
    differ by summation order only. fp32 inputs: TOL_GRAD, or GRAD_SHARE of
    the mean |plain grad| where that is smaller. bf16 inputs: BF16_ULPS
    bf16 ulps of the element plus BF16_GRAD_FLOOR, a floor for elements
    that cancel to near zero (set from the readings, PERF.md)."""
    import torch
    if dtype == "float32":
        return min(TOL_GRAD, GRAD_SHARE * ref.abs().mean().item())
    top = torch.maximum(got.abs(), ref.abs())
    _, e = torch.frexp(top)
    ulp = torch.where(top > 0, torch.ldexp(torch.ones_like(top), e - 8), 0.0)
    return BF16_ULPS * ulp + BF16_GRAD_FLOOR


def hold_grad(name, dtype, got, ref, case):
    """Check one gradient against its plain version; returns (max |diff|,
    the largest |diff| / limit, mean |plain|, the floor this element
    needed: |diff| less its ulp part, bf16 only)."""
    import torch
    diff = (got - ref).abs()
    limit = grad_limit(dtype, got, ref)
    share = (diff / limit).max().item() if diff.numel() else 0.0
    err = diff.max().item() if diff.numel() else 0.0
    typical = ref.abs().mean().item()
    need = 0.0
    if dtype != "float32":
        need = (diff - (limit - BF16_GRAD_FLOOR)).max().clamp(min=0).item()
    check(math.isfinite(share) and share <= 1.0 and
          torch.isfinite(got).all().item(),
          f"kernel {name} differs from its plain version by up to {err} "
          f"({share:.3g} of the limit; mean |{name}| {typical}) on {case}")
    return err, share, typical, need


def backward_inputs(case, gen, rng, tables=None):
    """q, k, v, dO; the forward kernel's o and lse; delta = rowsum(dO * O)
    in fp32 (as the op's backward computes it); the forward tables and both
    transposed tables: the plan's (width KT*) and bcsr_transpose's (width
    nrb). `tables` = (col_idx, nvalid) numpy replaces the random ones."""
    import torch
    from repro_torch.core.sparse_attention import (bcsr_transpose,
                                                   host_transpose_tables)
    from repro_torch.kernels.block_sparse_attn import block_sparse_fwd
    dt = getattr(torch, case["dtype"])
    N, G, S, hd, block = (case[k] for k in ("N", "G", "S", "hd", "block"))
    offsets = case.get("offsets")
    extra = 0 if offsets is None else block
    nrb, ncb = S // block, (S + extra) // block
    if tables is None:
        tables = random_tables(
            rng, nrb, ncb, causal=case["causal"],
            empty_rows=case.get("empty_rows", ()),
            empty_cols=case.get("empty_cols", ()), pad=case.get("pad", 2),
            diag_offset=extra // block)
    col, nvalid = tables
    row_idx, nvalid_t, kt = host_transpose_tables(col, nvalid, ncb=ncb)
    dev = DEVICE
    colt = torch.as_tensor(col, device=dev)
    nvt = torch.as_tensor(nvalid, device=dev)
    fb_row, fb_nvt = bcsr_transpose(colt, nvt, ncb=ncb)
    q = torch.randn((N, G, S, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((N, S + extra, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((N, S + extra, hd), generator=gen, device=dev).to(dt)
    do = torch.randn((N, G, S, hd), generator=gen, device=dev).to(dt)
    fkw = dict(block=block, causal=case["causal"],
               sliding_window=case.get("sw"), offsets=offsets,
               seq_len=None if offsets is None else 2 * (S + extra))
    o, lse = block_sparse_fwd(q, k, v, colt, nvt, **fkw)
    delta = (do.float() * o.float()).sum(dim=-1)
    kw = dict(fkw)
    kw.pop("seq_len")
    return dict(q=q, k=k, v=v, do=do, lse=lse, delta=delta, col=colt,
                nvalid=nvt, row=torch.as_tensor(row_idx, device=dev),
                nvalid_t=torch.as_tensor(nvalid_t, device=dev), kt=kt,
                fb_row=fb_row, fb_nvalid_t=fb_nvt, kw=kw)


def compare_backward(case, gen, rng, tables=None):
    """dQ and dK/dV kernels against their plain versions on one case, with
    the plan's transposed tables (or bcsr_transpose's when case["tables"]
    is "fallback"), and out-of-range ids mixed into the kernels' tables
    when case["bad_ids"]; with the plan's, dK/dV through the fallback
    tables too, held to TOL_PLAN. Returns {grad: (err, share, mean |plain|, floor
    needed)} and the inputs."""
    import torch
    from repro_torch.kernels.block_sparse_attn import (
        block_sparse_dkv, block_sparse_dq, fused_dkv_reference,
        fused_dq_reference)
    x = backward_inputs(case, gen, rng, tables)
    args = (x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"])
    plan = case.get("tables", "plan") == "plan"
    row, nvt = (x["row"], x["nvalid_t"]) if plan else \
        (x["fb_row"], x["fb_nvalid_t"])
    check(not plan or row.shape[1] == x["kt"], "plan table width is not KT*")
    kcol, knv, krow, knvt = x["col"], x["nvalid"], row, nvt
    if case.get("bad_ids"):
        # the kernels' tables list the same in-range tiles with ids outside
        # the range mixed in; the plain versions take the clean ones
        nrb, ncb = x["q"].shape[2] // case["block"], \
            x["k"].shape[1] // case["block"]
        kcol, knv, krow, knvt = (
            torch.as_tensor(t, device=DEVICE) for t in
            with_bad_ids(rng, kcol.cpu().numpy(), knv.cpu().numpy(), ncb)
            + with_bad_ids(rng, krow.cpu().numpy(), knvt.cpu().numpy(),
                           nrb))
    dq = block_sparse_dq(*args, kcol, knv, **x["kw"])
    dk, dv = block_sparse_dkv(*args, krow, knvt, **x["kw"])
    torch.cuda.synchronize()
    rdq = fused_dq_reference(*args, x["col"], x["nvalid"], **x["kw"])
    rdk, rdv = fused_dkv_reference(*args, row, nvt, **x["kw"])
    out = {}
    for name, got, ref in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        check(got.dtype == torch.float32 and got.shape == ref.shape,
              f"{name} is {got.dtype} {tuple(got.shape)}")
        out[name] = hold_grad(name, case["dtype"], got, ref, case)
    block = case["block"]
    for r in case.get("empty_rows", ()):
        check(not dq[:, :, r * block:(r + 1) * block].any().item(),
              f"dq of the empty row block {r} is not 0 on {case}")
    for c in case.get("empty_cols", ()):
        check(not dk[:, c * block:(c + 1) * block].any().item() and
              not dv[:, c * block:(c + 1) * block].any().item(),
              f"dk/dv of the empty column block {c} are not 0 on {case}")
    if plan:
        fdk, fdv = block_sparse_dkv(*args, x["fb_row"], x["fb_nvalid_t"],
                                    **x["kw"])
        gap = max((fdk - dk).abs().max().item(),
                  (fdv - dv).abs().max().item())
        check(gap <= TOL_PLAN, f"dK/dV through the plan tables differ from "
              f"the fallback tables by {gap} on {case}")
        out["plan_vs_fallback"] = gap
    return out, x


def phase_backward_sweep(gen, rng):
    """The dQ and dK/dV kernels against their plain versions: a sweep like
    the forward's, then the serving path's shape (the training path's shape
    is held after training, with the trained plan's tables)."""
    shapes = [(16, 16), (32, 32), (64, 64), (128, 128), (64, 32), (128, 64),
              (16, 128), (80, 16)]
    sweep, i = [], 0
    for dtype in ("float32", "bfloat16"):
        for causal, sw in ((True, None), (False, None), (True, 48)):
            for G in (1, 4, 7):
                hd, block = shapes[i % len(shapes)]
                i += 1
                sweep.append(dict(dtype=dtype, causal=causal, sw=sw, G=G,
                                  N=2, S=256, hd=hd, block=block,
                                  empty_rows=(1,), empty_cols=(1,),
                                  tables="plan" if i % 2 else "fallback"))
    sweep.append(dict(dtype="float32", causal=True, G=4, N=2, S=256, hd=64,
                      block=32, offsets=(3, 2), empty_rows=(0,)))
    sweep.append(dict(dtype="bfloat16", causal=False, G=7, N=2, S=256,
                      hd=128, block=64, offsets=(2, 1), pad=4,
                      tables="fallback"))
    sweep.append(dict(dtype="float32", causal=False, G=1, N=3, S=512, hd=96,
                      block=128, empty_cols=(1,)))
    # blocks above 64 that are not 128: the backward programs take half a
    # block each
    sweep.append(dict(dtype="float32", causal=True, G=2, N=2, S=480, hd=48,
                      block=96, empty_rows=(2,)))
    sweep.append(dict(dtype="bfloat16", causal=False, G=3, N=2, S=400,
                      hd=112, block=80, empty_cols=(0,), tables="fallback"))
    worst = {"float32": 0.0, "bfloat16": 0.0}
    share_most = {"float32": 0.0, "bfloat16": 0.0}
    need, gap, lowest_mean = 0.0, 0.0, math.inf
    for case in sweep:
        res, _ = compare_backward(case, gen, rng)
        gap = max(gap, res.pop("plan_vs_fallback", 0.0))
        for err, share, typical, floor in res.values():
            worst[case["dtype"]] = max(worst[case["dtype"]], err)
            share_most[case["dtype"]] = max(share_most[case["dtype"]], share)
            need = max(need, floor)
            if case["dtype"] == "float32":
                lowest_mean = min(lowest_mean, typical)
    log(f"backward sweep: {len(sweep)} cases pass (dq, dk, dv; plan and "
        f"fallback tables; empty rows and columns; offsets); worst |grad - "
        f"plain| fp32 {worst['float32']:.3e} (limit min({TOL_GRAD}, "
        f"{GRAD_SHARE} x mean |grad|), smallest mean |grad| "
        f"{lowest_mean:.3e}; no element past {share_most['float32']:.3g} of "
        f"its limit), bf16 {worst['bfloat16']:.3e} (no element past "
        f"{share_most['bfloat16']:.3g} of its limit of {BF16_ULPS} bf16 ulps "
        f"+ {BF16_GRAD_FLOOR}; the largest floor needed {need:.3e}); plan "
        f"vs fallback dK/dV {gap:.3e} (tol {TOL_PLAN})")
    phase_bf16_backward_shapes()
    for dtype in ("float32", "bfloat16"):
        res, _ = compare_backward(dict(dtype=dtype, causal=True, pad=0,
                                       **PATH), gen, rng)
        log_backward_path("serving", PATH, dtype, res)


def bf16_backward_shape_cases():
    """Every head dim and block the bf16 (tensor-core) dQ and dK/dV kernels
    take, each pair once, cycling through causal / non-causal / sliding
    window 48, G 1, 4 and 7, global offsets, out-of-range row and column
    ids, and the plan's and the fallback transposed tables; then Q/dO and
    K/V of fewer rows (N G S = N Sk = 32) than one 64-row box reads. Every
    case has an empty row block and an empty column block."""
    from repro_torch.kernels.block_sparse_attn import _HEAD_DIMS
    cases = []
    modes = ((True, None), (False, None), (True, 48))
    for i, (hd, block) in enumerate(
            (hd, block) for hd in _HEAD_DIMS
            for block in (16, 32, 64, 80, 96, 128)):
        causal, sw = modes[i % 3]
        cases.append(dict(dtype="bfloat16", causal=causal, sw=sw,
                          G=(1, 4, 7)[(i // 3) % 3], N=2,
                          S=480 if block in (80, 96) else 256, hd=hd,
                          block=block, empty_rows=(1,), empty_cols=(0,),
                          bad_ids=i % 2 == 0,
                          offsets=(2, 1) if i % 4 == 1 else None,
                          tables="fallback" if i % 5 == 2 else "plan"))
    cases.append(dict(dtype="bfloat16", causal=True, sw=None, G=1, N=1, S=32,
                      hd=16, block=16, empty_rows=(1,), empty_cols=(1,),
                      bad_ids=True, offsets=None, tables="plan"))
    return cases


def phase_bf16_backward_shapes():
    """The cases of bf16_backward_shape_cases, from random streams of their
    own, each held by compare_backward at grad_limit and TOL_PLAN."""
    import numpy as np
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    rng = np.random.default_rng(SEED + 2)
    cases = bf16_backward_shape_cases()
    most, worst, need, gap = 0.0, 0.0, 0.0, 0.0
    for case in cases:
        res, _ = compare_backward(case, gen, rng)
        gap = max(gap, res.pop("plan_vs_fallback", 0.0))
        for err, share, _, floor in res.values():
            most, worst = max(most, share), max(worst, err)
            need = max(need, floor)
    log(f"bf16 backward at every head dim x block: {len(cases)} cases pass "
        f"(causal, non-causal, window 48; G 1/4/7; offsets; out-of-range row "
        f"and column ids; empty rows and columns; plan and fallback tables); "
        f"worst |grad - plain| {worst:.3e}, no element past {most:.3f} of "
        f"its limit of {BF16_ULPS} bf16 ulps + {BF16_GRAD_FLOOR} (the "
        f"largest floor needed {need:.3e}); plan vs fallback dK/dV {gap:.3e} "
        f"(tol {TOL_PLAN})")


def log_backward_path(label, shape, dtype, res):
    gap = res.pop("plan_vs_fallback", None)
    parts = [f"{name} |diff| {err:.3e} ({share:.3g} of its limit; mean "
             f"|{name}| {typical:.3e}"
             + (f"; floor needed {need:.3e})" if dtype != "float32" else ")")
             for name, (err, share, typical, need) in res.items()]
    log(f"backward at the {label} path's shape {shape} {dtype}: "
        + "; ".join(parts)
        + ("" if gap is None else f"; plan vs fallback {gap:.3e}"))


def bwd_bytes_flops(x):
    """(dq flops, dq bytes, dkv flops, dkv bytes) that these inputs need:
    each input read once, each output written once; the listed tiles
    only."""
    N, G, S, hd = x["q"].shape
    block = x["kw"]["block"]
    es = x["q"].element_size()
    nv, cols = x["nvalid"].cpu().numpy(), x["col"].cpu().numpy()
    nvt, rows = x["nvalid_t"].cpu().numpy(), x["row"].cpu().numpy()
    listed, listed_t = int(nv.sum()), int(nvt.sum())
    kcols = {int(c) for r in range(len(nv)) for c in cols[r, :nv[r]]}
    qrows = {int(r) for c in range(len(nvt)) for r in rows[c, :nvt[c]]}
    rowvec = N * G * block * 4                    # one row block's lse, delta
    dq_flops = 6.0 * N * G * listed * block * block * hd
    dq_bytes = (2 * x["q"].numel() * es           # q, dO
                + 2 * N * G * S * 4               # lse, delta
                + x["q"].numel() * 4              # dq (fp32)
                + 2 * N * len(kcols) * block * hd * es   # listed K, V
                + 4 * (x["col"].numel() + x["nvalid"].numel()))
    dkv_flops = 8.0 * N * G * listed_t * block * block * hd
    dkv_bytes = (2 * x["k"].numel() * es          # k, v
                 + 2 * x["k"].numel() * 4         # dk, dv (fp32)
                 + 2 * N * G * len(qrows) * block * hd * es   # listed Q, dO
                 + 2 * len(qrows) * rowvec        # their lse, delta
                 + 4 * (x["row"].numel() + x["nvalid_t"].numel()))
    return dq_flops, dq_bytes, dkv_flops, dkv_bytes


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), \
        "operations" if t_ops >= t_bytes else "bytes"


def parent_kernels(path):
    """The kernel module of another checkout of this repository at `path`
    (its src/repro_torch/kernels/block_sparse_attn.py, which builds that
    checkout's csrc into that checkout's build/), so that its backward
    kernels are timed beside these on the same inputs."""
    import importlib.util
    src = os.path.join(os.path.abspath(path), "src", "repro_torch",
                       "kernels", "block_sparse_attn.py")
    check(os.path.exists(src), f"--before {path}: no {src}")
    spec = importlib.util.spec_from_file_location("before_block_sparse_attn",
                                                  src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def backward_timing(x, before=None):
    """ms of the dQ and dK/dV kernels and their plain versions on the
    inputs `x`, their bounds, and the autograd backward of PyTorch's dense
    scaled_dot_product_attention at the same shape (dq, dk and dv
    together, over every row) as the library yardstick; with `before` (a
    parent_kernels module), that tree's kernels too, timed in turns with
    these (before, these, these, before), as before_ms."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.block_sparse_attn import (
        block_sparse_dkv, block_sparse_dq, fused_dkv_reference,
        fused_dq_reference)
    args = (x["q"], x["k"], x["v"], x["do"], x["lse"], x["delta"])
    kw = x["kw"]
    calls = {"block_sparse_dq": args + (x["col"], x["nvalid"]),
             "block_sparse_dkv": args + (x["row"], x["nvalid_t"])}
    plain = {"block_sparse_dq": fused_dq_reference,
             "block_sparse_dkv": fused_dkv_reference}
    wrapper = {"block_sparse_dq": block_sparse_dq,
               "block_sparse_dkv": block_sparse_dkv}
    out = {}
    for name, a in calls.items():
        def now():
            return wrapper[name](*a, **kw)
        if before is None:
            out[name] = dict(ms=cuda_ms(now, 20))
        else:
            def old():
                return getattr(before, name)(*a, **kw)
            b1 = cuda_ms(old, 20)
            m1, m2 = cuda_ms(now, 20), cuda_ms(now, 20)
            b2 = cuda_ms(old, 20)
            out[name] = dict(ms=(m1 + m2) / 2, before_ms=(b1 + b2) / 2,
                             runs=(b1, m1, m2, b2))
        out[name]["plain_ms"] = cuda_ms(lambda: plain[name](*a, **kw), 3)
        # the same launch with nothing listed: what a program costs
        # before and after its tiles (the order, the stores of 0)
        empty = a[:-1] + (torch.zeros_like(a[-1]),)
        out[name]["empty_ms"] = cuda_ms(lambda: wrapper[name](*empty, **kw),
                                        20)
    q, k, v = (x[n].detach().requires_grad_() for n in "qkv")
    N, G, S, hd = q.shape
    kx = k[:, None].expand(N, G, k.shape[1], hd)
    vx = v[:, None].expand(N, G, k.shape[1], hd)
    o = F.scaled_dot_product_attention(q, kx, vx, is_causal=kw["causal"])
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        o, (q, k, v), x["do"], retain_graph=True), 10)
    dq_f, dq_b, dkv_f, dkv_b = bwd_bytes_flops(x)
    for name, flops, nbytes in (("block_sparse_dq", dq_f, dq_b),
                                ("block_sparse_dkv", dkv_f, dkv_b)):
        b_ms, by = bound(flops, nbytes)
        out[name].update(bound_ms=b_ms, bound_by=by, library_ms=library_ms,
                         flops=flops, bytes=nbytes)
        t = out[name]
        was = "" if before is None else (
            f"; before (the --before tree's kernel, timed in turns "
            f"before/now/now/before: {', '.join(f'{r:.4f}' for r in t['runs'])}"
            f" ms) {t['before_ms']:.4f} ms, {t['before_ms'] / t['ms']:.2f}x")
        log(f"{name} at N={N} G={G} S={S} hd={hd} block={kw['block']} "
            f"{q.dtype}: {t['ms']:.4f} ms{was}; with nothing listed "
            f"{t['empty_ms']:.4f} ms; plain {t['plain_ms']:.4f} ms; "
            f"sdpa backward (dense, dq+dk+dv) {library_ms:.4f} ms; bound "
            f"{b_ms:.5f} ms by {by} ({flops:.4g} flop, {nbytes} bytes); "
            f"{b_ms / t['ms']:.4f} of the bound")
    return out


def kernel_timing(inputs, label):
    """ms of the forward kernel, its plain version and SDPA on `inputs`,
    and the kernel's bound from these tables."""
    import torch.nn.functional as F
    from repro_torch.kernels.block_sparse_attn import (
        block_sparse_fwd, fused_forward_reference)
    q, k, v, col, nvalid, kw = inputs
    N, G, S, hd = q.shape
    block = kw["block"]
    ms = cuda_ms(lambda: block_sparse_fwd(q, k, v, col, nvalid, **kw), 20)
    plain_ms = cuda_ms(
        lambda: fused_forward_reference(q, k, v, col, nvalid, **kw), 5)
    # yardstick only: PyTorch's fused attention over the same rows, dense
    # (what the kernel computes when the plan covers everything)
    kx = k[:, None].expand(N, G, S, hd).contiguous()
    vx = v[:, None].expand(N, G, S, hd).contiguous()
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, kx, vx, is_causal=kw["causal"]), 20)
    nv = nvalid.cpu().numpy()
    cols = col.cpu().numpy()
    listed = int(nv.sum())
    distinct = len({int(c) for r in range(len(nv)) for c in cols[r, :nv[r]]})
    esize = q.element_size()
    flops = 4.0 * N * G * listed * block * block * hd
    nbytes = (2 * q.numel() * esize + N * G * S * 4          # q, o, lse
              + 2 * N * distinct * block * hd * esize         # listed K, V
              + col.numel() * 4 + nvalid.numel() * 4)
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"block_sparse_fwd at {label} N={N} G={G} S={S} hd={hd} "
        f"block={block} {q.dtype}: {ms:.4f} ms; plain {plain_ms:.4f} ms; "
        f"sdpa (dense{', causal' if kw['causal'] else ''}) "
        f"{library_ms:.4f} ms; bound {bound_ms:.5f} ms by {bound_by} "
        f"({flops:.4g} flop over {listed} listed tiles, {nbytes} bytes); "
        f"{bound_ms / ms:.4f} of the bound")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def profile_serving(eng, cfg, rng):
    """Device time by kernel for one sparse fused prefill of 1024 tokens and
    one decode tick of the engine's 4 slots (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    prefill = make_prefill_step(cfg, spion=True, with_cache=True)
    decode = make_serve_step(cfg, spion=True)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 1024)),
                           device=DEVICE)
    pex = eng._sparse_prefill_exec(1024)
    tok1 = torch.zeros((eng.slots, 1), dtype=torch.long, device=DEVICE)
    pos = torch.as_tensor(eng.pos.clip(0), dtype=torch.int32, device=DEVICE)
    steps = {
        "prefill 1024": lambda: prefill(eng.params, {"tokens": toks}, pex),
        "decode tick": lambda: decode(eng.params, eng.pool.cache(eng._pt_dev),
                                      tok1, pos, eng.exec),
    }
    calls = 3

    def window(fn):
        """ms a call of fn() on the host clock over `calls` calls."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / calls * 1e3

    for label, fn in steps.items():
        with torch.inference_mode():
            fn()
            plain_wall = window(fn)
            # busy time and wall time from the same profiled calls
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                wall = window(fn)
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        check(rows, f"the profiler saw no device time in {label}")
        busy = sum(e.self_device_time_total for e in rows) / 1e3 / calls
        log(f"profile {label}, {calls} calls: {wall:.2f} ms a call on the "
            f"host clock under the profiler ({plain_wall:.2f} ms without "
            f"it); device busy {busy:.2f} ms a call; idle share of the "
            f"profiled window {max(0.0, 1 - busy / wall):.3f}")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"  {e.self_device_time_total / 1e3 / calls:9.3f} ms "
                f"{e.count // calls:5d}x {e.key[:90]}")


def cast_params(tree, dtype):
    """A copy of a ParamTree with every tensor cast to `dtype`."""
    from repro_torch.models.layers import ParamTree

    def conv(node):
        return {k: conv(v) if isinstance(v, ParamTree) else v.to(dtype)
                for k, v in node.items()}
    return ParamTree(conv(tree))


def covering_and_dense(cfg, params, toks):
    """fp32 logits of a prefill through a fully covering plan (the kernel
    in every layer) and of a dense one."""
    import torch
    from repro_torch.kernels.block_sparse_attn import block_sparse_fwd
    from repro_torch.launch.steps import causal_band_tables, make_prefill_step
    prefill = make_prefill_step(cfg, spion=True, with_cache=True)
    block = cfg.spion.block_size
    cover = dict(causal_band_tables(cfg.num_layers, toks.shape[1] // block),
                 block=block)
    with torch.inference_mode():
        before = block_sparse_fwd.launches
        ls, _, _ = prefill(params, {"tokens": toks}, cover)
        check(block_sparse_fwd.launches - before == cfg.num_layers,
              "the covering prefill did not run the kernel in every layer")
        ld, _, _ = prefill(params, {"tokens": toks}, None)
        return ls.float(), ld.float()


def phase_serve(gen, rng):
    """qwen2-7b at full width and depth, bf16, through ServeEngine."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.sparse_attention import build_sparsity_plan
    from repro_torch.kernels.block_sparse_attn import block_sparse_fwd
    from repro_torch.launch.serve import Request, ServeEngine
    from repro_torch.models.registry import build

    cfg = get_config("qwen2-7b")
    check(cfg.dtype == "bfloat16" and cfg.spion.block_size == 128,
          "qwen2-7b config changed")
    t0 = time.perf_counter()
    params = build(cfg).init(gen, device=DEVICE)
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in params.parameters())
    log(f"qwen2-7b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}: {nparams} parameters initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")

    max_len, block = 2048, cfg.spion.block_size
    nrb = max_len // block
    layers = [random_tables(rng, nrb, nrb, causal=True, pad=0)
              for _ in range(cfg.num_layers)]
    K = max(c.shape[1] for c, _ in layers)
    col = np.stack([np.pad(c, ((0, 0), (0, K - c.shape[1])), mode="edge")
                    for c, _ in layers])
    nvalid = np.stack([n for _, n in layers])
    plan = build_sparsity_plan(col, nvalid, block)
    log(f"plan: {nrb} row-blocks of {block}, K={K}, density "
        f"{np.mean(plan.stats['per_layer_density']):.3f}")

    eng = ServeEngine(cfg, params, slots=4, max_len=max_len, spion=plan,
                      device=DEVICE)
    # one short request first, so that the timed run does not pay for the
    # first calls into cuBLAS and the caching allocator
    eng.run([Request(rid=-1, prompt=np.arange(128, dtype=np.int32),
                     max_new=2)])
    prefill_s, decode_s, bad = [], [], []

    def timed(fn, times):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            if not torch.isfinite(out[0]).all():
                bad.append(len(times))
            return out
        return wrapped
    eng._prefill = timed(eng._prefill, prefill_s)
    eng._decode = timed(eng._decode, decode_s)
    lens = rng.integers(200, 1501, size=6)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, size=int(n))
                    .astype(np.int32), max_new=16)
            for i, n in enumerate(lens)]

    warm = eng.prefill_fused
    block_sparse_fwd.launches = 0
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = block_sparse_fwd.launches

    check(all(r.done and len(r.out) == 16 for r in reqs),
          "a request did not get its 16 tokens")
    check(not bad, "a logit is not finite")
    prefills = eng.prefill_fused - warm
    check(prefills == len(reqs), "not every request was prefilled")
    check(launches == cfg.num_layers * prefills,
          f"{launches} kernel launches for {prefills} fused prefills of "
          f"{cfg.num_layers} layers")
    prefill_ms = 1e3 * float(np.median(prefill_s))
    decode_ms = 1e3 * float(np.median(decode_s))
    # window totals beside the medians: a stall inside the window moves
    # these and not the medians
    prefill_mean = 1e3 * sum(prefill_s) / len(prefill_s)
    decode_mean = 1e3 * sum(decode_s) / len(decode_s)
    log(f"serve: prompts {lens.tolist()}, 6 x 16 tokens in {wall:.2f} s; "
        f"kernel launches {launches} over {prefills} fused prefills; "
        f"prefill {prefill_ms:.2f} ms median, all {len(prefill_s)} "
        f"prefills {1e3 * sum(prefill_s):.2f} ms ({prefill_mean:.2f} ms "
        f"each) ({', '.join(f'{1e3 * t:.1f}' for t in prefill_s)}); decode "
        f"{decode_ms:.2f} ms per tick median, all {len(decode_s)} ticks "
        f"{1e3 * sum(decode_s):.2f} ms ({decode_mean:.2f} ms each)")
    profile_serving(eng, cfg, rng)

    # sparse (fully covering plan, so the kernel) vs dense prefill of one
    # prompt, in bf16 and with the same weights cast to fp32. In fp32 the two
    # are the same function up to summation order: gated at TOL_LOGITS. In
    # bf16 the dense path rounds scores and probabilities to bf16 (the JAX
    # package's semantics) where the kernel keeps them in fp32, so both bf16
    # prefills are held against the fp32 dense logits: the kernel's path
    # may be no farther from them than BF16_LOGITS_SLACK x the dense path.
    del eng
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 1024)),
                           device=DEVICE)
    s16, d16 = covering_and_dense(cfg, params, toks)
    p32 = cast_params(params, torch.float32)
    s32, d32 = covering_and_dense(cfg.replace(dtype="float32"), p32, toks)
    del p32

    def diff(a, b):
        d = (a - b).abs()
        return d.max().item(), d.mean().item()
    e32, e32_mean = diff(s32, d32)
    es16, es16_mean = diff(s16, d32)
    ed16, ed16_mean = diff(d16, d32)
    gap16, _ = diff(s16, d16)
    log(f"covering sparse prefill vs dense, 1024 tokens (mean |logit| "
        f"{d32.abs().mean().item():.4e}, max {d32.abs().max().item():.4e}): "
        f"fp32 sparse - fp32 dense max {e32:.4e} mean {e32_mean:.4e} (tol "
        f"{TOL_LOGITS}); against fp32 dense, bf16 sparse max {es16:.4e} "
        f"mean {es16_mean:.4e}, bf16 dense max {ed16:.4e} mean "
        f"{ed16_mean:.4e} (the sparse at most {BF16_LOGITS_SLACK} x the "
        f"dense); bf16 "
        f"sparse - bf16 dense max {gap16:.4e}")
    check(math.isfinite(e32) and e32 <= TOL_LOGITS,
          f"covering sparse prefill logits differ from dense by {e32} in "
          f"fp32")
    check(math.isfinite(es16) and es16 <= BF16_LOGITS_SLACK * ed16 and
          es16_mean <= BF16_LOGITS_SLACK * ed16_mean,
          f"the bf16 sparse prefill is farther from the fp32 logits "
          f"({es16}, mean {es16_mean}) than {BF16_LOGITS_SLACK} x the bf16 "
          f"dense one ({ed16}, mean {ed16_mean})")
    return dict(launches=launches, prefill_ms=prefill_ms,
                decode_ms=decode_ms, prefill_mean=prefill_mean,
                decode_mean=decode_mean)


# -- training ------------------------------------------------------------------

TRAIN_STEPS = 20
STEPS_PER_EPOCH = 4


def launch_counts():
    from repro_torch.kernels import block_sparse_attn as bsa
    return {name: getattr(bsa, name).launches for name in KERNELS}


def reset_launch_counts():
    from repro_torch.kernels import block_sparse_attn as bsa
    for name in KERNELS:
        getattr(bsa, name).launches = 0


def listops_data_fn(batch, seq_len):
    """data_fn(step): a ListOps batch of `batch` sequences of seq_len + 1
    tokens from the grammar, seeded by (SEED, step); next-token targets."""
    import numpy as np
    from repro_torch.data.listops import make_listops_batch

    def data_fn(step):
        rng = np.random.default_rng([SEED, step])
        xs, _ = make_listops_batch(rng, batch, seq_len + 1)
        return {"tokens": xs[:, :-1], "labels": xs[:, 1:]}
    return data_fn


def lra_config():
    """spion-lra at its published width with the smoke's phase schedule
    (min/max dense epochs 1/3), and the LRA ListOps preset."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.spion_lra import LRA_TASKS
    task = LRA_TASKS["listops"]
    cfg = get_config("spion-lra")
    check(cfg.num_layers == 4 and cfg.d_model == 64 and cfg.num_heads == 4
          and cfg.spion.block_size == task["block_size"] and cfg.remat,
          "spion-lra config changed")
    cfg = cfg.replace(spion=dataclasses.replace(
        cfg.spion, min_dense_epochs=1, max_dense_epochs=3))
    return cfg, task


def lra_trainer(**kw):
    """Trainer of spion-lra under the ListOps preset on the card, from the
    seed; `kw` adds to the Trainer's arguments (ckpt_dir, chaos, ...)."""
    from repro_torch.launch.train import Trainer
    cfg, task = lra_config()
    S, B = task["seq_len"], task["batch"]
    data_fn = listops_data_fn(B, S)
    tr = Trainer(cfg, seq_len=S, batch=B, steps_per_epoch=STEPS_PER_EPOCH,
                 data_fn=data_fn, seed=SEED, device=DEVICE, **kw)
    return tr, cfg, data_fn


def record_steps(tr):
    """Wrap tr._one_step so that every step appends {phase, s, loss,
    launches} to the returned list: its phase, host seconds to the end of
    its device work, loss and the kernels it launched. Returns (records,
    undo)."""
    import torch
    steps, inner = [], tr._one_step

    def one_step(batch):
        phase = tr.spion_state.phase
        before = launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        metrics = inner(batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = launch_counts()
        steps.append(dict(phase=phase, s=dt, loss=float(metrics["loss"]),
                          launches={k: after[k] - before[k] for k in after}))
        return metrics

    def undo():
        tr._one_step = inner
    tr._one_step = one_step
    return steps, undo


def sparse_launches(cfg):
    """Kernel launches of one sparse step: the forward runs once per layer
    in the forward and once more per layer when remat recomputes the layer
    in the backward; dQ and dK/dV run once per layer."""
    L = cfg.num_layers
    return {"block_sparse_fwd": (2 if cfg.remat else 1) * L,
            "block_sparse_dq": L, "block_sparse_dkv": L}


def phase_train():
    """Three-phase SPION training of spion-lra at its published width under
    the LRA ListOps preset, through launch/train.Trainer on the card."""
    import numpy as np
    import torch
    t0 = time.perf_counter()
    tr, cfg, data_fn = lra_trainer()
    S, B, L = tr.seq_len, lra_config()[1]["batch"], cfg.num_layers
    torch.cuda.synchronize()
    nparams = sum(p.numel() for p in tr.params.parameters())
    log(f"spion-lra: {L} layers, d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, remat {cfg.remat}, "
        f"{cfg.dtype} over fp32 masters: {nparams} parameters; ListOps "
        f"seq_len {S}, batch {B}; trainer ready in "
        f"{time.perf_counter() - t0:.1f} s")
    init = {n: p.detach().clone() for n, p in tr.params.named_parameters()}

    captures, fills = [], []
    inner_capture = tr.capture
    inner_generate = tr.spion_ctl.generate

    def capture(batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner_capture(batch)
        torch.cuda.synchronize()
        captures.append(time.perf_counter() - t)
        return out

    def generate(state, pooled):
        t = time.perf_counter()
        out = inner_generate(state, pooled)
        fills.append(time.perf_counter() - t)
        return out

    steps, undo = record_steps(tr)
    tr.capture, tr.spion_ctl.generate = capture, generate
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = tr.train(TRAIN_STEPS, log_every=STEPS_PER_EPOCH,
                      log=lambda m: log(f"  train: {m}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = launch_counts()
    undo()
    tr.capture, tr.spion_ctl.generate = inner_capture, inner_generate

    st = tr.spion_state
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"a training loss is not finite: {losses}")
    check(st.phase == "sparse", f"training ended in phase {st.phase}")
    check(st.density is not None and 0 < st.density < 1,
          f"plan density {st.density}")
    dense = [r for r in steps if r["phase"] == "dense"]
    sparse = [r for r in steps if r["phase"] == "sparse"]
    check(len(dense) <= 3 * STEPS_PER_EPOCH and
          len(sparse) >= TRAIN_STEPS - 3 * STEPS_PER_EPOCH,
          f"{len(dense)} dense and {len(sparse)} sparse steps")
    want = sparse_launches(cfg)
    for r in dense:
        check(not any(r["launches"].values()),
              f"a dense step launched a sparse kernel: {r['launches']}")
    for r in sparse:
        check(r["launches"] == want, f"a sparse step launched "
              f"{r['launches']}, not {want}")
    check(launches == {k: n * len(sparse) for k, n in want.items()},
          f"launches over the run {launches}")
    moved = max((p.detach() - init[n]).abs().max().item()
                for n, p in tr.params.named_parameters())
    check(moved > 0, "training did not change the parameters")

    def ms(rs):
        xs = [1e3 * r["s"] for r in rs]
        return float(np.median(xs)), float(sum(xs)), len(xs)
    d_med, d_tot, d_n = ms(dense[1:])      # the first step pays for warm-up
    s_med, s_tot, s_n = ms(sparse[1:])
    stats = st.plan_stats
    log(f"train: {TRAIN_STEPS} steps in {wall:.2f} s; losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; phase {st.phase} after "
        f"{len(dense)} dense steps; plan density {st.density:.4f} "
        f"(per layer {stats['per_layer_density']}), K {stats['K']}, KT* "
        f"{stats['kt_star']}; launches {launches} ({want} per sparse step); "
        f"peak device memory {peak_gb:.2f} GB")
    log(f"train steps: dense {d_med:.2f} ms median, {d_n} steps after the "
        f"first {d_tot:.2f} ms ({d_tot / d_n:.2f} ms each), first "
        f"{1e3 * dense[0]['s']:.2f} ms; sparse {s_med:.2f} ms median, "
        f"{s_n} steps after the first {s_tot:.2f} ms ({s_tot / s_n:.2f} ms "
        f"each), first {1e3 * sparse[0]['s']:.2f} ms; capture "
        f"{', '.join(f'{1e3 * c:.2f}' for c in captures)} ms; host flood "
        f"fill and plan {', '.join(f'{1e3 * f:.2f}' for f in fills)} ms")
    profile_sparse_step(tr, tr._one_step)
    return dict(trainer=tr, cfg=cfg, launches=launches, dense_ms=d_med,
                sparse_ms=s_med, data_fn=data_fn, losses=losses,
                dense_steps=len(dense))


def profile_sparse_step(tr, step_fn):
    """torch.profiler device time of one sparse train step, and the share
    of the three kernels in it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    batch = tr._next_batch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step_fn(batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    check(rows, "the profiler saw no device time in the sparse step")
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    share = {}
    for name in KERNELS:
        share[name] = sum(e.self_device_time_total for e in rows
                          if f"{name}_kernel" in e.key) / 1e3
    log(f"profile sparse train step: {wall:.2f} ms on the host clock under "
        f"the profiler; device busy {busy:.2f} ms (idle share "
        f"{max(0.0, 1 - busy / wall):.3f}); "
        + ", ".join(f"{n} {ms_:.3f} ms ({ms_ / busy:.3f})"
                    for n, ms_ in share.items()))
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d}x "
            f"{e.key[:90]}")


def phase_train_path_kernels(train, gen, before=None):
    """The three kernels at the training path's shape, on layer 0's tables
    of the trained plan: the forward (o and lse, where the Alg. 6
    correction for the unstored positions dominates the denominator at
    this density), dQ and dK/dV against their plain versions in fp32 and
    bf16, then timed (bf16, as the path runs them) beside their bounds."""
    st = train["trainer"].spion_state
    tables = (st.tables["col_idx"][0].cpu().numpy(),
              st.tables["nvalid"][0].cpu().numpy())
    out = {}
    for dtype in ("float32", "bfloat16"):
        case = dict(dtype=dtype, causal=False, **TRAIN_PATH)
        err, tol, share, typical, lerr, _ = compare_kernel(
            case, gen, None, tables=tables)
        log(f"kernel at the training path's shape {TRAIN_PATH} {dtype} "
            f"non-causal, trained layer-0 tables ({int(tables[1].sum())} "
            f"listed tiles): |o - plain| = {err:.3e} (that element's limit "
            f"{tol:.3e}; no element past {share:.3f} of its limit; mean |o| "
            f"{typical:.3e}); |lse - plain| {lerr:.3e} (tol {TOL_LSE})")
        res, x = compare_backward(case, gen, None, tables=tables)
        log_backward_path("training", TRAIN_PATH, dtype, res)
        out[dtype] = {n: res[n][0] for n in ("dq", "dk", "dv")}
        out[dtype]["o"] = err
    timing = backward_timing(x, before)
    timing["block_sparse_fwd"] = kernel_timing(
        (x["q"], x["k"], x["v"], x["col"], x["nvalid"], x["kw"]),
        "the training path's shape")
    return out, timing


COVER_BATCH = 32     # sequences in the covering-plan step check
TOL_LOSS_REL = 1e-5
TOL_STEP_GRAD = 1e-3


def phase_covering_step(train):
    """One train step's loss and gradients through a fully covering
    non-causal plan (the three kernels in every layer) against the dense
    step, from the trained masters and one ListOps batch: equal in fp32
    (every gradient element within TOL_STEP_GRAD); in bf16 both held
    against the fp32 dense gradients leaf by leaf, each layer's leaves
    split apart. On each layer's attention leaves (the projections, which
    take dq, dk, dv and o straight from the kernels, and the attention
    norm) the kernels' path may be at most BF16_LOGITS_SLACK x as far as
    the dense path, by max and by mean; the other leaves are printed."""
    import numpy as np
    import torch
    from repro_torch.core.attention_exec import SparseAttentionExec
    from repro_torch.core.sparse_attention import build_sparsity_plan
    from repro_torch.launch.steps import make_loss_and_grads
    tr, cfg = train["trainer"], train["cfg"]
    S, L, block = tr.seq_len, cfg.num_layers, cfg.spion.block_size
    nrb = S // block
    col = np.tile(np.arange(nrb, dtype=np.int32), (L, nrb, 1))
    plan = build_sparsity_plan(col, np.full((L, nrb), nrb, np.int32), block)
    cover = SparseAttentionExec.from_plan(plan).to(DEVICE)
    host = listops_data_fn(COVER_BATCH, S)(10_000)
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in host.items()}
    want = {"block_sparse_fwd": (2 if cfg.remat else 1) * L,
            "block_sparse_dq": L, "block_sparse_dkv": L}

    def run(dtype, tables):
        """The step's loss and {leaf: fp32 gradient}, a stacked per-layer
        tensor split into one leaf per layer ("layers.attn.wq[2]")."""
        fn = make_loss_and_grads(cfg.replace(dtype=dtype))
        before = launch_counts()
        loss, grads = fn(tr.params, batch, tables)
        torch.cuda.synchronize()
        got = {k: launch_counts()[k] - before[k] for k in before}
        check(got == (want if tables is not None else
                      dict.fromkeys(want, 0)),
              f"the {dtype} step launched {got}")
        leaves = {}
        for name, g in grads.items():
            g = g.float()
            if name == "pos_embed.w":
                g = g[:S]     # the positions past seq_len get no gradient
            if name.startswith("layers."):
                leaves.update({f"{name}[{i}]": g[i] for i in range(L)})
            else:
                leaves[name] = g
        return loss.item(), leaves

    ls32, gs32 = run("float32", cover)
    ld32, gd32 = run("float32", None)
    ls16, gs16 = run("bfloat16", cover)
    ld16, gd16 = run("bfloat16", None)
    rel = abs(ls32 - ld32) / abs(ld32)
    g32, worst = 0.0, {"gated": 0.0, "other": 0.0}
    for name, ref in gd32.items():
        d32 = (gs32[name] - ref).abs().max().item()
        g32 = max(g32, d32)
        es, ed = (gs16[name] - ref).abs(), (gd16[name] - ref).abs()
        es_max, es_mean = es.max().item(), es.mean().item()
        ed_max, ed_mean = ed.max().item(), ed.mean().item()
        ratio = max(es_max / ed_max if ed_max else
                    (0.0 if es_max == 0 else math.inf),
                    es_mean / ed_mean if ed_mean else
                    (0.0 if es_mean == 0 else math.inf))
        gated = name.startswith("layers.attn")
        worst["gated" if gated else "other"] = max(
            worst["gated" if gated else "other"], ratio)
        log(f"  {name:24s} mean |grad| {ref.abs().mean().item():.4e}; fp32 "
            f"|sparse - dense| {d32:.4e}; bf16 from fp32 dense: sparse max "
            f"{es_max:.4e} mean {es_mean:.4e}, dense max {ed_max:.4e} mean "
            f"{ed_mean:.4e} (ratio {ratio:.4f}{', gated' if gated else ''})")
        check(math.isfinite(d32) and d32 <= TOL_STEP_GRAD,
              f"covering-plan fp32 gradient of {name} differs from dense by "
              f"{d32}")
        check(not gated or (math.isfinite(es_max) and
                            es_max <= BF16_LOGITS_SLACK * ed_max and
                            es_mean <= BF16_LOGITS_SLACK * ed_mean),
              f"the bf16 covering-plan gradient of {name} is farther from the "
              f"fp32 one ({es_max}, mean {es_mean}) than {BF16_LOGITS_SLACK} "
              f"x the bf16 dense one ({ed_max}, mean {ed_mean})")
    allg = torch.cat([g.flatten() for g in gd32.values()])
    log(f"covering-plan step vs dense step, spion-lra, {COVER_BATCH} x {S} "
        f"ListOps tokens, {len(gd32)} leaves, {allg.numel()} gradient "
        f"elements (mean |grad| {allg.abs().mean().item():.4e}, max "
        f"{allg.abs().max().item():.4e}): fp32 loss {ls32:.8f} vs {ld32:.8f} "
        f"(rel {rel:.3e}, tol {TOL_LOSS_REL}); fp32 grads max |diff| "
        f"{g32:.4e} (tol {TOL_STEP_GRAD}); bf16 sparse / dense distance from "
        f"the fp32 dense grads, the larger of the max and mean ratios: at "
        f"most {worst['gated']:.4f} on the attention leaves (limit "
        f"{BF16_LOGITS_SLACK}), {worst['other']:.4f} on the others; bf16 "
        f"losses {ls16:.6f} / {ld16:.6f}")
    check(math.isfinite(rel) and rel <= TOL_LOSS_REL,
          f"covering-plan fp32 loss differs from dense by {rel} (relative)")


# -- self-healing training -----------------------------------------------------

CKPT_DIR = os.path.join(ROOT, "build", "chip_smoke_ckpt")
CKPT_EVERY = 7      # saves at step 7 (dense) and step 14 (sparse), then 20
RESUME_AT = 14      # the sparse-phase checkpoint the resume phase continues
KILL_STEP = 16      # the respawn phase's worker is SIGKILLed here
NAN_STEP = 17       # the rollback phase poisons the masters here
ROLLBACK_EVERY = 2  # the rollback phase's saves: 16 (good), 18 (poisoned)
# resumed and stitched losses against the uninterrupted run's, relative.
# Not 0: F.embedding's backward on the card is not bitwise reproducible
# (chip_repro.py: the token embedding's gradient, alone of all leaves,
# differed in 7 of 60 repeated dense steps), so the dense steps before a
# checkpoint may leave another state than phase 5's. On one H100 80GB
# HBM3 at 700 W sound runs read 0 or 1.102e-6 (resumed in 2 of 8 runs,
# stitched in 4 of 7); restores planted by chip_repro.py read 2.625e-5
# with the count one ahead, 1.758e-3 with the data offset one ahead,
# 6.462e-3 with the first moments at zero. Both phases also hold the
# restored state bitwise.
TOL_RESUME = 1e-5


def loss_gap(got, want):
    """Largest relative difference of two loss lists (0.0 when bitwise)."""
    check(len(got) == len(want), f"{len(got)} losses against {len(want)}")
    return max((abs(a - b) / abs(b) for a, b in zip(got, want)), default=0.0)


def state_snapshot(tr):
    """Host copies of a trainer's masters, moments and count."""
    import torch
    snap = {f"params.{n}": p.detach().cpu().clone()
            for n, p in tr.params.named_parameters()}
    for k in ("mu", "nu"):
        snap.update({f"{k}.{n}": t.cpu().clone()
                     for n, t in tr.opt[k].items()})
    snap["count"] = tr.opt["count"].cpu().clone()
    return {k: v.to(torch.float64) if v.is_floating_point() else v
            for k, v in snap.items()}


def state_gap(a, b):
    """Largest |difference| between two snapshots, and the leaves that
    differ at all."""
    check(a.keys() == b.keys(), "the snapshots hold different leaves")
    gaps = {k: (a[k] - b[k]).abs().max().item() if a[k].numel() else 0.0
            for k in a}
    return max(gaps.values()), sorted(k for k, g in gaps.items() if g)


def plan_digest_of(state):
    from repro_torch.core.spion import plan_digest
    return plan_digest(state.table_arrays(), state.tables["block"])


def recovery_record(tr):
    """What a restore must reproduce: step, data offset, phase, plan digest,
    and the masters, moments and count (state_snapshot)."""
    st = tr.spion_state
    return {"step": tr.step, "data_offset": tr.data_offset, "phase": st.phase,
            "digest": plan_digest_of(st) if st.tables else None,
            "state": state_snapshot(tr)}


def check_sparse_steps(steps, cfg, what):
    want = sparse_launches(cfg)
    for r in steps:
        check(r["phase"] == "sparse" and r["launches"] == want,
              f"{what}: a step in phase {r['phase']} launched "
              f"{r['launches']}, not {want}")


def reproducibility(tr):
    """One sparse step run twice from the state restored at RESUME_AT:
    whether its loss and the updated state are bitwise the same (printed;
    chip_repro.py repeats the steps and names the op that is not)."""
    runs = []
    for _ in range(2):
        tr._restore_latest(step=RESUME_AT)
        batch = tr._next_batch()
        loss = float(tr._one_step(batch)["loss"])
        runs.append((loss, state_snapshot(tr)))
    gap, leaves = state_gap(runs[0][1], runs[1][1])
    bitwise = runs[0][0] == runs[1][0] and not leaves
    log(f"resume: one sparse step twice from step {RESUME_AT}: losses "
        f"{runs[0][0]!r} / {runs[1][0]!r}, updated state max |diff| {gap:.3e}"
        f" ({len(leaves)} leaves differ{': ' if leaves else ''}"
        f"{', '.join(leaves[:8])}): "
        f"{'bitwise reproducible' if bitwise else 'NOT bitwise reproducible'}")
    return bitwise


def phase_resume(train):
    """Train spion-lra into the sparse phase with checkpoints under build/
    (CKPT_EVERY), then resume from the sparse-phase checkpoint with a fresh
    Trainer: the restored step, data offset, phase, plan digest, masters
    and moments must be the saved ones, every sparse step after the resume
    must launch the three kernels, and the resumed losses must equal the
    uninterrupted run's (phase 5) within TOL_RESUME."""
    import shutil
    import torch
    ref = train["losses"]
    d = os.path.join(CKPT_DIR, "resume")
    shutil.rmtree(d, ignore_errors=True)
    first, cfg, _ = lra_trainer(ckpt_dir=d)
    t0 = time.perf_counter()
    lead = first.train(RESUME_AT, ckpt_every=CKPT_EVERY, log_every=10**9,
                       log=lambda m: None)
    torch.cuda.synchronize()
    lead_s = time.perf_counter() - t0
    check(first.spion_state.phase == "sparse" and
          first.ckpt.all_steps() == [CKPT_EVERY, RESUME_AT],
          f"the first leg ended in phase {first.spion_state.phase} with "
          f"checkpoints {first.ckpt.all_steps()}")
    saved = state_snapshot(first)
    saved_digest = plan_digest_of(first.spion_state)
    t0 = time.perf_counter()
    first.save()           # the same step again: what one save costs
    first.ckpt.wait()
    save_s = time.perf_counter() - t0
    del first

    t0 = time.perf_counter()
    tr, _, _ = lra_trainer(ckpt_dir=d)
    check(tr.maybe_resume(), "the fresh trainer found no checkpoint")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    st = tr.spion_state
    gap, leaves = state_gap(state_snapshot(tr), saved)
    check(tr.step == RESUME_AT and tr.data_offset == 0 and
          st.phase == "sparse" and plan_digest_of(st) == saved_digest,
          f"restored step {tr.step}, data offset {tr.data_offset}, phase "
          f"{st.phase}, plan digest {plan_digest_of(st)} (saved "
          f"{saved_digest})")
    check(not leaves, f"restored state differs from the saved one by {gap} "
          f"in {leaves}")
    bitwise = reproducibility(tr)
    tr._restore_latest(step=RESUME_AT)
    reset_launch_counts()
    steps, undo = record_steps(tr)
    resumed = tr.train(TRAIN_STEPS - RESUME_AT, ckpt_every=CKPT_EVERY,
                       log_every=10**9, log=lambda m: None)
    undo()
    launches = launch_counts()
    check_sparse_steps(steps, cfg, "after the resume")
    check(launches == {k: n * len(steps)
                       for k, n in sparse_launches(cfg).items()},
          f"the resumed run launched {launches}")
    check(tr._exec_tables is tr.spion_state.tables,
          "the sparse exec was not rebuilt from the restored plan")
    lead_gap = loss_gap(lead, ref[:RESUME_AT])
    gap = loss_gap(resumed, ref[RESUME_AT:])
    log(f"resume: first leg {RESUME_AT} steps from the seed in {lead_s:.2f} s "
        f"(checkpoints {CKPT_EVERY}, {RESUME_AT}), its losses vs phase 5's "
        f"max rel {lead_gap:.3e}; save of one checkpoint {1e3 * save_s:.1f} "
        f"ms; fresh Trainer + maybe_resume {1e3 * restore_s:.1f} ms: step "
        f"{tr.step - len(resumed)}, phase sparse, plan digest {saved_digest}, "
        f"masters and moments bitwise; {len(resumed)} resumed steps launched "
        f"{launches} (per step {sparse_launches(cfg)}); resumed losses "
        f"{', '.join(f'{x:.6f}' for x in resumed)} vs phase 5's max rel "
        f"{gap:.3e} (gate {TOL_RESUME})")
    check(gap <= TOL_RESUME and lead_gap <= TOL_RESUME,
          f"resumed losses differ from the uninterrupted run's by {gap} "
          f"(first leg {lead_gap}); gate {TOL_RESUME}")
    return dict(dir=d, save_s=save_s, restore_s=restore_s, bitwise=bitwise,
                launches=launches, gap=gap, lead_gap=lead_gap)


def phase_rollback(resume):
    """A NaN poisoning (ChaosMonkey(nan_step=NAN_STEP)) in the sparse phase,
    in-process, from a copy of the resume phase's checkpoints: one rollback
    to the pinned good step, the poisoned save quarantined, the data offset
    advanced by the window, the replayed sparse steps launching the three
    kernels on the restored tables, every stitched loss finite."""
    import shutil
    import torch
    from repro_torch.distributed.chaos import ChaosMonkey
    d = os.path.join(CKPT_DIR, "rollback")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(resume["dir"], d)
    for name in os.listdir(d):
        if name.startswith("step_") and int(name.split("_")[1]) > RESUME_AT:
            shutil.rmtree(os.path.join(d, name))
    tr, cfg, _ = lra_trainer(ckpt_dir=d, chaos=ChaosMonkey(nan_step=NAN_STEP))
    check(tr.maybe_resume() and tr.step == RESUME_AT,
          f"the rollback phase resumed at step {tr.step}")
    digest = plan_digest_of(tr.spion_state)
    reset_launch_counts()
    steps, undo = record_steps(tr)
    t0 = time.perf_counter()
    tr.train(TRAIN_STEPS - RESUME_AT, ckpt_every=ROLLBACK_EVERY,
             log_every=10**9, log=lambda m: log(f"  rollback: {m}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    undo()
    launches = launch_counts()
    ev = [e for e in tr.events if e["event"] == "rollback"]
    good = NAN_STEP - NAN_STEP % ROLLBACK_EVERY
    window = NAN_STEP - good + 1
    check(tr.rollback_count == 1 and len(ev) == 1 and
          ev[0]["from_step"] == NAN_STEP and ev[0]["to_step"] == good,
          f"rollbacks {tr.rollback_count}, events {ev}")
    check(os.path.exists(os.path.join(
        d, f"quarantined_step_{good + ROLLBACK_EVERY:09d}")),
          "the poisoned save was not quarantined")
    check(tr.data_offset == window and tr.step == TRAIN_STEPS,
          f"data offset {tr.data_offset} (window {window}), step {tr.step}")
    check(plan_digest_of(tr.spion_state) == digest and
          tr._exec_tables is tr.spion_state.tables,
          "the replay did not run on the restored plan")
    replay = steps[NAN_STEP - RESUME_AT + 1:]
    check(len(replay) == TRAIN_STEPS - good, f"{len(replay)} replayed steps")
    check_sparse_steps(steps, cfg, "around the rollback")
    hist = [tr.loss_history[s] for s in range(RESUME_AT, TRAIN_STEPS)]
    check(sorted(tr.loss_history) == list(range(RESUME_AT, TRAIN_STEPS)) and
          all(math.isfinite(x) for x in hist),
          f"stitched losses {tr.loss_history}")
    log(f"rollback: NaN at step {NAN_STEP}, rolled back to step {good} in "
        f"{ev[0]['seconds']:.3f} s, step {good + ROLLBACK_EVERY}'s save "
        f"quarantined, data offset {tr.data_offset}; {len(steps)} sparse "
        f"steps ({len(replay)} replayed) launched {launches} in {wall:.2f} s;"
        f" stitched losses {', '.join(f'{x:.6f}' for x in hist)}")
    return dict(seconds=ev[0]["seconds"], launches=launches)


def train_worker(d):
    """The respawn phase's worker (`--train-worker DIR`): spion-lra from
    DIR's latest checkpoint (or the seed) to step TRAIN_STEPS with
    checkpoints every CKPT_EVERY steps; each step appends {pid, step,
    phase, loss, launches, t} to DIR/losses.jsonl, and the end writes
    DIR/done_<pid>.json. The recovery_record of the state it saves at
    RESUME_AT goes to DIR/saved_<pid>.pt, and that of the state it resumed
    to DIR/restored_<pid>.pt."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # heartbeat_interval 0: every step's beat is written, the last one too
    tr, _, _ = lra_trainer(ckpt_dir=d, heartbeat_interval=0.0)
    start = tr.step
    resumed = tr.maybe_resume()
    steps, _ = record_steps(tr)
    pid = os.getpid()
    if resumed:
        torch.save(recovery_record(tr), os.path.join(d, f"restored_{pid}.pt"))
    inner_save = tr.save

    def save():
        inner_save()
        if tr.step == RESUME_AT:
            torch.save(recovery_record(tr),
                       os.path.join(d, f"saved_{pid}.pt"))
    tr.save = save

    def on_step(step, loss):
        r = steps[-1]
        with open(os.path.join(d, "losses.jsonl"), "a") as f:
            f.write(json.dumps({"pid": pid, "step": step, "loss": loss,
                                "phase": r["phase"], "launches":
                                r["launches"], "t": time.time()}) + "\n")
    tr.step_callback = on_step
    log(f"worker {pid}: {'resumed at' if resumed else 'from'} step "
        f"{tr.step if resumed else start}, phase {tr.spion_state.phase}")
    tr.train(TRAIN_STEPS - tr.step, ckpt_every=CKPT_EVERY, log_every=10**9,
             log=lambda m: None)
    with open(os.path.join(d, f"done_{pid}.json"), "w") as f:
        json.dump({"launches": launch_counts(), "step": tr.step,
                   "phase": tr.spion_state.phase}, f)
    return 0


def phase_respawn(train, resume):
    """FleetSupervisor with nproc 1 runs this script as the training worker
    with SPION_CHAOS_KILL_STEP at a sparse step, on a copy of the resume
    phase's dense checkpoint (step CKPT_EVERY; the dense steps before it
    are phase 5's and the resume phase's): generation 0 resumes in the
    dense phase, reaches the sparse phase and is killed; one respawn;
    generation 1 resumes in the sparse phase, its step, data offset, phase,
    plan digest, masters, moments and count bitwise those generation 0
    saved there, and finishes; the stitched loss history equals phase 5's
    within TOL_RESUME; the heartbeat payload reads back."""
    import gc
    import shutil
    import torch
    from repro_torch.distributed.fault import Heartbeat
    from repro_torch.distributed.supervisor import FleetSupervisor
    cfg = train["cfg"]
    d = os.path.join(CKPT_DIR, "respawn")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    name = f"step_{CKPT_EVERY:09d}"
    shutil.copytree(os.path.join(resume["dir"], name), os.path.join(d, name))
    gc.collect()
    torch.cuda.empty_cache()   # the workers need the card's memory
    env = dict(os.environ, SPION_CHAOS_KILL_STEP=str(KILL_STEP),
               SPION_CHAOS_ONCE_DIR=os.path.join(d, "once"))
    sup = FleetSupervisor(
        [sys.executable, os.path.abspath(__file__), "--train-worker", d], 1,
        d, dead_timeout=180.0, hang_timeout=180.0, poll_interval=0.2,
        max_respawns=2, backoff_base=0.1, backoff_max=1.0, env=env,
        log=lambda m: log(f"  {m}"))
    t0 = time.perf_counter()
    rc = sup.run()
    wall = time.perf_counter() - t0
    check(rc == 0 and sup.respawns == 1,
          f"the supervisor returned {rc} after {sup.respawns} respawns")
    with open(os.path.join(d, "losses.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    pids = list(dict.fromkeys(x["pid"] for x in lines))
    check(len(pids) == 2, f"{len(pids)} worker generations wrote losses")
    gen0 = [x for x in lines if x["pid"] == pids[0]]
    gen1 = [x for x in lines if x["pid"] == pids[1]]
    check([x["step"] for x in gen0] == list(range(CKPT_EVERY, KILL_STEP)) and
          gen0[0]["phase"] == "dense" and
          [x["step"] for x in gen1] == list(range(RESUME_AT, TRAIN_STEPS)),
          f"generation 0 ran steps {[x['step'] for x in gen0]}, generation "
          f"1 {[x['step'] for x in gen1]}")
    check(os.path.exists(os.path.join(d, f"done_{pids[1]}.json")) and
          not os.path.exists(os.path.join(d, f"done_{pids[0]}.json")),
          "generation 1 did not finish, or generation 0 was not killed")
    with open(os.path.join(d, f"done_{pids[1]}.json")) as f:
        done = json.load(f)
    want = sparse_launches(cfg)
    for x in gen1:
        check(x["phase"] == "sparse" and x["launches"] == want,
              f"a resumed worker step in phase {x['phase']} launched "
              f"{x['launches']}, not {want}")
    check(done["launches"] == {k: n * len(gen1) for k, n in want.items()},
          f"generation 1 launched {done['launches']}")
    saved = torch.load(os.path.join(d, f"saved_{pids[0]}.pt"))
    restored = torch.load(os.path.join(d, f"restored_{pids[1]}.pt"))
    state_diff, leaves = state_gap(restored.pop("state"), saved.pop("state"))
    stitched = {x["step"]: x["loss"] for x in lines}
    gap = loss_gap([stitched[s] for s in range(CKPT_EVERY, TRAIN_STEPS)],
                   train["losses"][CKPT_EVERY:])
    hb = Heartbeat.read(os.path.join(d, "hb_0"))
    respawn_s = gen1[0]["t"] - gen0[-1]["t"]
    log(f"respawn: worker killed at step {KILL_STEP} (generation 0 resumed at "
        f"step {CKPT_EVERY} in phase dense and ran steps {CKPT_EVERY}-"
        f"{KILL_STEP - 1}), generation 1 resumed at step {RESUME_AT} "
        f"in phase sparse to {restored} against generation 0's {saved} "
        f"(masters, moments and count: {len(leaves)} leaves differ, max "
        f"|diff| {state_diff:.3e}) and finished; from generation 0's last "
        f"step to generation 1's first {respawn_s:.2f} s; supervisor "
        f"{wall:.2f} s in all; generation 1 launched {done['launches']}; "
        f"heartbeat {hb}; stitched losses vs phase 5's max rel {gap:.3e} "
        f"(gate {TOL_RESUME})")
    check(restored == saved and saved["step"] == RESUME_AT and not leaves,
          f"generation 1 resumed to {restored}, leaves {leaves} off by "
          f"{state_diff}; generation 0 saved {saved}")
    check(hb is not None and hb.get("step") == TRAIN_STEPS and
          hb.get("phase") == "sparse" and hb.get("pid") == pids[1],
          f"heartbeat payload {hb}")
    check(gap <= TOL_RESUME, f"stitched losses differ from the uninterrupted "
          f"run's by {gap}; gate {TOL_RESUME}")
    return dict(seconds=respawn_s, wall=wall, launches=done["launches"],
                gap=gap)


def main(argv):
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--before", metavar="DIR", help="another checkout "
                        "of this repository (e.g. the parent commit from "
                        "git archive): its dQ and dK/dV kernels are built "
                        "and timed beside these at the training shape")
    parser.add_argument("--train-worker", metavar="DIR", help="run as the "
                        "respawn phase's training worker with checkpoints "
                        "in DIR (started by the phase's FleetSupervisor)")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.train_worker:
        return train_worker(args.train_worker)
    import numpy as np
    from repro_torch.kernels.block_sparse_attn import (library_path,
                                                       load_library)

    log(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    start = t0 = time.perf_counter()
    before, builder = None, None
    if args.before:
        import threading
        before = parent_kernels(args.before)
        builder = threading.Thread(target=before.load_library)
        builder.start()       # its nvcc processes run beside this tree's
    load_library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    if builder is not None:
        builder.join()
        before.load_library()         # raises here if that build failed
        log(f"the --before tree's kernels built and loaded by "
            f"{time.perf_counter() - t0:.1f} s")
    report = library_path().parent / "build.log"
    if report.exists():
        name = "?"
        for line in report.read_text().splitlines():
            if "_kernel" in line and "Compiling" in line:
                name = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                log(f"ptxas {name[:70]}: {line.split(':', 1)[-1].strip()}")

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    err, tol, inputs = phase_kernel_sweep(gen, rng)
    phase_backward_sweep(gen, rng)
    reset_launch_counts()
    serve = phase_serve(gen, rng)
    served = launch_counts()
    check(served["block_sparse_dq"] == 0 and served["block_sparse_dkv"] == 0,
          f"serving launched a backward kernel: {served}")
    train = phase_train()
    train_err, train_timing = phase_train_path_kernels(train, gen, before)
    phase_covering_step(train)
    timing = kernel_timing(inputs, "the serving path's shape")
    resume = phase_resume(train)
    rollback = phase_rollback(resume)
    respawn = phase_respawn(train, resume)

    fwd = {"launches": serve["launches"] + train["launches"]["block_sparse_fwd"],
           "launches_serve": serve["launches"],
           "launches_train": train["launches"]["block_sparse_fwd"],
           "max_abs_err": err, "tol": tol,
           "train_shape": dict(train_timing.pop("block_sparse_fwd"),
                               max_abs_err=train_err["bfloat16"]["o"]),
           **timing}
    rows = {"block_sparse_fwd": fwd}
    for name, grads in (("block_sparse_dq", ("dq",)),
                        ("block_sparse_dkv", ("dk", "dv"))):
        t = train_timing[name]
        rows[name] = {"launches": train["launches"][name],
                      "max_abs_err": max(train_err["bfloat16"][g]
                                         for g in grads),
                      **{k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                           "bound_by", "library_ms",
                                           "before_ms") if k in t}}
    for name, row in rows.items():
        for path, run in (("resume", resume), ("rollback", rollback),
                          ("respawn", respawn)):
            row[f"launches_{path}"] = run["launches"][name]
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNELS[name][0],
         "replaces": KERNELS[name][1], **row} for name, row in rows.items()]}
    log(f"serve prefill_ms median {serve['prefill_ms']:.3f} mean "
        f"{serve['prefill_mean']:.3f}; decode_ms_per_tick median "
        f"{serve['decode_ms']:.3f} mean {serve['decode_mean']:.3f}; train "
        f"dense_step_ms median {train['dense_ms']:.3f}, sparse_step_ms median "
        f"{train['sparse_ms']:.3f}")
    card = card_line()
    for what, sec in (("save of one checkpoint", resume["save_s"]),
                      ("restore (fresh Trainer + maybe_resume)",
                       resume["restore_s"]),
                      ("respawn (killed worker's last step to the new "
                       "worker's first)", respawn["seconds"]),
                      ("rollback", rollback["seconds"])):
        log(f"recovery, spion-lra at ListOps size, {what}: {sec:.3f} s "
            f"({card})")
    log(f"recovery: supervisor {respawn['wall']:.2f} s in all; a sparse step "
        f"run twice is {'' if resume['bitwise'] else 'NOT '}bitwise "
        f"reproducible; max rel gap to the uninterrupted run's losses (gate "
        f"{TOL_RESUME}): first leg {resume['lead_gap']:.3e}, resumed "
        f"{resume['gap']:.3e}, respawn's stitched {respawn['gap']:.3e}")
    log(f"chip_smoke: every phase passed in {time.perf_counter() - start:.1f} s")
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
