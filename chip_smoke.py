#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (each one fails the run; nothing falls back to the CPU):
  1. print the card's name and power limit; turn TF32 off;
  2. build the Hopper kernels from src/repro_torch/kernels/csrc (timed);
  3. hold the block-sparse attention kernel against its plain PyTorch
     version on the card: a sweep over fp32/bf16, causal / non-causal /
     causal + sliding window, G in {1, 4, 7}, empty rows, clamped padded
     tables and global offsets, then the serving path's own shape in fp32
     and in bf16 (each bf16 element of o within 2 bf16 ulps of itself);
  4. serve qwen2-7b at full width and depth in bf16 with random weights
     from a seed: ServeEngine(slots=4, max_len=2048) over a SPION plan of
     random causal block masks, six requests of 16 new tokens; the kernel's
     launch count must rise by 28 (one per layer) for every fused prefill;
     then one 1024-token prompt prefilled through a fully covering plan
     (the kernel) and densely must give the same logits in fp32, and in
     bf16 the kernel's prefill must be no farther from the fp32 logits
     than the dense bf16 prefill is;
  5. time the kernel, its plain version and PyTorch's
     scaled_dot_product_attention at the path's shape beside the kernel's
     bound, and the serving prefill and decode.
The line before the last is the kernels' JSON record; the last line is
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
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/block_sparse_fwd.cuh"
KERNEL_REPLACES = "src/repro/kernels/block_sparse_attn.py:138"


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


def random_tables(rng, nrb, ncb, *, causal, empty_rows=(), pad=2,
                  diag_offset=0):
    """Seeded block mask (diagonal set) as clamped, padded BCSR tables."""
    import numpy as np
    mask = rng.random((nrb, ncb)) < 0.5
    mask[np.arange(nrb), np.arange(nrb) + diag_offset] = True
    if causal:
        mask &= np.arange(ncb)[None, :] <= np.arange(nrb)[:, None] + \
            diag_offset
    for r in empty_rows:
        mask[r] = False
    K = int(mask.sum(1).max()) + pad
    col = np.zeros((nrb, K), np.int32)
    nvalid = mask.sum(1).astype(np.int32)
    for r in range(nrb):
        idx = np.nonzero(mask[r])[0]
        col[r, :len(idx)] = idx
        col[r, len(idx):] = idx[-1] if len(idx) else 0
    return col, nvalid


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


def compare_kernel(case, gen, rng):
    """Kernel vs plain version on one case; returns (max |do|, the limit of
    that element, the largest |do| / limit, mean |plain o|, inputs)."""
    import torch
    from repro_torch.kernels.block_sparse_attn import (
        block_sparse_fwd, fused_forward_reference)
    dt = getattr(torch, case["dtype"])
    N, G, S, hd, block = (case[k] for k in ("N", "G", "S", "hd", "block"))
    offsets = case.get("offsets")
    extra = 0 if offsets is None else block
    nrb = S // block
    col, nvalid = random_tables(
        rng, nrb, (S + extra) // block, causal=case["causal"],
        empty_rows=case.get("empty_rows", ()), pad=case.get("pad", 2),
        diag_offset=extra // block)
    dev = DEVICE
    q = torch.randn((N, G, S, hd), generator=gen, device=dev).to(dt)
    k = torch.randn((N, S + extra, hd), generator=gen, device=dev).to(dt)
    v = torch.randn((N, S + extra, hd), generator=gen, device=dev).to(dt)
    colt = torch.as_tensor(col, device=dev)
    nvt = torch.as_tensor(nvalid, device=dev)
    kw = dict(block=block, causal=case["causal"],
              sliding_window=case.get("sw"), offsets=offsets,
              seq_len=None if offsets is None else 2 * (S + extra))
    o, lse = block_sparse_fwd(q, k, v, colt, nvt, **kw)
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
    return err, tol, share, typical, (q, k, v, colt, nvt, kw)


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
        err, _, share, _, _ = compare_kernel(case, gen, rng)
        worst[case["dtype"]] = max(worst[case["dtype"]], err)
        if case["dtype"] == "bfloat16":
            most = max(most, share)
    log(f"kernel sweep: {len(sweep)} cases pass; worst |o - plain| "
        f"fp32 {worst['float32']:.3e} (tol {TOL_O['float32']}), bf16 "
        f"{worst['bfloat16']:.3e} (no bf16 element past {most:.3f} of its "
        f"limit of {BF16_ULPS} bf16 ulps of itself)")
    # the path's shape in fp32 (the same kernel template, held at 3e-5),
    # then in bf16 as the serving prefill runs it
    for dtype in ("float32", "bfloat16"):
        path = dict(dtype=dtype, causal=True, pad=0, **PATH)
        err, tol, share, typical, inputs = compare_kernel(path, gen, rng)
        log(f"kernel at the path's shape {PATH} {dtype} causal: "
            f"|o - plain| = {err:.3e} (that element's limit {tol:.3e}; "
            f"no element past {share:.3f} of its limit; mean |o| "
            f"{typical:.3e})")
    return err, tol, inputs


def kernel_timing(inputs):
    """ms of the kernel, its plain version and SDPA at the path's shape,
    and the kernel's bound from this run's tables."""
    import torch
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
    # causal (what the kernel computes when the plan covers everything)
    kx = k[:, None].expand(N, G, S, hd).contiguous()
    vx = v[:, None].expand(N, G, S, hd).contiguous()
    library_ms = cuda_ms(
        lambda: F.scaled_dot_product_attention(q, kx, vx, is_causal=True), 20)
    nv = nvalid.cpu().numpy()
    cols = col.cpu().numpy()
    listed = int(nv.sum())
    distinct = len({int(c) for r in range(len(nv)) for c in cols[r, :nv[r]]})
    esize = q.element_size()
    flops = 4.0 * N * G * listed * block * block * hd
    nbytes = (2 * q.numel() * esize + N * G * S * 4          # q, o, lse
              + 2 * N * distinct * block * hd * esize         # listed K, V
              + col.numel() * 4 + nvalid.numel() * 4)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"block_sparse_fwd at N={N} G={G} S={S} hd={hd} block={block} bf16: "
        f"{ms:.4f} ms; plain {plain_ms:.4f} ms; sdpa (dense causal) "
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.kernels.block_sparse_attn import (library_path,
                                                       load_library)

    log(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    load_library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    report = library_path().parent / "build.log"
    if report.exists():
        name = "?"
        for line in report.read_text().splitlines():
            if "block_sparse_fwd_kernel" in line and "Compiling" in line:
                name = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                log(f"ptxas {name[:60]}: {line.split(':', 1)[-1].strip()}")

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    err, tol, inputs = phase_kernel_sweep(gen, rng)
    serve = phase_serve(gen, rng)
    timing = kernel_timing(inputs)

    record = {"kernels": [{
        "name": "block_sparse_fwd", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": serve["launches"], "max_abs_err": err,
        "tol": tol, "ms": timing["ms"],
        "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"], "library_ms": timing["library_ms"]}]}
    log(f"serve prefill_ms median {serve['prefill_ms']:.3f} mean "
        f"{serve['prefill_mean']:.3f}; decode_ms_per_tick median "
        f"{serve['decode_ms']:.3f} mean {serve['decode_mean']:.3f}")
    log(card_line())
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
