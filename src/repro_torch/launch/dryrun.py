"""The dry run: one rank's step of each (arch x shape x mesh x mode) cell,
traced once on meta tensors in a fake world the size of the production
mesh, with its per-rank memory, FLOPs, HBM bytes and collective bytes (the
JAX package's `launch/dryrun.py`, which lowers and compiles each cell for
256 or 512 TPU chips).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape train_4k --mode both [--mesh single|multi|both] [--all] \\
        [--skip-costs] [--out DIR]

How a cell is traced:

  - **A fake world.** The process joins torch's "fake" backend as rank 0
    of the mesh's ranks (`runtime.initialize(fake_world=n)`); the mesh
    builds its process groups there, so the step's collectives dispatch
    as on a real job and move nothing. The backend needs a process of its
    own: the CLI is one, and tests run cells in subprocesses.
  - **Meta tensors.** The rank's shards of the parameters (fp32 masters
    and their AdamW moments for a train cell, the model dtype for
    serving), of the batch or the decode cache are made in their specs
    (`param_pspecs`, `batch_pspecs`, `cache_pspecs`) as meta tensors,
    which hold no storage, on every machine, and the port's own step runs
    once on them: `make_train_step(mesh=)`, `make_prefill_step(mesh=,
    specs=)`, `make_serve_step(mesh=, specs=)`. Nothing is allocated or
    computed, and the kernels' ops (kernels/block_sparse_attn.py) give
    their outputs' shapes without building or launching anything. The
    port takes the card's path on meta tensors (`resolve_kernel`, the
    kernels' wrappers), so the counts are the card's.
  - **The tables.** A sparse cell's plan (`spion_dryrun_tables`, or the
    caller's) stays real on the host beside the meta activations
    (kernels/work.table_device): the layer slices, the casts and a
    shard's rebased tables are computed, and each kernel's work is
    counted from what its tables list (kernels/work.py), as on the card.
  - **Counts.** FLOPs from `FlopCounterMode` (the kernels through their
    registered formulas); HBM bytes, collectives and the op census from
    the op records (launch/hlo.py); the peak memory from `MemTracker`.
    Every figure is the dry run's arithmetic; the roofline divides it by
    launch/mesh.py's H100 SXM5 constants (data sheet, 700 W).

Departures from the reference (ROADMAP.md):

  - The eager trace sees every layer, so the port counts directly
    (`"extrapolation": {"plan": "direct"}`) where the reference compiles
    one- and two-layer variants and extrapolates.
  - The memory is the port's own layout: the Trainer keeps the moments
    under the parameter spec and the port has no FSDP, where the
    reference's cell shards the moments ZeRO-1 and, above
    FSDP_PARAM_THRESHOLD parameters, the parameters over the data axes
    too. The record's "layout" says so; no layout is traced that the
    port's step cannot run.
  - The roofline's link term uses the H100's NVLink rate, a lower bound
    for lines that cross InfiniBand (launch/mesh.py).

Records keep the reference's keys ("status" ok / skipped / error with its
skip reasons, "sparse_kernel", "seq_sharded", "n_micro", "params",
"active_params", "chips", "memory", "per_device", "roofline", "dominant",
"model_flops_per_device", "useful_fraction") and add "rank" (0, the
traced rank) and "layout". A cell whose step raises is an "error" with
its message; `main` exits 1 on any error, as the reference's does. A
scan width |model| does not divide traces the reference's fallback
(its column gathers count among the model line's collectives).
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import SHAPES, all_configs, get_config
from repro_torch.core.attention_exec import (SparseAttentionExec,
                                             resolve_kernel)
from repro_torch.distributed import runtime
from repro_torch.distributed.sharding import (kernel_seq_axis, local_index,
                                              local_slices, mesh_context,
                                              param_pspecs)
from repro_torch.launch import hlo
from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW_PER_GPU,
                                     PEAK_FLOPS_BF16, make_production_mesh)
from repro_torch.launch.steps import (batch_pspecs, cache_pspecs,
                                      make_prefill_step, make_serve_step,
                                      make_train_step, spion_dryrun_halo,
                                      spion_dryrun_tables)
from repro_torch.launch.train import nest
from repro_torch.models.layers import ParamTree
from repro_torch.models.registry import input_specs, params_specs
from repro_torch.optim import adamw_init

FSDP_PARAM_THRESHOLD = 8e9  # the reference data-shards params above this
CONSTANTS = ("the dry run's arithmetic; roofline with the H100 SXM5 80GB "
             "data-sheet constants at 700 W: 989 TFLOP/s dense bf16, "
             "3.35 TB/s HBM3, 450 GB/s NVLink 4 a GPU one way")


def _spion_layers(cfg):
    """Number of per-layer patterns the tables need for this cfg."""
    if cfg.family == "hybrid":
        return max(cfg.num_layers // cfg.hybrid_attn_every, 1)
    return cfg.num_layers


def choose_n_micro(cfg, shape, mesh):
    """The reference's gradient-accumulation factor: the smallest power of
    two that brings the estimated activation residency (2.2 x L x B_loc x
    S x d x 2 bytes) under 8e9 bytes a rank, at most B_loc."""
    if shape.kind != "train":
        return 1
    daxes = int(np.prod([mesh.shape[a] for a in ("pod", "data")
                         if a in mesh.axis_names]))
    B = shape.global_batch
    max_n = max(B // daxes, 1)
    b_loc = max(B / daxes, 1)
    act = 2.2 * cfg.num_layers * b_loc * shape.seq_len * cfg.d_model * 2
    n = 1
    while n < max_n and act / n > 8e9:
        n *= 2
    return n


DEVICE = torch.device("meta")   # the dry run's tensors (module docstring)


def join_fake_world(size: int):
    """Make this process rank 0 of a fake world of `size` ranks (leaving a
    fake world of another size first)."""
    if runtime.is_initialized():
        if runtime.is_fake() and runtime.process_count() == size:
            return
        if not runtime.is_fake():
            raise RuntimeError("the dry run needs a process of its own: this "
                               "one is part of a real job")
        runtime.shutdown()
    runtime.initialize(fake_world=size)


# ---------------------------------------------------------------------------
# one rank's cell
# ---------------------------------------------------------------------------

def _local_shape(index, shape):
    out = []
    for ix, d in zip(index, shape):
        out.append(len(range(*ix.indices(d))) if isinstance(ix, slice)
                   else len(ix))
    return tuple(out) + tuple(shape[len(index):])


def _empty(shape, dtype, device, name):
    return torch.empty(shape, dtype=dtype, device=device)


_CACHE_LEAVES = ("k", "v", "ck", "cv", "S", "ssm", "conv", "tm_prev",
                 "cm_prev")


def random_inputs(cfg, seed=0):
    """A `make` for `build_cell` that makes real tensors from `seed` on
    their device: token ids and labels in the vocabulary, a decode position
    of 0, caches zeros, floating-point tensors of two or more dims N(0,
    0.02) and the others (norm scales, biases) ones."""
    gens = {}

    def make(shape, dtype, device, name):
        dev = torch.device(device)
        gen = gens.get(dev)
        if gen is None:
            gen = gens[dev] = torch.Generator(device=dev).manual_seed(seed)
        if name in ("tokens", "labels"):
            return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                 device=dev).to(dtype)
        if name == "pos" or name in _CACHE_LEAVES:
            return torch.zeros(shape, dtype=dtype, device=dev)
        if len(shape) < 2:
            return torch.ones(shape, dtype=dtype, device=dev)
        return (torch.randn(shape, generator=gen, device=dev,
                            dtype=torch.float32) * 0.02).to(dtype)
    return make


def build_cell(cfg, shape, mesh, mode, n_micro=1, *, device=DEVICE, rank=0,
               tables=None, make=_empty):
    """(step, args, tracked) of `rank`'s step of one cell: `step(*args)`
    runs it; `tracked` lists its inputs (the parameters' ParamTree and the
    other input tensors) for the memory count. `mesh` None (or of one
    rank) is a one-rank cell. The inputs are `make(shape, dtype, device,
    name)` (default: empty tensors) in the rank's shard; a train cell's
    parameters are the Trainer's fp32 masters (ndim >= 2; the others in
    their own dtype) with AdamW moments under the parameter spec. A sparse
    cell's
    tables are `tables` (a SparseAttentionExec or a plan dict of host
    arrays; default the reference's `spion_dryrun_tables` over the whole
    sequence), real tensors wherever they live."""
    on_mesh = mesh is not None and mesh.size > 1
    step_mesh = mesh if on_mesh else None
    sparse = mode == "sparse"
    train = shape.kind == "train"
    ex = None
    if sparse:
        if tables is None:
            tables = spion_dryrun_tables(cfg, shape.seq_len,
                                         _spion_layers(cfg))
        ex = tables if isinstance(tables, SparseAttentionExec) else \
            SparseAttentionExec(tables, block=tables["block"],
                                halo=tables.get("halo"),
                                phase="train" if train else "prefill",
                                dtype=cfg.dtype)
    whole = params_specs(cfg)
    specs = param_pspecs(whole, mesh) if on_mesh else None

    def local(name, x, spec, packed=False):
        if not on_mesh:
            shp = tuple(x.shape)
        elif packed:
            shp = _local_shape(local_index(mesh, name, spec, x.shape, cfg,
                                           rank=rank), x.shape)
        else:
            shp = _local_shape(local_slices(mesh, spec, x.shape, rank),
                               x.shape)
        dtype = torch.float32 if train and x.ndim >= 2 and \
            isinstance(x, torch.nn.Parameter) else x.dtype
        return make(shp, dtype, device, name)

    params = ParamTree(nest({
        n: local(n, x, specs[n] if on_mesh else (), packed=True)
        for n, x in whole.named_parameters()}), trainable=train)
    if shape.kind in ("train", "prefill"):
        batch = input_specs(cfg, shape)["batch"]
        bsp = batch_pspecs(cfg, batch, mesh) if on_mesh else {}
        fb = {k: local(k, x, bsp.get(k, ())) for k, x in batch.items()}
        tracked = [params, *fb.values()]
        if not train:
            step = make_prefill_step(cfg, spion=sparse, mesh=step_mesh,
                                     specs=bsp or None,
                                     halo=None if ex is None else ex.halo)
            return step, (params, fb) + ((ex,) if sparse else ()), tracked
        opt = adamw_init(params)
        tracked += [*opt["mu"].values(), *opt["nu"].values(), opt["count"]]
        step = make_train_step(cfg, spion=sparse, n_micro=n_micro,
                               mesh=step_mesh, specs=specs,
                               halo=None if ex is None else ex.halo)
        return step, (params, opt, fb, 0) + ((ex,) if sparse else ()), \
            tracked
    spec = input_specs(cfg, shape)
    B = shape.global_batch
    csp = cache_pspecs(cfg, spec["cache"], mesh, B) if on_mesh else {}
    cache = {k: local(k, x, csp.get(k, ()), packed=True)
             for k, x in spec["cache"].items()}
    tsp = batch_pspecs(cfg, {"tokens": spec["tokens"]}, mesh)["tokens"] \
        if on_mesh and B > 1 else ()
    tokens = local("tokens", spec["tokens"], tsp)
    pos = make((), torch.int32, device, "pos")
    step = make_serve_step(cfg, mesh=step_mesh, specs=csp or None)
    return step, (params, cache, tokens, pos), [params, *cache.values(),
                                                tokens, pos]


def _tracked_bytes(tracked):
    n = 0
    for x in tracked:
        ts = x.parameters() if hasattr(x, "parameters") else [x]
        n += sum(t.numel() * t.element_size() for t in ts)
    return n


def trace_cell(step, args, tracked, *, costs=True):
    """Run `step(*args)` once under the counting modes: the memory tracker,
    and with `costs` the FLOP counter and the op records
    (launch/hlo.OpRecorder). The same on meta inputs and on the card's (or
    the CPU's) real ones. Returns {"mem": MemTracker, "flops":
    FlopCounterMode or None, "records": list or None, "device": the
    inputs' device, "inputs_bytes": the tracked inputs' bytes, "out": the
    step's outputs}."""
    import contextlib

    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    mt = MemTracker()
    mt.track_external(*tracked)
    fc = trace = None
    with contextlib.ExitStack() as stack:
        stack.enter_context(mt)
        if costs:
            fc = stack.enter_context(FlopCounterMode(display=False))
            trace = stack.enter_context(hlo.OpRecorder())
        out = step(*args)
    device = next(iter(tracked[0].parameters())).device
    return {"mem": mt, "flops": fc, "records": trace and trace.records,
            "device": device, "inputs_bytes": _tracked_bytes(tracked),
            "out": out}


def cost_of(traced) -> dict:
    """Per-rank FLOPs (FlopCounterMode; the kernels through their
    formulas), HBM bytes, collective bytes by kind and the op census of a
    traced step."""
    recs = traced["records"]
    coll = hlo.collective_stats(recs)
    return {
        "flops": float(traced["flops"].get_total_flops()),
        "hbm_bytes": float(hlo.hbm_bytes(recs)),
        "coll_bytes": float(coll["total_bytes"]),
        "coll_by_kind": coll["by_kind"],
        "coll_count": coll["count"],
        "census": hlo.op_census(recs),
    }


def analyse_memory(traced) -> dict:
    """The pass's peak on the rank's device (MemTracker; not the host
    tables'): its categories, the total, `per_device_gb`, the inputs'
    bytes and the step's rise over them (`step_peak_bytes`: what the
    card's max_memory_allocated rises by over a step whose inputs
    exist)."""
    dev = traced["mem"].get_tracker_snapshot("peak").get(traced["device"])
    if not dev:
        return {}
    cats = {getattr(k, "value", str(k)): int(v) for k, v in dev.items()
            if k != "Total"}
    total = int(dev["Total"])
    return {"by_category": cats, "total_bytes": total,
            "inputs_bytes": int(traced["inputs_bytes"]),
            "step_peak_bytes": total - int(traced["inputs_bytes"]),
            "per_device_gb": total / 2 ** 30}


def _layout(cfg, shape):
    fsdp = cfg.param_count() > FSDP_PARAM_THRESHOLD
    train = shape.kind == "train"
    ref_params = "param_pspecs + the data axes (FSDP)" if fsdp \
        else "param_pspecs"
    out = {"params": "param_pspecs",
           "moments": "param_pspecs" if train else None,
           "reference": {"params": ref_params,
                         "moments": "zero1_pspecs" if train else None}}
    differs = fsdp or train
    out["note"] = (
        "the port's own layout (moments under the parameter spec, no "
        "FSDP); the reference's cell would use "
        + " and ".join(x for x in (("FSDP" if fsdp else ""),
                                   ("ZeRO-1 moments" if train else ""))
                       if x) + ", which the port does not run"
        if differs else "the reference's layout")
    return out


def run_cell(arch, shape_name, multi_pod, mode, outdir, verbose=True,
             cfg_override=None, skip_costs=False, mesh_override=None):
    """Trace one cell (see the module docstring) and write its record to
    `outdir`/<cell>.json; returns the record."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = SHAPES[shape_name]
    reason = cfg.skip_reason(shape_name)
    where = "multi" if multi_pod else "single"
    cellname = f"{arch}__{shape_name}__{where}__{mode}"
    path = os.path.join(outdir, cellname + ".json")
    if reason:
        rec = {"cell": cellname, "status": "skipped", "reason": reason}
        _write(path, rec)
        if verbose:
            print(f"[skip] {cellname}: {reason}", flush=True)
        return rec
    if mode == "sparse" and (not cfg.spion.enabled or shape.kind == "decode"):
        rec = {"cell": cellname, "status": "skipped",
               "reason": "SPION inapplicable (attention-free arch or "
                         "decode shape)"}
        _write(path, rec)
        if verbose:
            print(f"[skip] {cellname}: sparse inapplicable", flush=True)
        return rec
    t0 = time.time()
    try:
        mesh = mesh_override
        if mesh is None or mesh.size > 1:
            size = mesh.size if mesh is not None else \
                (512 if multi_pod else 256)
            join_fake_world(size)
            if mesh is None:
                mesh = make_production_mesh(multi_pod=multi_pod)
            elif mesh._groups is None:
                mesh.build_groups()
        chips = mesh.size
        n_micro = choose_n_micro(cfg, shape, mesh)
        sparse_kernel = seq_sharded = None
        if mode == "sparse":
            halo = spion_dryrun_halo(cfg, shape.seq_len, _spion_layers(cfg))
            nrb = max(shape.seq_len // cfg.spion.block_size, 1)
            with mesh_context(mesh):
                # what the step dispatches to on the rank's device
                sparse_kernel = resolve_kernel(
                    cfg, torch.empty(0, device=DEVICE))
            seq_ax, seq_reason = kernel_seq_axis(mesh, nrb, halo)
            seq_sharded = {"active": seq_ax is not None,
                           "halo": list(halo) if halo else None,
                           "detail": seq_reason}
        step, args, tracked = build_cell(cfg, shape, mesh, mode, n_micro)
        with mesh_context(mesh if mesh.size > 1 else None):
            traced = trace_cell(step, args, tracked, costs=not skip_costs)
        memd = analyse_memory(traced)
        rec = {"cell": cellname, "status": "ok", "arch": arch,
               "shape": shape_name, "mesh": where,
               "mode": mode, "chips": chips, "rank": 0, "n_micro": n_micro,
               "sparse_kernel": sparse_kernel,
               "seq_sharded": seq_sharded,
               "t_trace_s": round(time.time() - t0, 1),
               "params": cfg.param_count(),
               "active_params": cfg.active_param_count(),
               "device": str(DEVICE),
               "layout": _layout(cfg, shape),
               "memory": memd}
        if not skip_costs:
            # the eager trace saw every layer: no extrapolation
            cost, plan = cost_of(traced), {"plan": "direct"}
            terms = hlo.roofline_terms(
                cost["flops"], cost["hbm_bytes"], cost["coll_bytes"], 1,
                peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW,
                link_bw=NVLINK_BW_PER_GPU)
            dom = max(terms, key=terms.get)
            tokens = shape.global_batch * shape.seq_len
            nd = 6 * cfg.active_param_count() * tokens
            model_flops_per_dev = (nd if shape.kind == "train"
                                   else nd / 3.0) / chips
            if shape.kind == "decode":
                model_flops_per_dev = 2 * cfg.active_param_count() * \
                    shape.global_batch / chips
            rec.update({
                "per_device": cost, "extrapolation": plan,
                "roofline": terms, "dominant": dom,
                "model_flops_per_device": model_flops_per_dev,
                "useful_fraction": (model_flops_per_dev / cost["flops"])
                if cost["flops"] else None,
            })
        rec["t_total_s"] = round(time.time() - t0, 1)
        if verbose:
            mem = rec["memory"].get("per_device_gb", float("nan"))
            extra = ""
            if not skip_costs:
                extra = (f" flops/dev={rec['per_device']['flops']:.3e}"
                         f" coll/dev={rec['per_device']['coll_bytes']:.3e}B"
                         f" dominant={rec['dominant']}"
                         f" useful={rec['useful_fraction']:.2f}"
                         if rec.get("useful_fraction") else "")
            print(f"[ok] {cellname}: mem/dev={mem:.2f}GiB{extra} "
                  f"({rec['t_total_s']}s)", flush=True)
    except Exception as e:  # noqa: BLE001
        rec = {"cell": cellname, "status": "error", "error": str(e)[-2000:],
               "traceback": traceback.format_exc()[-4000:]}
        if verbose:
            print(f"[ERR] {cellname}: {str(e)[:300]}", flush=True)
    _write(path, rec)
    return rec


def _write(path, rec):
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--mode", choices=["dense", "sparse", "both"],
                    default="dense")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-costs", action="store_true",
                    help="memory only (multi-pod cells always)")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    print(f"dry run: one rank's step a cell on meta tensors; every figure "
          f"is {CONSTANTS}", flush=True)

    archs = args.arch.split(",") if args.arch else \
        sorted(a for a in all_configs() if a != "spion-lra")
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    modes = {"dense": ["dense"], "sparse": ["sparse"],
             "both": ["dense", "sparse"]}[args.mode]

    results = []
    t0 = time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                for mode in modes:
                    results.append(run_cell(arch, shape, mp, mode, args.out,
                                            skip_costs=args.skip_costs or mp))
    ok = sum(r["status"] == "ok" for r in results)
    sk = sum(r["status"] == "skipped" for r in results)
    err = sum(r["status"] == "error" for r in results)
    print(f"\n== dry-run: {ok} ok / {sk} skipped / {err} errors "
          f"({time.time() - t0:.1f}s) ==", flush=True)
    if err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
