"""Kernel autotuner with a persistent on-disk config cache: the counterpart
of the JAX package's `kernels/autotune.py`.

The bf16 Hopper kernels have two knobs (dispatch.KernelConfig): the depth
of the ring their tiles stream through, and the warpgroups of a forward or
dQ program. The best point depends on the pattern (how many tiles a row or
column block streams), the tile shape, the dtype and the backend. `tune`
sweeps a bounded candidate set for one pattern on synthetic inputs, times
each, and persists the winner as one small JSON file per key under
`SPION_AUTOTUNE_DIR` (default ~/.cache/spion/autotune); `SPION_AUTOTUNE=0`
turns the cache off.

The cache is consulted, a lookup and never a sweep, when a
`SparseAttentionExec` is constructed, so training and serving run their
tuned configs by building their exec. The exec keys its lookup by the
dtype the kernels will run in (the reference always looks up float32):
fp32 runs the scalar kernels, which have no knob.

Correctness contract: a config may only ever change speed. Every
candidate's o, lse, dq, dk and dv are held bitwise against the default
config's before it may win (the reference checks the forward only; here
all three kernels take the config), and a corrupt, stale or unparseable
cache entry falls back to the default config with a warning, never a
crash and never a different result.

Keys: `pattern_digest` hashes the kernel-visible tables (col_idx / nvalid
and, from a plan, row_idx / nvalid_t) as numpy int32 on the host, plus the
block size, and gives the reference's sha256 for the same tables; the
table shape (nrb, K, block), the dtype's numpy name and the backend
("cuda" on the card, "cpu" elsewhere) complete the file name.

On the CPU the sweep times the kernels' plain versions, which ignore the
config: the mechanics (tune -> cache -> lookup) run end to end there, and
no time from there says anything about the card.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
import warnings

import numpy as np
import torch

from repro_torch.kernels.dispatch import (DEFAULT_CONFIG, MAX_DEPTH,
                                          NUM_WARPS, KernelConfig,
                                          compiled_backend)

_VERSION = 1
_ENV_DIR = "SPION_AUTOTUNE_DIR"
_ENV_ENABLE = "SPION_AUTOTUNE"
# core.sparse_attention.PLAN_TABLE_KEYS, in the reference's order
_TABLE_KEYS = ("col_idx", "nvalid", "row_idx", "nvalid_t")


def enabled() -> bool:
    return os.environ.get(_ENV_ENABLE, "1") not in ("0", "false", "off")


def cache_dir() -> str:
    return os.environ.get(
        _ENV_DIR, os.path.join(os.path.expanduser("~"), ".cache", "spion",
                               "autotune"))


def _host_int32(val) -> np.ndarray:
    if isinstance(val, torch.Tensor):
        val = val.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(val), dtype=np.int32)


def pattern_digest(tables, block) -> str:
    """sha256 over the kernel-visible table payload + block size (the
    reference's digest of the same tables)."""
    h = hashlib.sha256()
    h.update(f"block={int(block)}".encode())
    for key in _TABLE_KEYS:
        val = tables.get(key) if hasattr(tables, "get") else None
        if val is None:
            continue
        arr = _host_int32(val)
        h.update(f"|{key}:{arr.dtype}:{arr.shape}:".encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _shape_sig(tables, block) -> str:
    shape = tuple(tables["col_idx"].shape)
    return f"nrb{int(shape[-2])}_k{int(shape[-1])}_b{int(block)}"


def dtype_name(dtype) -> str:
    """numpy's name of a torch dtype, of its name or of a numpy dtype
    ("float32", "bfloat16")."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    if not isinstance(getattr(torch, name, None), torch.dtype):
        raise ValueError(f"not a dtype the kernels run in: {dtype!r}")
    return name


def cache_path(digest: str, shape_sig: str, dtype, backend: str) -> str:
    name = f"{digest[:16]}__{shape_sig}__{dtype_name(dtype)}__{backend}"
    return os.path.join(cache_dir(), name + ".json")


def _backend_name(device=None) -> str:
    """The cache's backend: that of `device`, else of this host (the card
    when there is one, as the port's entry points resolve device=None)."""
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return compiled_backend(device) or "cpu"


# ---------------------------------------------------------------------------
# cache IO (loud fallback on anything malformed)
# ---------------------------------------------------------------------------

def load_entry(path: str) -> dict | None:
    """Parse + validate one cache entry; None (with a warning) when bad."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            entry = json.load(f)
        if not isinstance(entry, dict):
            raise ValueError(f"entry is {type(entry).__name__}, not an object")
        if entry.get("version") != _VERSION:
            raise ValueError(f"cache version {entry.get('version')!r} != "
                             f"current {_VERSION} (stale entry)")
        entry["config"] = KernelConfig.from_json(entry["config"])
        return entry
    except (OSError, ValueError, TypeError, KeyError,
            json.JSONDecodeError) as e:
        warnings.warn(
            f"spion autotune: ignoring unusable cache entry {path} ({e}); "
            f"falling back to the default kernel config", stacklevel=2)
        return None


def _path(tables, block, dtype, backend):
    return cache_path(pattern_digest(tables, block),
                      _shape_sig(tables, block), dtype, backend)


def lookup(tables, block, *, dtype=torch.float32,
           device=None) -> KernelConfig | None:
    """Pure cache lookup (no sweep). None on miss / disabled / bad entry."""
    if not enabled():
        return None
    entry = load_entry(_path(tables, block, dtype, _backend_name(device)))
    return None if entry is None else entry["config"]


def store(tables, block, config: KernelConfig, *, dtype=torch.float32,
          device=None, best_us: float | None = None, swept: int = 0) -> str:
    """Write `config` as the entry of these tables (atomically: a reader
    sees the old entry or the new one)."""
    backend = _backend_name(device)
    path = _path(tables, block, dtype, backend)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    entry = {"version": _VERSION, "backend": backend,
             "dtype": dtype_name(dtype),
             "shape_sig": _shape_sig(tables, block),
             "config": config.to_json(), "best_us": best_us, "swept": swept}
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(entry, f, indent=1)
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# candidate sweep
# ---------------------------------------------------------------------------

def candidate_grid(backend: str, dtype) -> list[KernelConfig]:
    """Every config a sweep on `backend` in `dtype` considers, before
    `config_fits`: on the card in bf16 each ring depth by each warp count
    (8), in fp32 the default alone (the scalar kernels have no knob); on
    the CPU three depths, so that the mechanics run there."""
    if backend == "cuda":
        if dtype_name(dtype) == "float32":
            return [DEFAULT_CONFIG]
        return [KernelConfig(depth=d, num_warps=w)
                for d in range(1, MAX_DEPTH + 1) for w in NUM_WARPS]
    return [KernelConfig(depth=d) for d in (1, 2, 3)]


def candidates(backend: str | None = None, dtype=torch.float32,
               shape: dict | None = None) -> list[KernelConfig]:
    """The bounded sweep set: `candidate_grid` less what does not fit in
    shared memory at `shape` (hd, block, G, K, KT; block_sparse_attn.
    config_fits), when a shape is given."""
    from repro_torch.kernels.block_sparse_attn import config_fits
    backend = _backend_name() if backend is None else backend
    grid = candidate_grid(backend, dtype)
    if shape is None:
        return grid
    return [c for c in grid if config_fits(c, **shape)]


_INNER = 10   # calls a timed rep averages, so that a rep outlasts a launch


def _time_us(fn, *, device, reps: int = 3, warmup: int = 1) -> float:
    """min over `reps` of the mean time of _INNER calls, in us; the warmup
    calls are discarded. CUDA events on the card, the host clock on the
    CPU."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    cuda = compiled_backend(device) == "cuda"
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(_INNER):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            t = 1e3 * start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(_INNER):
                fn()
            t = 1e6 * (time.perf_counter() - t0)
        best = min(best, t / _INNER)
    return best


def _bitwise_equal(a, b) -> bool:
    """Equal bit for bit (so -0.0 differs from 0.0, and a NaN equals the
    same NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return torch.equal(a.view(ints[a.dtype]), b.view(ints[b.dtype]))


def _layer0(tables, key):
    """Table `key` on the host, layer 0's when the tables are stacked."""
    val = tables.get(key)
    if val is None:
        return None
    t = torch.as_tensor(_host_int32(val))
    return t[0] if len(tables["col_idx"].shape) == 3 else t


def tune_shape(tables, block, *, group, head_dim) -> dict:
    """The shape `config_fits` and `candidates` take for a sweep of these
    tables (as `tune` runs it): hd, block, G, the forward's width K and
    dK/dV's width KT (a plan's, or bcsr_transpose's nrb)."""
    col = tables["col_idx"]
    row_idx = tables.get("row_idx")
    KT = int(row_idx.shape[-1]) if row_idx is not None else int(col.shape[-2])
    return dict(hd=int(head_dim), block=int(block), G=int(group),
                K=int(col.shape[-1]), KT=KT)


def tune(tables, block, *, heads: int = 1, group: int = 1, head_dim: int = 64,
         dtype=torch.float32, causal: bool = False, sliding_window=None,
         reps: int = 3, device=None, generator=None, write_cache: bool = True):
    """Sweep the candidate set on synthetic inputs shaped by the tables:
    q and do (heads, group, nrb * block, head_dim), k and v (heads, ncb *
    block, head_dim) from `generator` (default: seed 0 on `device`), on
    `device` (None: the card). Stacked (Ly, nrb, K) tables tune on layer 0;
    without a plan's row_idx / nvalid_t, dK/dV streams bcsr_transpose's.

    Returns (best_config, report). The report lists every candidate with
    its forward, dQ and dK/dV times (us; the forward decides, as in the
    reference), the shared memory of each launch, and whether all of o,
    lse, dq, dk and dv matched the default config's bit for bit
    (mismatching candidates are disqualified: the cache must never change
    results). The winner is persisted unless write_cache=False."""
    from repro_torch import resolve_device
    from repro_torch.core.sparse_attention import bcsr_transpose
    from repro_torch.kernels.block_sparse_attn import (block_sparse_dkv,
                                                       block_sparse_dq,
                                                       block_sparse_fwd,
                                                       config_smem)
    device = resolve_device(device)
    dt = getattr(torch, dtype_name(dtype))
    col = _layer0(tables, "col_idx").clamp(min=0)
    nvalid = _layer0(tables, "nvalid")
    nrb = col.shape[0]
    row_idx, nvalid_t = _layer0(tables, "row_idx"), _layer0(tables, "nvalid_t")
    if row_idx is None:
        ncb = max(nrb, int(col.max()) + 1 if col.numel() else 0)
        row_idx, nvalid_t = bcsr_transpose(col, nvalid, ncb=ncb)
    ncb = row_idx.shape[0]
    idx = {n: t.to(device=device, dtype=torch.int32).contiguous()
           for n, t in (("col", col), ("nvalid", nvalid), ("row", row_idx),
                        ("nvalid_t", nvalid_t))}
    gen = generator if generator is not None else \
        torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(dt)
    S, Sk = nrb * block, ncb * block
    q, do = randn(heads, group, S, head_dim), randn(heads, group, S, head_dim)
    k, v = randn(heads, Sk, head_dim), randn(heads, Sk, head_dim)
    kw = dict(block=int(block), causal=bool(causal),
              sliding_window=None if sliding_window is None
              else int(sliding_window))
    shape = tune_shape(tables, block, group=group, head_dim=head_dim)
    o0, _ = block_sparse_fwd(q, k, v, idx["col"], idx["nvalid"], **kw)
    delta = (do.float() * o0.float()).sum(dim=-1)

    def fwd(c):
        return block_sparse_fwd(q, k, v, idx["col"], idx["nvalid"], config=c,
                                **kw)

    def dq(c, lse):
        return block_sparse_dq(q, k, v, do, lse, delta, idx["col"],
                               idx["nvalid"], config=c, **kw)

    def dkv(c, lse):
        return block_sparse_dkv(q, k, v, do, lse, delta, idx["row"],
                                idx["nvalid_t"], config=c, **kw)

    def outputs(c):
        o, lse = fwd(c)
        return (o, lse, dq(c, lse), *dkv(c, lse))

    base = outputs(DEFAULT_CONFIG)
    backend = _backend_name(device)
    report, best, best_us = [], DEFAULT_CONFIG, None
    for cand in [DEFAULT_CONFIG] + [c for c in candidates(backend, dt, shape)
                                    if c != DEFAULT_CONFIG]:
        got = base if cand == DEFAULT_CONFIG else outputs(cand)
        bitwise = all(_bitwise_equal(a, b) for a, b in zip(got, base))
        lse = got[1]
        row = {"config": cand, "bitwise": bitwise,
               "us": _time_us(lambda: fwd(cand), device=device, reps=reps),
               "dq_us": _time_us(lambda: dq(cand, lse), device=device,
                                 reps=reps),
               "dkv_us": _time_us(lambda: dkv(cand, lse), device=device,
                                  reps=reps),
               "smem": config_smem(cand, **shape)}
        report.append(row)
        if not bitwise:
            warnings.warn(f"spion autotune: candidate {cand} changed a "
                          f"kernel's output bitwise; disqualified",
                          stacklevel=2)
            continue
        if best_us is None or row["us"] < best_us:
            best, best_us = cand, row["us"]
    if write_cache:
        store(tables, block, best, dtype=dt, device=device, best_us=best_us,
              swept=len(report))
    return best, report


def tune_plan(plan, **kw):
    """`tune` on a core.sparse_attention.SparsityPlan."""
    return tune(plan.tables, plan.tables["block"], **kw)


def describe(config: KernelConfig | None) -> str:
    if config is None:
        return "default"
    parts = [f"depth={config.depth}"]
    for f in dataclasses.fields(config):
        val = getattr(config, f.name)
        if f.name != "depth" and val is not None:
            parts.append(f"{f.name}={val}")
    return ",".join(parts)
