"""Multi-process runtime: `torch.distributed` bring-up and the host data
that makes single-controller training real (the JAX package's
`distributed/runtime.py`).

Every process runs the same program; this module owns the places where
that symmetry is broken or enforced:

  - **Bring-up** (`initialize`): one call joins the process group. Its
    parameters come from explicit arguments or the `SPION_COORDINATOR` /
    `SPION_NUM_PROCESSES` / `SPION_PROCESS_ID` environment (set by the
    fleet supervisor); with neither, the run is single-process, the call
    returns False and every helper below degrades to a no-op.

  - **Two groups.** Device tensors (the gradient all-reduce, the halo
    exchange of the sequence-parallel kernels) go over the *device group*:
    NCCL when every rank of the host has a card of its own, gloo on the
    CPU and when ranks share a card (NCCL cannot put two ranks on one
    GPU). Host data (the plan broadcast, flags, digests, barriers) goes
    over a gloo group of CPU tensors whatever the device backend is, so a
    few bytes of control never take a round trip through a card. The
    reference broadcasts host data on the training fabric itself; the port
    keeps the control plane on gloo (ROADMAP departures).

  - **Single-controller host data** (`broadcast_arrays`, `host_allgather`,
    `assert_in_sync`): host-side work that must not run N times (the flood
    fill, checkpoint writes) runs on process 0 and its results reach the
    others as a header and one byte payload. `assert_in_sync` is the loud
    half: each process contributes a digest of what it holds and every
    process raises when they differ.

  - **Synchronisation** (`barrier`, `any_flag`, `any_flags`, `max_value`):
    the named rendezvous of the checkpoint commit, and the per-step OR that
    turns a SIGTERM on one host into a fleet-wide, same-step save.

  - **Device collectives** (`all_reduce_sum`, `broadcast_tensors`,
    `send_recv` with its `transport`): bucketed sums and broadcasts, and
    the point-to-point messages of the 'seq' halo and the pipeline's hops.

  - **A fake world** (`initialize(fake_world=n)`): the dry run
    (launch/dryrun.py) joins torch's "fake" backend as rank 0 of n ranks,
    the production mesh's size. Its collectives move nothing (the dry run
    records them); the host-data collectives return this rank's value,
    as if every rank held it. It takes a process of its own.

Collectives are ordered per group, so call this module from the main
thread only (the CheckpointManager's commit barrier runs in `wait()` for
that reason).
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# env vars the launcher sets for each worker
ENV_COORDINATOR = "SPION_COORDINATOR"
ENV_NUM_PROCESSES = "SPION_NUM_PROCESSES"
ENV_PROCESS_ID = "SPION_PROCESS_ID"

_initialized = False
_host_group = None          # gloo group of every process (None: the default)
_fake = False               # a fake world (the dry run's)


def local_process_count(num_processes: int) -> int:
    """The number of processes on this host: LOCAL_WORLD_SIZE when a
    launcher sets it (a job across hosts), else `num_processes` (one
    host)."""
    if os.environ.get("LOCAL_WORLD_SIZE"):
        return int(os.environ["LOCAL_WORLD_SIZE"])
    return int(num_processes)


def device_backend(num_processes: int) -> str:
    """The device group's backend: NCCL when this host has a card for each
    of its processes, gloo otherwise (the CPU, or ranks sharing a card)."""
    if torch.cuda.is_available() and dist.is_nccl_available() and \
            torch.cuda.device_count() >= local_process_count(num_processes):
        return "nccl"
    return "gloo"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               fake_world: Optional[int] = None) -> bool:
    """Join the process group (idempotent). Arguments fall back to the
    SPION_* environment; with neither this is a single-process run and the
    call returns False. `coordinator` is HOST:PORT (a tcp:// prefix is
    accepted). The backend is `device_backend`'s; under NCCL the process's
    card is set first (`local_device`). Returns True when the process is
    part of a multi-process job.

    `fake_world` = n joins a fake world of n ranks as rank 0 instead (the
    dry run's; see the module docstring): no coordinator, no card, and no
    gloo group for host data (one cannot be made under the fake backend)."""
    global _initialized, _host_group, _fake
    if _initialized:
        return True
    if fake_world is not None:
        # importing the module registers the "fake" backend
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=int(fake_world))
        _host_group, _fake, _initialized = None, True, True
        return True
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if num_processes is None and os.environ.get(ENV_NUM_PROCESSES):
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and os.environ.get(ENV_PROCESS_ID):
        process_id = int(os.environ[ENV_PROCESS_ID])
    if coordinator is None or num_processes is None:
        return False
    backend = device_backend(num_processes)
    if backend == "nccl":
        torch.cuda.set_device(local_device(process_id))
    if not coordinator.startswith("tcp://"):
        coordinator = "tcp://" + coordinator
    dist.init_process_group(backend=backend, init_method=coordinator,
                            world_size=int(num_processes),
                            rank=int(process_id))
    _host_group = None if backend == "gloo" else \
        dist.new_group(backend="gloo")
    _initialized = True
    return True


def shutdown(exit_code: Optional[int] = None):
    """Leave the job: a barrier, then the process group is destroyed. Call
    it on every process at the end of a job. With `exit_code` the process
    then ends at once (output flushed, `os._exit`): after gloo traffic the
    interpreter's own teardown aborts now and then ("terminate called
    without an active exception", exit -6, in 2 to 12% of 2-rank CPU jobs
    under load), which a supervisor would take for a crash."""
    global _initialized, _host_group, _fake
    if _initialized and dist.is_initialized():
        barrier("shutdown")
        dist.destroy_process_group()
    _initialized, _host_group, _fake = False, None, False
    if exit_code is not None:
        import sys
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(int(exit_code))


def is_initialized() -> bool:
    return _initialized


def is_fake() -> bool:
    """Whether this process is rank 0 of a fake world (the dry run's)."""
    return _fake


def process_index() -> int:
    return dist.get_rank() if _initialized else 0


def process_count() -> int:
    return dist.get_world_size() if _initialized else 1


def is_coordinator() -> bool:
    """Single-controller gate: host-side work (flood fill, checkpoint
    writes, logging) runs only where this is True."""
    return process_index() == 0


def local_rank(process_id: Optional[int] = None) -> int:
    """This process's rank on its host: LOCAL_RANK when a launcher sets it,
    else the process index (one host)."""
    if os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    return process_index() if process_id is None else int(process_id)


def local_device(process_id: Optional[int] = None) -> torch.device:
    """The card of this rank, `cuda:{local_rank % device_count}`: ranks
    beyond the host's cards share them. Raises without a card (nothing
    falls back to the CPU unasked), and in a fake world, whose ranks have
    no card of their own (the dry run names its device)."""
    if _fake:
        raise RuntimeError("local_device: a fake world's ranks have no "
                           "card; pass the device explicitly")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    return torch.device(
        "cuda", local_rank(process_id) % torch.cuda.device_count())


# ---------------------------------------------------------------------------
# host-data collectives (gloo, CPU tensors)
# ---------------------------------------------------------------------------

def _broadcast0(x: np.ndarray) -> np.ndarray:
    """Process 0's copy of `x` on every process (shape and dtype must agree
    already)."""
    if _fake:
        return np.asarray(x)
    t = torch.from_numpy(np.ascontiguousarray(x).copy())
    dist.broadcast(t, src=0, group=_host_group)
    return t.numpy()


def host_allgather(x: np.ndarray) -> np.ndarray:
    """One host array per process -> (process_count, *x.shape) on every
    process, in process order. In a fake world every process holds this
    one's."""
    x = np.asarray(x)
    if process_count() == 1:
        return x[None]
    if _fake:
        return np.stack([x] * process_count())
    t = torch.from_numpy(np.ascontiguousarray(x).copy())
    out = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(out, t, group=_host_group)
    return np.stack([o.numpy() for o in out])


def barrier(name: str = "") -> None:
    """Named rendezvous. The allgather doubles as a check that every process
    is at the *same* barrier (the name digests must agree): two processes
    at different barriers raise instead of deadlocking later."""
    if process_count() == 1:
        return
    tag = np.frombuffer(hashlib.sha256(name.encode()).digest()[:8],
                        np.uint8).copy()
    got = host_allgather(tag)
    if not (got == tag[None]).all():
        raise RuntimeError(
            f"barrier({name!r}): processes met at different barriers "
            f"(tag rows: {got.tolist()})")


def any_flag(flag: bool) -> bool:
    """Fleet-wide OR of a per-process bool: a SIGTERM lands on one host,
    and every process learns it at the same step boundary."""
    if process_count() == 1:
        return bool(flag)
    got = host_allgather(np.asarray([1 if flag else 0], np.int32))
    return bool(got.sum() > 0)


def any_flags(flags) -> list:
    """Element-wise fleet-wide OR of several per-process bools in ONE
    collective (the step loop's preempted and diverged flags)."""
    flags = [bool(f) for f in flags]
    if process_count() == 1:
        return flags
    got = host_allgather(np.asarray([1 if f else 0 for f in flags], np.int32))
    return [bool(v) for v in (got.sum(axis=0) > 0)]


def max_value(value: int) -> int:
    """Fleet-wide max of a per-process int: the rollback's agreed
    divergence step."""
    if process_count() == 1:
        return int(value)
    got = host_allgather(np.asarray([value], np.int64))
    return int(got.max())


# ---------------------------------------------------------------------------
# single-controller payloads
# ---------------------------------------------------------------------------

def payload_digest(arrays: Optional[dict], meta: Optional[dict] = None) -> str:
    """Deterministic hex digest of an {name: ndarray} payload (+ JSON-able
    meta): name, dtype, shape and bytes all take part, so one flipped int32
    of a plan table changes it. The reference's digest, byte for byte."""
    h = hashlib.sha256()
    for k in sorted(arrays or {}):
        a = np.ascontiguousarray(np.asarray((arrays or {})[k]))
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    if meta is not None:
        h.update(json.dumps(meta, sort_keys=True).encode())
    return h.hexdigest()[:32]


def broadcast_arrays(arrays: Optional[dict], meta: Optional[dict] = None):
    """The coordinator's ({name: ndarray}, meta) on every process: two
    broadcasts, the lengths and then one uint8 buffer of a JSON header and
    the arrays' bytes, so the others need to know nothing in advance. They
    may pass anything. Returns (arrays, meta) everywhere; a single process
    (and rank 0 of a fake world) gets its arguments back."""
    if process_count() == 1 or _fake:
        return arrays, meta
    if is_coordinator():
        arrays = {k: np.ascontiguousarray(np.asarray(v))
                  for k, v in (arrays or {}).items()}
        header = json.dumps({
            "meta": meta,
            "names": sorted(arrays),
            "specs": {k: [str(arrays[k].dtype), list(arrays[k].shape)]
                      for k in arrays},
        }).encode()
        payload = b"".join(arrays[k].tobytes() for k in sorted(arrays))
        lengths = np.asarray([len(header), len(payload)], np.int64)
        buf = np.frombuffer(header + payload, np.uint8).copy()
    else:
        lengths = np.zeros(2, np.int64)
        buf = None
    lengths = _broadcast0(lengths)
    hlen, plen = int(lengths[0]), int(lengths[1])
    if buf is None:
        buf = np.zeros(hlen + plen, np.uint8)
    buf = _broadcast0(buf)
    head = json.loads(bytes(buf[:hlen]))
    out, off = {}, hlen
    for k in head["names"]:
        dtype, shape = head["specs"][k]
        n = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        out[k] = np.frombuffer(bytes(buf[off:off + n]),
                               dtype=dtype).reshape(shape).copy()
        off += n
    return out, head["meta"]


def assert_in_sync(tag: str, digest: str) -> None:
    """Every process contributes `digest`; all must match, else every
    process raises with the per-process table (a plan whose tables differ
    across processes would run different patterns through the kernels)."""
    if process_count() == 1:
        return
    d = np.frombuffer(bytes.fromhex(digest.ljust(32, "0")[:32]),
                      np.uint8).copy()
    got = host_allgather(d)
    if not (got == got[0][None]).all():
        rows = {p: bytes(got[p]).hex() for p in range(got.shape[0])}
        raise RuntimeError(
            f"assert_in_sync({tag!r}): digest mismatch across processes — "
            f"{rows} (local process {process_index()})")


# ---------------------------------------------------------------------------
# device collectives
# ---------------------------------------------------------------------------

BUCKET_BYTES = 32 << 20


def _buckets(tensors):
    """Consecutive runs of `tensors` of one dtype and device, at most
    BUCKET_BYTES each (a larger tensor is a bucket of its own)."""
    buckets, cur, size = [], [], 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        if cur and (size + nb > BUCKET_BYTES or t.dtype != cur[0].dtype
                    or t.device != cur[0].device):
            buckets.append(cur)
            cur, size = [], 0
        cur.append(t)
        size += nb
    if cur:
        buckets.append(cur)
    return buckets


def _bucketed(collective, tensors):
    """Run `collective(flat)` on each bucket flattened, and copy the result
    back into the bucket's tensors (in place)."""
    for b in _buckets(tensors):
        flat = torch.cat([t.reshape(-1) for t in b])
        collective(flat)
        off = 0
        for t in b:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n
    return tensors


def all_reduce_sum(tensors, group=None):
    """Sum each tensor of the list over `group` (the device group by
    default) in place, flattened into buckets of at most BUCKET_BYTES of
    one dtype: one all-reduce per bucket, not per tensor. Returns the
    list."""
    if process_count() == 1 and group is None:
        return tensors
    return _bucketed(lambda f: dist.all_reduce(f, group=group), tensors)


def broadcast_tensors(tensors, src: int = 0, group=None):
    """Process `src`'s values of each tensor on every process, in place and
    in buckets (the replicated parameters at a job's start)."""
    if process_count() == 1 and group is None:
        return tensors
    return _bucketed(lambda f: dist.broadcast(f, src=src, group=group),
                     tensors)


def transport(group, x) -> str:
    """How point-to-point messages of `x`'s kind cross `group` (the 'seq'
    halo exchange, the pipeline's hops): "p2p" (NCCL, or gloo with CPU
    tensors: dist.batch_isend_irecv) or "host-p2p" (gloo with CUDA
    tensors, which gloo moves only for broadcast and all_reduce: the same
    messages through pinned host buffers)."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return "host-p2p"
    return "p2p"


def send_recv(group, sends, recvs, staged):
    """One exchange of point-to-point messages on `group`, posted together
    and waited for: `sends` [(tensor, peer)], `recvs` [(tensor, peer)]
    filled in place (peers are global ranks). `staged` (the "host-p2p"
    transport) sends and receives through pinned host buffers."""
    if staged:
        hosted = []
        for t, p in sends:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            hosted.append((buf, p))
        torch.cuda.current_stream().synchronize()
        sends = hosted
        bufs = [(torch.empty(t.shape, dtype=t.dtype, pin_memory=True), p)
                for t, p in recvs]
    else:
        bufs = recvs
    ops = [dist.P2POp(dist.isend, t, p, group=group) for t, p in sends]
    ops += [dist.P2POp(dist.irecv, b, p, group=group) for b, p in bufs]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if staged:
        for (t, _), (b, _) in zip(recvs, bufs):
            t.copy_(b, non_blocking=True)
