"""Port parity, the multi-process runtime: `distributed/runtime.py` over
real `torch.distributed` CPU processes (gloo), the JAX package's
RUNTIME_CODE scenario (tests/test_multiprocess.py) on the port; the
payload digest against the reference's, byte for byte; the single-process
no-ops; the mesh of ranks (`launch/mesh.py`); and the sharded batcher
(`data/pipeline.py`)."""
import numpy as np
import pytest
import torch

from conftest import run_distributed_case

MP_ENV = {"OMP_NUM_THREADS": "1"}

RUNTIME_CODE = """
import os
import numpy as np
import torch
pid = int(os.environ["MP_PID"]); nproc = int(os.environ["MP_NPROC"])
from repro_torch.distributed import runtime
assert runtime.initialize(f"localhost:{os.environ['MP_PORT']}", nproc, pid)
assert runtime.initialize()                  # idempotent
assert runtime.process_count() == nproc and runtime.process_index() == pid
assert runtime.is_coordinator() == (pid == 0)
g = runtime.host_allgather(np.asarray([pid * 10 + 7], np.int32))
assert g.tolist() == [[7], [17]], g
# broadcast: only process 0 knows the payload (shapes, dtypes, meta)
if runtime.is_coordinator():
    arrays = {"a": np.arange(12, dtype=np.int32).reshape(3, 4),
              "b": np.full(5, 3.5, np.float64),
              "c": np.arange(7, dtype=np.uint8)}
    meta = {"block": 16, "note": "hi"}
else:
    arrays, meta = None, None
out, m = runtime.broadcast_arrays(arrays, meta)
assert m == {"block": 16, "note": "hi"}
assert out["a"].dtype == np.int32 and \\
    out["a"].tolist() == np.arange(12).reshape(3, 4).tolist()
assert out["b"].dtype == np.float64 and np.allclose(out["b"], 3.5)
assert out["c"].dtype == np.uint8 and out["c"].tolist() == list(range(7))
runtime.assert_in_sync("payload", runtime.payload_digest(out, m))
assert runtime.any_flag(pid == 1) is True   # OR: one process's flag reaches all
assert runtime.any_flag(False) is False
assert runtime.any_flags([pid == 0, False, True]) == [True, False, True]
assert runtime.max_value(3 + 4 * pid) == 7
# the gradient buckets: two dtypes, one tensor past the bucket size
ts = [torch.full((3,), float(pid + 1)), torch.full((2, 2), pid, dtype=torch.int64),
      torch.full((5,), 2.0 * pid)]
runtime.BUCKET_BYTES = 16
runtime.all_reduce_sum(ts)
assert ts[0].tolist() == [3.0] * 3 and ts[1].tolist() == [[1, 1], [1, 1]]
assert ts[2].tolist() == [2.0] * 5
try:
    runtime.barrier("left" if pid == 0 else "right")
    raise SystemExit("met at different barriers without an error")
except RuntimeError as e:
    assert "different barriers" in str(e)
print("RT_OK")
runtime.shutdown(0)
"""


def test_runtime_primitives_two_processes():
    outs = run_distributed_case(RUNTIME_CODE, nproc=2, env_extra=MP_ENV)
    assert all("RT_OK" in o for o in outs)


DIGEST_MISMATCH_CODE = """
import os
import numpy as np
pid = int(os.environ["MP_PID"])
from repro_torch.distributed import runtime
runtime.initialize(f"localhost:{os.environ['MP_PORT']}",
                   int(os.environ["MP_NPROC"]), pid)
tab = np.arange(6, dtype=np.int32)
if pid == 1:
    tab[3] += 1                      # one flipped entry on one process
try:
    runtime.assert_in_sync("plan", runtime.payload_digest({"t": tab}))
except RuntimeError as e:
    assert "digest mismatch" in str(e) and "plan" in str(e)
    print("RAISED")
runtime.shutdown(0)
"""


def test_divergent_digest_raises_on_every_process():
    outs = run_distributed_case(DIGEST_MISMATCH_CODE, nproc=2,
                                env_extra=MP_ENV)
    assert all("RAISED" in o for o in outs)


@pytest.mark.parametrize("case", ["plan", "empty", "meta_only", "mixed"])
def test_payload_digest_is_the_reference_digest(case):
    from repro.distributed import runtime as jrt
    from repro_torch.distributed import runtime as trt
    rng = np.random.default_rng(1)
    arrays, meta = {
        "plan": ({"col_idx": rng.integers(0, 9, (2, 4, 3)).astype(np.int32),
                  "nvalid": np.full((2, 4), 3, np.int32)}, {"block": 16}),
        "empty": ({}, None),
        "meta_only": (None, {"block": 64, "halo": [1, 2]}),
        "mixed": ({"b": np.full(5, 3.5), "a": np.arange(7, dtype=np.uint8),
                   "z": np.zeros((0, 3), np.float32)},
                  {"note": "hi", "k": [1, 2.5]}),
    }[case]
    assert trt.payload_digest(arrays, meta) == jrt.payload_digest(arrays,
                                                                  meta)


def test_single_process_helpers_are_identities(monkeypatch):
    from repro_torch.distributed import runtime
    for k in (runtime.ENV_COORDINATOR, runtime.ENV_NUM_PROCESSES,
              runtime.ENV_PROCESS_ID):
        monkeypatch.delenv(k, raising=False)
    assert runtime.initialize() is False and not runtime.is_initialized()
    assert (runtime.process_count(), runtime.process_index()) == (1, 0)
    arrays = {"a": np.arange(3)}
    assert runtime.broadcast_arrays(arrays, {"m": 1}) == (arrays, {"m": 1})
    assert runtime.host_allgather(np.asarray([4])).tolist() == [[4]]
    assert runtime.any_flag(True) and runtime.any_flags([0, 1]) == [False,
                                                                     True]
    assert runtime.max_value(5) == 5
    runtime.barrier("x")
    runtime.assert_in_sync("x", "00")
    ts = [torch.ones(2)]
    assert runtime.all_reduce_sum(ts)[0].tolist() == [1.0, 1.0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runtime.local_device(0)


def test_mesh_of_ranks(monkeypatch):
    from repro_torch.distributed import runtime
    from repro_torch.launch.mesh import (Mesh, make_distributed_mesh,
                                         make_host_mesh, make_mesh,
                                         make_seq_mesh)
    m = Mesh(np.arange(8).reshape(2, 2, 2), ("pod", "seq", "data"))
    assert m.shape == {"pod": 2, "seq": 2, "data": 2} and m.size == 8
    assert m.coords(5) == {"pod": 1, "seq": 0, "data": 1}
    assert m.line("seq", 5) == [5, 7] and m.line("data", 5) == [4, 5]
    assert m.line(("pod", "data"), 5) == [0, 1, 4, 5]
    assert m.flat_index(("pod", "data"), 5) == 3
    assert m.axis_size(("pod", "data")) == 4 and m.axis_size(None) == 1
    with pytest.raises(RuntimeError, match="no process groups"):
        m.group("seq", 0)
    # one process: the reference's axis names at size 1
    assert make_distributed_mesh().shape == {"pod": 1, "data": 1, "model": 1}
    assert make_host_mesh().shape == {"data": 1, "model": 1}
    assert make_mesh((1, 1), ("seq", "data")).size == 1
    # a 'model' axis builds (tensor parallelism, items 12b.2 and 12b.2b),
    # and so does 'seq' together with 'model' (12b.2c): the reference's
    # (seq, data, model) mesh, model ranks adjacent
    assert make_mesh((1, 2), ("data", "model")).shape == {"data": 1,
                                                          "model": 2}
    m = make_seq_mesh(2, 1, model=2)
    assert m.shape == {"seq": 2, "data": 1, "model": 2}
    assert m.line("model", 2) == [2, 3] and m.line("seq", 1) == [1, 3]
    m = make_mesh((2, 1, 2), ("seq", "data", "model"))
    assert m.coords(3) == {"seq": 1, "data": 0, "model": 1}
    # its groups: every axis, the plane of every axis but 'model' (the
    # loss and gradient sums), the whole mesh
    assert (("seq", "data") in m._group_keys()
            and ("seq", "data", "model") in m._group_keys())
    with pytest.raises(ValueError, match="divide"):
        make_distributed_mesh(seq=2)
    # a job of 4 processes (the groups wait for a joined job)
    monkeypatch.setattr(runtime, "process_count", lambda: 4)
    assert make_distributed_mesh(model=2).shape == {"pod": 2, "data": 1,
                                                    "model": 2}
    m = make_distributed_mesh(model=2, data=2)
    assert m.line("model", 2) == [2, 3] and m.line("data", 2) == [0, 2]


def test_batch_shards_and_batcher():
    """Each rank's shard of a global batch: the batch axis over 'pod' x
    'data', the sequence over 'seq'; the batcher prefetches and surfaces an
    error at next()."""
    from repro_torch.data.pipeline import ShardedBatcher, host_shard
    from repro_torch.distributed.sharding import batch_spec, local_slices
    from repro_torch.launch.mesh import Mesh
    m = Mesh(np.arange(8).reshape(2, 2, 2), ("pod", "seq", "data"))
    assert batch_spec(m, 2) == (("pod", "data"), "seq")
    x = np.arange(8 * 6).reshape(8, 6)
    shards = {r: x[local_slices(m, batch_spec(m, 2), x.shape, r)]
              for r in range(8)}
    assert shards[0].tolist() == x[0:2, 0:3].tolist()
    assert shards[5].tolist() == x[6:8, 0:3].tolist()      # pod 1, data 1
    assert shards[7].tolist() == x[6:8, 3:6].tolist()      # seq 1
    got = np.concatenate([np.concatenate([shards[m.devices[p, s, d]]
                                          for s in range(2)], axis=1)
                          for p in range(2) for d in range(2)])
    np.testing.assert_array_equal(got, x)
    assert host_shard(None, {"t": x})["t"].shape == (8, 6)

    it = ShardedBatcher(iter([{"t": np.full((2, 3), i)} for i in range(4)]),
                        device="cpu")
    assert [int(b["t"][0, 0]) for b in it] == [0, 1, 2, 3]
    assert all(b["t"].device.type == "cpu" for b in
               ShardedBatcher(iter([{"t": x}]), mesh=m, device="cpu"))
    if not torch.cuda.is_available():      # the card by default, never the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedBatcher(iter([]))

    def bad():
        yield {"t": np.zeros(2)}
        raise ValueError("boom")
    it = ShardedBatcher(bad(), device="cpu")
    assert next(it)["t"].shape == (2,)
    with pytest.raises(ValueError, match="boom"):
        next(it)


@pytest.mark.parametrize("cards,local,world,want", [
    (1, None, 2, "gloo"),          # one host, two ranks sharing one card
    (2, None, 2, "nccl"),          # one host, a card for each rank
    (8, "8", 16, "nccl"),          # two hosts of 8 cards, 8 ranks each
    (8, "16", 16, "gloo"),         # 16 ranks on one host of 8 cards
    (0, None, 2, "gloo"),          # no card
])
def test_device_backend_counts_this_hosts_processes(monkeypatch, cards,
                                                    local, world, want):
    """NCCL when this host has a card for each of *its* processes (the
    world size of a job across hosts is not the host's)."""
    from repro_torch.distributed import runtime
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: True)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    assert runtime.device_backend(world) == want
