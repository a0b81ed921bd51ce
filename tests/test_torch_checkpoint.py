"""Port parity, checkpointing: the port's CheckpointManager against the JAX
package's, on the CPU. The port's msgpack subset writes msgpack's bytes;
its leaf order is jax.tree_util's; the JAX package's manager scenarios
(tests/test_substrates.py) hold for the port's manager; and each manager
restores the other's checkpoints bit for bit."""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.checkpoint import CheckpointManager as JManager
from repro.launch.train import Trainer as JTrainer
from repro.optim import adamw_init as j_adamw_init
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import msgpack_lite
from repro_torch.checkpoint.manager import tree_flatten, treedef_str
from repro_torch.launch.train import Trainer as TTrainer
from repro_torch.launch.train import nest
from torch_parity import configs, lra_configs, params as parity_params

# -- the msgpack subset ---------------------------------------------------------

_scalars = (st.none() | st.booleans()
            | st.integers(-(2 ** 63), 2 ** 64 - 1)
            | st.floats(allow_nan=False) | st.text() | st.binary())
_values = st.recursive(
    _scalars, lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(st.text(), inner, max_size=20), max_leaves=60)


@settings(max_examples=200, deadline=None)
@given(st.dictionaries(st.text(), _values, max_size=20))
def test_msgpack_subset_is_msgpack_bytes(obj):
    """Maps of the types a checkpoint's meta holds: the port writes the
    bytes msgpack.packb writes, and each side reads the other's."""
    raw = msgpack.packb(obj)
    assert msgpack_lite.packb(obj) == raw
    assert msgpack_lite.unpackb(raw) == msgpack.unpackb(raw)
    assert msgpack.unpackb(msgpack_lite.packb(obj)) == msgpack.unpackb(raw)


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_msgpack_subset_lengths_at_each_boundary(n):
    """Every size class of str, bin, array and map, and ints around each
    width's limits, as msgpack encodes them."""
    ints = [v + d for v in (0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                            2 ** 32, 2 ** 63, -32, -33, -128, -129, -32768,
                            -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63 + 1)
            for d in (-1, 0, 1) if -2 ** 63 <= v + d < 2 ** 64]
    obj = {"s": "x" * n, "b": b"\x01" * n, "l": list(range(min(n, 300))),
           "m": {str(i): i for i in range(min(n, 300))}, "ints": ints,
           "f": [0.0, -0.0, 1.5, float("inf"), -1e308], "t": True,
           "n": None, "u": "ü" * (n // 2)}
    if n > 300:
        obj["l"] = [None] * n
        obj["m"] = {f"k{i}": False for i in range(n)}
    raw = msgpack.packb(obj)
    assert msgpack_lite.packb(obj) == raw
    assert msgpack_lite.unpackb(raw) == msgpack.unpackb(raw)


def test_msgpack_subset_refuses_what_a_checkpoint_never_holds():
    with pytest.raises(TypeError):
        msgpack_lite.packb({"x": object()})
    with pytest.raises(OverflowError):
        msgpack_lite.packb(2 ** 64)
    with pytest.raises(ValueError, match="outside the subset"):
        msgpack_lite.unpackb(msgpack.packb(msgpack.ExtType(1, b"x")))
    with pytest.raises(ValueError, match="ends inside"):
        msgpack_lite.unpackb(msgpack.packb({"a": "bcd"})[:-1])


# -- the leaf order -------------------------------------------------------------

def _jax_paths(tree):
    return [tuple(k.key for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("family", ["encoder", "dense"])
def test_leaf_order_is_jax_tree_flatten_order(family):
    """The port's train state (spion-lra, and reduced qwen2-7b) flattens in
    the order of the JAX trainer's state, and its treedef string is JAX's."""
    jc, tc = lra_configs() if family == "encoder" else configs()
    jp, tp = parity_params(jc, tc)
    jm = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32)
                                if x.ndim >= 2 else x, jp)
    jstate = {"params": jm, "opt": j_adamw_init(jm)}
    tt = TTrainer(tc, seq_len=64, batch=1, params=tp, device="cpu")
    tstate = tt._state_tree()
    assert [p for p, _ in tree_flatten(tstate)] == _jax_paths(jstate)
    assert treedef_str(tstate) == str(jax.tree_util.tree_structure(jstate))
    for (path, leaf), want in zip(tree_flatten(tstate),
                                  jax.tree_util.tree_leaves(jstate)):
        assert tuple(leaf.shape) == np.shape(want), path


def test_leaf_order_follows_key_tuples_not_dotted_names():
    """'a-b' sorts before 'a.y' as a dotted name but after ('a', 'y') as a
    key tuple; the port follows JAX's key tuples."""
    tree = {"p": {"a-b": np.zeros(1), "a": {"y": np.zeros(2)},
                  "b": {"x": np.zeros(3)}}, "c": None}
    got = [p for p, _ in tree_flatten(tree)]
    assert got == _jax_paths(tree) == [("p", "a", "y"), ("p", "a-b"),
                                       ("p", "b", "x")]
    assert sorted(".".join(p) for p in got) != [".".join(p) for p in got]
    assert treedef_str(tree) == str(jax.tree_util.tree_structure(tree))
    named = {"a-b": 1, "a.y": 2, "b.x": 3}
    assert nest(named) == {"a-b": 1, "a": {"y": 2}, "b": {"x": 3}}


# -- the JAX package's manager scenarios, on the port's manager ---------------

def _tree():
    return {"params": {"w": torch.arange(6.0).reshape(2, 3)},
            "opt": {"count": torch.tensor(7, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    tree = _tree()
    mgr.save(10, tree, extra={"phase": "sparse"},
             extra_arrays={"spion_col_idx": np.arange(4, dtype=np.int32)})
    got, step, extra = mgr.restore(target=tree)
    assert step == 10 and extra["phase"] == "sparse"
    assert torch.equal(got["params"]["w"], tree["params"]["w"])
    assert got["opt"]["count"].dtype == torch.int32
    assert got["opt"]["count"].shape == () and int(got["opt"]["count"]) == 7
    np.testing.assert_array_equal(extra["_arrays"]["spion_col_idx"],
                                  np.arange(4))


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_ignores_uncommitted(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(1, _tree())
    os.makedirs(tmp_path / "step_000000099")     # no DONE marker
    assert mgr.latest_step() == 1


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    mgr.save(5, _tree())
    mgr.wait()
    assert mgr.latest_step() == 5


def test_checkpoint_restore_waits_for_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    tree = _tree()
    mgr.save(5, tree)
    assert mgr.latest_step() == 5          # no explicit wait() in between
    mgr.save(6, tree)
    got, step, _ = mgr.restore(target=tree)
    assert step == 6 and torch.equal(got["params"]["w"], tree["params"]["w"])


def test_checkpoint_async_write_failure_surfaces(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(mgr, "_write", boom)
    mgr.save(1, _tree())
    with pytest.raises(RuntimeError, match="background write failed"):
        mgr.wait()
    monkeypatch.undo()            # consumed once surfaced; still usable
    mgr.save(2, _tree())
    mgr.wait()
    assert mgr.latest_step() == 2
    monkeypatch.setattr(mgr, "_write", boom)
    mgr.save(3, _tree())
    with pytest.raises(RuntimeError, match="background write failed"):
        mgr.save(4, _tree())      # surfacing via save()'s leading wait()


def test_checkpoint_crash_mid_save_recovery(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    tree = _tree()
    mgr.save(1, tree)
    orphan = tmp_path / ".tmp_step_000000002"
    os.makedirs(orphan)
    np.savez(orphan / "arrays.npz", leaf_0=np.zeros(3))
    assert mgr.latest_step() == 1
    _, step, _ = mgr.restore(target=tree)
    assert step == 1
    mgr.save(3, tree)
    assert not orphan.exists()
    assert mgr.all_steps() == [1, 3]


def test_checkpoint_gc_never_removes_pinned_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    mgr.save(1, _tree())
    mgr.pin(1)
    for s in (2, 3, 4, 5):
        mgr.save(s, _tree())
    assert mgr.all_steps() == [1, 4, 5]
    assert mgr.pinned() == [1]
    mgr.unpin(1)
    mgr.save(6, _tree())
    assert mgr.all_steps() == [5, 6]


def test_checkpoint_reap_orphans_skips_pinned(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(1, _tree())
    pinned = tmp_path / ".tmp_step_000000007"
    stray = tmp_path / ".tmp_step_000000008"
    os.makedirs(pinned)
    os.makedirs(stray)
    mgr.pin(7)
    mgr.save(2, _tree())
    assert pinned.exists() and not stray.exists()


def test_checkpoint_quarantine_after(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=0, async_save=False)
    tree = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    mgr.quarantine_after(2)
    assert mgr.all_steps() == [1, 2] and mgr.latest_step() == 2
    _, step, _ = mgr.restore(target=tree)
    assert step == 2
    assert (tmp_path / "quarantined_step_000000003").exists()
    assert (tmp_path / "quarantined_step_000000004").exists()
    mgr.save(5, tree)
    mgr.quarantine_after(2)
    assert mgr.all_steps() == [1, 2]


def test_multiprocess_checkpoint_raises_naming_the_roadmap_item(tmp_path,
                                                                monkeypatch):
    """Multi-process checkpoints are ported (process 0 writes, every
    process reads, the commit barrier in wait()): multiprocess=True no
    longer raises. Process 0 writes and commits; another process copies
    nothing to the host and writes nothing, and reads what process 0
    wrote. (The barriers across real processes: test_torch_multiprocess.)"""
    from repro_torch.distributed import runtime
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    mgr = CheckpointManager(str(tmp_path), multiprocess=True)
    assert mgr.multiprocess and mgr.is_writer
    mgr.save(3, tree)
    assert mgr._pending_commit
    mgr.wait()                       # the (one-process) commit barrier
    assert mgr.all_steps() == [3] and not mgr._pending_commit
    monkeypatch.setattr(runtime, "is_coordinator", lambda: False)
    other = CheckpointManager(str(tmp_path), multiprocess=True)
    assert not other.is_writer
    other.save(4, {"w": None})       # a non-writer never reads its tree
    other.quarantine_after(3)
    assert other.all_steps() == [3]
    got, step, _ = other.restore(target=tree)
    assert step == 3 and torch.equal(got["w"], tree["w"])


def test_restore_refuses_a_mismatched_leaf(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _tree())
    wrong = _tree()
    wrong["params"]["w"] = wrong["params"]["w"].double()
    with pytest.raises(ValueError, match="dtype"):
        mgr.restore(target=wrong)
    wrong = _tree()
    wrong["params"]["w"] = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(target=wrong)
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(target={"params": _tree()["params"]})


def test_async_save_is_not_torn_by_an_in_place_update(tmp_path):
    """The port updates its parameters in place; an async save of CPU
    tensors followed at once by an update still restores the saved
    values (the manager copies every leaf before the writer starts)."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    w = torch.arange(4_000_000, dtype=torch.float32)
    want = w.clone()
    tree = {"params": {"w": w}, "opt": {"count": torch.tensor(1)}}
    mgr.save(1, tree)
    w.fill_(-1.0)                 # the next step's p.copy_, before the write
    got, _, _ = mgr.restore(target=tree)
    assert torch.equal(got["params"]["w"], want)


# -- both directions, bit for bit -----------------------------------------------

def _jax_state(seed=0):
    """A JAX train state with fp32, int32 and bf16 leaves, and the extra
    the trainer writes."""
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.standard_normal((3, 5), np.float32))
    b = jnp.asarray(rng.standard_normal((5,), np.float32), jnp.bfloat16)
    params = {"layers": {"w": w, "b-bias": b}, "embed": {"w": w + 1}}
    opt = {"count": jnp.int32(9), "mu": jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32) * 0.5, params),
        "nu": jax.tree_util.tree_map(lambda x: x.astype(jnp.float32) ** 2,
                                     params)}
    extra = {"spion": {"phase": "sparse", "epoch": 3,
                       "tables_meta": {"block": 32}}, "step": 9,
             "data_offset": 2}
    arrays = {"spion_col_idx": rng.integers(0, 4, (2, 4, 3), np.int32),
              "spion_nvalid": rng.integers(0, 4, (2, 4), np.int32)}
    return {"params": params, "opt": opt}, extra, arrays


def _as_port(tree):
    def conv(x):
        a = np.asarray(x)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return jax.tree_util.tree_map(conv, tree)


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 and \
        a.dtype.kind in "Vf" else a


def test_jax_checkpoint_restores_bitwise_into_the_port(tmp_path):
    jstate, extra, arrays = _jax_state()
    jm = JManager(str(tmp_path / "j"), async_save=False)
    jm.save(9, jstate, extra=extra, extra_arrays=arrays)
    target = jax.tree_util.tree_map(torch.zeros_like, _as_port(jstate))
    got, step, gx = CheckpointManager(str(tmp_path / "j")).restore(
        target=target)
    assert step == 9 and {k: v for k, v in gx.items() if k != "_arrays"} \
        == extra
    for k, v in arrays.items():
        np.testing.assert_array_equal(gx["_arrays"][k], v)
    assert got["params"]["layers"]["b-bias"].dtype == torch.bfloat16
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    # the port writes the same meta bytes and the same leaves
    tm = CheckpointManager(str(tmp_path / "t"), async_save=False)
    tm.save(9, _as_port(jstate), extra=extra, extra_arrays=arrays)
    jdir, tdir = (tmp_path / d / "step_000000009" for d in ("j", "t"))
    assert (tdir / "meta.msgpack").read_bytes() == \
        (jdir / "meta.msgpack").read_bytes()
    with np.load(jdir / "arrays.npz") as a, np.load(tdir / "arrays.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype.str[1:] == b[k].dtype.str[1:]
            assert a[k].tobytes() == b[k].tobytes(), k


def test_port_checkpoint_restores_bitwise_through_the_jax_manager(tmp_path):
    jstate, extra, arrays = _jax_state(seed=1)
    tm = CheckpointManager(str(tmp_path), async_save=True)
    tm.save(9, _as_port(jstate), extra=extra, extra_arrays=arrays)
    tm.wait()
    got, step, gx = JManager(str(tmp_path)).restore(target=jstate)
    assert step == 9 and gx["data_offset"] == 2
    for k, v in arrays.items():
        np.testing.assert_array_equal(gx["_arrays"][k], v)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    b = got["params"]["layers"]["b-bias"]            # a |V2 array
    assert np.asarray(b).view(ml_dtypes.bfloat16).tobytes() == \
        np.asarray(jstate["params"]["layers"]["b-bias"]).tobytes()


def test_port_trainer_checkpoint_restores_into_a_jax_target(tmp_path):
    """The port trainer's own save (masters, moments, count, plan-less
    extra) restores through the JAX manager with the JAX trainer's state
    as the target."""
    jc, tc = lra_configs()
    jp, tp = parity_params(jc, tc)
    tt = TTrainer(tc, seq_len=64, batch=1, params=tp, device="cpu",
                  ckpt_dir=str(tmp_path))
    with torch.no_grad():
        for i, t in enumerate(tt.opt["mu"].values()):
            t.add_(i + 0.25)
    tt.opt["count"] = torch.tensor(5, dtype=torch.int32)
    tt.step = 5
    tt.save()
    tt.ckpt.wait()
    jt = JTrainer(jc, seq_len=64, batch=1, sentinel=False)
    got, step, extra = JManager(str(tmp_path)).restore(
        target={"params": jt.params, "opt": jt.opt})
    assert step == 5 and extra["spion"]["phase"] == "dense"
    assert int(got["opt"]["count"]) == 5
    tleaves = [leaf for _, leaf in tree_flatten(tt._state_tree())]
    for g, t in zip(jax.tree_util.tree_leaves(got), tleaves):
        np.testing.assert_array_equal(np.asarray(g), _bits(t.detach()))
