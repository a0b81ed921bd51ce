"""Port parity, the training loop: the JAX package's Trainer and the port's
side by side on the CPU, from the same masters and the same data_fn(step),
at reduced size in fp32. Unpinned, they reach the sparse phase at the same
epoch. With the plan pinned (the port's capture replaced by the pooled
arrays the JAX trainer captured, so both flood fills see identical input),
their plans are equal and their losses track each other through the
sparse phase, once through the gather and once through kernel="fused"
(the JAX package's Pallas kernels in interpret mode against the port's
plain versions). A sparse-phase checkpoint of either trainer resumes in the
other, a resumed port run is the uninterrupted one bit for bit, a NaN
rollback takes the same course in both, and an I/O error mid-step is
retried from the last checkpoint only."""
import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.core.spion import plan_digest as j_digest
from repro.launch.train import Trainer as JTrainer
from repro_torch.convert import params_from_numpy
from repro_torch.core.spion import plan_digest as t_digest
from repro_torch.launch.train import Trainer as TTrainer
from torch_parity import lra_configs

S = 128
STEPS_PER_EPOCH = 2


def _data_fn(step):
    rng = np.random.default_rng([3, step])
    toks = rng.integers(0, 128, size=(2, S + 1)).astype(np.int32)
    toks[:, 1::2] = toks[:, ::2][:, : toks[:, 1::2].shape[1]]  # some structure
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _trainers(kernel, *, max_dense=3, transition_tol=0.05):
    jc, tc = lra_configs("float32")
    jc, tc = (c.replace(spion=dataclasses.replace(
        c.spion, min_dense_epochs=1, max_dense_epochs=max_dense,
        transition_tol=transition_tol, kernel=kernel)) for c in (jc, tc))
    kw = dict(seq_len=S, batch=2, lr=0.05, total_steps=100,
              steps_per_epoch=STEPS_PER_EPOCH, data_fn=_data_fn)
    jt = JTrainer(jc, sentinel=False, **kw)
    masters = jax.tree_util.tree_map(np.asarray, jt.params)
    tt = TTrainer(tc, params=params_from_numpy(masters, tc, device="cpu"),
                  device="cpu", **kw)
    captured = []
    inner = jt.spion_ctl.observe_epoch

    def observe(state, pooled, frob):
        captured.append((np.array(pooled), np.array(frob)))
        return inner(state, pooled, frob)
    jt.spion_ctl.observe_epoch = observe
    return jt, tt, captured


def _quiet(*_a, **_k):
    pass


def test_trainers_reach_the_sparse_phase_at_the_same_epoch():
    """Each trainer with its own capture: the same Frobenius histories (to
    rounding), the transition at the same epoch by the Alg. 2 criterion
    (the max_dense cap is out of reach) and the same dense losses."""
    jt, tt, captured = _trainers("jnp", max_dense=6, transition_tol=1e-2)
    jl = jt.train(4 * STEPS_PER_EPOCH, log_every=100, log=_quiet)
    tl = tt.train(4 * STEPS_PER_EPOCH, log_every=100, log=_quiet)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    js, ts = jt.spion_state, tt.spion_state
    assert js.phase == "sparse", "the reference did not reach the sparse phase"
    assert (ts.phase, ts.epoch) == (js.phase, js.epoch)
    assert len(js.frob_hist) < 6      # the criterion, not the cap
    for a, b in zip(ts.frob_hist, js.frob_hist):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    np.testing.assert_allclose(ts.dist_hist, js.dist_hist, rtol=1e-3,
                               atol=1e-7)


@pytest.mark.parametrize("kernel", ["jnp", "fused"])
def test_pinned_plan_sparse_losses_track(kernel):
    """The port's capture returns the JAX trainer's captured arrays, so the
    transition epoch and the plan are the reference's bit for bit; the
    sparse-phase losses then track the reference's."""
    jt, tt, captured = _trainers(kernel)
    steps = 5 * STEPS_PER_EPOCH
    jl = jt.train(steps, log_every=100, log=_quiet)
    assert jt.spion_state.phase == "sparse"
    pinned = iter(captured)
    tt.capture = lambda batch: tuple(torch.as_tensor(a) for a in next(pinned))
    tl = tt.train(steps, log_every=100, log=_quiet)
    js, ts = jt.spion_state, tt.spion_state
    assert (ts.phase, ts.epoch) == (js.phase, js.epoch)
    for k in ("col_idx", "nvalid", "row_idx", "nvalid_t"):
        np.testing.assert_array_equal(np.asarray(ts.tables[k]),
                                      np.asarray(js.tables[k]), err_msg=k)
    assert ts.plan_stats == js.plan_stats and ts.density < 1
    sparse_from = 3 * STEPS_PER_EPOCH          # max_dense_epochs = 3
    assert len(tl) == steps and np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl[:sparse_from], jl[:sparse_from], rtol=1e-5)
    np.testing.assert_allclose(tl[sparse_from:], jl[sparse_from:], rtol=1e-4)


# -- checkpoints across the two packages ----------------------------------------

def _state_np(tr):
    """{key path: numpy array} of a trainer's params and opt state, JAX or
    port, in the checkpoint's leaf order."""
    from repro_torch.checkpoint.manager import tree_flatten
    if isinstance(tr, TTrainer):
        return {p: v.detach().cpu().numpy().copy()
                for p, v in tree_flatten(tr._state_tree())}
    flat = jax.tree_util.tree_flatten_with_path(
        {"params": tr.params, "opt": tr.opt})[0]
    return {tuple(k.key for k in p): np.array(v) for p, v in flat}


def _assert_same_state(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))


def _digest(tr):
    st = tr.spion_state
    fn = t_digest if isinstance(tr, TTrainer) else j_digest
    return fn(st.table_arrays(), st.tables["block"])


def _copy_step(src, dst, step):
    """A checkpoint directory holding `src`'s step `step` alone."""
    name = f"step_{step:09d}"
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    return str(dst)


SAVE_AT = 4 * STEPS_PER_EPOCH      # two sparse steps after the transition


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sparse_checkpoint_resumes_across_packages(direction, tmp_path):
    """One package's Trainer trains into the sparse phase and saves; the
    other's restores it with maybe_resume(): step, data offset, phase and
    plan digest equal, masters, moments and count bitwise; the continued
    sparse losses track the writer's own continuation (rtol 1e-4, the
    sparse tolerance of this file), both through kernel="fused"."""
    jt, tt, _ = _trainers("fused")
    d = str(tmp_path / "w")
    writer = jt if direction == "jax_to_port" else tt
    kw = dict(seq_len=S, batch=2, lr=0.05, total_steps=100,
              steps_per_epoch=STEPS_PER_EPOCH, data_fn=_data_fn)
    if writer is jt:
        writer = JTrainer(jt.cfg, sentinel=False, ckpt_dir=d, **kw)
        writer.params = jt.params
        writer.opt = jt.opt
    else:
        writer = TTrainer(tt.cfg, sentinel=False, ckpt_dir=d, device="cpu",
                          params=tt.params, **kw)
    writer.train(SAVE_AT, ckpt_every=SAVE_AT, log_every=100, log=_quiet)
    assert writer.spion_state.phase == "sparse"
    saved, digest = _state_np(writer), _digest(writer)
    want = writer.train(3, ckpt_every=0, log_every=100, log=_quiet)

    d2 = _copy_step(d, tmp_path / "r", SAVE_AT)
    if direction == "jax_to_port":
        reader = TTrainer(tt.cfg, sentinel=False, ckpt_dir=d2, device="cpu",
                          **kw)
    else:
        reader = JTrainer(jt.cfg, sentinel=False, ckpt_dir=d2, **kw)
    assert reader.maybe_resume()
    assert (reader.step, reader.data_offset, reader.spion_state.phase) == \
        (SAVE_AT, 0, "sparse")
    assert _digest(reader) == digest
    assert reader.spion_state.epoch == 4
    _assert_same_state(_state_np(reader), saved)
    got = reader.train(3, ckpt_every=0, log_every=100, log=_quiet)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_port_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """On the CPU a saved-and-resumed port run is the uninterrupted run, bit
    for bit: losses and the final state."""
    _, tt, _ = _trainers("fused")
    d = str(tmp_path / "a")
    kw = dict(seq_len=S, batch=2, lr=0.05, total_steps=100,
              steps_per_epoch=STEPS_PER_EPOCH, data_fn=_data_fn,
              device="cpu")
    a = TTrainer(tt.cfg, ckpt_dir=d, params=tt.params, **kw)
    a.train(SAVE_AT, ckpt_every=SAVE_AT, log_every=100, log=_quiet)
    want = a.train(4, ckpt_every=0, log_every=100, log=_quiet)
    b = TTrainer(tt.cfg, ckpt_dir=_copy_step(d, tmp_path / "b", SAVE_AT),
                 **kw)
    assert b.maybe_resume() and b.step == SAVE_AT
    got = b.train(4, ckpt_every=0, log_every=100, log=_quiet)
    assert got == want
    _assert_same_state(_state_np(b), _state_np(a))
    assert b._exec_tables is b.spion_state.tables   # rebuilt from the plan


def test_nan_rollback_matches_the_reference(tmp_path):
    """ChaosMonkey(nan_step=14) with saves every 5 steps, as in
    tests/test_selfheal.py: both trainers roll back once from step 14 to the
    pinned good step 10, quarantine the poisoned step-15 save, skip the
    window [10, 14], and their stitched histories track (rtol 1e-5 dense,
    1e-4 sparse)."""
    from repro.distributed.chaos import ChaosMonkey as JChaos
    from repro.distributed.fault import DivergenceSentinel as JSentinel
    from repro_torch.distributed.chaos import ChaosMonkey as TChaos
    from repro_torch.distributed.fault import DivergenceSentinel as TSentinel
    jt0, tt0, captured = _trainers("fused")
    kw = dict(seq_len=S, batch=2, lr=0.05, total_steps=100,
              steps_per_epoch=STEPS_PER_EPOCH, data_fn=_data_fn)
    jt = JTrainer(jt0.cfg, ckpt_dir=str(tmp_path / "j"),
                  sentinel=JSentinel(spike=False), chaos=JChaos(nan_step=14),
                  **kw)
    jt.params, jt.opt = jt0.params, jt0.opt
    jt.spion_ctl.observe_epoch = jt0.spion_ctl.observe_epoch  # records
    tt = TTrainer(tt0.cfg, ckpt_dir=str(tmp_path / "t"), params=tt0.params,
                  sentinel=TSentinel(spike=False), chaos=TChaos(nan_step=14),
                  device="cpu", **kw)
    jt.train(20, ckpt_every=5, log_every=100, log=_quiet)
    pinned = iter(captured)        # the port flood-fills the same pooled maps
    tt.capture = lambda batch: tuple(torch.as_tensor(a) for a in next(pinned))
    tt.train(20, ckpt_every=5, log_every=100, log=_quiet)
    for tr, sub in ((jt, "j"), (tt, "t")):
        ev = [{k: e[k] for k in ("from_step", "to_step", "skip",
                                 "data_offset")}
              for e in tr.events if e["event"] == "rollback"]
        assert ev == [{"from_step": 14, "to_step": 10, "skip": 5,
                       "data_offset": 5}]
        assert (tr.rollback_count, tr.data_offset, tr.good_step, tr.step) \
            == (1, 5, 20, 20)
        assert (tmp_path / sub / "quarantined_step_000000015").exists()
        assert sorted(tr.loss_history) == list(range(20))
    js = [jt.loss_history[s] for s in range(20)]
    ts = [tt.loss_history[s] for s in range(20)]
    assert np.all(np.isfinite(ts))
    sparse_from = 3 * STEPS_PER_EPOCH
    np.testing.assert_allclose(ts[:sparse_from], js[:sparse_from], rtol=1e-5)
    np.testing.assert_allclose(ts[sparse_from:], js[sparse_from:], rtol=1e-4)
    assert _digest(tt) == _digest(jt)


def _io_trainer(tmp_path=None, fail_at=None):
    """A reduced spion-lra trainer on the CPU (dense phase) with step-indexed
    data whose fetches are recorded; with `fail_at`, the step that starts
    there first updates the state in place and then raises OSError, once."""
    fetched = []

    def data_fn(step):
        fetched.append(step)
        return _data_fn(step)

    tr = TTrainer(lra_configs("float32")[1], seq_len=S, batch=2,
                  steps_per_epoch=100, device="cpu", data_fn=data_fn,
                  ckpt_dir=None if tmp_path is None else str(tmp_path))
    tr.supervisor.sleep_fn = lambda d: None
    if fail_at is not None:
        inner, failed = tr._one_step, []

        def one_step(batch):
            out = inner(batch)
            if tr.step == fail_at + 1 and not failed:
                failed.append(1)
                raise OSError("the data volume went away mid-step")
            return out
        tr._one_step = one_step
    return tr, fetched


def test_trainer_retries_an_io_error_from_the_last_checkpoint(tmp_path):
    """The step that failed after changing the masters and moments in place
    is retried from the checkpoint of step 4, on step 4's batch fetched after
    the restore: the stitched losses equal an uninterrupted run's bitwise."""
    tr, fetched = _io_trainer(tmp_path, fail_at=5)
    tr.train(8, ckpt_every=2, log=_quiet)
    assert tr.supervisor.restarts == 1 and tr.step == 8
    assert fetched == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7]
    ref, _ = _io_trainer()
    ref.train(8, ckpt_every=0, log=_quiet)
    assert tr.loss_history == ref.loss_history


def test_trainer_without_a_checkpoint_reraises_an_io_error():
    """With nothing to restore, the in-place update of the failed step
    cannot be undone, so the OSError ends the run."""
    tr, fetched = _io_trainer(fail_at=5)
    with pytest.raises(OSError, match="went away"):
        tr.train(8, ckpt_every=2, log=_quiet)
    assert tr.supervisor.restarts == 1 and fetched == [0, 1, 2, 3, 4, 5]
