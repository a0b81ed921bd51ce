"""Port parity, the training loop: the JAX package's Trainer and the port's
side by side on the CPU, from the same masters and the same data_fn(step),
at reduced size in fp32. Unpinned, they reach the sparse phase at the same
epoch. With the plan pinned (the port's capture replaced by the pooled
arrays the JAX trainer captured, so both flood fills see identical input),
their plans are equal and their losses track each other through the
sparse phase, once through the gather and once through kernel="fused"
(the JAX package's Pallas kernels in interpret mode against the port's
plain versions)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.launch.train import Trainer as JTrainer
from repro_torch.convert import params_from_numpy
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
