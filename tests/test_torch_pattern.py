"""Port parity, host-side planning: the flood-fill pattern generator, the
SPION controller's transition and plan, its state's round trip, and the
seeded data generators, each against the JAX package's module of the same
name. All of it is numpy on the host, so it is held bit for bit."""
import dataclasses
import json

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core import pattern as jpat
from repro.core.spion import SpionController as JController
from repro.core.spion import SpionState as JState
from repro.core.spion import plan_digest as j_digest
from repro.data import listops as jlistops
from repro.data import synthetic as jsynth
from repro_torch.configs import get_config as tget_config
from repro_torch.core import pattern as tpat
from repro_torch.core.spion import SpionController as TController
from repro_torch.core.spion import SpionState as TState
from repro_torch.core.spion import plan_digest as t_digest
from repro_torch.data import listops as tlistops
from repro_torch.data import synthetic as tsynth


def _np(tables):
    return {k: np.asarray(v) for k, v in tables.items() if k != "block"}


def _pooled(rng, Ly, n, ties=True):
    """Pooled conv maps with a strong diagonal band; with `ties` some
    entries repeat exactly, so the flood fill's `v == m` branch is taken
    with several neighbours."""
    a = rng.random((Ly, n, n)) * 0.1
    idx = np.arange(n)
    a[:, idx, idx] += 1.0
    a[:, idx[:-1], idx[1:]] += rng.random((Ly, n - 1)) * 0.8
    if ties:
        a[:, 2:, 0] = a[:, 1:-1, 0]
        a[:, ::3, ::3] = 0.5
    return a


@pytest.mark.parametrize("variant", ["cf", "c", "f"])
@pytest.mark.parametrize("causal", [False, True])
def test_generate_pattern_matches_reference(variant, causal):
    """From the full map (conv + pool inside) and from a pooled map, the
    block masks are bitwise equal; so are the Alg. 3 components and the
    fixed-pattern baselines."""
    rng = np.random.default_rng(0)
    L, B, F = 256, 16, 7
    a_s = rng.random((L, L)) ** 4
    kw = dict(variant=variant, conv_filter_size=F, block_size=B,
              alpha_quantile=0.9, causal=causal)
    want = jpat.generate_pattern(a_s, **kw)
    got = tpat.generate_pattern(a_s, **kw)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    pooled = _pooled(rng, 1, 16)[0]
    np.testing.assert_array_equal(
        tpat.generate_pattern(None, pooled=pooled, **kw),
        jpat.generate_pattern(None, pooled=pooled, **kw))
    filt = tpat.diagonal_filter(F)
    np.testing.assert_array_equal(filt, jpat.diagonal_filter(F))
    np.testing.assert_array_equal(tpat.diag_conv(a_s, filt),
                                  jpat.diag_conv(a_s, filt))
    np.testing.assert_array_equal(tpat.avg_pool(a_s, B),
                                  jpat.avg_pool(a_s, B))
    np.testing.assert_array_equal(tpat.upsample(want, B),
                                  jpat.upsample(want, B))
    np.testing.assert_array_equal(
        tpat.bigbird_pattern(16, seed=3, causal=causal),
        jpat.bigbird_pattern(16, seed=3, causal=causal))
    np.testing.assert_array_equal(tpat.window_pattern(16, causal=causal),
                                  jpat.window_pattern(16, causal=causal))
    assert tpat.density(got) == jpat.density(want)
    fl_t = tpat.flood_fill_iterative(pooled, np.zeros((16, 16), np.int8), 0.3)
    fl_j = jpat.flood_fill_recursive(pooled, 0, 0, np.zeros((16, 16),
                                                            np.int8), 0.3)
    assert fl_t[0, 0] == 0 and fl_j.sum() <= fl_t.sum()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("causal", [False, True])
def test_plan_is_bitwise_equal_for_the_same_pooled_input(seed, causal):
    """Both controllers' generate on identical pooled arrays: masks (through
    the tables), forward and transposed tables, kt_star, the halo and every
    other plan statistic, density, and the plan digest."""
    jcfg = jget_config("spion-lra").spion
    tcfg = tget_config("spion-lra").spion
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    pooled = _pooled(np.random.default_rng(seed), 4, 32)
    jc = JController(jcfg, causal=causal, seq_len=32 * jcfg.block_size)
    tc = TController(tcfg, causal=causal, seq_len=32 * tcfg.block_size)
    js = jc.generate(JState(), pooled)
    ts = tc.generate(TState(), pooled)
    assert ts.phase == js.phase == "sparse"
    want, got = _np(js.tables), _np(ts.tables)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ts.tables["block"] == js.tables["block"]
    assert ts.plan_stats == js.plan_stats
    assert ts.plan_stats["kt_star"] == got["row_idx"].shape[-1]
    assert ts.density == js.density and 0 < ts.density < 1
    assert t_digest(ts.table_arrays(), ts.tables["block"]) == \
        j_digest(js.table_arrays(), js.tables["block"])
    for l in range(4):
        np.testing.assert_array_equal(
            tpat.generate_pattern(None, pooled=pooled[l], variant=tcfg.variant,
                                  block_size=tcfg.block_size,
                                  alpha_quantile=tcfg.alpha_quantile,
                                  causal=causal),
            jpat.generate_pattern(None, pooled=pooled[l], variant=jcfg.variant,
                                  block_size=jcfg.block_size,
                                  alpha_quantile=jcfg.alpha_quantile,
                                  causal=causal))


@pytest.mark.parametrize("frob_scale,min_dense,max_dense",
                         [(1.0, 1, 8), (0.0, 2, 8), (5.0, 1, 3)])
def test_transition_at_the_same_epoch(frob_scale, min_dense, max_dense):
    """The same Frobenius sequence gives the transition at the same epoch
    (Eq. 2 distances, Alg. 2 line 10 criterion, the max_dense cap), the same
    histories, and then the same plan; epochs after it only count."""
    rng = np.random.default_rng(7)
    base = jget_config("spion-lra").spion
    jcfg = dataclasses.replace(base, min_dense_epochs=min_dense,
                               max_dense_epochs=max_dense)
    tcfg = dataclasses.replace(tget_config("spion-lra").spion,
                               min_dense_epochs=min_dense,
                               max_dense_epochs=max_dense)
    jc = JController(jcfg, causal=False, seq_len=1024)
    tc = TController(tcfg, causal=False, seq_len=1024)
    js, ts = JState(), TState()
    phases = []
    for epoch in range(10):
        pooled = _pooled(rng, 2, 16, ties=False)
        frob = 4.0 + frob_scale * rng.random(2) / (epoch + 1)
        js = jc.observe_epoch(js, pooled, frob)
        ts = tc.observe_epoch(ts, pooled, frob)
        assert (ts.phase, ts.epoch) == (js.phase, js.epoch)
        assert ts.dist_hist == js.dist_hist
        assert len(ts.frob_hist) == len(js.frob_hist)
        for a, b in zip(ts.frob_hist, js.frob_hist):
            np.testing.assert_array_equal(a, b)
        phases.append(ts.phase)
    assert "sparse" in phases and phases[0] == "dense"
    first = phases.index("sparse")
    assert first < max_dense
    for k, v in _np(js.tables).items():
        np.testing.assert_array_equal(_np(ts.tables)[k], v)


def test_state_round_trip_matches_reference():
    """to_py gives the reference's JSON for the same state, with and
    without the tables; from_py reads the reference's dicts back (tables
    inline, as binary arrays, or rebuilt from a plan-less col_idx /
    nvalid), and refuses the mismatched pairs the reference refuses."""
    jcfg = jget_config("spion-lra").spion
    pooled = _pooled(np.random.default_rng(3), 2, 16)
    js = JController(jcfg, causal=False, seq_len=1024).generate(JState(),
                                                                pooled)
    ts = TController(tget_config("spion-lra").spion, causal=False,
                     seq_len=1024).generate(TState(), pooled)
    js.frob_hist = ts.frob_hist = [np.array([1.0, 2.0])]
    js.dist_hist = ts.dist_hist = [0.5]
    for tables in (True, False):
        assert json.dumps(ts.to_py(tables), sort_keys=True) == \
            json.dumps(js.to_py(tables), sort_keys=True)
    arrays = js.table_arrays()
    for d, arr in ((js.to_py(True), None), (js.to_py(False), arrays)):
        back = TState.from_py(json.loads(json.dumps(d)), arr)
        assert back.phase == "sparse" and back.tables["block"] == 64
        for k, v in _np(js.tables).items():
            np.testing.assert_array_equal(_np(back.tables)[k], v)
    legacy = js.to_py(True)
    del legacy["tables"]["row_idx"], legacy["tables"]["nvalid_t"]
    back = TState.from_py(legacy)
    want = JState.from_py(legacy)
    for k, v in _np(want.tables).items():
        np.testing.assert_array_equal(_np(back.tables)[k], v)
    assert back.plan_stats == want.plan_stats
    with pytest.raises(ValueError, match="tables_meta"):
        TState.from_py(js.to_py(False), None)
    dense = JState().to_py()
    with pytest.raises(ValueError, match="neither"):
        TState.from_py(dense, arrays)
    assert TState.from_py(dense).tables is None


@pytest.mark.parametrize("seed", [0, 11])
def test_data_generators_are_bitwise_equal(seed):
    """ListOps and the synthetic streams from the same seed."""
    xs_t, ys_t = tlistops.make_listops_batch(np.random.default_rng(seed), 4,
                                             257, depth=5)
    xs_j, ys_j = jlistops.make_listops_batch(np.random.default_rng(seed), 4,
                                             257, depth=5)
    np.testing.assert_array_equal(xs_t, xs_j)
    np.testing.assert_array_equal(ys_t, ys_j)
    assert xs_t.dtype == xs_j.dtype and tlistops.VOCAB_SIZE == \
        jlistops.VOCAB_SIZE
    for structured in (True, False):
        it_t = tsynth.lm_batch_iterator(np.random.default_rng(seed), batch=3,
                                        seq_len=65, vocab=512,
                                        structured=structured)
        it_j = jsynth.lm_batch_iterator(np.random.default_rng(seed), batch=3,
                                        seq_len=65, vocab=512,
                                        structured=structured)
        for _ in range(3):
            bt, bj = next(it_t), next(it_j)
            assert sorted(bt) == sorted(bj) == ["labels", "tokens"]
            for k in bt:
                np.testing.assert_array_equal(bt[k], bj[k])
    for task in ("image", "retrieval"):
        got = tsynth.synthetic_task_batch(np.random.default_rng(seed), task,
                                          batch=3, seq_len=64)
        want = jsynth.synthetic_task_batch(np.random.default_rng(seed), task,
                                           batch=3, seq_len=64)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
