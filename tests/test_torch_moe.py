"""Port parity, the moe family: models/moe.py, the mixtral-8x7b and
arctic-480b configs, the family's forward and loss, and the sliding-window
ring engine of mixtral — the JAX package and the port on the same numpy
inputs and parameters, fp32 at 3e-5 and bf16 at 6e-2.

Also the reference's grouping limit: `moe_apply` reshapes its T tokens into
g = max(1, T // 1024) groups, which fails where g does not divide T; the
port refuses those lengths with a ValueError instead of serving them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
from repro.core.sparse_attention import build_sparsity_plan as j_plan
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JEngine
from repro.models import moe as jmoe
from repro.models.registry import build as jbuild
from repro_torch.convert import params_from_numpy
from repro_torch.core.sparse_attention import build_sparsity_plan as t_plan
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.launch.steps import causal_band_tables
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import build as tbuild
from torch_parity import FWD_TOL, assert_close, normal, params, to_torch


def moe_configs(arch, dtype="float32"):
    """(JAX cfg, port cfg) of a reduced moe arch; equal as dataclass
    dicts."""
    jc = jcfgs.get_config(arch).reduced().replace(dtype=dtype)
    tc = tcfgs.get_config(arch).reduced().replace(dtype=dtype)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert jc.family == "moe"
    return jc, tc


def test_full_size_configs_equal_the_reference():
    for arch in ("mixtral-8x7b", "arctic-480b"):
        assert dataclasses.asdict(jcfgs.get_config(arch)) == \
            dataclasses.asdict(tcfgs.get_config(arch))
    assert tcfgs.get_config("mixtral-8x7b").sliding_window == 4096
    assert tcfgs.get_config("arctic-480b").moe.dense_residual_ff == 7168


def _moe_params(jc, tc, seed=0):
    jp = jmoe.moe_init(jax.random.key(seed), jc, dtype=jnp.dtype(jc.dtype))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc,
                           device="cpu")
    return jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b"])
@pytest.mark.parametrize("B,S", [(2, 40), (1, 2048)])
def test_moe_apply_matches_reference(arch, dtype, B, S):
    """Output and both aux losses; (1, 2048) routes two dispatch groups
    with capacity drops, (2, 40) one group under the dropless floor."""
    jc, tc = moe_configs(arch, dtype)
    jp, tp = _moe_params(jc, tc)
    assert ("dense_residual" in tp) == (arch == "arctic-480b")
    x = normal(np.random.default_rng(S), (B, S, jc.d_model), dtype)
    want, jaux = jmoe.moe_apply(jc, jp, jnp.asarray(x))
    got, taux = tmoe.moe_apply(tc, tp, to_torch(x))
    assert got.dtype == to_torch(x).dtype
    assert_close(got, want, FWD_TOL[dtype], "moe output")
    for k in ("lb_loss", "z_loss"):
        assert_close(taux[k], jaux[k], 3e-5 * max(1.0, abs(float(jaux[k]))),
                     k)


def test_moe_grouping_refusal_matches_the_reference():
    """At T = 3200 the reference's reshape fails (g = 3 does not divide
    3200) and the port raises a ValueError naming the grouping; at T = 3072
    (g = 3) and T = 4224 (g = 4) both run and agree."""
    jc, tc = moe_configs("mixtral-8x7b")
    jp, tp = _moe_params(jc, tc)
    rng = np.random.default_rng(7)
    x = normal(rng, (1, 3200, jc.d_model))
    with pytest.raises(TypeError, match="reshape"):
        jmoe.moe_apply(jc, jp, jnp.asarray(x))
    with pytest.raises(ValueError, match="dispatch groups"):
        tmoe.moe_apply(tc, tp, to_torch(x))
    for T in (3072, 4224):
        x = normal(rng, (1, T, jc.d_model))
        want, jaux = jmoe.moe_apply(jc, jp, jnp.asarray(x))
        got, taux = tmoe.moe_apply(tc, tp, to_torch(x))
        assert_close(got, want, FWD_TOL["float32"], f"T={T}")
        assert_close(taux["z_loss"], jaux["z_loss"], 3e-5, f"T={T}")


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b"])
def test_params_from_numpy_carries_the_moe_subtree(arch):
    """Every leaf of a bf16 moe model crosses bit for bit, with the
    reference's keys and shapes."""
    jc, tc = moe_configs(arch, "bfloat16")
    jp = jbuild(jc).init(jax.random.key(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc,
                           device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(list(tp.parameters()))
    for path, leaf in flat:
        t = tp
        for key in path:
            t = t[key.key]
        a = np.asarray(leaf)
        assert tuple(t.shape) == a.shape and str(t.dtype)[6:] == a.dtype.name
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
            t = t.detach().view(torch.int16).numpy().view(np.uint16)
        else:
            t = t.detach().numpy()
        assert np.array_equal(t, a), path
    ex = tp["layers"]["moe"]["experts"]["w_in"]
    assert ex.shape == (jc.num_layers, jc.moe.num_experts, jc.d_model,
                        jc.d_ff)


def test_mixtral_forward_and_loss_match_reference():
    """fp32. In bf16 the two frameworks' attention rounds differently, and
    a token whose top-2 experts nearly tie can route to other experts: one
    run read 6 of 24,576 logits past 6e-2 (0.0847), while moe_apply itself
    holds 6e-2 in bf16 on equal inputs (above)."""
    dtype = "float32"
    jc, tc = moe_configs("mixtral-8x7b", dtype)
    jp, tp = params(jc, tc)
    rng = np.random.default_rng(3)
    raw = rng.integers(0, jc.vocab_size, size=(2, 97)).astype(np.int32)
    jb = {"tokens": jnp.asarray(raw[:, :-1]), "labels": jnp.asarray(raw[:, 1:])}
    tb = {"tokens": to_torch(raw[:, :-1]).long(),
          "labels": to_torch(raw[:, 1:]).long()}
    jl, jaux = jbuild(jc).loss(jp, jb)
    tl, taux = tbuild(tc).loss(tp, tb)
    (jlogits, _), (tlogits, _) = (jbuild(jc).forward(jp, jb),
                                  tbuild(tc).forward(tp, tb))
    tol = FWD_TOL[dtype]
    assert_close(tlogits, jlogits, tol, "logits")
    assert_close(tl, jl, tol, "loss")
    for k in ("lb_loss", "z_loss"):
        assert float(taux[k]) > 0
        assert_close(taux[k], jaux[k], tol, k)
    # per-layer remat carries the aux losses out of the checkpointed layer
    rl, raux = tbuild(tc.replace(remat=True)).loss(tp, tb)
    assert torch.equal(rl, tl)
    for k in ("lb_loss", "z_loss"):
        assert torch.equal(raux[k], taux[k])


def _ring_plan(jc, nrb, block, seed=0):
    """Stacked causal tables (random band widths) of nrb row blocks."""
    rng = np.random.default_rng(seed)
    t = causal_band_tables(jc.num_layers, nrb,
                           width=int(rng.integers(2, nrb)))
    return j_plan(t["col_idx"], t["nvalid"], block), \
        t_plan(t["col_idx"], t["nvalid"], block)


@pytest.mark.parametrize("paged,sparse", [(True, False), (False, False),
                                          (True, True), (False, True)])
def test_sliding_window_ring_engine_matches_reference(paged, sparse):
    """tests/test_serve.py's ring engine, ported as a parity test: a
    70-token prompt over a 64-slot ring (the window) gives the reference
    engine's tokens, paged and contiguous, dense and through a plan."""
    jc, tc = moe_configs("mixtral-8x7b")
    jp, tp = params(jc, tc)
    prompt = np.asarray(jax.random.randint(jax.random.key(2), (70,), 0,
                                           jc.vocab_size), np.int32)
    jspion = tspion = None
    if sparse:
        jspion, tspion = _ring_plan(jc, 96 // 16, 16)
    je = JEngine(jc, jp, slots=2, max_len=jc.sliding_window, paged=paged,
                 spion=jspion)
    te = ServeEngine(tc, tp, slots=2, max_len=tc.sliding_window,
                     paged=paged, spion=tspion, device="cpu")
    assert not te.share_prefix
    jr = JRequest(rid=0, prompt=prompt, max_new=4)
    tr = Request(rid=0, prompt=prompt.copy(), max_new=4)
    je.run([jr])
    te.run([tr])
    assert tr.out == jr.out, (tr.out, jr.out)
    n = tc.sliding_window
    for got, want in zip(te.slot_kv(0, n), je.slot_kv(0, n)):
        assert_close(got, want, 3e-5, "ring cache")
