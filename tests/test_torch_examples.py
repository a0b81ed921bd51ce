"""Port parity, the two examples with no counterpart before:
examples/quickstart_torch.py and examples/long_context_decode_torch.py.

  - The quickstart's `main` on the CPU, started from the JAX Trainer's
    initial masters (through convert.params_from_numpy) on the same seeded
    synthetic stream, reaches the sparse phase; its first 10 losses are
    within 1e-4 relative of the JAX Trainer's on the reference example's
    configuration, and the transition comes at the same epoch (the same
    number of dense epochs observed). Without --device it asks for a card.
  - The long-context decode example at reduced size: the recurrent state's
    bytes equal the JAX example's, one decode_step from equal state and
    parameters gives logits within 3e-5 of the JAX decode_step's in fp32
    (6e-2 in the example's bf16), and the state does not depend on the
    position.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one thread; TF32 off)

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
LOSS_RTOL = 1e-4
DECODE_TOL = {"float32": 3e-5, "bfloat16": 6e-2}
JAX_STEPS = 40       # past the transition: max_dense_epochs 4 of 10 steps


def example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(*_a, **_k):
    pass


def jax_quickstart_config():
    """The configuration examples/quickstart.py builds inside its main."""
    from repro.configs import SpionConfig, get_config
    return get_config("spion-lra").replace(
        num_layers=2, d_ff=128, vocab_size=64,
        spion=SpionConfig(enabled=True, variant="cf", conv_filter_size=7,
                          block_size=16, alpha_quantile=0.85,
                          transition_tol=0.5, min_dense_epochs=1,
                          max_dense_epochs=4))


@pytest.fixture(scope="module")
def quickstart():
    """(the JAX Trainer after JAX_STEPS steps and its losses, the port's
    Trainer after the example's main from the JAX masters)."""
    import jax
    from repro.launch.train import Trainer as JTrainer
    from repro_torch.convert import params_from_numpy
    mod = example("quickstart_torch")
    jc, tc = jax_quickstart_config(), mod.quickstart_config()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    jt = JTrainer(jc, seq_len=128, batch=8, lr=1e-3, steps_per_epoch=10)
    masters = jax.tree_util.tree_map(np.asarray, jt.params)
    jl = jt.train(JAX_STEPS, ckpt_every=0, log_every=100, log=_quiet)
    tt = mod.main(["--device", "cpu"],
                  params=params_from_numpy(masters, tc, device="cpu"))
    return jt, jl, tt


def test_quickstart_reaches_the_sparse_phase(quickstart):
    """main(["--device", "cpu"]) trains 80 steps and ends sparse (its own
    assert), with a pattern that prunes blocks."""
    _, _, tt = quickstart
    st = tt.spion_state
    assert st.phase == "sparse" and tt.step == 80
    assert 0.0 < st.density < 1.0
    assert all(np.isfinite(v) for v in tt.loss_history.values())


def test_quickstart_tracks_the_jax_trainer(quickstart):
    """From the JAX Trainer's masters on the same stream: the first 10
    losses within 1e-4 relative, the transition at the same epoch (the
    same Frobenius histories' length, the reference's criterion or cap)."""
    jt, jl, tt = quickstart
    tl = [tt.loss_history[s] for s in range(10)]
    np.testing.assert_allclose(tl, jl[:10], rtol=LOSS_RTOL)
    js, ts = jt.spion_state, tt.spion_state
    assert js.phase == "sparse", "the reference did not reach the sparse phase"
    assert len(ts.frob_hist) == len(js.frob_hist)
    for a, b in zip(ts.frob_hist, js.frob_hist):
        np.testing.assert_allclose(a, b, rtol=1e-4)


def test_quickstart_asks_for_the_card_by_default(monkeypatch):
    """Without --device the example runs on the card: with none present it
    raises before training."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example("quickstart_torch").main([])


def test_long_context_state_bytes_match_the_reference(capsys):
    """The example's recurrent state: the JAX example's bytes (fp32 token
    shift and WKV state of 2 layers), the same printed line, and 3 x 20
    tokens decoded."""
    import jax
    from repro.configs import get_config as jget
    from repro.models.registry import build as jbuild
    mod = example("long_context_decode_torch")
    jc = jget("rwkv6-7b").reduced().replace(remat=False)
    assert dataclasses.asdict(jc) == dataclasses.asdict(mod.decode_config())
    jcache = jbuild(jc).init_cache(1, max_len=1)
    want = sum(int(np.prod(v.shape)) * v.dtype.itemsize
               for v in jax.tree_util.tree_leaves(jcache))
    nbytes, ms = mod.main(["--device", "cpu"])
    assert nbytes == want
    assert sorted(ms) == sorted(mod.POSITIONS)
    assert f"recurrent state: {want/1e3:.1f} KB" in capsys.readouterr().out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_long_context_decode_step_matches_the_reference(dtype):
    """One decode_step from equal state (random, not zeros) and parameters
    (the JAX package's, through params_from_numpy): logits within 3e-5 in
    fp32 (6e-2 in bf16) of the JAX decode_step's, the new state likewise;
    the port's logits the same bits at position 1,000 and 524,288."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.models.registry import build as jbuild
    from repro_torch.convert import params_from_numpy
    from repro_torch.models.registry import build
    mod = example("long_context_decode_torch")
    cfg = mod.decode_config().replace(dtype=dtype)
    jcfg = jget("rwkv6-7b").reduced().replace(remat=False, dtype=dtype)
    jb, tb = jbuild(jcfg), build(cfg)
    jp = jb.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                           device="cpu")
    rng = np.random.default_rng(4)
    state = {k: (rng.standard_normal(v.shape) * 0.5).astype(np.float32)
             for k, v in jb.init_cache(1, max_len=1).items()}
    tok = np.array([[17]], np.int32)
    jl, jc = jb.decode_step(jp, {k: jnp.asarray(v) for k, v in state.items()},
                            jnp.asarray(tok), jnp.int32(1000))
    outs = []
    for pos in (1000, 524_288):
        cache = {k: torch.from_numpy(v.copy()) for k, v in state.items()}
        with torch.no_grad():
            tl, tc = tb.decode_step(tp, cache, torch.from_numpy(tok).long(),
                                    pos)
        outs.append((tl.float().numpy(), {k: v.numpy() for k, v in
                                          tc.items()}))
    tol = DECODE_TOL[dtype]
    jl = np.asarray(jl.astype(jnp.float32))
    assert np.abs(outs[0][0] - jl).max() <= tol
    for k, v in jc.items():
        assert np.abs(outs[0][1][k] - np.asarray(v)).max() <= tol, k
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
