"""Port parity, the Mamba2 layer (models/mamba.py): the causal conv with and
without its decode state, the chunked SSD scan at two and more chunks, and
the whole layer in its forward and decode forms, against the JAX package on
the CPU at reduced zamba2-1.2b size (d_model 64, 8 heads of 16, state 8,
chunk 16), fp32 first, then bf16."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jm
from repro.models.registry import build as jbuild
from repro_torch.convert import params_from_numpy
from repro_torch.models import mamba as tm
from repro_torch.models.layers import layer_view
from torch_parity import FWD_TOL, arch_configs, assert_close, normal, \
    to_torch


def mamba_params(jc, tc, layer=0, seed=0):
    """One Mamba layer's parameters from the JAX hybrid init, as (JAX
    dict, port dict of tensors)."""
    jp = jbuild(jc).init(jax.random.key(seed))
    jl = jax.tree_util.tree_map(lambda a: a[layer], jp["layers"]["mamba"])
    tree = jax.tree_util.tree_map(np.asarray, jp)
    tp = params_from_numpy(tree, tc, device="cpu")
    return jl, layer_view(tp["layers"], layer)["mamba"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(dtype, with_state):
    rng = np.random.default_rng(0)
    B, S, C = 2, 5 if not with_state else 1, 24
    x = normal(rng, (B, S, C), dtype)
    w = normal(rng, (jm.CONV_W, C), dtype) * np.float32(0.3)
    w = np.asarray(jnp.asarray(w, dtype))
    b = normal(rng, (C,), dtype)
    st = rng.standard_normal((B, jm.CONV_W - 1, C)).astype(np.float32) \
        if with_state else None
    jy, jst = jm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              None if st is None else jnp.asarray(st))
    ty, tst = tm._causal_conv(to_torch(x), to_torch(w), to_torch(b),
                              None if st is None else to_torch(st))
    assert ty.dtype == getattr(torch, dtype) and ty.shape == (B, S, C)
    assert_close(ty, jy, FWD_TOL[dtype])
    if with_state:
        assert tst.dtype == torch.float32
        # the new state is the last W-1 inputs, rounded to x's dtype on the
        # way in (the reference's state.astype(x.dtype))
        np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    else:
        assert tst is None and jst is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", [(32, 16), (48, 16), (16, 4)])
def test_ssd_chunked_matches_reference(dtype, S, chunk):
    rng = np.random.default_rng(1)
    b, H, P, N = 2, 4, 8, 6
    x = normal(rng, (b, S, H, P), dtype)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)) - 1)).astype(
        np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = normal(rng, (b, S, 1, N), dtype)
    Cm = normal(rng, (b, S, 1, N), dtype)
    D = rng.standard_normal(H).astype(np.float32)
    jy = jm.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, Bm, Cm, D)),
                        chunk)
    ty = tm.ssd_chunked(*(to_torch(a) for a in (x, dt, A, Bm, Cm, D)), chunk)
    assert ty.dtype == getattr(torch, dtype) and ty.shape == (b, S, H, P)
    assert_close(ty, jy, FWD_TOL[dtype])


def test_ssd_chunked_refuses_a_partial_chunk():
    """The reference reshapes S into whole chunks and fails at S = 20,
    chunk 16; the port raises there too instead of padding."""
    rng = np.random.default_rng(2)
    args = (rng.standard_normal((1, 20, 2, 4)), np.ones((1, 20, 2)),
            -np.ones(2), rng.standard_normal((1, 20, 1, 3)),
            rng.standard_normal((1, 20, 1, 3)), np.ones(2))
    args = [a.astype(np.float32) for a in args]
    with pytest.raises(TypeError):
        jm.ssd_chunked(*(jnp.asarray(a) for a in args), 16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tm.ssd_chunked(*(to_torch(a) for a in args), 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_forward_and_decode_match_reference(dtype):
    """The layer's chunked forward over 32 tokens (two chunks), then eight
    decode steps from a random state, each against the reference's."""
    jc, tc = arch_configs("zamba2-1.2b", dtype)
    jp, tp = mamba_params(jc, tc)
    rng = np.random.default_rng(3)
    tol = FWD_TOL[dtype]
    x = normal(rng, (2, 32, jc.d_model), dtype)
    jy, jst = jm.mamba_apply(jc, jp, jnp.asarray(x))
    ty, tst = tm.mamba_apply(tc, tp, to_torch(x))
    assert jst is None and tst is None
    assert_close(ty, jy, tol)
    jstate = jm.init_state(jc, 2)
    tstate = tm.init_state(tc, 2)
    assert {k: v.shape for k, v in jstate.items()} == \
        {k: tuple(v.shape) for k, v in tstate.items()}
    jstate = {k: jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
              for k, v in jstate.items()}
    tstate = {k: to_torch(np.asarray(v)) for k, v in jstate.items()}
    for t in range(8):
        x1 = normal(rng, (2, 1, jc.d_model), dtype)
        jy, jstate = jm.mamba_apply(jc, jp, jnp.asarray(x1), state=jstate)
        ty, tstate = tm.mamba_apply(tc, tp, to_torch(x1), state=tstate)
        assert_close(ty, jy, tol, f"decode step {t}")
        for k in jstate:
            assert tstate[k].dtype == torch.float32
            assert_close(tstate[k], jstate[k], tol, f"{k} at step {t}")
