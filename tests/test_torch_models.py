"""Port parity, models: configs, parameter conversion, the layers, the dense
transformer's forward and fused prefill (dense and sparse), and its decode
step over contiguous and paged caches (dense and sparse), each against the
JAX package with the same parameters (the JAX init, converted by
`params_from_numpy`) and the same numpy tokens. fp32 first, then bf16."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
from repro.core.kv_pool import PagePool as JPool
from repro.core.sparse_attention import bcsr_from_blockmask
from repro.launch.steps import causal_band_tables as j_band
from repro.models import layers as jlyr
from repro.models.registry import build as jbuild
from repro_torch.core.kv_pool import PagePool as TPool
from repro_torch.launch.steps import causal_band_tables as t_band
from repro_torch.models import layers as tlyr
from repro_torch.models.registry import build as tbuild
from torch_parity import (FWD_TOL, assert_close, configs, normal, params,
                          random_blockmask, to_np, to_torch)

LOGIT_TOL = {"float32": 1e-4, "bfloat16": 6e-2}


def test_full_config_and_band_tables_match_reference():
    for name in ("qwen2-7b",):
        assert dataclasses.asdict(tcfgs.get_config(name)) == \
            dataclasses.asdict(jcfgs.get_config(name))
    for width in (None, 2):
        for key, arr in j_band(3, 5, width).items():
            np.testing.assert_array_equal(t_band(3, 5, width)[key], arr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converted_params_are_the_reference_leaves(dtype):
    jc, tc = configs(dtype)
    jp, tp = params(jc, tc)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {".".join(k.key for k in path): leaf for path, leaf in flat}
    got = dict(tp.named_parameters())
    assert set(got) == set(want)
    for name, leaf in want.items():
        assert got[name].dtype == getattr(torch, str(leaf.dtype)), name
        np.testing.assert_array_equal(to_np(got[name]), to_np(leaf), name)
    # the port's own init draws other numbers with the same keys and shapes
    mine = dict(tbuild(tc).init(torch.Generator().manual_seed(0),
                                device="cpu").named_parameters())
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in got.items()}


def test_other_families_are_refused():
    cfg = tcfgs.get_config("qwen2-7b").replace(family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbuild(cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    jc, tc = configs(dtype)
    jp, tp = params(jc, tc)
    rng = np.random.default_rng(2)
    x = normal(rng, (2, 8, jc.d_model), dtype)
    pos = np.arange(8)
    tol = FWD_TOL[dtype]
    jl = jax.tree_util.tree_map(lambda a: a[1], jp["layers"])
    tl = tlyr.layer_view(tp["layers"], 1)
    assert_close(tlyr.rmsnorm(tl["attn_norm"], to_torch(x)),
                 jlyr.rmsnorm(jl["attn_norm"], jnp.asarray(x)), tol)
    assert_close(tlyr.mlp(tc, tl["mlp"], to_torch(x)),
                 jlyr.mlp(jc, jl["mlp"], jnp.asarray(x)), tol)
    xr = normal(rng, (2, 8, 4, 16), dtype)
    assert_close(tlyr.rope(to_torch(xr), torch.as_tensor(pos), 1e6),
                 jlyr.rope(jnp.asarray(xr), jnp.asarray(pos), 1e6), tol)
    assert_close(tlyr.unembed(tp["lm_head"], to_torch(x)),
                 jlyr.unembed(jp["lm_head"], jnp.asarray(x)), tol)


def _tables(jc, S, block, rng):
    """-1-padded per-layer tables of random causal masks (both execution
    paths of both packages read them alike) as a dict payload."""
    nrb = S // block
    bs = [bcsr_from_blockmask(random_blockmask(rng, nrb, causal=True), block,
                              max_k=nrb) for _ in range(jc.num_layers)]
    return {"col_idx": np.stack([np.asarray(b.col_idx) for b in bs]),
            "nvalid": np.stack([np.asarray(b.nvalid) for b in bs]),
            "block": block}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse", [None, "jnp", "fused"])
def test_forward_and_prefill_match_reference(dtype, sparse):
    """Logits of `forward`, and logits + per-layer K/V of `prefill_step`.
    The port's "fused" runs the kernel's plain version on CPU tensors; the
    reference runs its gather path (the same function on -1-padded
    tables)."""
    jc, tc = configs(dtype)
    jp, tp = params(jc, tc)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jc.vocab_size, size=(2, 64))
    spion = None if sparse is None else _tables(jc, 64, 16, rng)
    tcfg = tc if sparse is None else tc.replace(
        spion=dataclasses.replace(tc.spion, kernel=sparse))
    jl, _ = jbuild(jc).forward(jp, {"tokens": jnp.asarray(toks)}, spion=spion)
    tl, _ = tbuild(tcfg).forward(tp, {"tokens": torch.as_tensor(toks)},
                                 spion=spion)
    assert_close(tl, jl, LOGIT_TOL[dtype], "forward")
    jl, jks, jvs = jbuild(jc).prefill_kv(jp, {"tokens": jnp.asarray(toks)},
                                         spion=spion)
    tl, tks, tvs = tbuild(tcfg).prefill_kv(
        tp, {"tokens": torch.as_tensor(toks)}, spion=spion)
    assert tks.shape == jks.shape == (jc.num_layers, 2, 64, 2, 16)
    assert_close(tl, jl, LOGIT_TOL[dtype], "prefill logits")
    assert_close(tks, jks, FWD_TOL[dtype], "prefill k")
    assert_close(tvs, jvs, FWD_TOL[dtype], "prefill v")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("sparse", [False, True])
def test_decode_step_matches_reference(dtype, paged, sparse):
    """Three decode steps at per-row positions after a prefill, over a
    contiguous cache or a paged pool; logits each step and the final
    cache."""
    jc, tc = configs(dtype)
    jp, tp = params(jc, tc)
    jb, tb = jbuild(jc), tbuild(tc)
    rng = np.random.default_rng(4)
    B, S, block, P = 2, 64, 16, 32
    spion = _tables(jc, S, block, rng) if sparse else None
    pre = None if spion is None else dict(
        spion, col_idx=spion["col_idx"][:, :P // block],
        nvalid=spion["nvalid"][:, :P // block])
    prompt = rng.integers(0, jc.vocab_size, size=(1, P))
    _, jks, jvs = jb.prefill_kv(jp, {"tokens": jnp.asarray(prompt)},
                                spion=pre)
    _, tks, tvs = tb.prefill_kv(tp, {"tokens": torch.as_tensor(prompt)},
                                spion=pre)
    if paged:
        pt = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
        kw = dict(layers=jc.num_layers, num_pages=9, page=block, kv_heads=2,
                  head_dim=16)
        jpool = JPool(dtype=dtype, **kw)
        tpool = TPool(dtype=getattr(torch, dtype), **kw)
        for row in pt:
            jpool.insert_blocks(jks, jvs, row[:P // block], 0)
            tpool.insert_blocks(tks, tvs, row[:P // block], 0)
        jcache, tcache = jpool.cache(jnp.asarray(pt)), \
            tpool.cache(torch.as_tensor(pt))
    else:
        jcache = jb.init_cache(B, S)
        tcache = tb.init_cache(B, S, device="cpu")
        for s in range(B):
            jcache = {n: jcache[n].at[:, s, :P].set(a[:, 0])
                      for n, a in (("k", jks), ("v", jvs))}
            tcache["k"][:, s, :P] = tks[:, 0]
            tcache["v"][:, s, :P] = tvs[:, 0]
    pos = np.array([P, P - 5], np.int32)
    for step in range(3):
        tok = rng.integers(0, jc.vocab_size, size=(B, 1))
        jl, jcache = jb.decode_step(jp, jcache, jnp.asarray(tok),
                                    jnp.asarray(pos + step), spion=spion)
        tl, tcache = tb.decode_step(tp, tcache, torch.as_tensor(tok),
                                    torch.as_tensor(pos + step), spion=spion)
        assert_close(tl, jl, LOGIT_TOL[dtype], f"step {step}")
    if paged:
        assert_close(tcache.kp, jcache.kp, FWD_TOL[dtype], "pool k")
        assert_close(tcache.vp, jcache.vp, FWD_TOL[dtype], "pool v")
    else:
        assert_close(tcache["k"], jcache["k"], FWD_TOL[dtype], "cache k")
        assert_close(tcache["v"], jcache["v"], FWD_TOL[dtype], "cache v")
