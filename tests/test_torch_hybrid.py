"""Port parity, the hybrid family (models/hybrid.py, zamba2-1.2b): Mamba2
layers and ONE shared attention block applied every k-th layer, whose SPION
tables are indexed by application. Against the JAX package on the CPU at
reduced size (d_model 64, 4 heads of 16, state 8, chunk 16, the block every
2nd layer), fp32 first, then bf16: parameters, the dense forward, decode
against the forward (contiguous and paged, dense and sparse), the sparse
forward with a per-application plan through the gather and through the
kernels' plain versions, its capture, and a sparse step's gradients."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.attention_exec import SparseAttentionExec as JExec
from repro.core.pattern import diagonal_filter
from repro.core.sparse_attention import bcsr_from_blockmask
from repro.core.sparse_attention import build_sparsity_plan as j_plan
from repro.models.registry import build as jbuild
from repro_torch.core.attention_exec import SparseAttentionExec as TExec
from repro_torch.core.kv_pool import PagedKVCache, PagePool
from repro_torch.core.sparse_attention import build_sparsity_plan as t_plan
from repro_torch.launch.steps import make_loss_and_grads
from repro_torch.models import hybrid as th
from repro_torch.models.layers import ParamTree
from repro_torch.models.registry import build as tbuild
from torch_parity import (FWD_TOL, arch_configs, assert_close, params,
                          random_blockmask, to_np, to_torch)

BLOCK, S = 16, 64
GRAD_TOL = 1e-3


def hybrid_configs(dtype="float32", **kw):
    """(JAX cfg, port cfg) of reduced zamba2-1.2b."""
    out = arch_configs("zamba2-1.2b", dtype, **kw)
    assert out[0].family == "hybrid"
    return out


def tokens(cfg, seed, shape=(2, S)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)


def app_plan(napps, seed=0, nrb=S // BLOCK):
    """A random causal plan, one block mask per APPLICATION, as (JAX plan,
    port plan)."""
    rng = np.random.default_rng(seed)
    bs = [bcsr_from_blockmask(random_blockmask(rng, nrb, causal=True), BLOCK,
                              max_k=nrb) for _ in range(napps)]
    col = np.stack([np.asarray(b.col_idx) for b in bs])
    nv = np.stack([np.asarray(b.nvalid) for b in bs])
    return j_plan(col, nv, BLOCK), t_plan(col, nv, BLOCK)


def test_converted_params_are_the_reference_leaves():
    """JAX parameters cross as an identity: the stacked Mamba `layers`, the
    one `shared_attn` block; the port's own init has the same keys, shapes
    and dtypes."""
    jc, tc = hybrid_configs("bfloat16")
    jp, tp = params(jc, tc)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {".".join(k.key for k in path): leaf for path, leaf in flat}
    got = dict(tp.named_parameters())
    assert set(got) == set(want)
    assert "shared_attn.attn.wq" in got and "layers.mamba.conv_w" in got
    for name, leaf in want.items():
        assert got[name].dtype == getattr(torch, str(leaf.dtype)), name
        np.testing.assert_array_equal(to_np(got[name]), to_np(leaf), name)
    mine = dict(tbuild(tc).init(torch.Generator().manual_seed(0),
                                device="cpu").named_parameters())
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in got.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers", [1, 4])
def test_dense_forward_matches_reference(dtype, layers):
    """1 layer: no application of the shared block (n_attn_apps 0); 4
    layers: two applications of it."""
    jc, tc = hybrid_configs(dtype, num_layers=layers)
    assert th.n_attn_apps(tc) == layers // 2
    jp, tp = params(jc, tc)
    toks = tokens(jc, 0)
    jl, jaux = jbuild(jc).forward(jp, {"tokens": jnp.asarray(toks)})
    tl, taux = tbuild(tc).forward(tp, {"tokens": to_torch(toks)})
    assert jaux == {} and taux == {}
    assert tl.dtype == getattr(torch, dtype)
    assert_close(tl, jl, FWD_TOL[dtype])


def _decode_all(bundle, params_, cache, toks, spion=None):
    out = []
    for t in range(toks.shape[1]):
        lg, cache = bundle.decode_step(params_, cache,
                                       to_torch(toks[:, t:t + 1]),
                                       torch.full((toks.shape[0],), t),
                                       spion=spion)
        out.append(lg)
    return torch.stack(out, dim=1), cache


@pytest.mark.parametrize("layers", [1, 2, 4])
def test_decode_matches_forward_and_reference(layers):
    """Teacher-forced decode over 16 tokens reproduces the forward's logits
    at chunk 4 (the reference's test_decode_matches_forward for zamba2-1.2b,
    limit 5e-2) and the reference's decode at fp32's limit, contiguous and
    through a page pool whose layer axis is the application."""
    jc, tc = hybrid_configs(chunk=4, remat=False, num_layers=layers)
    jp, tp = params(jc, tc)
    toks = tokens(jc, 1, (2, 16))
    tb, jb = tbuild(tc), jbuild(jc)
    fwd, _ = tb.forward(tp, {"tokens": to_torch(toks)})
    cache = tb.init_cache(2, 16, device="cpu")
    napps = th.n_attn_apps(tc)
    assert cache["k"].shape == (napps, 2, 16, tc.num_kv_heads, 16)
    dec, out = _decode_all(tb, tp, cache, toks)
    assert out is cache
    assert (dec - fwd).abs().max().item() < 5e-2
    jcache = jb.init_cache(2, 16)
    jdecode = jax.jit(jb.decode_step)
    want = []
    for t in range(16):
        lg, jcache = jdecode(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
        want.append(np.asarray(lg))
    assert_close(dec, np.stack(want, 1), FWD_TOL["float32"])
    for k in jcache:
        assert_close(cache[k], jcache[k], FWD_TOL["float32"], k)
    # paged: pages of 4 positions, each row its own 4 pages
    pool = PagePool(layers=napps, num_pages=9, page=4, kv_heads=4,
                    head_dim=16, dtype=torch.float32)
    pt = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    pcache = dict(tb.init_cache(2, 0, device="cpu"), kv=pool.cache(pt))
    del pcache["k"], pcache["v"]
    pdec, _ = _decode_all(tb, tp, pcache, toks)
    assert torch.equal(pdec, dec)
    if napps:
        assert torch.equal(pool.kp[:, pt.long()].reshape(napps, 2, 16, 4, 16),
                           cache["k"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["auto", "fused"])
def test_sparse_forward_per_application_plan(dtype, kernel):
    """A random causal plan with one block mask per application of the
    shared block (4 layers, 2 applications), through the port's gather
    ("auto" on CPU tensors) and through the kernels' plain versions
    ("fused"), against the reference's jnp path."""
    jc, tc = hybrid_configs(dtype, kernel=kernel, num_layers=4)
    jc = jc.replace(spion=dataclasses.replace(jc.spion, kernel="auto"))
    jp, tp = params(jc, tc)
    jplan, tplan = app_plan(2)
    toks = tokens(jc, 2)
    jl, _ = jbuild(jc).forward(jp, {"tokens": jnp.asarray(toks)},
                               spion=JExec.from_plan(jplan))
    tl, _ = tbuild(tc).forward(tp, {"tokens": to_torch(toks)},
                               spion=TExec.from_plan(tplan))
    assert_close(tl, jl, FWD_TOL[dtype])
    # the applications' tables are not interchangeable
    col = tplan.tables["col_idx"]
    if not torch.equal(col[0], col[1]):
        swapped = {k: v.flip(0) for k, v in tplan.tables.items()
                   if torch.is_tensor(v)}
        tw, _ = tbuild(tc).forward(tp, {"tokens": to_torch(toks)},
                                   spion=TExec(swapped, block=BLOCK))
        assert (tw.float() - tl.float()).abs().max().item() > 1e-3


def test_capture_is_per_layer_with_zeros_between_applications():
    jc, tc = hybrid_configs(num_layers=4)
    jp, tp = params(jc, tc)
    toks = tokens(jc, 3)
    filt = diagonal_filter(7).astype(np.float32)
    _, jaux = jbuild(jc).forward(jp, {"tokens": jnp.asarray(toks)},
                                 capture={"filt": jnp.asarray(filt),
                                          "block": BLOCK})
    _, taux = tbuild(tc).forward(tp, {"tokens": to_torch(toks)},
                                 capture={"filt": torch.as_tensor(filt),
                                          "block": BLOCK})
    (jpool, jfrob), (tpool, tfrob) = jaux["captured"], taux["captured"]
    assert tpool.shape == (4, S // BLOCK, S // BLOCK) and tfrob.shape == (4,)
    assert not tpool[0].any() and not tpool[2].any()
    assert tpool[1].any() and tpool[3].any()
    np.testing.assert_allclose(to_np(tpool), np.asarray(jpool), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(to_np(tfrob), np.asarray(jfrob), rtol=1e-5)


@pytest.mark.parametrize("kernel", ["auto", "fused"])
def test_sparse_step_gradients_match_reference(kernel):
    """The loss and every gradient of a sparse step (per-application plan,
    remat on: only the Mamba part is recomputed) against jax.grad of the
    reference's loss, fp32, within 1e-3; through the gather and through
    the three kernels' plain versions."""
    jc, tc = hybrid_configs(kernel=kernel, num_layers=4, remat=True)
    jc = jc.replace(spion=dataclasses.replace(jc.spion, kernel="auto"))
    jp, tp = params(jc, tc)
    masters = ParamTree({k: v for k, v in tp.items()}, trainable=True)
    jplan, tplan = app_plan(2, seed=4)
    raw = tokens(jc, 4, (2, S + 1))
    jb = {"tokens": jnp.asarray(raw[:, :-1]), "labels": jnp.asarray(raw[:, 1:])}
    tb = {"tokens": to_torch(raw[:, :-1]), "labels": to_torch(raw[:, 1:])}
    jex = JExec.from_plan(jplan)
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jbuild(jc).loss(p, jb, spion=jex), has_aux=True)(jp)
    tloss, tg = make_loss_and_grads(tc)(masters, tb, TExec.from_plan(tplan))
    assert abs(tloss.item() - float(jloss)) <= FWD_TOL["float32"]
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    want = {".".join(k.key for k in path): leaf for path, leaf in flat}
    assert set(tg) == set(want)
    for name, g in want.items():
        assert_close(tg[name], g, GRAD_TOL, name)
    assert tg["shared_attn.attn.wq"].abs().max().item() > 0


@pytest.mark.parametrize("paged", [False, True])
def test_sparse_decode_per_application_plan(paged):
    """Sparse decode: each application gathers only its pattern row's cache
    blocks, contiguous and paged (page = block), against the reference's
    contiguous sparse decode."""
    jc, tc = hybrid_configs(remat=False, num_layers=4)
    jp, tp = params(jc, tc)
    jplan, tplan = app_plan(2, seed=5)
    toks = tokens(jc, 5, (2, 24))
    jb, tb = jbuild(jc), tbuild(tc)
    jex = JExec.from_plan(jplan, phase="decode")
    tex = TExec.from_plan(tplan, phase="decode")
    jcache = jb.init_cache(2, S)
    jdecode = jax.jit(lambda p, c, tok, t, ex: jb.decode_step(p, c, tok, t,
                                                              spion=ex))
    want = []
    for t in range(toks.shape[1]):
        lg, jcache = jdecode(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t), jex)
        want.append(np.asarray(lg))
    cache = tb.init_cache(2, S, device="cpu")
    if paged:
        pool = PagePool(layers=2, num_pages=9, page=BLOCK, kv_heads=4,
                        head_dim=16, dtype=torch.float32)
        pt = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
        cache = {"conv": cache["conv"], "ssm": cache["ssm"],
                 "kv": pool.cache(pt)}
        assert isinstance(cache["kv"], PagedKVCache)
    got, _ = _decode_all(tb, tp, cache, toks, spion=tex)
    assert_close(got, np.stack(want, 1), FWD_TOL["float32"])
