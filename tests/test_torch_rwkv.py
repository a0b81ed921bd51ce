"""Port parity, the ssm family (models/rwkv.py, rwkv6-7b): token shift, the
chunked WKV6 at two and more chunks, the time-mix and channel-mix blocks in
their forward and decode forms, the family's forward, its decode against
its forward, and its serving through the engine's stepwise prefill, against
the JAX package on the CPU at reduced size (d_model 64, 4 heads of 16,
chunk 16), fp32 first, then bf16. The family has no KV cache: sparse decode
and paging are refused where steps and engines are built."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JEngine
from repro.models import rwkv as jr
from repro.models.registry import build as jbuild
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import rwkv as tr
from repro_torch.models.layers import layer_view
from repro_torch.models.registry import build as tbuild
from torch_parity import (FWD_TOL, arch_configs, assert_close, normal,
                          params, to_np, to_torch)


def rwkv_configs(dtype="float32", **kw):
    """(JAX cfg, port cfg) of reduced rwkv6-7b."""
    out = arch_configs("rwkv6-7b", dtype, **kw)
    assert out[0].family == "ssm"
    return out


def test_converted_params_are_the_reference_leaves():
    """JAX parameters cross as an identity (keys, shapes, dtypes, bits),
    `tm` and `cm` subtrees included, and the port's own init has the same
    keys, shapes and dtypes."""
    jc, tc = rwkv_configs("bfloat16")
    jp, tp = params(jc, tc)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {".".join(k.key for k in path): leaf for path, leaf in flat}
    got = dict(tp.named_parameters())
    assert set(got) == set(want) and "layers.tm.w_lora_b" in got
    for name, leaf in want.items():
        assert got[name].dtype == getattr(torch, str(leaf.dtype)), name
        np.testing.assert_array_equal(to_np(got[name]), to_np(leaf), name)
    mine = dict(tbuild(tc).init(torch.Generator().manual_seed(0),
                                device="cpu").named_parameters())
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in got.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", [(32, 16), (48, 16), (16, 4)])
def test_wkv6_chunked_matches_reference(dtype, S, chunk):
    rng = np.random.default_rng(0)
    B, H, K = 2, 3, 8
    r, k, v = (normal(rng, (B, S, H, K), dtype) for _ in range(3))
    a = np.clip(-np.exp(rng.standard_normal((B, S, H, K)) - 2), -8,
                -1e-6).astype(np.float32)
    u = (rng.standard_normal((H, K)) * 0.1).astype(np.float32)
    jy = jr.wkv6_chunked(*(jnp.asarray(x) for x in (r, k, v, a, u)), chunk)
    ty = tr.wkv6_chunked(*(to_torch(x) for x in (r, k, v, a, u)), chunk)
    assert ty.dtype == getattr(torch, dtype) and ty.shape == (B, S, H, K)
    assert_close(ty, jy, FWD_TOL[dtype])
    x = normal(rng, (B, S, 5), dtype)
    np.testing.assert_array_equal(to_np(tr.token_shift(to_torch(x))),
                                  to_np(jr.token_shift(jnp.asarray(x))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_timemix_and_channelmix_forward_and_decode(dtype):
    """Both blocks over 32 tokens (two chunks), then six decode steps from
    random states, each against the reference's."""
    jc, tc = rwkv_configs(dtype)
    jp, tp = params(jc, tc)
    jl = jax.tree_util.tree_map(lambda a: a[1], jp["layers"])
    tl = layer_view(tp["layers"], 1)
    rng = np.random.default_rng(1)
    tol = FWD_TOL[dtype]
    B, d = 2, jc.d_model
    H, hd = jc.num_heads, jc.resolved_head_dim
    x = normal(rng, (B, 32, d), dtype)
    for name, jf, tf in (("tm", jr.timemix_apply, tr.timemix_apply),
                         ("cm", jr.channelmix_apply, tr.channelmix_apply)):
        jy, _ = jf(jc, jl[name], jnp.asarray(x))
        ty, st = tf(tc, tl[name], to_torch(x))
        assert st is None
        assert_close(ty, jy, tol, name)
    jst = {"prev": rng.standard_normal((B, d)).astype(np.float32),
           "S": rng.standard_normal((B, H, hd, hd)).astype(np.float32)}
    tst = {k: to_torch(v) for k, v in jst.items()}
    jst = {k: jnp.asarray(v) for k, v in jst.items()}
    jcm = {"prev": jst["prev"]}
    tcm = {"prev": tst["prev"]}
    for t in range(6):
        x1 = normal(rng, (B, 1, d), dtype)
        jy, jst = jr.timemix_apply(jc, jl["tm"], jnp.asarray(x1), state=jst)
        ty, tst = tr.timemix_apply(tc, tl["tm"], to_torch(x1), state=tst)
        assert_close(ty, jy, tol, f"time-mix decode step {t}")
        for k in ("prev", "S"):
            assert tst[k].dtype == torch.float32
            assert_close(tst[k], jst[k], tol, f"{k} at step {t}")
        jy, jcm = jr.channelmix_apply(jc, jl["cm"], jnp.asarray(x1),
                                      state=jcm)
        ty, tcm = tr.channelmix_apply(tc, tl["cm"], to_torch(x1), state=tcm)
        assert_close(ty, jy, tol, f"channel-mix decode step {t}")
        assert_close(tcm["prev"], jcm["prev"], tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_loss_match_reference(dtype):
    jc, tc = rwkv_configs(dtype)
    jp, tp = params(jc, tc)
    rng = np.random.default_rng(2)
    raw = rng.integers(0, jc.vocab_size, size=(2, 33)).astype(np.int32)
    jb = {"tokens": jnp.asarray(raw[:, :-1]), "labels": jnp.asarray(raw[:, 1:])}
    tb = {"tokens": to_torch(raw[:, :-1]), "labels": to_torch(raw[:, 1:])}
    jl, jaux = jbuild(jc).forward(jp, jb)
    tl, taux = tbuild(tc).forward(tp, tb)
    assert jaux == {} and taux == {}
    assert tl.dtype == getattr(torch, dtype) and tl.shape == (2, 32, 128)
    assert_close(tl, jl, FWD_TOL[dtype])
    jloss, _ = jbuild(jc).loss(jp, jb)
    tloss, _ = tbuild(tc).loss(tp, tb)
    assert abs(float(tloss) - float(jloss)) <= FWD_TOL[dtype]


def test_decode_matches_forward():
    """Teacher-forced decode over 16 tokens reproduces the forward's logits
    at chunk 4 (the reference's test_decode_matches_forward for rwkv6-7b,
    limit 5e-2), and matches the reference's decode step by step; the
    cache is updated in place."""
    jc, tc = rwkv_configs(chunk=4, remat=False)
    jp, tp = params(jc, tc)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jc.vocab_size, size=(2, 16)).astype(np.int32)
    fwd, _ = tbuild(tc).forward(tp, {"tokens": to_torch(toks)})
    jcache = jbuild(jc).init_cache(2, 16)
    tcache = tbuild(tc).init_cache(2, 16, device="cpu")
    errs = []
    for t in range(16):
        jlg, jcache = jbuild(jc).decode_step(jp, jcache,
                                             jnp.asarray(toks[:, t:t + 1]),
                                             jnp.int32(t))
        tlg, out = tbuild(tc).decode_step(tp, tcache,
                                          to_torch(toks[:, t:t + 1]), t)
        assert out is tcache
        assert_close(tlg, jlg, FWD_TOL["float32"], f"step {t}")
        for k in jcache:
            assert_close(tcache[k], jcache[k], FWD_TOL["float32"], k)
        errs.append((tlg - fwd[:, t]).abs().max().item())
    assert max(errs) < 5e-2, errs


def test_serve_engine_matches_reference_engine():
    """rwkv6-7b's engine is contiguous by default (the registry's
    supports_paged_cache); every request is prefilled stepwise from a fresh
    B=1 state and written into its slot, then decoded with the others.
    More requests than slots, mixed lengths: tokens equal the reference
    engine's, logits within fp32's limit."""
    jc, tc = rwkv_configs(remat=False)
    jp, tp = params(jc, tc)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, jc.vocab_size, size=n).astype(np.int32)
               for n in (7, 12, 3)]
    je = JEngine(jc, jp, slots=2, max_len=32)
    te = ServeEngine(tc, tp, slots=2, max_len=32, device="cpu")
    assert not te.paged and not je.paged and te._prefill is None
    got = {}
    for name, eng, req in (("jax", je, JRequest), ("torch", te, Request)):
        rows = []
        dec = eng._decode

        def kept(*a, _dec=dec, _rows=rows, **kw):
            out = _dec(*a, **kw)
            _rows.append(to_np(out[0]))
            return out
        eng._decode = kept
        reqs = [req(rid=i, prompt=p.copy(), max_new=5)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        got[name] = ([r.out for r in reqs], rows, eng.prefill_stepwise_tokens)
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][2] == got["jax"][2] == sum(map(len, prompts))
    assert te.prefill_fused == 0
    for a, b in zip(got["torch"][1], got["jax"][1]):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def test_sparse_decode_paging_and_fused_prefill_are_refused(monkeypatch):
    """The registry's flags (supports_sparse_decode, supports_paged_cache:
    False) and a missing prefill_kv are refused where steps and engines are
    built, before the engine allocates anything: the page pool, the cache
    and the sparse exec are never reached."""
    _jc, tc = rwkv_configs()
    _jp, tp = params(_jc, tc)
    b = tbuild(tc)
    assert not b.supports_sparse_decode and not b.supports_paged_cache
    assert b.prefill_kv is None
    with pytest.raises(NotImplementedError, match="supports_sparse_decode"):
        make_serve_step(tc, spion=True)
    with pytest.raises(NotImplementedError, match="no fused KV prefill"):
        make_prefill_step(tc, spion=True, with_cache=True)
    make_prefill_step(tc)                     # logits only: allowed
    cache = b.init_cache(1, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="recurrent state"):
        b.decode_step(tp, cache, torch.zeros((1, 1), dtype=torch.long), 0,
                      spion={"block": 8})

    def allocates(*a, **kw):
        raise AssertionError("allocated before the refusal")
    monkeypatch.setattr(tserve, "PagePool", allocates)
    monkeypatch.setattr(tserve.SparseAttentionExec, "coerce", allocates)
    monkeypatch.setattr(tserve.SparseAttentionExec, "from_plan", allocates)
    monkeypatch.setattr(tserve, "build", lambda cfg: b._replace(
        init_cache=allocates))
    with pytest.raises(NotImplementedError, match="supports_paged_cache"):
        ServeEngine(tc, tp, slots=1, max_len=32, paged=True, device="cpu")
    with pytest.raises(NotImplementedError, match="supports_sparse_decode"):
        ServeEngine(tc, tp, slots=1, max_len=32, spion={"block": 8},
                    device="cpu")
