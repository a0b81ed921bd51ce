"""Port parity, the encoder-decoder family (models/encdec.py, whisper-tiny):
against the JAX package on the CPU at reduced size (2 encoder and 2
decoder layers, d_model 64, 4 heads of 16, GELU MLP, LayerNorm), fp32
first, then bf16: the sinusoidal table (bitwise), the encoder,
the forward (dense, and through a plan by the gather and the kernels'
plain versions), its capture, a step's loss and gradients, the cross K/V,
teacher-forced decode (contiguous and paged, dense and sparse) and the
serving engine's tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pattern import diagonal_filter
from repro.core.sparse_attention import bcsr_from_blockmask
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JEngine
from repro.models import encdec as je
from repro.models import layers as jlyr
from repro.models.registry import build as jbuild
from repro_torch.core.kv_pool import PagePool
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.launch.steps import make_loss_and_grads
from repro_torch.models import encdec as te
from repro_torch.models import layers as tlyr
from repro_torch.models.layers import ParamTree
from repro_torch.models.registry import build as tbuild
from torch_parity import (FWD_TOL, arch_configs, assert_close, normal, params,
                          random_blockmask, to_np, to_torch)

BLOCK, S, S_ENC = 16, 64, 48
GRAD_TOL = 1e-3


def encdec_configs(dtype="float32", kernel=None, **kw):
    """(JAX cfg, port cfg) of reduced whisper-tiny."""
    out = arch_configs("whisper-tiny", dtype, kernel=kernel, **kw)
    assert out[0].family == "audio" and out[0].encoder_layers == 2
    return out


def inputs(cfg, seed, batch=2, seq=S, dtype="float32"):
    """(frames (batch, S_ENC, d), tokens (batch, seq)) from a seed."""
    rng = np.random.default_rng(seed)
    frames = normal(rng, (batch, S_ENC, cfg.d_model), dtype)
    toks = rng.integers(0, cfg.vocab_size, size=(batch, seq)).astype(np.int32)
    return frames, toks


def tables(cfg, seed):
    """A random causal block mask per decoder layer as a -1-padded tables
    payload."""
    rng = np.random.default_rng(seed)
    nrb = S // BLOCK
    bs = [bcsr_from_blockmask(random_blockmask(rng, nrb, causal=True), BLOCK,
                              max_k=nrb) for _ in range(cfg.num_layers)]
    return {"col_idx": np.stack([np.asarray(b.col_idx) for b in bs]),
            "nvalid": np.stack([np.asarray(b.nvalid) for b in bs]),
            "block": BLOCK}


@pytest.mark.parametrize("length,d", [(1500, 384), (48, 64), (7, 6)])
def test_sinusoidal_positions_are_bitwise_the_reference(length, d):
    want = np.asarray(jlyr.sinusoidal_positions(length, d))
    got = tlyr.sinusoidal_positions(length, d).numpy()
    assert got.dtype == np.float32 and got.shape == (length, d)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_cross_kv_match_reference(dtype):
    """The encoder's output and every decoder layer's cross K/V
    (precompute_cross)."""
    jc, tc = encdec_configs(dtype)
    jp, tp = params(jc, tc)
    frames, _ = inputs(jc, 0, dtype=dtype)
    assert_close(te.encode(tp, tc, to_torch(frames)),
                 je.encode(jp, jc, jnp.asarray(frames)), FWD_TOL[dtype])
    jck, jcv = je.precompute_cross(jp, jc, jnp.asarray(frames))
    tck, tcv = te.precompute_cross(tp, tc, to_torch(frames))
    assert tck.shape == jck.shape == (jc.num_layers, 2, S_ENC, 4, 16)
    assert_close(tck, jck, FWD_TOL[dtype], "ck")
    assert_close(tcv, jcv, FWD_TOL[dtype], "cv")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse", [None, "auto", "fused"])
def test_forward_matches_reference(dtype, sparse):
    """Logits, dense and through a random causal plan on the decoder's
    self-attention: the port's gather ("auto" on CPU tensors) and the
    kernels' plain versions ("fused") against the reference's jnp path."""
    jc, tc = encdec_configs(dtype, kernel=sparse)
    jc = jc.replace(spion=dataclasses.replace(jc.spion, kernel="auto"))
    jp, tp = params(jc, tc)
    frames, toks = inputs(jc, 1, dtype=dtype)
    spion = None if sparse is None else tables(jc, 1)
    jl, jaux = jbuild(jc).forward(jp, {"frames": jnp.asarray(frames),
                                       "tokens": jnp.asarray(toks)},
                                  spion=spion)
    tl, taux = tbuild(tc).forward(tp, {"frames": to_torch(frames),
                                       "tokens": to_torch(toks)}, spion=spion)
    assert jaux == {} and taux == {}
    assert tl.shape == (2, S, tc.vocab_size)
    assert tl.dtype == getattr(torch, dtype)
    assert_close(tl, jl, FWD_TOL[dtype])


def test_capture_is_one_map_per_decoder_layer():
    jc, tc = encdec_configs()
    jp, tp = params(jc, tc)
    frames, toks = inputs(jc, 2)
    filt = diagonal_filter(7).astype(np.float32)
    _, jaux = jbuild(jc).forward(
        jp, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)},
        capture={"filt": jnp.asarray(filt), "block": BLOCK})
    _, taux = tbuild(tc).forward(
        tp, {"frames": to_torch(frames), "tokens": to_torch(toks)},
        capture={"filt": torch.as_tensor(filt), "block": BLOCK})
    (jpool, jfrob), (tpool, tfrob) = jaux["captured"], taux["captured"]
    assert tpool.shape == (jc.num_layers, S // BLOCK, S // BLOCK)
    assert tfrob.shape == (jc.num_layers,)
    # causal: every block on and below the diagonal holds weight
    assert tpool[:, np.tril(np.ones((S // BLOCK,) * 2, bool))].all()
    np.testing.assert_allclose(to_np(tpool), np.asarray(jpool), rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(to_np(tfrob), np.asarray(jfrob), rtol=1e-5)


@pytest.mark.parametrize("kernel", [None, "auto", "fused"])
def test_loss_and_gradients_match_reference(kernel):
    """The loss and every gradient of a step (remat on: each encoder and
    decoder layer recomputed) against jax.grad of the reference's loss,
    fp32, within 1e-3: dense, and sparse through the gather and through
    the three kernels' plain versions."""
    jc, tc = encdec_configs(kernel=kernel, remat=True)
    jc = jc.replace(spion=dataclasses.replace(jc.spion, kernel="auto"))
    jp, tp = params(jc, tc)
    masters = ParamTree({k: v for k, v in tp.items()}, trainable=True)
    frames, raw = inputs(jc, 3, seq=S + 1)
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(raw[:, :-1]),
          "labels": jnp.asarray(raw[:, 1:])}
    tb = {"frames": to_torch(frames), "tokens": to_torch(raw[:, :-1]),
          "labels": to_torch(raw[:, 1:])}
    spion = None if kernel is None else tables(jc, 3)
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jbuild(jc).loss(p, jb, spion=spion), has_aux=True)(jp)
    tloss, tg = make_loss_and_grads(tc, block=BLOCK)(masters, tb, spion)
    assert abs(tloss.item() - float(jloss)) <= FWD_TOL["float32"]
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    want = {".".join(k.key for k in path): leaf for path, leaf in flat}
    assert set(tg) == set(want)
    for name, g in want.items():
        assert_close(tg[name], g, GRAD_TOL, name)
    for name in ("enc_layers.attn.wq", "dec_layers.attn.wq",
                 "dec_layers.cross.wk"):
        assert tg[name].abs().max().item() > 0, name


def _decode_all(bundle, p, cache, toks, spion=None):
    out = []
    for t in range(toks.shape[1]):
        lg, cache = bundle.decode_step(p, cache, to_torch(toks[:, t:t + 1]),
                                       torch.full((toks.shape[0],), t),
                                       spion=spion)
        out.append(lg)
    return torch.stack(out, dim=1), cache


@pytest.mark.parametrize("sparse", [False, True])
def test_decode_matches_forward_and_reference(sparse):
    """Teacher-forced decode of 32 tokens after precompute_cross, fp32:
    the reference's decode at fp32's limit and the port's own forward
    (the reference's test_decode_matches_forward for whisper-tiny),
    contiguous and through a page pool whose pages hold the decoder's
    self-attention K/V while the cross K/V stay contiguous; sparse through
    a random causal plan."""
    jc, tc = encdec_configs()
    jp, tp = params(jc, tc)
    frames, toks = inputs(jc, 4, seq=32)
    spion = tables(jc, 4) if sparse else None
    tb, jb = tbuild(tc), jbuild(jc)
    # the forward of 32 tokens reads the plan's first two row blocks
    pre = None if spion is None else dict(
        spion, col_idx=spion["col_idx"][:, :2], nvalid=spion["nvalid"][:, :2])
    fwd, _ = tb.forward(tp, {"frames": to_torch(frames),
                             "tokens": to_torch(toks)}, spion=pre)
    jcache = jb.init_cache(2, S)
    assert jcache["ck"].shape[2] == S
    jcache["ck"], jcache["cv"] = je.precompute_cross(jp, jc,
                                                     jnp.asarray(frames))
    jdecode = jax.jit(lambda p, c, tok, t: jb.decode_step(p, c, tok, t,
                                                          spion=spion))
    want = []
    for t in range(toks.shape[1]):
        lg, jcache = jdecode(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
        want.append(np.asarray(lg))
    want = np.stack(want, 1)
    ck, cv = te.precompute_cross(tp, tc, to_torch(frames))
    cache = dict(tb.init_cache(2, S, device="cpu"), ck=ck, cv=cv)
    dec, out = _decode_all(tb, tp, cache, toks, spion)
    assert out is cache
    assert_close(dec, want, FWD_TOL["float32"])
    assert_close(dec, fwd, 1e-4)
    for k in ("k", "v"):
        assert_close(cache[k], jcache[k], FWD_TOL["float32"], k)
    # paged: page = block, each row its own 4 pages
    pool = PagePool(layers=tc.num_layers, num_pages=9, page=BLOCK,
                    kv_heads=4, head_dim=16, dtype=torch.float32)
    pt = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    pdec, _ = _decode_all(tb, tp, {"kv": pool.cache(pt), "ck": ck, "cv": cv},
                          toks, spion)
    assert torch.equal(pdec, dec)
    assert torch.equal(
        pool.kp[:, pt.long()].reshape(tc.num_layers, 2, S, 4, 16)[:, :, :32],
        cache["k"][:, :, :32])


def test_engine_cross_cache_is_the_reference_engines():
    """The engine's per-slot extra state is init_cache(slots, max_len)
    without k and v, as in the reference engine: cross K/V at max_len,
    not at length 0. Paged: `_extra_cache`; each stepwise prefill's B=1
    sub-cache has them at max_len too. As in the reference, the engine
    never fills them: after serving they are still zero."""
    jc, tc = encdec_configs(remat=False)
    jp, tp = params(jc, tc)
    je_ = JEngine(jc, jp, slots=3, max_len=S)
    te_ = ServeEngine(tc, tp, slots=3, max_len=S, device="cpu")
    assert te_.paged and je_.paged and te_._prefill is None
    assert set(te_._extra_cache) == set(je_._extra_cache) == {"ck", "cv"}
    for k in ("ck", "cv"):
        assert tuple(te_._extra_cache[k].shape) == \
            je_._extra_cache[k].shape == (tc.num_layers, 3, S, 4, 16)
    assert tuple(te_._recurrent_state(1)["ck"].shape) == \
        (tc.num_layers, 1, S, 4, 16)
    te_.run([Request(rid=0, prompt=np.arange(1, 6, dtype=np.int32),
                     max_new=3)])
    assert not te_._extra_cache["ck"].any()
    assert not te_._extra_cache["cv"].any()


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("sparse", [False, True])
def test_engine_tokens_match_the_reference_engine(paged, sparse):
    """whisper served stepwise (no fused prefill), three requests on two
    slots, paged and contiguous, dense and with a plan (block = page 16):
    the tokens equal the reference engine's."""
    jc, tc = encdec_configs(remat=False)
    jp, tp = params(jc, tc)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, tc.vocab_size, size=n).astype(np.int32)
               for n in (5, 11, 3)]
    kw = {}
    if sparse:
        from repro.core.sparse_attention import build_sparsity_plan as jplan
        from repro_torch.core.sparse_attention import \
            build_sparsity_plan as tplan
        tab = tables(jc, 6)
        kw = dict(jspion=jplan(tab["col_idx"], tab["nvalid"], BLOCK),
                  tspion=tplan(tab["col_idx"], tab["nvalid"], BLOCK))
    je_ = JEngine(jc, jp, slots=2, max_len=S, paged=paged,
                  spion=kw.get("jspion"))
    te_ = ServeEngine(tc, tp, slots=2, max_len=S, paged=paged,
                      spion=kw.get("tspion"), device="cpu")
    jr = [JRequest(rid=i, prompt=p.copy(), max_new=4)
          for i, p in enumerate(prompts)]
    tr = [Request(rid=i, prompt=p.copy(), max_new=4)
          for i, p in enumerate(prompts)]
    je_.run(jr)
    te_.run(tr)
    assert [r.out for r in tr] == [r.out for r in jr]
    assert te_.prefill_fused == 0 and te_.prefill_stepwise_tokens == 19
