"""Port parity, sparse attention: host-side tables and plans (bitwise), the
gather path `bcsr_attention`, the three-step oracles of kernels/ref.py, and
the dense and sparse decode attention over contiguous and paged caches,
each against the JAX package on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import sparse_attention as jsa
from repro.kernels import ref as jref
from repro.models import attention as jatt
from repro_torch.core import sparse_attention as tsa
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ops import spion_attention_kernel as t_kernel
from repro_torch.launch.steps import causal_band_tables as t_band
from repro_torch.models import attention as tatt
from torch_parity import (FWD_TOL, assert_close, configs, normal,
                          random_blockmask, to_np, to_torch)


def _np(x):
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_tables_and_plan_are_bitwise_equal(seed):
    rng = np.random.default_rng(seed)
    n, block = 6, 16
    masks = [random_blockmask(rng, n, density=0.4, empty_rows=(seed,))
             for _ in range(3)]
    jb = [jsa.bcsr_from_blockmask(m, block, max_k=n) for m in masks]
    tb = [tsa.bcsr_from_blockmask(m, block, max_k=n) for m in masks]
    for j, t in zip(jb, tb):
        np.testing.assert_array_equal(_np(t.col_idx), np.asarray(j.col_idx))
        np.testing.assert_array_equal(_np(t.nvalid), np.asarray(j.nvalid))
        assert (t.block, t.seq_len) == (j.block, j.seq_len)
    col = np.stack([np.asarray(j.col_idx) for j in jb])
    nv = np.stack([np.asarray(j.nvalid) for j in jb])
    for got, want in zip(tsa.host_transpose_tables(col, nv, max_kt=4),
                         jsa.host_transpose_tables(col, nv, max_kt=4)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tsa.pattern_col_extents(col[0], nv[0]),
                         jsa.pattern_col_extents(col[0], nv[0])):
        np.testing.assert_array_equal(got, want)
    tplan = tsa.build_sparsity_plan(col, nv, block)
    jplan = jsa.build_sparsity_plan(col, nv, block)
    assert tplan.kt_star == jplan.kt_star and tplan.stats == jplan.stats
    for key in tsa.PLAN_TABLE_KEYS:
        np.testing.assert_array_equal(_np(tplan.tables[key]),
                                      np.asarray(jplan.tables[key]))
    tf, jf = tsa.full_bcsr(64, block), jsa.full_bcsr(64, block)
    np.testing.assert_array_equal(_np(tf.col_idx), np.asarray(jf.col_idx))
    np.testing.assert_array_equal(_np(tf.nvalid), np.asarray(jf.nvalid))


GATHER = [
    # (dtype, causal, sliding_window, row_chunk)
    ("float32", True, None, None),
    ("float32", False, None, 1),
    ("float32", True, 40, 2),
    ("bfloat16", True, None, 2),
    ("bfloat16", False, None, None),
]


@pytest.mark.parametrize("dtype,causal,sw,row_chunk", GATHER)
def test_bcsr_attention_matches_reference(dtype, causal, sw, row_chunk):
    jc, tc = configs(dtype, causal=causal, sliding_window=sw)
    rng = np.random.default_rng(4)
    B, S, H, KV, hd, blk = 2, 128, 4, 2, 16, 16
    q = normal(rng, (B, S, H, hd), dtype)
    k = normal(rng, (B, S, KV, hd), dtype)
    v = normal(rng, (B, S, KV, hd), dtype)
    mask = random_blockmask(rng, S // blk, causal=causal, empty_rows=(2,))
    jb = jsa.bcsr_from_blockmask(mask, blk)
    tb = tsa.bcsr_from_blockmask(mask, blk)
    want = jsa.bcsr_attention(jc, jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), jb, row_chunk=row_chunk)
    got = tsa.bcsr_attention(tc, to_torch(q), to_torch(k), to_torch(v), tb,
                             row_chunk=row_chunk)
    assert_close(got, want, FWD_TOL[dtype])


@pytest.mark.parametrize("causal,sw", [(True, None), (False, None),
                                       (True, 24)])
def test_three_step_oracles_match_reference(causal, sw):
    rng = np.random.default_rng(5)
    N, S, hd, blk = 2, 64, 16, 16
    q, k, v = (normal(rng, (N, S, hd)) for _ in range(3))
    col = np.asarray(jsa.bcsr_from_blockmask(
        random_blockmask(rng, S // blk, causal=causal), blk).col_idx)
    kw = dict(block=blk, causal=causal, sliding_window=sw)
    js = jref.sddmm_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(col), **kw)
    ts = tref.sddmm_ref(to_torch(q), to_torch(k), to_torch(col), **kw)
    np.testing.assert_array_equal(np.isinf(to_np(ts)), np.isinf(to_np(js)))
    fin = ~np.isinf(to_np(js))
    np.testing.assert_allclose(to_np(ts)[fin], to_np(js)[fin], atol=3e-5)
    jp = jref.sparse_softmax_ref(js, jnp.asarray(col), seq_len=S, **kw)
    tp = tref.sparse_softmax_ref(ts, to_torch(col), seq_len=S, **kw)
    assert_close(tp, jp, 3e-5)
    assert_close(tref.spmm_ref(tp, to_torch(v), to_torch(col)),
                 jref.spmm_ref(jp, jnp.asarray(v), jnp.asarray(col)), 3e-5)
    assert_close(tref.fused_ref(to_torch(q), to_torch(k), to_torch(v),
                                to_torch(col), **kw),
                 jref.fused_ref(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(col), **kw), 3e-5)


def _decode_inputs(dtype, rng, B=3, S=64, H=4, KV=2, hd=16):
    q = normal(rng, (B, 1, H, hd), dtype)
    kc = normal(rng, (B, S, KV, hd), dtype)
    vc = normal(rng, (B, S, KV, hd), dtype)
    return q, kc, vc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_contiguous_decode_matches_reference(dtype):
    """decode_attention, and sparse_decode_attention on a partial pattern,
    at a scalar and at per-row positions."""
    jc, tc = configs(dtype)
    rng = np.random.default_rng(6)
    q, kc, vc = _decode_inputs(dtype, rng)
    blk = 16
    mask = random_blockmask(rng, 4, causal=True)
    b = jsa.bcsr_from_blockmask(mask, blk)
    col, nv = np.asarray(b.col_idx), np.asarray(b.nvalid)
    for pos in (np.int32(37), np.array([0, 21, 63], np.int32)):
        want = jatt.decode_attention(jc, jnp.asarray(q), jnp.asarray(kc),
                                     jnp.asarray(vc), jnp.asarray(pos))
        got = tatt.decode_attention(tc, to_torch(q), to_torch(kc),
                                    to_torch(vc), to_torch(pos))
        assert_close(got, want, FWD_TOL[dtype], f"dense pos={pos}")
        want = jsa.sparse_decode_attention(
            jc, jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(pos), jnp.asarray(col), jnp.asarray(nv), block=blk)
        got = tsa.sparse_decode_attention(
            tc, to_torch(q), to_torch(kc), to_torch(vc), to_torch(pos),
            to_torch(col), to_torch(nv), block=blk)
        assert_close(got, want, FWD_TOL[dtype], f"sparse pos={pos}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_matches_reference(dtype):
    """Dense and sparse decode through a page table with an unmapped page
    and a fully unmapped row (the NaN guard gives it zero context)."""
    jc, tc = configs(dtype)
    rng = np.random.default_rng(7)
    L, NP, page, KV, hd, B, NB = 2, 9, 16, 2, 16, 3, 4
    q = normal(rng, (B, 1, 4, hd), dtype)
    kp = normal(rng, (L, NP, page, KV, hd), dtype)
    vp = normal(rng, (L, NP, page, KV, hd), dtype)
    pt = np.array([[3, 1, 5, -1], [2, 4, 6, 8], [-1, -1, -1, -1]], np.int32)
    pos = np.array([40, 63, 7], np.int32)
    b = jsa.bcsr_from_blockmask(random_blockmask(rng, NB, causal=True), page)
    col, nv = np.asarray(b.col_idx), np.asarray(b.nvalid)
    want = jatt.paged_decode_attention(
        jc, jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), 1,
        jnp.asarray(pos), jnp.asarray(pt), page=page)
    got = tatt.paged_decode_attention(
        tc, to_torch(q), to_torch(kp), to_torch(vp), 1, to_torch(pos),
        to_torch(pt), page=page)
    assert np.all(to_np(got)[2] == 0.0)
    assert_close(got, want, FWD_TOL[dtype], "dense")
    want = jsa.paged_sparse_decode_attention(
        jc, jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), 1,
        jnp.asarray(pos), jnp.asarray(pt), jnp.asarray(col), jnp.asarray(nv),
        page=page)
    got = tsa.paged_sparse_decode_attention(
        tc, to_torch(q), to_torch(kp), to_torch(vp), 1, to_torch(pos),
        to_torch(pt), to_torch(col), to_torch(nv), page=page)
    assert_close(got, want, FWD_TOL[dtype], "sparse")


def test_update_cache_matches_reference():
    rng = np.random.default_rng(8)
    kc, vc = (normal(rng, (3, 8, 2, 4)) for _ in range(2))
    kn, vn = (normal(rng, (3, 1, 2, 4)) for _ in range(2))
    for slot in (np.int32(5), np.array([0, 7, 2], np.int32)):
        jk, jv = jatt.update_cache(jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(kn), jnp.asarray(vn),
                                   jnp.asarray(slot))
        tk, tv = tatt.update_cache(to_torch(kc), to_torch(vc), to_torch(kn),
                                   to_torch(vn), to_torch(slot))
        np.testing.assert_array_equal(to_np(tk), to_np(jk))
        np.testing.assert_array_equal(to_np(tv), to_np(jv))


def test_clamped_padding_counts_again_in_the_gather_path_only():
    """Tables with clamped padding (causal_band_tables) repeat a row's last
    block past nvalid. The gather path reads validity from col_idx >= 0 and
    counts the repeat again — in both packages alike — while the kernel
    path reads nvalid and equals dense attention."""
    jc, tc = configs()
    rng = np.random.default_rng(9)
    B, S, H, KV, hd, blk = 1, 64, 4, 2, 16, 16
    q, k, v = (normal(rng, (B, S, n, hd)) for n in (H, KV, KV))
    band = tsa.BCSR(*(to_torch(a[0]) for a in t_band(1, S // blk).values()),
                    blk, S)
    jband = jsa.BCSR(*(jnp.asarray(a[0]) for a in
                       t_band(1, S // blk).values()), blk, S)
    pos = np.arange(S)
    dense = tatt.dense_attention(tc, to_torch(q), to_torch(k), to_torch(v),
                                 to_torch(pos), to_torch(pos))
    gather = tsa.bcsr_attention(tc, to_torch(q), to_torch(k), to_torch(v),
                                band)
    assert_close(gather, jsa.bcsr_attention(jc, jnp.asarray(q),
                                            jnp.asarray(k), jnp.asarray(v),
                                            jband), 3e-5)
    assert np.abs(to_np(gather) - to_np(dense)).max() > 0.1
    kernel = t_kernel(tc, to_torch(q), to_torch(k), to_torch(v), band)
    assert_close(kernel, dense, 3e-5)


@pytest.mark.parametrize("kernel,on_card,want", [
    ("auto", False, "jnp"), ("jnp", False, "jnp"), ("fused", False, "fused"),
    ("auto", True, "fused"), ("fused", True, "fused"), ("jnp", True, None)])
def test_the_tensor_device_picks_the_sparse_path(kernel, on_card, want):
    """CUDA tensors always take the kernel and refuse "jnp"; the setting
    picks between gather and plain kernel only for CPU tensors. A stand-in
    with `is_cuda` plays the card's tensor."""
    import dataclasses
    import types

    from repro_torch.core.attention_exec import resolve_kernel
    _, tc = configs()
    cfg = tc.replace(spion=dataclasses.replace(tc.spion, kernel=kernel))
    q = types.SimpleNamespace(is_cuda=on_card)
    if want is None:
        with pytest.raises(ValueError, match="CPU tensors only"):
            resolve_kernel(cfg, q)
    else:
        assert resolve_kernel(cfg, q) == want
