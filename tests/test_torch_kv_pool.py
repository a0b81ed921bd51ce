"""Port parity, the paged KV cache: core.kv_pool and the paged ServeEngine
of the port against the JAX package's, on the same inputs.

The properties of tests/test_kv_pool.py, each held port against reference:
  - chain digests byte-equal; allocator state (refcounts, free list, LRU,
    registry, stats) equal after every op of random op sequences, and the
    evict-LRU and decref rules;
  - `write_target` (ring and append) and `insert_ring` equal;
  - paged dense and sparse decode bitwise equal to contiguous, with and
    without the ring, and within 3e-5 of the reference;
  - engine level: the COW fork with a cached first token, the shared system
    prompt prefilled once, ring page recycling and exhaustion queues give
    the reference engine's tokens and prefix_stats, logits within 3e-5;
  - the hybrid family's pool (its layer axis the shared block's
    application) against the contiguous engine and the reference's, and
    the ssm family's capability gate.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
from repro.core import kv_pool as jkv
from repro.core.sparse_attention import paged_sparse_decode_attention as j_psd
from repro.core.sparse_attention import sparse_decode_attention as j_sd
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JEngine
from repro.models.attention import decode_attention as j_decode
from repro.models.attention import ring_kpos as j_ring_kpos
from repro_torch.core import kv_pool as tkv
from repro_torch.core.sparse_attention import paged_sparse_decode_attention
from repro_torch.core.sparse_attention import sparse_decode_attention
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.launch.steps import causal_band_tables
from repro_torch.models.attention import (decode_attention,
                                          paged_decode_attention, ring_kpos)
from torch_parity import arch_configs, configs, params, to_np, to_torch

TOL = 3e-5     # fp32 logits and attention outputs, port vs reference


def _pools(num_pages=8, layers=1, page=4, kv=1, hd=2):
    kw = dict(layers=layers, num_pages=num_pages, page=page, kv_heads=kv,
              head_dim=hd)
    return (jkv.PagePool(dtype="float32", **kw),
            tkv.PagePool(dtype=torch.float32, **kw))


def _state(pool):
    return (pool.rc.tolist(), list(pool.free), list(pool.lru),
            dict(pool.by_hash), dict(pool.meta),
            {k: list(v) for k, v in pool.by_parent.items()},
            dict(pool.first_tok), dict(pool.stats))


def _same_state(jp, tp):
    for i, (a, b) in enumerate(zip(_state(jp), _state(tp))):
        assert a == b, (i, a, b)


# ---------------------------------------------------------------------------
# host-side: digests and the allocator, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page", [1, 4, 16])
def test_chain_digests_byte_equal(page):
    rng = np.random.default_rng(page)
    assert tkv.ROOT_DIGEST == jkv.ROOT_DIGEST
    for n in (1, page, 3 * page, 3 * page + 2, 50):
        p = rng.integers(0, 50_000, size=n).astype(np.int32)
        assert tkv.chain_digests(p, page) == jkv.chain_digests(p, page)
        assert tkv._digest(b"x", p) == jkv._digest(b"x", p)


@settings(deadline=None, max_examples=20)
@given(st.integers(0, 10_000), st.integers(4, 24))
def test_allocator_state_equals_reference_under_random_ops(seed, num_pages):
    """The same random alloc / incref / decref / register / match sequence
    on both pools: refcounts, free list, LRU, registry and stats equal
    after every op, and the reference test's invariants hold."""
    rng = np.random.default_rng(seed)
    jp, tp = _pools(num_pages=num_pages)
    live = {}
    for _ in range(150):
        op = int(rng.integers(0, 6))
        if op == 0 and tp.available() > 0:
            n = int(rng.integers(1, tp.available() + 1))
            got = tp.alloc(n)
            assert jp.alloc(n) == got
            for p in got:
                assert p != tkv.SCRATCH_PAGE and p not in live
                live[p] = 1
        elif op in (1, 2) and live:
            p = int(rng.choice(sorted(live)))
            if op == 1:
                tp.incref(p)
                jp.incref(p)
                live[p] += 1
            else:
                tp.decref(p)
                jp.decref(p)
                live[p] -= 1
                if not live[p]:
                    del live[p]
        elif op == 3 and live:
            p = int(rng.choice(sorted(live)))
            toks = tuple(int(t) for t in rng.integers(0, 9, size=4))
            parent = bytes([int(rng.integers(0, 3))])
            d = jkv._digest(parent, np.asarray(toks, np.int32))
            for pool in (jp, tp):
                pool.register_full(p, d, parent, toks)
        elif op == 4 and live:
            p = int(rng.choice(sorted(live)))
            toks = tuple(int(t) for t in rng.integers(0, 9, size=2))
            for pool in (jp, tp):
                pool.register_tail(p, jkv.ROOT_DIGEST, toks)
        elif op == 5:
            prompt = rng.integers(0, 9, size=int(rng.integers(1, 10)))
            assert tp.match_prefix(prompt) == jp.match_prefix(prompt)
        _same_state(jp, tp)
        assert len(tp.free) + len(tp.lru) + len(live) == tp.capacity
        assert not (set(tp.free) | set(tp.lru)) & set(live)
    for p, rc in list(live.items()):
        for _ in range(rc):
            tp.decref(p)
            jp.decref(p)
    _same_state(jp, tp)
    assert tp.available() == tp.capacity and tp.live_pages() == 0


def test_evict_lru_and_decref_rules():
    """Registered pages at refcount 0 go to the LRU (revivable), others to
    the free list; an exhausted free list evicts the LRU's oldest page and
    unregisters it — the same on both pools."""
    jp, tp = _pools(num_pages=4)
    for pool in (jp, tp):
        a, b, c = pool.alloc(3)
        with pytest.raises(RuntimeError, match="exhausted"):
            pool.alloc(1)
        pool.register_full(b, b"db", b"p", (9,))
        pool.register_full(c, b"dc", b"db", (8,))
        pool.decref(a)
        pool.decref(b)
        pool.decref(c)
        assert a in pool.free and b in pool.lru and c in pool.lru
        pool.incref(b)               # revival keeps the registration
        assert b not in pool.lru and pool.rc[b] == 1
        assert pool.by_hash[b"db"] == b
        assert pool.alloc(2) == [a, c]   # free first, then the LRU
        assert pool.stats["evictions"] == 1
        assert b"dc" not in pool.by_hash and b"db" not in pool.by_parent
    _same_state(jp, tp)
    with pytest.raises(RuntimeError, match="dead page"):
        tp.decref(tkv.SCRATCH_PAGE)


@pytest.mark.parametrize("ring", [False, True])
def test_write_target_ring_and_append(ring):
    pt = np.array([[3, 7, -1, -1], [5, 6, 8, 9]], np.int32)
    for p in range(0, 40, 3):
        posb = np.array([p, p + 1], np.int32)
        phys, off = tkv.write_target(torch.as_tensor(pt),
                                     torch.as_tensor(posb), 4, ring=ring)
        jphys, joff = jkv.write_target(jnp.asarray(pt), jnp.asarray(posb), 4,
                                       ring=ring)
        assert phys.tolist() == np.asarray(jphys).tolist()
        assert off.tolist() == np.asarray(joff).tolist()
    # the reference test's cases
    phys, off = tkv.write_target(torch.as_tensor(pt[:1]),
                                 torch.as_tensor([17]), 4, ring=ring)
    assert (int(phys[0]), int(off[0])) == ((3, 1) if ring else (0, 1))


@pytest.mark.parametrize("plen", [16, 23, 37])
def test_insert_ring_and_copy_page(plen):
    """The ring-layout prefill insert and the COW page copy give
    the reference pool's pages bitwise."""
    rng = np.random.default_rng(plen)
    L, pg, KV, hd, Sp = 2, 4, 2, 3, 40
    jp, tp = _pools(num_pages=9, layers=L, page=pg, kv=KV, hd=hd)
    ks = rng.standard_normal((L, 1, Sp, KV, hd)).astype(np.float32)
    vs = rng.standard_normal((L, 1, Sp, KV, hd)).astype(np.float32)
    phys = np.array([6, 2, 8, 3], np.int32)      # a ring of 16 positions
    tp.insert_ring(to_torch(ks), to_torch(vs), phys, plen)
    jp.insert_ring(jnp.asarray(ks), jnp.asarray(vs), phys, plen)
    tp.copy_page(8, 5)
    jp.copy_page(8, 5)
    for a, b in ((tp.kp, jp.kp), (tp.vp, jp.vp)):
        assert np.array_equal(to_np(a), to_np(b))
    assert tp.stats == jp.stats
    # slot 0 of the ring holds the latest prompt position = 0 (mod 16)
    assert np.array_equal(to_np(tp.kp[:, 6, 0]),
                          ks[:, 0, ((plen - 1) // 16) * 16])


# ---------------------------------------------------------------------------
# function level: paged decode vs contiguous, port vs reference
# ---------------------------------------------------------------------------

def _decode_inputs(cfg, seed):
    hd, KV, H = cfg.resolved_head_dim, cfg.num_kv_heads, cfg.num_heads
    B, page, NB = 3, 8, 4
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, NB * page, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, NB * page, KV, hd)).astype(np.float32)
    posb = np.array([5, 17, 30], np.int32)
    if cfg.sliding_window:
        posb = np.array([5, 41, 70], np.int32)     # two rows have wrapped
    pt = (1 + np.arange(B * NB, dtype=np.int32)).reshape(B, NB)
    kp = np.zeros((1, 1 + B * NB, page, KV, hd), np.float32)
    vp = np.zeros_like(kp)
    kp[0, pt] = kc.reshape(B, NB, page, KV, hd)
    vp[0, pt] = vc.reshape(B, NB, page, KV, hd)
    return q, kc, vc, posb, pt, kp, vp, page


@pytest.mark.parametrize("ring", [False, True])
def test_paged_dense_decode_bitwise_vs_contiguous(ring):
    jc, tc = configs(sliding_window=32 if ring else None)
    q, kc, vc, posb, pt, kp, vp, page = _decode_inputs(tc, 0)
    S = kc.shape[1]
    t = [to_torch(a) for a in (q, kc, vc, posb)]
    kpos = ring_kpos(t[3], S) if ring else None
    ref = decode_attention(tc, *t, kpos=kpos)
    out = paged_decode_attention(tc, t[0], to_torch(kp), to_torch(vp), 0,
                                 t[3], to_torch(pt), page=page)
    assert torch.equal(out, ref)
    jkpos = j_ring_kpos(jnp.asarray(posb), S) if ring else None
    want = j_decode(jc, *(jnp.asarray(a) for a in (q, kc, vc, posb)),
                    kpos=jkpos)
    np.testing.assert_allclose(to_np(out), to_np(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("ring", [False, True])
def test_paged_sparse_decode_bitwise_vs_contiguous(ring):
    jc, tc = configs(sliding_window=32 if ring else None)
    q, kc, vc, posb, pt, kp, vp, page = _decode_inputs(tc, 1)
    nrb = 12 if ring else 4          # the ring's rows reach position 70
    tabs = causal_band_tables(1, nrb, width=2)
    col, nval = tabs["col_idx"][0], tabs["nvalid"][0]
    t = [to_torch(a) for a in (q, kc, vc, posb, col, nval)]
    ref = sparse_decode_attention(tc, *t, block=page, ring=ring)
    out = paged_sparse_decode_attention(
        tc, t[0], to_torch(kp), to_torch(vp), 0, t[3], to_torch(pt), t[4],
        t[5], page=page, ring=ring)
    assert torch.equal(out, ref)
    ja = [jnp.asarray(a) for a in (q, kc, vc, posb, col, nval)]
    np.testing.assert_allclose(
        to_np(out), to_np(j_sd(jc, *ja, block=page, ring=ring)), atol=TOL,
        rtol=0)
    want = j_psd(jc, ja[0], jnp.asarray(kp), jnp.asarray(vp), jnp.int32(0),
                 ja[3], jnp.asarray(pt), ja[4], ja[5], page=page, ring=ring)
    np.testing.assert_allclose(to_np(out), to_np(want), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# engine level: port engine vs reference engine
# ---------------------------------------------------------------------------

def _recorded(fn, out):
    def wrapped(*a, **kw):
        res = fn(*a, **kw)
        out.append(to_np(res[0]))
        return res
    return wrapped


def _record(eng):
    """Keep every logits tensor the engine's prefill, batched decode and
    B=1 stepwise decode return."""
    log = []
    eng._prefill = _recorded(eng._prefill, log)
    eng._decode = _recorded(eng._decode, log)
    step1 = eng._decode1_step
    eng._decode1_step = lambda: _recorded(step1(), log)
    return log


class _Pair:
    """The same requests through a reference engine and a port engine."""

    def __init__(self, jc, tc, jp, tp, **kw):
        self.je = JEngine(jc, jp, **kw)
        # the reference's stepwise suffix default (2 pages), which the
        # port's engine leaves off
        kw.setdefault("stepwise_suffix_max",
                      getattr(self.je, "stepwise_suffix_max", None))
        self.te = ServeEngine(tc, tp, device="cpu", **kw)
        self.jlog, self.tlog = _record(self.je), _record(self.te)

    def run(self, prompts, max_new, rid0=0):
        jr = [JRequest(rid=rid0 + i, prompt=p.copy(), max_new=max_new)
              for i, p in enumerate(prompts)]
        tr = [Request(rid=rid0 + i, prompt=p.copy(), max_new=max_new)
              for i, p in enumerate(prompts)]
        self.je.run(jr)
        self.te.run(tr)
        for a, b in zip(jr, tr):
            assert b.out == a.out, (b.rid, b.out, a.out)
        return tr

    def check(self):
        st = self.te.prefix_stats
        assert st == self.je.prefix_stats, (st, self.je.prefix_stats)
        assert len(self.tlog) == len(self.jlog)
        for a, b in zip(self.tlog, self.jlog):
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
        return st


def _qwen(seed=0):
    jc, tc = configs(cache_dtype="float32")
    jp, tp = params(jc, tc, seed)
    return jc, tc, jp, tp


def _tokens(rng, cfg, n):
    return rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)


def test_cow_fork_with_cached_first_token():
    """The same prompt again admits with no prefill (cached first token and
    a forked tail page) and generates the donor's tokens; a prompt whose
    last token diverges shares the full page and recomputes its tail — as
    the reference engine does, stats and logits alike."""
    jc, tc, jp, tp = _qwen()
    rng = np.random.default_rng(0)
    prompt = _tokens(rng, tc, 40)          # one full page of 32 + 8 tail
    pair = _Pair(jc, tc, jp, tp, slots=2, max_len=128)
    (a,) = pair.run([prompt], 5)
    (b,) = pair.run([prompt], 5, rid0=1)
    assert b.out == a.out
    st = pair.check()
    assert st["prefill_reused"] == 1 and st["forks"] >= 1
    assert st["prefill_fused"] == 1 and st["prefix_hit_rate"] > 0
    p2 = prompt.copy()
    p2[-1] = (p2[-1] + 1) % tc.vocab_size
    pair.run([p2], 5, rid0=2)
    st = pair.check()
    assert st["prefill_stepwise_tokens"] == 8


def test_shared_system_prompt_prefilled_once():
    jc, tc, jp, tp = _qwen()
    rng = np.random.default_rng(1)
    sys_p = _tokens(rng, tc, 64)
    prompts = [np.concatenate([sys_p, _tokens(rng, tc, 5)])
               for _ in range(3)]
    pair = _Pair(jc, tc, jp, tp, slots=2, max_len=128)
    pair.run(prompts, 4)
    st = pair.check()
    assert st["prefill_fused"] == 1 and st["prefix_hit_rate"] > 0
    assert st["prefix_tokens_reused"] >= 2 * 2 * 32


def test_shared_system_prompt_with_fused_suffixes():
    """stepwise_suffix_max=0 (the port's default): every uncovered suffix
    takes the fused prefill, which leaves the shared pages alone — the
    reference engine at the same setting gives the same tokens, stats and
    logits, and fewer pages are allocated than without sharing."""
    jc, tc, jp, tp = _qwen()
    assert ServeEngine(tc, tp, device="cpu").stepwise_suffix_max == 0
    rng = np.random.default_rng(1)
    sys_p = _tokens(rng, tc, 64)
    prompts = [np.concatenate([sys_p, _tokens(rng, tc, 5)])
               for _ in range(3)]
    pair = _Pair(jc, tc, jp, tp, slots=2, max_len=128, stepwise_suffix_max=0)
    pair.run(prompts, 4)
    st = pair.check()
    assert st["prefill_fused"] == 3 and st["prefill_stepwise_tokens"] == 0
    assert st["prefix_hit_rate"] > 0
    assert st["prefix_tokens_reused"] == 2 * 2 * 32
    base = ServeEngine(tc, tp, slots=2, max_len=128, share_prefix=False,
                       device="cpu")
    base.run([Request(rid=i, prompt=p.copy(), max_new=4)
              for i, p in enumerate(prompts)])
    assert pair.te.pool.stats["allocs"] < base.pool.stats["allocs"]


def test_ring_page_recycling_fixed_page_set():
    """Sliding-window decode recycles the slot's own pages across rotations
    and gives the reference's tokens, paged and contiguous."""
    jc = jcfgs.get_config("mixtral-8x7b").reduced().replace(
        dtype="float32", cache_dtype="float32")
    tc = tcfgs.get_config("mixtral-8x7b").reduced().replace(
        dtype="float32", cache_dtype="float32")
    jp, tp = params(jc, tc, seed=1)
    prompt = _tokens(np.random.default_rng(2), tc, 70)
    pair = _Pair(jc, tc, jp, tp, slots=1, max_len=64, page_size=16)
    te = pair.te
    r = Request(rid=0, prompt=prompt, max_new=8)
    te.submit(r)
    te.step()
    pages0 = set(te.page_tables[0][te.page_tables[0] >= 0].tolist())
    assert len(pages0) == 4
    while not r.done:
        te.step()
    assert set(te.page_tables[0][te.page_tables[0] >= 0].tolist()) == pages0
    assert te.pool.stats["allocs"] == 4
    jr = JRequest(rid=0, prompt=prompt.copy(), max_new=8)
    pair.je.run([jr])
    assert r.out == jr.out
    pair.check()
    ec = ServeEngine(tc, tp, slots=1, max_len=64, paged=False, device="cpu")
    rc = Request(rid=0, prompt=prompt.copy(), max_new=8)
    ec.run([rc])
    assert rc.out == r.out


def test_pool_exhaustion_queues_until_pages_free():
    jc, tc, jp, tp = _qwen()
    rng = np.random.default_rng(3)
    prompts = [_tokens(rng, tc, 40) for _ in range(3)]
    pair = _Pair(jc, tc, jp, tp, slots=4, max_len=128, num_pages=3)
    te = pair.te
    reqs = [Request(rid=i, prompt=p.copy(), max_new=4)
            for i, p in enumerate(prompts)]
    for r in reqs:
        te.submit(r)
    saw_wait = False
    while te.waiting or any(x is not None for x in te.active):
        te.step()
        saw_wait = saw_wait or bool(te.waiting)
    assert saw_wait and all(r.done for r in reqs)
    jr = [JRequest(rid=i, prompt=p.copy(), max_new=4)
          for i, p in enumerate(prompts)]
    pair.je.run(jr)
    assert [r.out for r in reqs] == [r.out for r in jr]
    pair.check()
    with pytest.raises(ValueError, match="page budget"):
        te.submit(Request(rid=9, prompt=np.arange(1, 70, dtype=np.int32),
                          max_new=30))


# ---------------------------------------------------------------------------
# the hybrid family's pool (layer axis = application) and the ssm gate
# ---------------------------------------------------------------------------

def test_engine_paged_hybrid_matches_contiguous():
    """The reference's test of the same name: zamba2 (fp32 cache), paged
    and contiguous engines give the same tokens; here both also equal the
    reference's paged engine's, and every logit the stepwise prefill and
    the decode return is within TOL of the reference's."""
    jc, tc = arch_configs("zamba2-1.2b", remat=False,
                          cache_dtype="float32")
    jp, tp = params(jc, tc, seed=2)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, tc.vocab_size, size=n).astype(np.int32)
               for n in (9, 17)]
    outs, logs = {}, {}
    for name, paged in (("paged", True), ("contiguous", False),
                        ("reference", True)):
        if name == "reference":
            eng, req = JEngine(jc, jp, slots=2, max_len=64), JRequest
        else:
            eng = ServeEngine(tc, tp, slots=2, max_len=64, paged=paged,
                              device="cpu")
            req = Request
        log = logs[name] = []
        eng._decode = _recorded(eng._decode, log)
        step1 = eng._decode1_step
        eng._decode1_step = lambda s=step1, lg=log: _recorded(s(), lg)
        reqs = [req(rid=i, prompt=p.copy(), max_new=4)
                for i, p in enumerate(prompts)]
        eng.run(reqs)
        outs[name] = [r.out for r in reqs]
    assert outs["paged"] == outs["contiguous"] == outs["reference"]
    assert len(logs["paged"]) == len(logs["reference"])
    for a, b in zip(logs["paged"], logs["reference"]):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)


def test_paged_capability_gate():
    """The reference's test of the same name: rwkv6-7b's bundle has
    neither capability, and the engine refuses paged=True and spion=."""
    jc, tc = arch_configs("rwkv6-7b", remat=False)
    _jp, tp = params(jc, tc)
    from repro_torch.models.registry import build
    b = build(tc)
    assert not b.supports_paged_cache and not b.supports_sparse_decode
    with pytest.raises(NotImplementedError,
                       match="supports_paged_cache|recurrent"):
        ServeEngine(tc, tp, slots=1, max_len=32, paged=True, device="cpu")
    with pytest.raises(NotImplementedError, match="recurrent"):
        ServeEngine(tc, tp, slots=1, max_len=32, spion={"block": 8},
                    device="cpu")
