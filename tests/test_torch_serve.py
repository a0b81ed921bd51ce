"""Port parity, serving: the continuous-batching ServeEngine of the port
against the JAX package's, on the same requests with the same parameters —
paged and contiguous caches, dense and sparse plans — plus the page pool's
allocator and the engine's refusals (what this slice does not port, and
requests that could never be served)."""
import numpy as np
import pytest
import torch

from repro.core.sparse_attention import bcsr_from_blockmask
from repro.core.sparse_attention import build_sparsity_plan as j_plan
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JEngine
from repro_torch.core.kv_pool import SCRATCH_PAGE, PagePool
from repro_torch.core.sparse_attention import build_sparsity_plan as t_plan
from repro_torch.launch.serve import Request, ServeEngine
from torch_parity import (arch_configs, configs, params, random_blockmask,
                          to_np)

MAX_LEN, BLOCK = 64, 16
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 6e-2}


def _recorder(fn, out):
    """Wrap an engine's step function to keep the logits it returns."""
    def wrapped(*a, **kw):
        res = fn(*a, **kw)
        out.append(to_np(res[0]))
        return res
    return wrapped


def _plan_tables(jc, seed=0):
    rng = np.random.default_rng(seed)
    nrb = MAX_LEN // BLOCK
    bs = [bcsr_from_blockmask(random_blockmask(rng, nrb, causal=True), BLOCK,
                              max_k=nrb) for _ in range(jc.num_layers)]
    return (np.stack([np.asarray(b.col_idx) for b in bs]),
            np.stack([np.asarray(b.nvalid) for b in bs]))


def _serve_both(dtype, paged, sparse, num_pages=None):
    jc, tc = configs(dtype)
    jp, tp = params(jc, tc)
    rng = np.random.default_rng(11)
    lens, news = (5, 17, 9, 30), (4, 6, 3, 5)
    prompts = [rng.integers(0, jc.vocab_size, size=n).astype(np.int32)
               for n in lens]
    kw = dict(slots=2, max_len=MAX_LEN, paged=paged, num_pages=num_pages)
    jspion = tspion = None
    if sparse:
        col, nv = _plan_tables(jc)
        jspion, tspion = j_plan(col, nv, BLOCK), t_plan(col, nv, BLOCK)
    je = JEngine(jc, jp, spion=jspion,
                 share_prefix=False if paged else None, **kw)
    te = ServeEngine(tc, tp, spion=tspion, device="cpu", **kw)
    logits = {}
    for name, eng in (("jax", je), ("torch", te)):
        logits[name] = ([], [])
        eng._prefill = _recorder(eng._prefill, logits[name][0])
        eng._decode = _recorder(eng._decode, logits[name][1])
    jreqs = [JRequest(rid=i, prompt=p, max_new=m)
             for i, (p, m) in enumerate(zip(prompts, news))]
    treqs = [Request(rid=i, prompt=p.copy(), max_new=m)
             for i, (p, m) in enumerate(zip(prompts, news))]
    je.run(jreqs)
    te.run(treqs)
    return je, te, jreqs, treqs, logits


CASES = [
    # (dtype, paged, sparse, num_pages)
    ("float32", True, False, None),
    ("float32", True, True, None),
    ("float32", False, False, None),
    ("float32", False, True, None),
    ("float32", True, True, 5),          # too few pages: requests queue
    ("bfloat16", True, True, None),
]


@pytest.mark.parametrize("dtype,paged,sparse,num_pages", CASES)
def test_engine_matches_reference_engine(dtype, paged, sparse, num_pages):
    je, te, jreqs, treqs, logits = _serve_both(dtype, paged, sparse,
                                               num_pages)
    for j, t in zip(jreqs, treqs):
        assert t.done and t.slot == j.slot
        assert t.out == j.out, (t.rid, t.out, j.out)
    assert te.prefill_fused == je.prefill_fused == len(treqs)
    for stage, (jl, tl) in enumerate(zip(logits["jax"], logits["torch"])):
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a, b, atol=LOGIT_TOL[dtype], rtol=0,
                                       err_msg=f"stage {stage}")
    # what the last requests left in their slots (prompt + fed tokens)
    for t in treqs[-2:]:
        n = len(t.prompt) + t.max_new - 1
        for got, want in zip(te.slot_kv(t.slot, n), je.slot_kv(t.slot, n)):
            np.testing.assert_allclose(to_np(got), to_np(want),
                                       atol=LOGIT_TOL[dtype], rtol=0)


def test_engine_refuses_what_is_not_ported_or_cannot_be_served(monkeypatch):
    _jc, tc = configs()
    _jp, tp = params(_jc, tc)
    # the reference's refusal: ring pages are overwritten in place
    with pytest.raises(ValueError, match="sliding-window ring"):
        ServeEngine(tc.replace(sliding_window=32), tp, share_prefix=True,
                    device="cpu")
    with pytest.raises(ValueError, match="sliding-window ring"):
        JEngine(_jc.replace(sliding_window=32), _jp, share_prefix=True)
    assert ServeEngine(tc, tp, device="cpu").share_prefix
    assert not ServeEngine(tc.replace(sliding_window=32), tp,
                           device="cpu").share_prefix
    _refeed_when_every_prompt_page_is_shared(_jc, tc, _jp, tp)
    with pytest.raises(ValueError, match="params are on"):
        ServeEngine(tc, tp, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(tc, tp)
    monkeypatch.undo()
    col, nv = _plan_tables(_jc)
    eng = ServeEngine(tc, tp, slots=1, max_len=2 * MAX_LEN, num_pages=4,
                      spion=t_plan(col, nv, BLOCK), device="cpu")
    long = np.arange(40, dtype=np.int32)
    with pytest.raises(ValueError, match="cache length"):
        eng.submit(Request(rid=0, prompt=np.arange(130, dtype=np.int32)))
    with pytest.raises(ValueError, match="coverage"):
        eng.submit(Request(rid=1, prompt=long, max_new=30))
    with pytest.raises(ValueError, match="pool capacity"):
        eng.submit(Request(rid=2, prompt=long, max_new=20))


def _refeed_when_every_prompt_page_is_shared(jc, tc, jp, tp):
    """A prompt of whole pages (tail_len == 0) whose pages are all shared
    but whose first token is not cached: the last prompt position lives in
    a shared page the request must not write, so the reference recomputes
    that page privately (nshared = nfull - 1) — stepwise under the
    reference's default, the suffix being one page; through the fused
    prefill under the port's. Tokens as the reference's, and prefix_stats
    too where both take the stepwise path."""
    rng = np.random.default_rng(5)
    long = rng.integers(1, tc.vocab_size, size=2 * 32 + 5).astype(np.int32)
    stats = []
    kw = dict(slots=1, max_len=MAX_LEN * 2)
    for eng, req in ((JEngine(jc, jp, **kw), JRequest),
                     (ServeEngine(tc, tp, stepwise_suffix_max=2 * 32,
                                  device="cpu", **kw), Request),
                     (ServeEngine(tc, tp, device="cpu", **kw), Request)):
        a = req(rid=0, prompt=long, max_new=3)
        b = req(rid=1, prompt=long[:64].copy(), max_new=3)
        eng.run([a])
        eng.run([b])
        stats.append((a.out, b.out, eng.prefix_stats,
                      eng.page_tables[0][:2].tolist()))
    (ja, jb, jst, _), (ta, tb, tst, row), (fa, fb, fst, frow) = stats
    assert (ta, tb) == (ja, jb) == (fa, fb) and tst == jst
    assert tst["lookups"] == 4 and tst["hits"] == 2
    assert tst["prefill_fused"] == 1
    assert tst["prefill_stepwise_tokens"] == 32
    assert row[0] != row[1]
    assert fst["lookups"] == 4 and fst["hits"] == 2
    assert fst["prefill_fused"] == 2 and fst["prefill_stepwise_tokens"] == 0
    assert frow[0] != frow[1]


def test_page_pool_allocator():
    pool = PagePool(layers=1, num_pages=4, page=2, kv_heads=1, head_dim=2,
                    dtype=torch.float32)
    assert pool.capacity == 3 and pool.available() == 3
    got = pool.alloc(3)
    assert SCRATCH_PAGE not in got and sorted(got) == [1, 2, 3]
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc(1)
    pool.incref(got[0])
    pool.decref(got[0])
    assert pool.available() == 0 and pool.live_pages() == 3
    pool.decref(got[0])
    assert pool.available() == 1 and pool.alloc(1) == [got[0]]
    with pytest.raises(RuntimeError, match="dead page"):
        pool.decref(SCRATCH_PAGE)
    assert pool.nbytes == 2 * 4 * 2 * 2 * 4



# ---------------------------------------------------------------------------
# families without a fused prefill: hybrid (zamba2) and ssm (rwkv6)
# ---------------------------------------------------------------------------

def _family(arch, seed=0, **kw):
    jc, tc = arch_configs(arch, remat=False, **kw)
    jp, tp = params(jc, tc, seed)
    return jc, tc, jp, tp


def _run_pair(je, te, prompts, max_new):
    """The same requests through a reference and a port engine; returns
    (reference tokens, port tokens, port requests)."""
    jr = [JRequest(rid=i, prompt=p.copy(), max_new=max_new)
          for i, p in enumerate(prompts)]
    tr = [Request(rid=i, prompt=p.copy(), max_new=max_new)
          for i, p in enumerate(prompts)]
    je.run(jr)
    te.run(tr)
    return [r.out for r in jr], [r.out for r in tr], tr


def test_hybrid_stepwise_prefill_engine():
    """The reference's test of the same name, against the reference's
    engine: zamba2's paged engine prefills stepwise per request (a FRESH
    B=1 recurrent state teacher-forced and written into the slot), then
    joins the batched per-slot-position decode; tokens equal."""
    jc, tc, jp, tp = _family("zamba2-1.2b")
    prompts = [np.array([3, 1, 4, 1, 5], np.int32),
               np.array([2, 7], np.int32)]
    je = JEngine(jc, jp, slots=2, max_len=16)
    te = ServeEngine(tc, tp, slots=2, max_len=16, device="cpu")
    assert not je._can_fuse and not te._can_fuse and te.paged
    want, got, _ = _run_pair(je, te, prompts, 3)
    assert got == want


def test_engine_paged_default_reads_the_registry():
    """`paged=None` is the registry's supports_paged_cache: paged for the
    attention and hybrid families, contiguous for ssm (PR 17's engine took
    True for every family)."""
    for arch, want in (("rwkv6-7b", False), ("zamba2-1.2b", True)):
        _jc, tc, _jp, tp = _family(arch)
        assert ServeEngine(tc, tp, slots=1, max_len=32,
                           device="cpu").paged is want
    _jc, tc = configs()
    assert ServeEngine(tc, params(_jc, tc)[1], device="cpu").paged


@pytest.mark.parametrize("arch", ["qwen2-7b", "internvl2-2b",
                                  "zamba2-1.2b", "whisper-tiny"])
def test_paged_extra_state_allocates_no_kv(arch):
    """A paged engine's per-slot extra state builds no contiguous K/V beside
    the page pool: every "k"/"v" the family's init_cache returns for it is
    empty. Pure-KV families build nothing at all; hybrid builds conv/ssm;
    encdec builds only the cross K/V, at max_len."""
    _jc, tc, _jp, tp = _family(arch)
    eng = ServeEngine(tc, tp, slots=4, max_len=MAX_LEN, device="cpu")
    assert eng.paged
    built, init = {}, eng.bundle.init_cache

    def spy(*a, **kw):
        out = init(*a, **kw)
        built.update(out)
        return out
    eng.bundle = eng.bundle._replace(init_cache=spy)
    state = eng._recurrent_state(4)
    assert built["k"].numel() == built["v"].numel() == 0
    want = {"dense": set(), "vlm": set(), "hybrid": {"conv", "ssm"},
            "audio": {"ck", "cv"}}[tc.family]
    assert set(state) == want
    assert sum(t.numel() for t in built.values()) == \
        sum(t.numel() for t in state.values())
    for k in want & {"ck", "cv"}:
        assert state[k].shape[:3] == (tc.num_layers, 4, MAX_LEN)


def test_hybrid_pool_layers_are_the_applications():
    """The hybrid pool's layer axis is the shared block's application
    (n_attn_apps), not the layer: 4 layers, the block every 2nd -> 2."""
    _jc, tc, _jp, tp = _family("zamba2-1.2b", num_layers=4)
    eng = ServeEngine(tc, tp, slots=2, max_len=32, device="cpu")
    assert eng.pool.kp.shape[0] == 2 and eng.pool.vp.shape[0] == 2
    assert set(eng._extra_cache) == {"conv", "ssm"}
    assert eng._extra_cache["conv"].shape[:2] == (4, 2)


def test_hybrid_engine_does_not_share_prefixes():
    """share_prefix defaults off without a fused prefill (recurrent state
    depends on the whole prefix), and share_prefix=True raises."""
    jc, tc, jp, tp = _family("zamba2-1.2b")
    eng = ServeEngine(tc, tp, slots=1, max_len=32, device="cpu")
    assert eng.paged and not eng.share_prefix
    for make, cfg, p in ((JEngine, jc, jp), (ServeEngine, tc, tp)):
        kw = {} if make is JEngine else {"device": "cpu"}
        with pytest.raises(ValueError, match="fused-prefill"):
            make(cfg, p, slots=1, max_len=32, share_prefix=True, **kw)


def test_engine_builds_no_fused_prefill_it_cannot_run():
    """No fused prefill is built for a family without one (the step maker
    refuses it), and the ssm family's decode steps are built dense; the
    engines still serve."""
    for arch in ("zamba2-1.2b", "rwkv6-7b"):
        _jc, tc, _jp, tp = _family(arch)
        eng = ServeEngine(tc, tp, slots=1, max_len=32, device="cpu")
        assert eng._prefill is None and not eng._can_fuse
        assert eng._spion_step is (arch != "rwkv6-7b")
        assert eng._ex_args() == ((None,) if eng._spion_step else ())
        r = Request(rid=0, prompt=np.arange(1, 6, dtype=np.int32),
                    max_new=3)
        eng.run([r])
        assert r.done and len(r.out) == 3 and eng.prefill_fused == 0


def test_hybrid_paged_request_prefills_stepwise_from_zero():
    """With no prefix covered, a hybrid request goes stepwise from position
    0 (the fused branch needs _can_fuse), whatever stepwise_suffix_max
    says."""
    _jc, tc, _jp, tp = _family("zamba2-1.2b")
    for suffix_max in (None, 0, 64):
        eng = ServeEngine(tc, tp, slots=2, max_len=32, device="cpu",
                          stepwise_suffix_max=suffix_max)
        reqs = [Request(rid=i, prompt=np.arange(1, n, dtype=np.int32),
                        max_new=2) for i, n in enumerate((9, 14))]
        eng.run(reqs)
        assert eng.prefill_fused == 0
        assert eng.prefill_stepwise_tokens == 8 + 13


@pytest.mark.parametrize("paged", [True, False])
def test_stepwise_prefill_carries_the_recurrent_state(paged):
    """The stepwise prefill writes the request's own conv/ssm states into
    its slot (paged: `_extra_cache`; contiguous: the whole fresh B=1 cache),
    so a slot reused after other requests holds what a fresh B=1 decode of
    the new prompt leaves, with no stale state. Tokens equal the reference
    engine's."""
    jc, tc, jp, tp = _family("zamba2-1.2b", seed=1)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, tc.vocab_size, size=n).astype(np.int32)
               for n in (6, 11, 4)]
    je = JEngine(jc, jp, slots=2, max_len=32, paged=paged)
    te = ServeEngine(tc, tp, slots=2, max_len=32, paged=paged, device="cpu")
    want, got, treqs = _run_pair(je, te, prompts, 4)
    assert got == want
    # a fresh B=1 run of the second prompt
    b = te.bundle
    again = treqs[1].prompt
    fresh = b.init_cache(1, 32, device="cpu")
    for t, tok in enumerate(again):
        b.decode_step(tp, fresh, torch.tensor([[int(tok)]]), t)
    state = te._extra_cache if paged else te.cache
    keys = ("conv", "ssm") if paged else tuple(fresh)
    # slot 0 served the first and the third request: its state is stale
    assert not torch.equal(state["ssm"][:, 0], fresh["ssm"][:, 0])
    # max_new=1 finishes at admission: no decode tick touches the slot
    te.submit(Request(rid=9, prompt=again.copy(), max_new=1))
    te.step()
    assert te.active == [None, None]
    for k in keys:
        assert torch.equal(state[k][:, 0], fresh[k][:, 0]), k


def test_hybrid_sparse_engine_matches_reference():
    """zamba2 served with a per-application plan (4 layers, 2 applications,
    block 16 = page): paged and contiguous, tokens equal the reference
    engine's; the stepwise prefill and decode gather only the listed
    blocks."""
    jc, tc, jp, tp = _family("zamba2-1.2b", num_layers=4)
    rng = np.random.default_rng(8)
    nrb = MAX_LEN // BLOCK
    bs = [bcsr_from_blockmask(random_blockmask(rng, nrb, causal=True), BLOCK,
                              max_k=nrb) for _ in range(2)]
    col = np.stack([np.asarray(b.col_idx) for b in bs])
    nv = np.stack([np.asarray(b.nvalid) for b in bs])
    prompts = [rng.integers(1, tc.vocab_size, size=n).astype(np.int32)
               for n in (21, 7)]
    for paged in (True, False):
        je = JEngine(jc, jp, slots=2, max_len=MAX_LEN, paged=paged,
                     spion=j_plan(col, nv, BLOCK))
        te = ServeEngine(tc, tp, slots=2, max_len=MAX_LEN, paged=paged,
                         spion=t_plan(col, nv, BLOCK), device="cpu")
        want, got, _ = _run_pair(je, te, prompts, 5)
        assert got == want, paged
        if paged:
            assert te.pool.kp.shape[0] == 2 and te.page == BLOCK
