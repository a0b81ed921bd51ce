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
from torch_parity import configs, params, random_blockmask, to_np

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
    with pytest.raises(NotImplementedError, match="prefix sharing"):
        ServeEngine(tc, tp, share_prefix=True, device="cpu")
    with pytest.raises(NotImplementedError, match="sliding window"):
        ServeEngine(tc.replace(sliding_window=32), tp, device="cpu")
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

