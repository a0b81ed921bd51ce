"""Port parity, the kernel autotuner: `kernels/dispatch.KernelConfig` and
`kernels/autotune.py` of the port against the JAX package's, case for case
with tests/test_autotune.py.

The two contracts the cache lives by, as in the reference:

  1. A KernelConfig changes speed only: tuned and default outputs (forward
     and gradients) are bitwise identical. On the CPU the wrappers run the
     kernels' plain versions, which ignore the config, so these tests hold
     the mechanics; chip_smoke.py holds every candidate's o, lse, dq, dk
     and dv bitwise against the default's on the card.
  2. The on-disk cache degrades loudly, never fatally: corrupt, stale or
     unknown-field entries warn and fall back to the default config.

Plus the keys (the reference's sha256 digest for the same tables, its file
names but for the backend), the candidate sets and the shared-memory
formula that bounds them, and the seams: SparseAttentionExec looks the
cache up when constructed (keyed by the kernels' dtype), the steps, the
controller and the serving engine hand the config on.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse_attention import bcsr_from_blockmask
from repro.core.sparse_attention import build_sparsity_plan as j_plan
from repro.kernels import autotune as jtune
from repro_torch.configs import get_config
from repro_torch.core.attention_exec import SparseAttentionExec
from repro_torch.core.sparse_attention import BCSR
from repro_torch.core.sparse_attention import build_sparsity_plan as t_plan
from repro_torch.kernels import autotune
from repro_torch.kernels import block_sparse_attn as bsa
from repro_torch.kernels.dispatch import (DEFAULT_CONFIG, MAX_DEPTH,
                                          KernelConfig, compiled_backend)
from repro_torch.kernels.ops import spion_attention_kernel
from torch_parity import random_blockmask

# the qwen2-7b serving shape on the card: hd 128, block 128, G 7, K 16
SERVE_SHAPE = dict(hd=128, block=128, G=7, K=16, KT=16)


@pytest.fixture(autouse=True)
def _isolated_cache(tmp_path, monkeypatch):
    """Every test gets a private cache dir; never touch ~/.cache."""
    monkeypatch.setenv("SPION_AUTOTUNE_DIR", str(tmp_path / "autotune"))
    monkeypatch.delenv("SPION_AUTOTUNE", raising=False)
    yield


def _tables(rng, n=8, block=32, density=0.5):
    """(numpy tables dict, the reference's BCSR) of a seeded block mask."""
    b = bcsr_from_blockmask(random_blockmask(rng, n, density), block)
    return {"col_idx": np.array(b.col_idx),
            "nvalid": np.array(b.nvalid)}, b


def _qkv(b, hd=16, N=2, G=1, seed=0):
    rng = np.random.default_rng(seed)
    S = b.col_idx.shape[0] * b.block
    q = torch.as_tensor(rng.standard_normal((N, G, S, hd), np.float32))
    k = torch.as_tensor(rng.standard_normal((N, S, hd), np.float32))
    v = torch.as_tensor(rng.standard_normal((N, S, hd), np.float32))
    return q, k, v


def _run(tables, block, config, q, k, v):
    col = torch.as_tensor(tables["col_idx"]).clamp(min=0).to(torch.int32)
    nvalid = torch.as_tensor(tables["nvalid"]).to(torch.int32)
    return bsa.fused_block_sparse_attention(q, k, v, col, nvalid, block=block,
                                            config=config)


# ---------------------------------------------------------------------------
# contract 1: configs are scheduling-only — bitwise identity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", [KernelConfig(depth=1),
                                    KernelConfig(depth=3, num_warps=8),
                                    KernelConfig(depth=MAX_DEPTH,
                                                 num_warps=4)],
                         ids=lambda c: autotune.describe(c))
def test_tuned_vs_default_bitwise(config, rng):
    """Forward and gradients (q, k, v) through the differentiable op under
    a config equal the default config's bit for bit."""
    tables, b = _tables(rng)

    def grads(cfg):
        q, k, v = (t.requires_grad_() for t in _qkv(b))
        o = _run(tables, b.block, cfg, q, k, v)
        (o ** 2).sum().backward()
        return o.detach(), q.grad, k.grad, v.grad

    for got, want in zip(grads(config), grads(DEFAULT_CONFIG)):
        assert autotune._bitwise_equal(got, want)


def test_config_json_roundtrip():
    cfg = KernelConfig(depth=3, num_warps=8)
    d = cfg.to_json()
    json.dumps(d)  # must be serialisable as-is
    assert KernelConfig.from_json(d) == cfg
    assert KernelConfig.from_json(KernelConfig().to_json()) == DEFAULT_CONFIG
    assert hash(cfg) == hash(KernelConfig(depth=3, num_warps=8))


def test_config_from_json_rejects_bad_entries():
    with pytest.raises(ValueError, match="unknown"):
        KernelConfig.from_json({"depth": 2, "bogus": 1})
    # the reference's Mosaic and Triton knobs have no counterpart here
    for dropped in ("dimension_semantics", "num_stages"):
        with pytest.raises(ValueError, match="unknown"):
            KernelConfig.from_json({"depth": 2, dropped: None})
    for depth in (0, "two", MAX_DEPTH + 1, True, 2.0):
        with pytest.raises(ValueError, match="depth"):
            KernelConfig.from_json({"depth": depth})
    for warps in (6, 16, 0):
        with pytest.raises(ValueError, match="num_warps"):
            KernelConfig.from_json({"depth": 2, "num_warps": warps})


def test_config_must_be_a_kernel_config(rng):
    """The wrappers, the op and the public kernel wrapper refuse anything
    but a KernelConfig or None, as the reference's op does."""
    tables, b = _tables(rng)
    q, k, v = _qkv(b)
    col = torch.as_tensor(tables["col_idx"]).clamp(min=0).to(torch.int32)
    nvalid = torch.as_tensor(tables["nvalid"]).to(torch.int32)
    for bad in ({"depth": 2}, 2, "default"):
        with pytest.raises(TypeError, match="KernelConfig"):
            _run(tables, b.block, bad, q, k, v)
        with pytest.raises(TypeError, match="KernelConfig"):
            bsa.block_sparse_fwd(q, k, v, col, nvalid, block=b.block,
                                 config=bad)
    cfg = get_config("spion-lra").reduced()
    S = col.shape[0] * b.block
    x = torch.zeros((2, S, 2, 16))
    with pytest.raises(TypeError, match="KernelConfig"):
        spion_attention_kernel(cfg, x, x, x, BCSR(col, nvalid, b.block, S),
                               config=(2, None))


def test_compiled_backend():
    assert compiled_backend(torch.zeros(1)) is None
    assert compiled_backend("cpu") is None
    assert compiled_backend(torch.device("cuda", 0)) == "cuda"
    assert compiled_backend("cuda") == "cuda"


# ---------------------------------------------------------------------------
# the knobs on the card: shared memory and what each kernel takes
# ---------------------------------------------------------------------------

def test_smem_formula_refuses_what_does_not_fit():
    """The host's copy of the launchers' formulas: at the serving shape dQ
    with two warpgroups needs 263,344 bytes at depth 3 (more than the
    232,448 a block may have), the forward 230,580 (at its limit); depth 4
    fits nowhere there with two warpgroups; the training shape fits
    everything."""
    smem = bsa.config_smem(KernelConfig(depth=3, num_warps=8), **SERVE_SHAPE)
    assert smem == {"fwd": 230580, "dq": 263344, "dkv": 116664}
    assert not bsa.config_fits(KernelConfig(depth=3, num_warps=8),
                               **SERVE_SHAPE)
    assert bsa.smem_bytes("dq", hd=128, block=128, G=7, depth=3, nwg=2,
                          width=16) > bsa.SMEM_LIMIT
    assert bsa.config_fits(KernelConfig(depth=3, num_warps=4),
                           **SERVE_SHAPE)
    # the default is today's launch: depth 2, the warpgroup rule (2 here)
    assert bsa.config_smem(DEFAULT_CONFIG, **SERVE_SHAPE) == bsa.config_smem(
        KernelConfig(depth=2, num_warps=8), **SERVE_SHAPE)
    train = dict(hd=16, block=64, G=1, K=19, KT=19)
    assert all(bsa.config_fits(c, **train)
               for c in autotune.candidate_grid("cuda", torch.bfloat16))
    with pytest.raises(ValueError, match="kind"):
        bsa.smem_bytes("dx", hd=16, block=64, G=1, depth=2, nwg=0, width=4)


def test_launch_config_clamps_depth_and_resolves_warpgroups():
    """The depth as launched never exceeds the table width (the reference's
    _depth); num_warps picks one or two warpgroups for the forward and dQ,
    and dK/dV keeps its own."""
    c = KernelConfig(depth=4, num_warps=4)
    assert bsa.launch_config("fwd", c, 2) == (2, 1)
    assert bsa.launch_config("dq", c, 0) == (1, 1)
    assert bsa.launch_config("dkv", c, 9) == (4, 0)
    assert bsa.launch_config("fwd", DEFAULT_CONFIG, 9) == (2, 0)
    assert bsa.launch_config("dq", KernelConfig(num_warps=8), 9) == (2, 2)


def test_launch_refuses_before_the_launch():
    """On CUDA tensors the wrappers resolve the launch before they launch:
    a config that does not fit raises ValueError naming shared memory, and
    the fp32 (scalar) kernels take the default config alone."""
    class Q:
        shape = (4, 7, 2048, 128)
        dtype = torch.bfloat16
    with pytest.raises(ValueError, match="shared memory"):
        bsa._launch_config("dq", Q, KernelConfig(depth=3, num_warps=8),
                           block=128, width=16)
    assert bsa._launch_config("fwd", Q, KernelConfig(depth=3, num_warps=8),
                              block=128, width=16) == (3, 2)
    Q.dtype = torch.float32
    assert bsa._launch_config("fwd", Q, DEFAULT_CONFIG, block=128,
                              width=16) == (2, 0)
    with pytest.raises(ValueError, match="default config"):
        bsa._launch_config("fwd", Q, KernelConfig(depth=1), block=128,
                           width=16)


def test_the_c_entry_points_take_depth_and_warpgroups():
    """The bf16 launchers size their ring from the depth they are given
    (no fixed stage count is left) and the library exports the shared
    memory of a launch; ctypes declares the two new ints of every entry."""
    csrc = bsa._CSRC
    text = {p.name: p.read_text() for p in csrc.glob("*.cu*")}
    assert not any("kStages" in t for t in text.values())
    assert "spion_sm90_smem_bytes" in text["block_sparse_fwd_bf16.cu"]
    for kind in ("fwd", "dq", "dkv"):
        sm90 = text[f"block_sparse_{kind}_sm90.cuh"]
        assert "i % depth" in sm90 and "(i / depth) & 1" in sm90
        assert "kMaxSmemBytes" in sm90
    assert "p.depth = depth;" in text["block_sparse_common.cuh"]
    assert "p.nwg = nwg;" in text["block_sparse_common.cuh"]
    assert "int depth, int nwg" in text["block_sparse_fwd.cuh"]
    assert "p.depth = depth;" in text["block_sparse_fwd_bf16.cu"]
    # the default depth is fixed at compile time; any other is read at
    # launch, from kernels built in files of their own
    for name in ("fwd_bf16", "fwd_bf16_bn128", "dq_bf16", "dq_bf16_bn128",
                 "dkv_bf16", "dkv_bf16_wg2"):
        assert "kDefaultDepth" in text[f"block_sparse_{name}.cu"]
        assert "_anydepth" in text[f"block_sparse_{name}_anydepth.cu"]


# ---------------------------------------------------------------------------
# contract 2: cache IO — keys, roundtrip, loud fallback
# ---------------------------------------------------------------------------

def test_pattern_digest_equals_the_reference(rng):
    """The same sha256 hex as the JAX package's for the same tables: bare
    BCSR tables (numpy or torch), a plan's tables with row_idx / nvalid_t,
    and stacked (Ly, nrb, K) tables; another pattern or block differs."""
    tables, b = _tables(rng)
    torch_tables = {k: torch.as_tensor(v) for k, v in tables.items()}
    want = jtune.pattern_digest(tables, b.block)
    assert autotune.pattern_digest(tables, b.block) == want
    assert autotune.pattern_digest(torch_tables, b.block) == want
    jp = j_plan(tables["col_idx"], tables["nvalid"], b.block)
    tp = t_plan(tables["col_idx"], tables["nvalid"], b.block)
    assert autotune.pattern_digest(tp.tables, b.block) == \
        jtune.pattern_digest(jp.tables, b.block)
    assert autotune.pattern_digest(tp.tables, b.block) != want
    masks = [random_blockmask(rng, 8) for _ in range(3)]
    bs = [bcsr_from_blockmask(m, b.block, max_k=8) for m in masks]
    stacked = {"col_idx": np.stack([np.array(x.col_idx) for x in bs]),
               "nvalid": np.stack([np.array(x.nvalid) for x in bs])}
    assert autotune.pattern_digest(
        {k: torch.as_tensor(v) for k, v in stacked.items()}, b.block) == \
        jtune.pattern_digest(stacked, b.block)
    other, _ = _tables(rng, density=0.9)
    assert autotune.pattern_digest(other, b.block) != want
    assert autotune.pattern_digest(tables, b.block * 2) != want


def test_cache_path_equals_the_reference_but_for_the_backend(rng):
    tables, b = _tables(rng)
    digest = autotune.pattern_digest(tables, b.block)
    sig = autotune._shape_sig(tables, b.block)
    assert sig == jtune._shape_sig(tables, b.block)
    for tdt, jdt in ((torch.float32, jnp.float32),
                     (torch.bfloat16, jnp.bfloat16),
                     ("bfloat16", jnp.bfloat16), (np.float32, np.float32)):
        assert os.path.basename(autotune.cache_path(digest, sig, tdt,
                                                    "cpu")) == \
            os.path.basename(jtune.cache_path(digest, sig, jdt, "cpu"))
    assert autotune.cache_path(digest, sig, torch.bfloat16, "cuda").endswith(
        "__bfloat16__cuda.json")
    assert autotune._backend_name("cpu") == "cpu"
    assert autotune._backend_name(torch.device("cuda")) == "cuda"
    with pytest.raises(ValueError, match="dtype"):
        autotune.dtype_name("float13")


def test_store_lookup_roundtrip(rng):
    tables, b = _tables(rng)
    assert autotune.lookup(tables, b.block) is None  # cold miss
    cfg = KernelConfig(depth=3, num_warps=4)
    path = autotune.store(tables, b.block, cfg, best_us=12.5, swept=3)
    assert os.path.exists(path)
    assert path.startswith(autotune.cache_dir())
    assert autotune.lookup(tables, b.block) == cfg
    # a different dtype is a different key, and so is the card
    assert autotune.lookup(tables, b.block, dtype=torch.bfloat16) is None
    assert autotune.lookup(tables, b.block, device="cuda") is None
    with open(path) as f:
        entry = json.load(f)
    assert entry["backend"] == "cpu" and entry["dtype"] == "float32"
    assert not [p for p in os.listdir(autotune.cache_dir())
                if p.endswith(".tmp")]


def _rewrite(path, fn):
    with open(path) as f:
        entry = json.load(f)
    fn(entry)
    with open(path, "w") as f:
        json.dump(entry, f)


def test_corrupted_entry_warns_and_falls_back(rng):
    tables, b = _tables(rng)
    path = autotune.store(tables, b.block, KernelConfig(depth=3))
    with open(path, "w") as f:
        f.write("not json {{{")
    with pytest.warns(UserWarning, match="unusable cache entry"):
        assert autotune.lookup(tables, b.block) is None


def test_stale_version_warns_and_falls_back(rng):
    tables, b = _tables(rng)
    path = autotune.store(tables, b.block, KernelConfig(depth=3))
    _rewrite(path, lambda e: e.update(version=0))
    with pytest.warns(UserWarning, match="stale"):
        assert autotune.lookup(tables, b.block) is None


@pytest.mark.parametrize("field,match", [
    ("from_the_future", "unknown KernelConfig fields"),
    ("dimension_semantics", "unknown KernelConfig fields"),
    ("depth", "depth")])
def test_unknown_or_bad_config_field_warns_and_falls_back(field, match, rng):
    """An entry the reference would write (its Mosaic field), one from a
    later version, or one out of the port's range: a warning and the
    default, never a crash."""
    tables, b = _tables(rng)
    path = autotune.store(tables, b.block, KernelConfig(depth=3))
    _rewrite(path, lambda e: e["config"].update({field: 7}))
    with pytest.warns(UserWarning, match=match):
        assert autotune.lookup(tables, b.block) is None


def test_env_disable_skips_cache(rng, monkeypatch):
    tables, b = _tables(rng)
    autotune.store(tables, b.block, KernelConfig(depth=3))
    monkeypatch.setenv("SPION_AUTOTUNE", "0")
    assert not autotune.enabled()
    assert autotune.lookup(tables, b.block) is None
    ex = SparseAttentionExec(tables, block=b.block)
    assert ex.kernel_config is None


def test_candidate_sets_are_bounded_and_fit():
    """On the card in bf16 a grid of 8 (4 depths x 4 or 8 warps) less what
    config_fits refuses at the shape; fp32 there takes the default alone;
    the CPU sweeps 3 depths (mechanics)."""
    grid = autotune.candidate_grid("cuda", torch.bfloat16)
    assert len(grid) == 8 and len(set(grid)) == 8
    assert all(isinstance(c, KernelConfig) and 1 <= c.depth <= MAX_DEPTH
               for c in grid)
    assert autotune.candidates("cuda", torch.float32) == [DEFAULT_CONFIG]
    assert autotune.candidates("cuda", "float32", SERVE_SHAPE) == \
        [DEFAULT_CONFIG]
    fits = autotune.candidates("cuda", torch.bfloat16, SERVE_SHAPE)
    assert fits == [c for c in grid if bsa.config_fits(c, **SERVE_SHAPE)]
    assert KernelConfig(depth=3, num_warps=8) not in fits
    assert KernelConfig(depth=3, num_warps=4) in fits
    assert len(fits) == 5
    assert len(autotune.candidates("cpu")) == 3
    assert autotune.candidates() == autotune.candidates("cpu")


# ---------------------------------------------------------------------------
# the full lane: tune -> cache -> exec dispatch
# ---------------------------------------------------------------------------

def test_tune_end_to_end(rng):
    """On the CPU (mechanics only: the plain versions ignore the config):
    every candidate timed for the three kernels and bitwise-checked in o,
    lse, dq, dk and dv; the winner persisted; a lookup finds it; the
    winner's output equals the default's."""
    tables, b = _tables(rng)
    gen = torch.Generator().manual_seed(0)
    best, report = autotune.tune(tables, b.block, head_dim=16, group=2,
                                 heads=2, reps=1, device="cpu",
                                 generator=gen)
    assert [r["config"] for r in report] == [DEFAULT_CONFIG] + [
        c for c in autotune.candidates("cpu") if c != DEFAULT_CONFIG]
    assert report[0]["config"] == DEFAULT_CONFIG
    assert all(r["bitwise"] for r in report)
    assert all(r["us"] > 0 and r["dq_us"] > 0 and r["dkv_us"] > 0
               for r in report)
    assert set(report[0]["smem"]) == {"fwd", "dq", "dkv"}
    assert best == min(report, key=lambda r: r["us"])["config"]
    assert autotune.lookup(tables, b.block) == best
    q, k, v = _qkv(b)
    assert autotune._bitwise_equal(_run(tables, b.block, best, q, k, v),
                                   _run(tables, b.block, None, q, k, v))
    # a plan's tables (dK/dV over row_idx / nvalid_t) under bf16
    plan = t_plan(tables["col_idx"], tables["nvalid"], b.block)
    autotune.tune_plan(plan, head_dim=16, reps=1, device="cpu",
                       dtype=torch.bfloat16, write_cache=False)
    assert autotune.lookup(plan.tables, b.block,
                           dtype=torch.bfloat16) is None


def test_tune_disqualifies_a_candidate_that_changes_results(rng,
                                                            monkeypatch):
    """A kernel whose output moved under a candidate (a scheduling knob
    that changed arithmetic) never wins: a warning names it, the default
    or another candidate is persisted."""
    tables, b = _tables(rng)
    real = bsa.block_sparse_dq

    def faulty(*a, config=None, **kw):
        dq = real(*a, config=config, **kw)
        return dq + 1.0 if config == KernelConfig(depth=1) else dq
    monkeypatch.setattr(bsa, "block_sparse_dq", faulty)
    with pytest.warns(UserWarning, match="disqualified"):
        best, report = autotune.tune(tables, b.block, head_dim=16, reps=1,
                                     device="cpu")
    bad = [r["config"] for r in report if not r["bitwise"]]
    assert bad == [KernelConfig(depth=1)] and best != KernelConfig(depth=1)


def test_exec_construction_consults_cache(rng):
    """Construction looks the cache up once, under the kernels' dtype (a
    departure: the reference always looks up float32); coerce, from_plan
    and to() keep the config; an explicit config wins over the cache."""
    tables, b = _tables(rng)
    tuned32, tuned16 = KernelConfig(depth=1), KernelConfig(depth=3,
                                                           num_warps=4)
    autotune.store(tables, b.block, tuned32)
    autotune.store(tables, b.block, tuned16, dtype=torch.bfloat16)
    ex = SparseAttentionExec(tables, block=b.block)
    assert ex.kernel_config == tuned32 and ex.dtype == "float32"
    ex16 = SparseAttentionExec(tables, block=b.block, dtype="bfloat16")
    assert ex16.kernel_config == tuned16
    assert "kernel_config=KernelConfig(depth=3, num_warps=4)" in repr(ex16)
    assert "dtype='bfloat16'" in repr(ex16)
    assert ex16.to("cpu").kernel_config == tuned16
    assert ex16.to("cpu").dtype == "bfloat16"
    dec = SparseAttentionExec.coerce(ex16, phase="decode")
    assert dec.phase == "decode" and dec.kernel_config == tuned16
    assert ex16.phase == "train"
    payload = dict(tables, block=b.block)
    assert SparseAttentionExec.coerce(payload, dtype=torch.bfloat16) \
        .kernel_config == tuned16
    ex2 = SparseAttentionExec(tables, block=b.block,
                              kernel_config=KernelConfig(depth=4))
    assert ex2.kernel_config == KernelConfig(depth=4)
    plan = t_plan(tables["col_idx"], tables["nvalid"], b.block)
    assert SparseAttentionExec.from_plan(plan).kernel_config is None
    autotune.store(plan.tables, b.block, tuned32)
    assert SparseAttentionExec.from_plan(plan).kernel_config == tuned32


def test_exec_attend_tuned_matches_default(rng, monkeypatch):
    """attend() hands its config to the kernel wrapper (the plain versions
    here), and the tuned exec's output equals the untuned one's."""
    cfg = get_config("spion-lra").reduced()
    cfg = cfg.replace(spion=cfg.spion.__class__(
        **{**cfg.spion.__dict__, "kernel": "fused"}))
    tables, b = _tables(rng)
    autotune.store(tables, b.block, KernelConfig(depth=3))
    ex_tuned = SparseAttentionExec(tables, block=b.block)
    assert ex_tuned.kernel_config == KernelConfig(depth=3)
    monkeypatch.setenv("SPION_AUTOTUNE", "0")
    ex_plain = SparseAttentionExec(tables, block=b.block)
    assert ex_plain.kernel_config is None
    seen = []
    real = bsa.fused_block_sparse_attention

    def spy(*a, config=None, **kw):
        seen.append(config)
        return real(*a, config=config, **kw)
    monkeypatch.setattr("repro_torch.kernels.ops.fused_block_sparse_attention",
                        spy)
    S, hd = ex_tuned.coverage, 16
    r = np.random.default_rng(1)
    q = torch.as_tensor(r.standard_normal((2, S, 2, hd), np.float32))
    kv = torch.as_tensor(r.standard_normal((2, S, 2, hd), np.float32))
    layer = {k: torch.as_tensor(v) for k, v in tables.items()}
    out_t = ex_tuned.attend(cfg, q, kv, kv, layer)
    out_p = ex_plain.attend(cfg, q, kv, kv, layer)
    assert seen == [KernelConfig(depth=3), None]
    assert autotune._bitwise_equal(out_t, out_p)


def test_steps_and_controller_hand_the_config_on(rng, monkeypatch):
    """make_train_step / make_loss_and_grads / make_prefill_step pass
    `kernel_config` to a dict payload's exec, and otherwise look the cache
    up under cfg.dtype; SpionController.attention_exec looks it up under
    the dtype it is given."""
    from repro_torch.core.spion import SpionController, SpionState
    from repro_torch.launch import steps
    tables, b = _tables(rng)
    made = []
    real = steps.SparseAttentionExec

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    monkeypatch.setattr(steps, "SparseAttentionExec", Spy)
    pinned = KernelConfig(depth=4, num_warps=8)
    payload = dict(tables, block=b.block)
    steps._coerce_step_tables(payload, block=b.block, phase="train",
                              kernel_config=pinned)
    assert made[-1].kernel_config == pinned
    autotune.store(tables, b.block, KernelConfig(depth=1),
                   dtype=torch.bfloat16)
    steps._coerce_step_tables(payload, block=b.block, phase="prefill",
                              dtype="bfloat16")
    assert made[-1].kernel_config == KernelConfig(depth=1)
    cfg = get_config("spion-lra").reduced()
    ctl = SpionController(cfg.spion, causal=False, seq_len=8 * b.block)
    st = SpionState(phase="sparse", tables=payload)
    assert ctl.attention_exec(st, dtype="bfloat16").kernel_config == \
        KernelConfig(depth=1)
    assert ctl.attention_exec(st).kernel_config is None


def test_describe():
    assert autotune.describe(None) == "default"
    s = autotune.describe(KernelConfig(depth=3, num_warps=8))
    assert "depth=3" in s and "num_warps=8" in s
    assert autotune.describe(DEFAULT_CONFIG) == "depth=2"


def test_engine_execs_look_their_configs_up(rng):
    """ServeEngine builds its exec from a plan under cfg.dtype, so the full
    plan's tuned config reaches it; the sliced prefill exec of a shorter
    prompt is built without it (as in the reference) and looks its own up
    under the sliced tables' digest."""
    from repro_torch.launch.serve import ServeEngine
    from repro_torch.models.registry import build
    from torch_parity import configs
    _, tc = configs("bfloat16")
    block, nrb = 16, 4
    masks = [random_blockmask(rng, nrb, causal=True)
             for _ in range(tc.num_layers)]
    bs = [bcsr_from_blockmask(m, block, max_k=nrb) for m in masks]
    col = np.stack([np.array(x.col_idx) for x in bs])
    nvalid = np.stack([np.array(x.nvalid) for x in bs])
    plan = t_plan(col, nvalid, block)
    full, sliced = KernelConfig(depth=3), KernelConfig(depth=1, num_warps=4)
    autotune.store(plan.tables, block, full, dtype=torch.bfloat16)
    autotune.store({k: plan.tables[k][:, :2] for k in ("col_idx", "nvalid")},
                   block, sliced, dtype=torch.bfloat16)
    params = build(tc).init(torch.Generator().manual_seed(0), device="cpu")
    eng = ServeEngine(tc, params, slots=1, max_len=nrb * block, spion=plan,
                      device="cpu")
    assert eng.exec.kernel_config == full and eng.exec.dtype == "bfloat16"
    assert eng._sparse_prefill_exec(nrb * block).kernel_config == full
    assert eng._sparse_prefill_exec(2 * block).kernel_config == sliced
    assert eng._sparse_prefill_exec(3 * block).kernel_config is None
