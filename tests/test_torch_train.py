"""Port parity, training slice: the encoder family (spion-lra) forward and
loss, the streamed pattern capture, the optimizer pieces and the train step
against the JAX package, on the CPU at reduced size, fp32 first, then bf16.
The two trainers side by side are in tests/test_torch_trainer.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as joptim
import repro_torch.optim as toptim
from repro.core.pattern import avg_pool as j_avg_pool
from repro.core.pattern import diag_conv as j_diag_conv
from repro.core.pattern import diagonal_filter
from repro.core.sparse_attention import bcsr_from_blockmask as j_bcsr
from repro.core.sparse_attention import build_sparsity_plan as j_plan
from repro.data.synthetic import lm_batch_iterator
from repro.launch.steps import make_train_step as j_make_train_step
from repro.launch.train import masters_of as j_masters_of
from repro.models import attention as jattn
from repro.models.registry import build as jbuild
from repro_torch.convert import params_from_numpy
from repro_torch.core.sparse_attention import build_sparsity_plan as t_plan
from repro_torch.launch.steps import compute_params
from repro_torch.launch.steps import make_train_step as t_make_train_step
from repro_torch.launch.train import masters_of as t_masters_of
from repro_torch.models import attention as tattn
from repro_torch.models.layers import ParamTree
from repro_torch.models.registry import build as tbuild
from torch_parity import (BLOCK, FWD_TOL, assert_close, lra_configs, normal,
                          random_blockmask, to_np, to_torch)

S, B = 128, 2


def flat(tree, prefix=""):
    """{dotted name: leaf} of a nested dict (the ParamTree's names)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def lra_params(jc, tc, seed=0):
    jp = jbuild(jc).init(jax.random.key(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_numpy(tree, tc, device="cpu")


def batch(seed=0, n=B, seq=S, vocab=128):
    return next(lm_batch_iterator(np.random.default_rng(seed), batch=n,
                                  seq_len=seq + 1, vocab=vocab))


def test_encoder_params_are_the_reference_leaves():
    jc, tc = lra_configs()
    jp, tp = lra_params(jc, tc)
    want = flat(jax.tree_util.tree_map(np.asarray, jp))
    got = dict(tp.named_parameters())
    assert sorted(got) == sorted(want)
    assert "pos_embed.w" in got and "layers.attn_norm.bias" in got
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        np.testing.assert_array_equal(to_np(got[name]), np.asarray(
            jnp.asarray(w, jnp.float32)), err_msg=name)
    # the port's own init has the same keys, shapes and dtypes
    own = tbuild(tc).init(torch.Generator().manual_seed(0), device="cpu")
    assert {n: (tuple(p.shape), p.dtype) for n, p in own.named_parameters()} \
        == {n: (tuple(p.shape), p.dtype) for n, p in got.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse", [None, "jnp", "fused"])
def test_encoder_logits_and_loss_match_reference(dtype, sparse):
    """Dense and sparse (a random non-causal plan, through the gather and
    through the kernels' plain versions) logits and loss of the encoder."""
    jc, tc = lra_configs(dtype)
    if sparse is not None:
        jc = jc.replace(spion=dataclasses.replace(jc.spion, kernel=sparse))
        tc = tc.replace(spion=dataclasses.replace(tc.spion, kernel=sparse))
    jp, tp = lra_params(jc, tc)
    b = batch()
    if sparse is not None:
        rng = np.random.default_rng(3)
        masks = [random_blockmask(rng, S // BLOCK) for _ in
                 range(jc.num_layers)]
        tabs = [j_bcsr(m, BLOCK, max_k=S // BLOCK) for m in masks]
        col = np.stack([np.asarray(t.col_idx) for t in tabs])
        nv = np.stack([np.asarray(t.nvalid) for t in tabs])
        kw = {"spion": j_plan(col, nv, BLOCK).tables}
        tkw = {"spion": t_plan(col, nv, BLOCK).tables}
    else:
        kw, tkw = {}, {}
    jl, _ = jbuild(jc).forward(jp, {"tokens": jnp.asarray(b["tokens"])},
                               **kw)
    tl, _ = tbuild(tc).forward(tp, {"tokens": to_torch(b["tokens"])}, **tkw)
    assert tl.dtype == getattr(torch, dtype)
    assert_close(tl, jl, FWD_TOL[dtype])
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: to_torch(v) for k, v in b.items()}
    jloss, _ = jbuild(jc).loss(jp, jb, **kw)
    tloss, _ = tbuild(tc).loss(tp, tb, **tkw)
    assert tloss.dtype == torch.float32
    assert abs(tloss.item() - float(jloss)) <= FWD_TOL[dtype] * 10
    mask = np.zeros_like(b["labels"])
    mask[:, : S // 2] = 1
    jm, _ = jbuild(jc).loss(jp, dict(jb, loss_mask=jnp.asarray(mask)), **kw)
    tm, _ = tbuild(tc).loss(tp, dict(tb, loss_mask=to_torch(mask)), **tkw)
    assert abs(tm.item() - float(jm)) <= FWD_TOL[dtype] * 10


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_capture_matches_reference_and_full_map(dtype):
    """capture_pooled_scores (streamed one block row at a time) against the
    JAX package's and, in fp32, against diag_conv + avg_pool of the full
    head-and-batch-averaged attention map; then the forward's capture hook
    with the trainer's cast."""
    jc, tc = lra_configs(dtype)
    rng = np.random.default_rng(0)
    H, hd, F = tc.num_heads, tc.resolved_head_dim, 7
    q = normal(rng, (B, S, H, hd), dtype)
    k = normal(rng, (B, S, tc.num_kv_heads, hd), dtype)
    pos = np.arange(S)
    filt = diagonal_filter(F).astype(np.float32)
    jp_, jf = jattn.capture_pooled_scores(jc, jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(pos), jnp.asarray(pos),
                                          jnp.asarray(filt), BLOCK)
    tp_, tf = tattn.capture_pooled_scores(tc, to_torch(q), to_torch(k),
                                          torch.as_tensor(pos),
                                          torch.as_tensor(pos),
                                          torch.as_tensor(filt), BLOCK)
    assert tp_.shape == (S // BLOCK, S // BLOCK) and tp_.dtype == torch.float32
    rtol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(to_np(tp_), np.asarray(jp_), rtol=rtol,
                               atol=1e-9)
    np.testing.assert_allclose(tf.item(), float(jf), rtol=rtol)
    if dtype == "float32":
        s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                      k.astype(np.float64)) / np.sqrt(hd)
        a = np.exp(s - s.max(-1, keepdims=True))
        a = (a / a.sum(-1, keepdims=True)).mean(axis=(0, 1))
        want = j_avg_pool(j_diag_conv(a, diagonal_filter(F)), BLOCK)
        np.testing.assert_allclose(to_np(tp_), want, rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(tf.item(), (a ** 2).sum(), rtol=1e-5)
    # the forward's capture hook, on masters cast as the trainers cast them
    jp, tp = lra_params(jc.replace(dtype="float32"),
                        tc.replace(dtype="float32"))
    tpc = compute_params(tp, getattr(torch, dtype))
    jpc = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.dtype(dtype)) if x.ndim >= 2 else x, jp)
    b = batch()
    _, jaux = jbuild(jc).forward(jpc, {"tokens": jnp.asarray(b["tokens"])},
                                 capture={"filt": jnp.asarray(filt),
                                          "block": BLOCK})
    _, taux = tbuild(tc).forward(tpc, {"tokens": to_torch(b["tokens"])},
                                 capture={"filt": torch.as_tensor(filt),
                                          "block": BLOCK})
    (jpool, jfrob), (tpool, tfrob) = jaux["captured"], taux["captured"]
    assert tpool.shape == (tc.num_layers, S // BLOCK, S // BLOCK)
    np.testing.assert_allclose(to_np(tpool), np.asarray(jpool), rtol=rtol,
                               atol=1e-9)
    np.testing.assert_allclose(to_np(tfrob), np.asarray(jfrob), rtol=rtol)


def test_adamw_clip_and_schedule_match_reference():
    """One AdamW update (decay on ndim >= 2 only), global-norm clipping with
    its +1e-6, and the cosine schedule with warmup, against the JAX ones."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "norm": {"scale": rng.standard_normal(5).astype(np.float32)},
            "b": rng.standard_normal(3).astype(np.float32)}
    grads = {"w": rng.standard_normal((6, 5)).astype(np.float32) * 3,
             "norm": {"scale": rng.standard_normal(5).astype(np.float32)},
             "b": rng.standard_normal(3).astype(np.float32)}
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jg, jn = joptim.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, grads), 1.0)
    tparams = ParamTree({k: (to_torch(v) if not isinstance(v, dict) else
                             {kk: to_torch(vv) for kk, vv in v.items()})
                         for k, v in tree.items()}, trainable=True)
    tg, tn = toptim.clip_by_global_norm(
        {k: to_torch(v) for k, v in flat(grads).items()}, 1.0)
    np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
    for name, g in flat(jax.tree_util.tree_map(np.asarray, jg)).items():
        assert_close(tg[name], g, 1e-7, name)
    jstate = joptim.adamw_init(jparams)
    tstate = toptim.adamw_init(tparams)
    for step in (0, 150, 199, 200, 600, 1000):
        jlr = joptim.cosine_schedule(step, peak=3e-2, warmup_steps=200,
                                     total_steps=1000)
        tlr = toptim.cosine_schedule(step, peak=3e-2, warmup_steps=200,
                                     total_steps=1000)
        assert tlr.dtype == torch.float32
        np.testing.assert_allclose(tlr.item(), float(jlr), rtol=1e-6)
    for i in range(2):
        lr = toptim.cosine_schedule(i, peak=3e-2, warmup_steps=2,
                                    total_steps=10)
        jparams, jstate = joptim.adamw_update(
            jparams, jg, jstate, lr=jnp.float32(lr.item()))
        tparams, tstate = toptim.adamw_update(tparams, tg, tstate, lr=lr)
    assert int(tstate["count"]) == int(jstate["count"]) == 2
    want = flat(jax.tree_util.tree_map(np.asarray, jparams))
    for name, p in tparams.named_parameters():
        assert_close(p, want[name], 1e-6, name)
        assert p.requires_grad
    for key in ("mu", "nu"):
        for name, m in flat(jax.tree_util.tree_map(np.asarray,
                                                   jstate[key])).items():
            assert_close(tstate[key][name], m, 1e-7, f"{key} {name}")


@pytest.mark.parametrize("dtype,n_micro", [("float32", 1), ("float32", 2),
                                           ("bfloat16", 1)])
def test_dense_train_steps_match_reference(dtype, n_micro):
    """Parameters and metrics after 1 and after 10 dense make_train_step
    steps (fp32 masters, forward in cfg.dtype, clip, cosine schedule,
    AdamW) from the same masters and batches."""
    jc, tc = lra_configs(dtype, remat=True)
    jp, _ = lra_params(jc, tc)
    jm = j_masters_of(jp)
    tm = t_masters_of(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm), tc, device="cpu"))
    assert all(p.requires_grad for p in tm.parameters())
    lr, total = 0.3, 100          # warmup 200: lr 1.5e-3 at step 0
    jstep = jax.jit(j_make_train_step(jc, lr=lr, total_steps=total,
                                      n_micro=n_micro))
    tstep = t_make_train_step(tc, lr=lr, total_steps=total, n_micro=n_micro)
    jo, to = joptim.adamw_init(jm), toptim.adamw_init(tm)
    it = lm_batch_iterator(np.random.default_rng(1), batch=2 * B,
                           seq_len=S + 1, vocab=tc.vocab_size)
    # AdamW's first steps move an element by about lr * sign(grad), so where
    # a gradient is at the level of rounding (a LayerNorm bias, say) its
    # sign may differ between the two, and bf16 forwards round at other
    # places than the reference's. So the updates are compared as a whole:
    # sum |update - reference update| within `share` of sum |reference
    # update|, and no element off by more than twice the summed lr.
    share = {"float32": 1e-4, "bfloat16": 0.15}[dtype]
    start = flat(jax.tree_util.tree_map(np.asarray, jm))
    lr_sum = 0.0
    for step in range(10):
        b = next(it)
        jm, jo, jmet = jstep(jm, jo, {k: jnp.asarray(v) for k, v in b.items()},
                             jnp.int32(step))
        tm, to, tmet = tstep(tm, to, {k: to_torch(v) for k, v in b.items()},
                             step)
        lr_sum += tmet["lr"].item()
        np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                                   rtol=1e-5 if dtype == "float32" else 1e-2)
        np.testing.assert_allclose(tmet["gnorm"].item(), float(jmet["gnorm"]),
                                   rtol=1e-4 if dtype == "float32" else 5e-2)
        np.testing.assert_allclose(tmet["lr"].item(), float(jmet["lr"]),
                                   rtol=1e-6)
        if step in (0, 9):
            want = flat(jax.tree_util.tree_map(np.asarray, jm))
            off = moved = 0.0
            for name, p in tm.named_parameters():
                assert p.dtype == torch.float32
                diff = np.abs(to_np(p) - want[name])
                assert diff.max() <= 2 * lr_sum, (name, step)
                off += diff.sum()
                moved += np.abs(want[name] - start[name]).sum()
            assert off <= share * moved, (off / moved, step)


def test_trainer_refuses_what_is_not_ported(tmp_path, monkeypatch):
    """Data-parallel meshes (item A12) and a 'seq' axis (item 12b.1) are
    ported (test_torch_multiprocess, test_torch_seq_train): a 'seq' mesh
    builds a trainer whose masters are broadcast over the whole mesh, and a
    seq_len that does not split into whole blocks a shard raises. A 'model'
    axis is ported for this family (item 12b.2, test_torch_model_parallel),
    and so is 'seq' together with 'model' (item 12b.2c,
    test_torch_seq_model): such a mesh passes every check and stops at the
    trainer's first collective here, on a mesh without process groups. A
    mesh of one rank is the single-device trainer. Checkpointing
    (item A8) is ported: ckpt_dir= gives the trainer its manager and
    heartbeat."""
    from repro_torch.distributed import runtime
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.train import Trainer
    _jc, tc = lra_configs()
    tr = Trainer(tc, seq_len=S, batch=B, ckpt_dir=str(tmp_path),
                 device="cpu")
    assert tr.ckpt.dir == str(tmp_path) and tr.ckpt.keep == 3
    assert tr.heartbeat.path == str(tmp_path / "hb_0")
    assert tr.mesh is None
    one = Mesh([[[0]]], ("pod", "data", "model"))
    assert Trainer(tc, seq_len=S, batch=B, mesh=one, device="cpu").mesh \
        is None
    with pytest.raises(RuntimeError, match="no process groups"):
        Trainer(tc, seq_len=S, batch=B,
                mesh=Mesh([[[0, 1]], [[2, 3]]], ("seq", "data", "model")),
                device="cpu")
    # a 'seq' mesh of this process and a peer: the one group the trainer's
    # construction uses (the masters' broadcast) stands in for a joined job's
    seq = Mesh([[0], [1]], ("seq", "data"))
    seq._groups = {(("seq", "data"), (0, 1)): "whole mesh"}
    sent = []
    monkeypatch.setattr(runtime, "broadcast_tensors",
                        lambda ts, group: sent.append((len(ts), group)))
    tr = Trainer(tc, seq_len=S, batch=B, mesh=seq, device="cpu")
    assert tr.mesh is seq
    assert sent == [(len(list(tr.params.parameters())), "whole mesh")]
    with pytest.raises(ValueError, match="whole blocks"):
        Trainer(tc, seq_len=S + tc.spion.block_size, batch=B, mesh=seq,
                device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_encoder_layers_match_reference(dtype, act):
    """LayerNorm with fp32 statistics, the norm dispatch on "bias", and the
    relu and gelu (tanh form, jax.nn.gelu's default) MLPs."""
    from repro.models import layers as jlyr
    from repro_torch.models import layers as tlyr
    jc, tc = lra_configs(dtype, act=act)
    rng = np.random.default_rng(0)
    d, ff = tc.d_model, tc.d_ff
    x = normal(rng, (2, 8, d), dtype)
    p = {"scale": normal(rng, (d,)), "bias": normal(rng, (d,))}
    # He-scaled weights, as the init draws them: outputs of order one
    mp = {"w_in": normal(rng, (d, ff)) / np.sqrt(d),
          "w_out": normal(rng, (ff, d)) / np.sqrt(ff)}
    mp = {k: np.asarray(jnp.asarray(v, dtype)) for k, v in mp.items()}
    jx, tx = jnp.asarray(x), to_torch(x)
    assert "bias" in tlyr.norm_init(tc, "cpu")
    for got, want in (
            (tlyr.norm(tc, {k: to_torch(v) for k, v in p.items()}, tx),
             jlyr.norm(jc, {k: jnp.asarray(v) for k, v in p.items()}, jx)),
            (tlyr.mlp(tc, {k: to_torch(v) for k, v in mp.items()}, tx),
             jlyr.mlp(jc, {k: jnp.asarray(v) for k, v in mp.items()}, jx))):
        assert got.dtype == getattr(torch, dtype)
        assert_close(got, want, FWD_TOL[dtype])
