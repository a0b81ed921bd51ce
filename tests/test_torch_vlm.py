"""Port parity, the vision-language family (internvl2-2b through
models/transformer): precomputed patch embeddings precede the text. Against
the JAX package on the CPU at reduced size (2 layers, d_model 64, 4 heads
of 16 over 2 KV heads as the full config's G = 2, 4 patch tokens, an untied
LM head), fp32 first, then bf16: the forward with patches (dense and
through a plan), the text-only loss and its gradients, and the serving
engine's stepwise tokens (text only, as the reference serves it)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse_attention import bcsr_from_blockmask
from repro.core.sparse_attention import build_sparsity_plan as jplan
from repro.launch.serve import Request as JRequest
from repro.launch.serve import ServeEngine as JEngine
from repro.models.registry import build as jbuild
from repro_torch.core.sparse_attention import build_sparsity_plan as tplan
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.launch.steps import make_loss_and_grads
from repro_torch.models.layers import ParamTree
from repro_torch.models.registry import build as tbuild
from repro_torch.models.registry import cross_entropy
from torch_parity import (FWD_TOL, arch_configs, assert_close, normal, params,
                          random_blockmask, to_torch)

BLOCK, S = 16, 64
P = 4                  # reduced num_patch_tokens
GRAD_TOL = 1e-3


def vlm_configs(dtype="float32", kernel=None, **kw):
    """(JAX cfg, port cfg) of reduced internvl2-2b with G = 2."""
    out = arch_configs("internvl2-2b", dtype, kernel=kernel, num_kv_heads=2,
                       **kw)
    assert out[0].family == "vlm" and out[0].num_patch_tokens == P
    assert not out[0].tie_embeddings
    return out


def inputs(cfg, seed, text=S - P, dtype="float32"):
    """(patch_embeds (2, P, d), tokens (2, text)) from a seed."""
    rng = np.random.default_rng(seed)
    patches = normal(rng, (2, P, cfg.d_model), dtype)
    toks = rng.integers(0, cfg.vocab_size, size=(2, text)).astype(np.int32)
    return patches, toks


def plan_tables(cfg, seed, nrb=S // BLOCK):
    """Random causal block masks, one per layer: (col_idx, nvalid)."""
    rng = np.random.default_rng(seed)
    bs = [bcsr_from_blockmask(random_blockmask(rng, nrb, causal=True), BLOCK,
                              max_k=nrb) for _ in range(cfg.num_layers)]
    return (np.stack([np.asarray(b.col_idx) for b in bs]),
            np.stack([np.asarray(b.nvalid) for b in bs]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sparse", [None, "auto", "fused"])
def test_forward_with_patches_matches_reference(dtype, sparse):
    """Logits over [patch, text] (P + 60 = 64 positions, 4 row blocks),
    dense and through a random causal plan: the port's gather ("auto" on
    CPU tensors) and the kernels' plain versions ("fused")."""
    jc, tc = vlm_configs(dtype, kernel=sparse)
    jc = jc.replace(spion=dataclasses.replace(jc.spion, kernel="auto"))
    jp, tp = params(jc, tc)
    patches, toks = inputs(jc, 1, dtype=dtype)
    spion = None
    if sparse is not None:
        col, nv = plan_tables(jc, 1)
        spion = {"col_idx": col, "nvalid": nv, "block": BLOCK}
    jl, _ = jbuild(jc).forward(jp, {"patch_embeds": jnp.asarray(patches),
                                    "tokens": jnp.asarray(toks)}, spion=spion)
    tl, _ = tbuild(tc).forward(tp, {"patch_embeds": to_torch(patches),
                                    "tokens": to_torch(toks)}, spion=spion)
    assert tl.shape == (2, S, tc.vocab_size)
    assert_close(tl, jl, FWD_TOL[dtype])
    # the patches reach the text's logits
    moved, _ = tbuild(tc).forward(tp, {"patch_embeds": to_torch(patches) + 1,
                                       "tokens": to_torch(toks)}, spion=spion)
    assert (moved[:, P:] - tl[:, P:]).abs().max().item() > 1e-3


@pytest.mark.parametrize("kernel", [None, "fused"])
def test_text_loss_and_gradients_match_reference(kernel):
    """The loss is cross-entropy over the text logits only (the first P
    logits taken apart), and it and every gradient (remat on) match
    jax.grad of the reference's loss in fp32, dense and through the
    kernels' plain versions."""
    jc, tc = vlm_configs(kernel=kernel, remat=True)
    jc = jc.replace(spion=dataclasses.replace(jc.spion, kernel="auto"))
    jp, tp = params(jc, tc)
    patches, raw = inputs(jc, 2, text=S - P + 1)
    jb = {"patch_embeds": jnp.asarray(patches),
          "tokens": jnp.asarray(raw[:, :-1]), "labels": jnp.asarray(raw[:, 1:])}
    tb = {"patch_embeds": to_torch(patches), "tokens": to_torch(raw[:, :-1]),
          "labels": to_torch(raw[:, 1:])}
    spion = None
    if kernel is not None:
        col, nv = plan_tables(jc, 2)
        spion = {"col_idx": col, "nvalid": nv, "block": BLOCK}
    tbundle = tbuild(tc)
    with torch.no_grad():
        logits, _ = tbundle.forward(tp, tb, spion=spion)
        loss, _ = tbundle.loss(tp, tb, spion=spion)
    assert logits.shape[1] == S
    assert loss.item() == cross_entropy(logits[:, P:], tb["labels"]).item()
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jbuild(jc).loss(p, jb, spion=spion), has_aux=True)(jp)
    masters = ParamTree({k: v for k, v in tp.items()}, trainable=True)
    tloss, tg = make_loss_and_grads(tc, block=BLOCK)(masters, tb, spion)
    assert abs(tloss.item() - float(jloss)) <= FWD_TOL["float32"]
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    want = {".".join(k.key for k in path): leaf for path, leaf in flat}
    assert set(tg) == set(want)
    for name, g in want.items():
        assert_close(tg[name], g, GRAD_TOL, name)


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("sparse", [False, True])
def test_engine_serves_text_stepwise_as_the_reference(paged, sparse):
    """internvl2 has patch tokens, so the engine has no fused prefill and
    serves the text prompts stepwise, pure-KV (no state beside the pool);
    three requests on two slots, dense and with a plan (block = page 16):
    tokens equal the reference engine's."""
    jc, tc = vlm_configs(remat=False)
    jp, tp = params(jc, tc)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, tc.vocab_size, size=n).astype(np.int32)
               for n in (9, 4, 13)]
    jspion = tspion = None
    if sparse:
        col, nv = plan_tables(jc, 5)
        jspion, tspion = jplan(col, nv, BLOCK), tplan(col, nv, BLOCK)
    je = JEngine(jc, jp, slots=2, max_len=S, paged=paged, spion=jspion)
    te = ServeEngine(tc, tp, slots=2, max_len=S, paged=paged, spion=tspion,
                     device="cpu")
    assert not te._can_fuse and te._prefill is None
    if paged:
        assert te._extra_cache == {} and je._extra_cache == {}
        assert not te.share_prefix
    jr = [JRequest(rid=i, prompt=p.copy(), max_new=4)
          for i, p in enumerate(prompts)]
    tr = [Request(rid=i, prompt=p.copy(), max_new=4)
          for i, p in enumerate(prompts)]
    je.run(jr)
    te.run(tr)
    assert [r.out for r in tr] == [r.out for r in jr]
    assert te.prefill_fused == 0 and te.prefill_stepwise_tokens == 26
