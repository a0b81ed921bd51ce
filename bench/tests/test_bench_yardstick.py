"""The yardstick's frozen copies against the program's originals: the
kernels' work formulas, the flood fill and the plan's tables, the LM
generator; the ListOps generator against LRA's grammar; and the step's
model FLOPs against torch.utils.flop_counter."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench.harness.params import make_params, nested
from bench.harness.spec import Spec
from bench.metrics import yardstick as Y
from bench.reference.pattern import plan_tables
from bench.traffic.gen import listops, lm


def seeded_tables(rng, nrb, causal):
    mask = rng.random((nrb, nrb)) < 0.3
    np.fill_diagonal(mask, True)
    if causal:
        mask = np.tril(mask)
    K = int(mask.sum(axis=1).max())
    col = np.full((nrb, K), -1, np.int32)
    nv = mask.sum(axis=1).astype(np.int32)
    for r in range(nrb):
        idx = np.nonzero(mask[r])[0]
        col[r, :len(idx)] = idx
    return col, nv


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_work_formulas_equal_the_programs(seed, causal):
    from repro_torch.core.sparse_attention import build_sparsity_plan
    from repro_torch.kernels import work as W
    rng = np.random.default_rng(seed)
    N, G, block, hd, nrb = 6, 2, 16, 32, 12
    S = nrb * block
    col, nv = seeded_tables(rng, nrb, causal)
    plan = build_sparsity_plan(col, nv, block)
    row, nvt = (plan.tables[k][0] for k in ("row_idx", "nvalid_t"))
    q = torch.empty((N, G, S, hd), dtype=torch.bfloat16, device="meta")
    k = torch.empty((N, S, hd), dtype=torch.bfloat16, device="meta")
    tc, tn = torch.as_tensor(col), torch.as_tensor(nv)
    want = {"block_sparse_fwd": W.fwd_work(q, k, tc, tn, block=block,
                                           causal=causal),
            "block_sparse_dq": W.dq_work(q, k, tc, tn, block=block,
                                         causal=causal),
            "block_sparse_dkv": W.dkv_work(q, k, row, nvt, block=block,
                                           causal=causal)}
    for kind in Y.KERNELS:
        got = Y.kernel_work(kind, N, G, S, hd, col, nv, row.numpy(),
                            nvt.numpy(), block, causal)
        assert got == want[kind], kind


@pytest.mark.parametrize("causal", [False, True])
def test_frozen_flood_fill_and_tables_equal_the_programs(causal):
    from repro_torch.core.spion import SpionController
    from repro_torch.configs.base import SpionConfig
    rng = np.random.default_rng(7)
    pooled = rng.random((3, 16, 16)).astype(np.float32)
    pooled[1, 3:6, 3:9] = pooled[1, 4, 4]      # ties for the fill
    cfg = SpionConfig(enabled=True, block_size=16, alpha_quantile=0.9)
    ctl = SpionController(cfg, causal=causal, seq_len=256)
    from repro_torch.core.spion import SpionState
    state = ctl.generate(SpionState(), pooled)
    got = state.table_arrays()
    want, _ = plan_tables(pooled, 0.9, causal)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_frozen_lm_generator_equals_the_programs():
    from repro_torch.data.synthetic import lm_batch_iterator
    mix = {"batch": 3, "seq_len": 64, "pool": 2}
    pool = lm.make_pool(mix, {"vocab_size": 50, "d_model": 8}, 11)
    for k, batch in enumerate(pool):
        it = lm_batch_iterator(np.random.default_rng([11, k]), batch=3,
                               seq_len=65, vocab=50)
        want = next(it)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(batch[key], want[key])


def lra_value(tokens):
    """The value of a row's tree, read back from its tokens: each operator
    token opens a list that its "]" closes."""
    stack = [[]]
    for t in tokens[1:]:
        if t == listops.PAD:
            break
        if t >= listops.DIG0:
            stack[-1].append(int(t - listops.DIG0))
        elif t >= listops.OP0:
            stack.append([listops.OPS[t - listops.OP0]])
        else:
            assert t == listops.CLOSE
            op, *vals = stack.pop()
            stack[-1].append({"MIN": min(vals), "MAX": max(vals),
                              "MED": int(np.median(vals)),
                              "SM": sum(vals) % 10}[op])
    (value,) = stack[0]
    return value


def test_listops_rows_follow_lra():
    mix = {"batch": 16, "seq_len": 2048, "pool": 2, "max_depth": 10,
           "max_args": 10, "op_p": 0.25, "min_len": 500, "max_len": 2000}
    pool = listops.make_pool(mix, {}, 2 ** 31 + 11)
    for batch in pool:
        toks = batch["tokens"]
        assert (toks[:, 0] == listops.CLS).all()
        n = (toks != listops.PAD).sum(axis=1) - 1
        assert ((n > 500) & (n < 2000)).all(), n
        for row, label in zip(toks, batch["labels"][:, 0]):
            assert label == listops.DIG0 + lra_value(row)
            depth = np.cumsum((row >= listops.OP0) & (row < listops.DIG0)) \
                - np.cumsum(row == listops.CLOSE)
            assert depth.max() <= 9          # operators above max_depth
        mask = np.zeros_like(batch["loss_mask"])
        mask[:, 0] = 1
        np.testing.assert_array_equal(batch["loss_mask"], mask)
        assert (batch["labels"][:, 1:] == listops.PAD).all()
    assert not np.array_equal(pool[0]["tokens"], pool[1]["tokens"])


def test_step_flops_equal_the_flop_counter(tiny):
    """The dense encoder step, remat off: the counter's matmuls are the
    linear layers, the head and the attention's four products, forward
    and backward."""
    from repro_torch.launch.steps import make_loss_and_grads
    from repro_torch.launch.train import masters_of
    from bench.kinds.training import model_config
    spec = Spec(tiny, "lra-listops-dense")
    cfg = model_config(spec.config).replace(remat=False)
    model = dataclasses.asdict(cfg)
    mix = dict(spec.traffic, batch=2, seq_len=64, min_len=20, max_len=60)
    params = masters_of(nested(make_params(spec.config["model"], 3, "cpu")))
    batch = spec.generator().make_pool(dict(mix, pool=1), model, 3)[0]
    # the loss over every position, as the counter sees the head run
    batch = {k: torch.as_tensor(v) for k, v in batch.items()
             if k != "loss_mask"}
    f = make_loss_and_grads(cfg)
    with FlopCounterMode(display=False) as counter:
        f(params, batch)
    assert counter.get_total_flops() == Y.step_flops(model, mix, None)
