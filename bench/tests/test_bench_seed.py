"""--seed makes the same batches, parameters and plan; another seed other
ones."""
import numpy as np
import torch

from bench.harness.params import make_params
from bench.harness.spec import Spec

SEED = 2 ** 31 + 977          # past 32 signed bits, as the driver's are


def setup(root, cell, seed):
    spec = Spec(root, cell)
    c = spec.kind().Cell(spec, seed, torch.device("cpu"))
    c.setup()
    return c


def test_same_seed_same_inputs_and_plan(tiny):
    a = setup(tiny, "lra-listops-sparse", SEED)
    b = setup(tiny, "lra-listops-sparse", SEED)
    c = setup(tiny, "lra-listops-sparse", SEED + 1)
    for x, y in zip(a.pool, b.pool):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert any((x["tokens"] != y["tokens"]).any()
               for x, y in zip(a.pool, c.pool))
    for k in ("col_idx", "nvalid", "row_idx", "nvalid_t"):
        np.testing.assert_array_equal(a.tables[k], b.tables[k])
    np.testing.assert_array_equal(a.pooled, b.pooled)
    assert a.readings["losses"] == b.readings["losses"]


def test_same_seed_same_parameters(tiny):
    spec = Spec(tiny, "internvl2-8k-sparse")
    model = spec.config["model"]
    a, b = (make_params(model, SEED, "cpu") for _ in range(2))
    c = make_params(model, SEED + 1, "cpu")
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["layers.attn.wq"], c["layers.attn.wq"])
    pool = spec.generator().make_pool(spec.traffic, model, SEED)
    again = spec.generator().make_pool(spec.traffic, model, SEED)
    for x, y in zip(pool, again):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert pool[0]["patch_embeds"].shape == (4, 16, model["d_model"])
