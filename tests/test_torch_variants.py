"""Port parity, the comparison baselines (core/variants.py): the fixed
BigBird / sliding-window plan tables (bitwise, contiguous), Reformer-style
LSH attention given the reference's rotations, and one reduced spion-lra
train step on fixed BigBird tables, against the JAX package on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as joptim
import repro_torch.optim as toptim
from repro.core.variants import fixed_pattern_tables as j_fixed
from repro.core.variants import lsh_attention as j_lsh
from repro.launch.steps import make_train_step as j_make_train_step
from repro.launch.train import masters_of as j_masters_of
from repro.models.registry import build as jbuild
from repro_torch.convert import params_from_numpy
from repro_torch.core.variants import fixed_pattern_tables as t_fixed
from repro_torch.core.variants import lsh_attention as t_lsh
from repro_torch.kernels import block_sparse_attn as bsa
from repro_torch.launch.steps import make_train_step as t_make_train_step
from repro_torch.launch.train import masters_of as t_masters_of
from torch_parity import (BLOCK, FWD_TOL, assert_close, lra_configs, normal,
                          to_np, to_torch)


@pytest.mark.parametrize("kind,kw", [("bigbird", {}),
                                     ("bigbird", {"num_random": 1}),
                                     ("window", {}),
                                     ("window", {"window": 5})])
@pytest.mark.parametrize("causal", [False, True])
def test_fixed_pattern_tables_are_bitwise_and_contiguous(kind, kw, causal):
    """Every stacked table equals the reference's bitwise over several
    seeds and layer counts, and is a contiguous tensor (the kernel
    wrappers refuse the stride-0 broadcast view)."""
    for seed, (seq, block, layers) in enumerate(((256, 32, 3), (512, 64, 1),
                                                 (128, 16, 4))):
        want = j_fixed(kind, seq, block, layers, causal=causal, seed=seed,
                       **kw)
        got = t_fixed(kind, seq, block, layers, causal=causal, seed=seed,
                      **kw)
        assert set(got) == set(want) and got["block"] == want["block"]
        for name in ("col_idx", "nvalid", "row_idx", "nvalid_t"):
            t = got[name]
            assert t.dtype == torch.int32 and t.is_contiguous(), name
            assert t.shape[0] == layers, name
            np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]),
                                          f"{name} seed {seed}")


def test_fixed_pattern_tables_refuse_an_unknown_kind():
    with pytest.raises(ValueError):
        t_fixed("longformer", 128, 16, 2)


def reference_rotations(key, num_hashes, hd, n_buckets):
    """The rotations the reference's lsh_attention draws from `key`."""
    return [np.asarray(jax.random.normal(jax.random.fold_in(key, r),
                                         (hd, n_buckets // 2)))
            for r in range(num_hashes)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("num_hashes,bucket", [(2, 32), (3, 16)])
def test_lsh_attention_with_the_reference_rotations(causal, num_hashes,
                                                    bucket):
    """fp32 q, k, v (2, 128, 4, 16); the reference's default key and the
    port's rotations= set to what that key draws: outputs within 3e-5.
    The port's own generator draws other rotations (another output of the
    same shape); with neither rotations= nor a generator it raises."""
    rng = np.random.default_rng(num_hashes)
    q, k, v = (normal(rng, (2, 128, 4, 16)) for _ in range(3))
    want = j_lsh(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 num_hashes=num_hashes, bucket_size=bucket, causal=causal)
    rots = reference_rotations(jax.random.key(0), num_hashes, 16,
                               max(2, 128 // bucket))
    got = t_lsh(to_torch(q), to_torch(k), to_torch(v), num_hashes=num_hashes,
                bucket_size=bucket, causal=causal,
                rotations=[to_torch(r) for r in rots])
    assert got.shape == (2, 128, 4, 16) and got.dtype == torch.float32
    assert_close(got, want, FWD_TOL["float32"])
    own = t_lsh(to_torch(q), to_torch(k), to_torch(v), num_hashes=num_hashes,
                bucket_size=bucket, causal=causal,
                generator=torch.Generator().manual_seed(3))
    assert own.shape == got.shape and torch.isfinite(own).all()
    with pytest.raises(ValueError):
        t_lsh(to_torch(q), to_torch(k), to_torch(v), num_hashes=num_hashes,
              rotations=[to_torch(r) for r in rots[:1]])
    with pytest.raises(ValueError, match="rotations= or generator="):
        t_lsh(to_torch(q), to_torch(k), to_torch(v), num_hashes=num_hashes)


@pytest.mark.parametrize("kernel", ["auto", "fused"])
def test_train_step_on_fixed_bigbird_tables(kernel):
    """One reduced spion-lra train step (S 128, block 32) with the fixed
    BigBird tables fed to both packages' make_train_step(spion=True):
    loss, gnorm and the updated masters; the port through the gather and
    through the kernels' plain versions. AdamW's first step moves an
    element by about lr * sign(grad), so where a gradient is at rounding
    level its sign may differ: the updates are compared as
    test_torch_train.py's dense steps are (sum |update - reference update|
    within 1e-4 of sum |reference update|, no element off by more than
    2 lr)."""
    jc, tc = lra_configs(remat=True)
    jp = jbuild(jc).init(jax.random.key(0))
    jm = j_masters_of(jp)
    tm = t_masters_of(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm), tc, device="cpu"))
    jtabs = j_fixed("bigbird", 128, BLOCK, jc.num_layers, seed=1)
    ttabs = t_fixed("bigbird", 128, BLOCK, tc.num_layers, seed=1)
    rng = np.random.default_rng(2)
    raw = rng.integers(0, tc.vocab_size, size=(2, 129)).astype(np.int32)
    jb = {"tokens": jnp.asarray(raw[:, :-1]), "labels": jnp.asarray(raw[:, 1:])}
    tb = {"tokens": to_torch(raw[:, :-1]), "labels": to_torch(raw[:, 1:])}
    jstep = jax.jit(j_make_train_step(jc, spion=True, lr=0.3,
                                      total_steps=100))
    tstep = t_make_train_step(tc, spion=True, lr=0.3, total_steps=100,
                              sparse_kernel=kernel)
    start = jax.tree_util.tree_map(np.asarray, jm)
    jm, _, jmet = jstep(jm, joptim.adamw_init(jm), jb, jnp.int32(0),
                        {k: v for k, v in jtabs.items() if k != "block"})
    before = bsa.block_sparse_fwd.launches
    tm, _, tmet = tstep(tm, toptim.adamw_init(tm), tb, 0, ttabs)
    assert bsa.block_sparse_fwd.launches == before      # plain versions
    np.testing.assert_allclose(tmet["loss"].item(), float(jmet["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(tmet["gnorm"].item(), float(jmet["gnorm"]),
                               rtol=1e-4)

    def named(tree):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {".".join(k.key for k in path): np.asarray(leaf)
                for path, leaf in flat}
    want, start = named(jm), named(start)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    off = moved = 0.0
    for name, leaf in want.items():
        diff = np.abs(to_np(got[name]) - leaf)
        assert diff.max() <= 2 * tmet["lr"].item(), name
        off += diff.sum()
        moved += np.abs(leaf - start[name]).sum()
    assert off <= 1e-4 * moved, off / moved
