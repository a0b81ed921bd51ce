"""Shared helpers of the port's parity tests (tests/test_torch_*.py): the
same numpy inputs and the same parameters go through the JAX package and
the PyTorch port, on the CPU.

Tolerances are the JAX package's own (tests/test_kernels.py): forward 3e-5
in fp32 and 6e-2 in bf16; host-side tables bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as jcfgs
import repro_torch.configs as tcfgs
from repro.models.registry import build as jbuild
from repro_torch.convert import params_from_numpy, tensor_from_numpy

# tier-1 runs several pytest workers on one machine
torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FWD_TOL = {"float32": 3e-5, "bfloat16": 6e-2}


def configs(dtype="float32", **kw):
    """(JAX cfg, port cfg) of reduced qwen2-7b with GQA (G = 2): plain
    reduced() keeps num_kv_heads = num_heads = 4. The two must be equal as
    dataclass dicts."""
    jc = jcfgs.get_config("qwen2-7b").reduced().replace(
        num_kv_heads=2, dtype=dtype, **kw)
    tc = tcfgs.get_config("qwen2-7b").reduced().replace(
        num_kv_heads=2, dtype=dtype, **kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    return jc, tc


BLOCK = 32    # the training tests' SPION block: S = 128 has 4 row blocks


def lra_configs(dtype="float32", **kw):
    """(JAX cfg, port cfg) of reduced spion-lra (2 layers, d_model 64, 4
    heads of 16, relu MLP, LayerNorm, learned positions, non-causal) with
    SPION block BLOCK. The two must be equal as dataclass dicts."""
    out = []
    for mod in (jcfgs, tcfgs):
        c = mod.get_config("spion-lra").reduced()
        out.append(c.replace(dtype=dtype, spion=dataclasses.replace(
            c.spion, block_size=BLOCK), **kw))
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    assert out[0].family == "encoder" and not out[0].causal
    return out


def params(jc, tc, seed=0):
    """Parameters from the JAX init, as (JAX tree, port ParamTree)."""
    jp = jbuild(jc).init(jax.random.key(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jp, params_from_numpy(tree, tc, device="cpu")


def normal(rng, shape, dtype="float32"):
    """Seeded numpy normals, rounded to `dtype` on both sides alike."""
    return np.asarray(jnp.asarray(rng.standard_normal(shape, np.float32),
                                  dtype))


def to_torch(a):
    return tensor_from_numpy(np.asarray(a))


def to_np(t):
    """Tensor or JAX array -> float32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def assert_close(got, want, atol, msg=""):
    np.testing.assert_allclose(to_np(got), to_np(want), atol=atol, rtol=0,
                               err_msg=msg)


def random_blockmask(rng, n, density=0.5, causal=False, empty_rows=()):
    """Seeded block mask with the diagonal set; `empty_rows` get no blocks
    (rows whose nvalid is 0)."""
    mask = rng.random((n, n)) < density
    np.fill_diagonal(mask, True)
    if causal:
        mask = np.tril(mask)
    for r in empty_rows:
        mask[r] = False
    return mask
