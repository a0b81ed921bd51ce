"""Port parity, the serving steps' specs: `launch/steps.batch_pspecs` and
`cache_pspecs` against the JAX package's, compared as tuples, and the
registry's `input_specs`, `cache_specs` and `params_specs` (meta-device
tensors) against the reference's ShapeDtypeStruct trees, shape and dtype
leaf by leaf. Every `ARCH_IDS` config at full size, every `SHAPES` entry,
test_torch_model_parallel.py's five meshes and the production ones: data
16 x model 16, seq 4 x data 4 x model 16 ('seq' carved out of the data
axis) and the multi-pod pod 2 x data 16 x model 16 (the specs once an
arch and mesh; the registry's once an arch). The reference's functions read only
`mesh.shape` and `axis_names`, so a port `Mesh` is passed to both. No
processes are spawned.
"""
import numpy as np
import pytest
import torch

MESHES = {"data2_model2": ((2, 2), ("data", "model")),
          "model4": ((4,), ("model",)),
          "pod2_data2_model2": ((2, 2, 2), ("pod", "data", "model")),
          "data1_model16": ((1, 16), ("data", "model")),
          "seq2_data2_model2": ((2, 2, 2), ("seq", "data", "model")),
          "data16_model16": ((16, 16), ("data", "model")),
          "seq4_data4_model16": ((4, 4, 16), ("seq", "data", "model")),
          "pod2_data16_model16": ((2, 16, 16), ("pod", "data", "model"))}


def _arch_ids():
    from repro_torch.configs import ARCH_IDS
    return ARCH_IDS


def _configs(arch):
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    return jget(arch), get_config(arch)


def _dtype(x) -> str:
    if isinstance(x, torch.dtype):
        return str(x).replace("torch.", "")
    return np.dtype(x).name


def _flat(tree, sep="."):
    """{path joined by `sep`: leaf} of a JAX pytree of dicts."""
    import jax
    from jax.sharding import PartitionSpec as P
    got = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {sep.join(k.key for k in path): leaf for path, leaf in got}


def _same_leaves(mine: dict, theirs: dict, what):
    """{name: meta tensor} against {name: ShapeDtypeStruct}."""
    assert sorted(mine) == sorted(theirs), what
    for k, t in mine.items():
        assert tuple(t.shape) == tuple(theirs[k].shape), (what, k)
        assert _dtype(t.dtype) == _dtype(theirs[k].dtype), (what, k)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", _arch_ids())
def test_batch_and_cache_pspecs_match_reference(arch, mesh_name):
    """batch_pspecs of every train / prefill shape's batch and cache_pspecs
    of every decode shape's cache (at its global batch) equal the JAX
    package's, as tuples; the tokens of a decode shape too."""
    from repro.launch import steps as ref
    from repro.models.registry import input_specs as jinput
    from repro_torch.configs import SHAPES
    from repro_torch.launch import steps as port
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.registry import input_specs
    jc, cfg = _configs(arch)
    shape, axes = MESHES[mesh_name]
    mesh = Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes)
    for sname, spec in SHAPES.items():
        mine, theirs = input_specs(cfg, spec), jinput(jc, spec)
        if spec.kind in ("train", "prefill"):
            got = port.batch_pspecs(cfg, mine["batch"], mesh)
            want = {k: tuple(v) for k, v in _flat(ref.batch_pspecs(
                jc, theirs["batch"], mesh)).items()}
            assert got == want, (sname, got, want)
            continue
        got = port.cache_pspecs(cfg, mine["cache"], mesh, spec.global_batch)
        want = {k: tuple(v) for k, v in _flat(ref.cache_pspecs(
            jc, theirs["cache"], mesh, spec.global_batch)).items()}
        assert got == want, (sname, got, want)
        tok = port.batch_pspecs(cfg, {"t": mine["tokens"]}, mesh)["t"]
        assert tok == tuple(ref.batch_pspecs(
            jc, {"t": theirs["tokens"]}, mesh)["t"]), sname


@pytest.mark.parametrize("arch", _arch_ids())
def test_registry_specs_match_reference(arch):
    """input_specs (every shape), cache_specs (every decode shape's batch
    and length, and a windowed length) and params_specs give the
    reference's leaves with its shapes and dtypes, allocating nothing
    (meta tensors)."""
    from repro.models import registry as jreg
    from repro_torch.configs import SHAPES
    from repro_torch.models import registry
    jc, cfg = _configs(arch)
    for sname, spec in SHAPES.items():
        mine, theirs = registry.input_specs(cfg, spec), \
            jreg.input_specs(jc, spec)
        assert sorted(mine) == sorted(theirs), sname
        for part in mine:
            if isinstance(mine[part], dict):
                _same_leaves(mine[part], _flat(theirs[part]),
                             (sname, part))
            else:
                _same_leaves({part: mine[part]}, {part: theirs[part]},
                             (sname, part))
            for t in (mine[part].values() if isinstance(mine[part], dict)
                      else [mine[part]]):
                assert t.device.type == "meta"
    for B, S in ((3, 100), (1, 8192)):
        _same_leaves(registry.cache_specs(cfg, B, S),
                     _flat(jreg.cache_specs(jc, B, S)), ("cache", B, S))
    mine = dict(registry.params_specs(cfg).named_parameters())
    assert all(t.device.type == "meta" for t in mine.values())
    _same_leaves(mine, _flat(jreg.params_specs(jc)), "params")
