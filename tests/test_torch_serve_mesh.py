"""Port parity, the prefill and decode steps under a mesh.

  - One 4-rank gloo job runs every case on four meshes built from the same
    four processes: (data 2, model 2) (`make_distributed_mesh(model=2,
    data=2)`: the batch over 'data', KV heads over 'model'), model 4 (KV
    heads that |model| does not divide: head_dim over 'model'), (seq 2,
    model 2) (the prompt over 'seq' through the halo exchange; decode
    replicated over 'seq') and data 4 at B 1 (the long_500k layout: the
    cache's positions over 'data', mixtral's ring included). Every family
    runs on every mesh: reduced qwen2-7b with 2 KV heads (dense),
    mixtral-8x7b with its 64-position ring (moe), internvl2-2b (vlm),
    whisper-tiny with 6 heads (audio), zamba2-1.2b (hybrid) and rwkv6-7b
    (ssm). Each case: a sparse prefill (rwkv6: dense) whose logits, and
    for the families with a fused prefill its K/V after `gather_cache`,
    are held against one process; then, from one process's cache after a
    stepwise prefill cut by `shard_cache`, 8 dense and (attention
    families) 8 sparse decode steps whose logits and final cache (through
    `gather_cache`) are held against one process's. fp32 within 3e-5;
    qwen2-7b in bf16 on (data 2, model 2) within 6e-2.
  - One case a family against the JAX package's one-device
    `make_prefill_step` / `make_serve_step` on the same numpy parameters,
    batch and starting cache, at 3e-5 (the reference's mesh steps do not
    run under this JAX: ROADMAP.md §C).
  - Planted faults, each past the gate: the sparse decode's zero
    correction counted once a rank, the new token written on every rank
    of the data line, head_dim's partial q·k products not summed over the
    model line, the hybrid's conv state cut in the reference's contiguous
    column order.
  - The paged pool under a mesh, replicated as the reference's
    cache_pspecs leave it: qwen2 on (data 2, model 2) and model 4 with 2
    KV heads, zamba2 and whisper (6 heads) with "kv" on (data 2, model 2)
    beside their states or cross K/V, dense and sparse from
    the same start cache as the contiguous legs: logits within 3e-5 of one
    process's paged decode, every rank's pool bitwise equal, the mapped
    pages equal to the contiguous leg's cache; a planted write without
    the gather leaves the pools apart. In the test process: the pool's
    specs against the JAX package's cache_pspecs, and a serve step on a
    mesh needs the cache's specs.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from conftest import run_distributed_case

MP_ENV = {"OMP_NUM_THREADS": "1"}
TOL = 3e-5               # fp32, of the reference's largest |element|
TOL_BF16 = 6e-2

# shared by the workers and the test process: configs, batches, tables
SRC = """
import dataclasses
import numpy as np
import torch
from repro_torch.configs import get_config

MESHES = ("data2_model2", "model4", "seq2_model2", "data4")
ARCHS = {"qwen2": ("qwen2-7b", {"num_kv_heads": 2}),
         "mixtral": ("mixtral-8x7b", {}),
         "internvl2": ("internvl2-2b", {}),
         "whisper6": ("whisper-tiny", {"num_heads": 6, "num_kv_heads": 6}),
         "zamba2": ("zamba2-1.2b", {}),
         "rwkv6": ("rwkv6-7b", {})}
S_MAX = 64       # decode cache positions (mixtral: its ring of 64)
ENC = 64         # whisper's frames
STEPS = 8        # decode steps a kind

CASES = {f"{a}@{m}": (a, m, "float32") for a in ARCHS for m in MESHES}
CASES["qwen2_bf16@data2_model2"] = ("qwen2", "data2_model2", "bfloat16")
# the cases also held against the JAX package's one-device steps
JAX_CASES = ("qwen2@model4", "mixtral@data4", "internvl2@data2_model2",
             "whisper6@seq2_model2", "zamba2@model4", "rwkv6@data2_model2")
# planted fault -> (case, decode kind)
FAULTS = {"zero_per_rank": ("qwen2@data4", "sparse"),
          "token_every_rank": ("qwen2@data4", "dense"),
          "hd_unsummed": ("qwen2@model4", "dense"),
          "conv_contiguous": ("zamba2@model4", "dense")}


def case_cfg(name):
    a, _, dtype = CASES[name]
    arch, kw = ARCHS[a]
    c = get_config(arch).reduced()
    return c.replace(dtype=dtype, spion=dataclasses.replace(
        c.spion, block_size=16, kernel="fused"), **kw)


def mesh_of(name):
    return CASES[name][1]


def batch_size(name):
    return 1 if mesh_of(name) == "data4" else 2


def prompt_len(name):
    # the MoE's rank must hold whole dispatch groups of 1024 tokens where
    # the batch splits over 'data'
    return 1024 if name == "mixtral@data2_model2" else 64


def decode_start(name):
    # mixtral's ring of 64 wraps during the decode steps
    return 60 if CASES[name][0] == "mixtral" else 44


def kinds(name):
    return ("dense",) if case_cfg(name).family == "ssm" else \\
        ("dense", "sparse")


def prefill_batch(name):
    cfg = case_cfg(name)
    rng = np.random.default_rng(11)
    B, P = batch_size(name), cfg.num_patch_tokens
    b = {"tokens": rng.integers(0, cfg.vocab_size, size=(
        B, prompt_len(name) - P)).astype(np.int32)}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((B, ENC, cfg.d_model)).astype(
            np.float32)
    if P:
        b["patch_embeds"] = rng.standard_normal(
            (B, P, cfg.d_model)).astype(np.float32)
    return b


def decode_tokens(name):
    cfg = case_cfg(name)
    rng = np.random.default_rng(12)
    return rng.integers(0, cfg.vocab_size, size=(
        decode_start(name) + STEPS, batch_size(name), 1)).astype(np.int64)


def _layers(cfg):
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import n_attn_apps
        return n_attn_apps(cfg)
    return None


def prefill_tables(name):
    from repro_torch.launch.steps import spion_dryrun_tables
    cfg = case_cfg(name)
    if cfg.family == "ssm":
        return None
    return spion_dryrun_tables(cfg, prompt_len(name), layers=_layers(cfg),
                               max_extent=1 if mesh_of(name) == "seq2_model2"
                               else None)


def decode_tables(name):
    from repro_torch.launch.steps import spion_dryrun_tables
    cfg = case_cfg(name)
    t = spion_dryrun_tables(cfg, S_MAX, layers=_layers(cfg))
    return {k: t[k] for k in ("col_idx", "nvalid")}


def whole_params(name):
    from repro_torch.models.registry import build
    return build(case_cfg(name)).init(torch.Generator().manual_seed(0),
                                      device="cpu")


def start_cache(name, params):
    \"\"\"One process's cache after a stepwise prefill of decode_start
    tokens (whisper: its cross K/V from the encoder first).\"\"\"
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.registry import build
    cfg = case_cfg(name)
    cache = build(cfg).init_cache(batch_size(name), S_MAX, device="cpu")
    if cfg.family == "audio":
        from repro_torch.models.encdec import precompute_cross
        frames = torch.as_tensor(prefill_batch(name)["frames"])
        cache["ck"], cache["cv"] = (t.to(cache["ck"].dtype) for t in
                                    precompute_cross(params, cfg, frames))
    serve = make_serve_step(cfg)
    toks = torch.as_tensor(decode_tokens(name))
    with torch.no_grad():
        for p in range(decode_start(name)):
            _, cache = serve(params, cache, toks[p], p)
    return cache


def decode_pos(name, i):
    p = decode_start(name) + i
    if mesh_of(name) == "data2_model2":
        return torch.full((batch_size(name),), p, dtype=torch.int64)
    return p


# the paged pool under a mesh, replicated as the reference's cache_pspecs
# leave it: these cases decode dense and sparse from the same start as
# their contiguous legs, through a pool of PAGE-position pages
PAGED = ("qwen2@data2_model2", "qwen2@model4", "zamba2@data2_model2",
         "whisper6@data2_model2")
PAGE = 16


def to_pool(name, cache):
    \"\"\"One process's contiguous cache as a paged pool under a shuffled
    page table (page 0 the scratch page); the hybrid's conv and ssm
    states, or the encdec's cross K/V, beside it under "kv".\"\"\"
    from repro_torch.core.kv_pool import PagedKVCache
    B, NB = batch_size(name), S_MAX // PAGE
    pt = torch.as_tensor((np.random.default_rng(5).permutation(B * NB) + 1)
                         .reshape(B, NB).astype(np.int32))
    k, v = cache["k"], cache["v"]
    kp = torch.zeros((k.shape[0], 1 + B * NB, PAGE, *k.shape[3:]),
                     dtype=k.dtype)
    vp = torch.zeros_like(kp)
    for b in range(B):
        for j in range(NB):
            kp[:, pt[b, j]] = k[:, b, j * PAGE:(j + 1) * PAGE]
            vp[:, pt[b, j]] = v[:, b, j * PAGE:(j + 1) * PAGE]
    pool = PagedKVCache(kp, vp, pt, page=PAGE)
    rest = {n: t for n, t in cache.items() if n not in ("k", "v")}
    return dict(rest, kv=pool) if rest else pool


def pool_records(cache):
    \"\"\"{record: array} of a paged cache: the pool's mapped pages in the
    contiguous layout (L, B, S, KV, hd) as cache/k and cache/v, the pool
    itself as kp and vp, the states beside it as cache/<name>.\"\"\"
    pool = cache if not isinstance(cache, dict) else cache["kv"]
    B, NB = pool.pt.shape
    idx = pool.pt.long()
    out = {"kp": pool.kp.float().numpy(), "vp": pool.vp.float().numpy()}
    for n, t in (("k", pool.kp), ("v", pool.vp)):
        out[f"cache/{n}"] = t[:, idx].reshape(
            t.shape[0], B, NB * PAGE, *t.shape[3:]).float().numpy()
    if isinstance(cache, dict):
        out.update({f"cache/{n}": t.float().numpy()
                    for n, t in cache.items() if n != "kv"})
    return out


def local_write(kp, vp, layer, k_new, v_new, phys, off):
    \"\"\"A planted fault: each rank writes its own rows and KV heads (or
    head_dim columns) of the new token into its pool, without the gather.\"\"\"
    from repro_torch.distributed import sharding
    rows = (sharding.own_rows(phys), sharding.own_rows(off))
    for pool, x in ((kp, k_new), (vp, v_new)):
        dst = sharding.pool_shard(pool[layer])
        x = x[:, 0]
        if x.shape[-1] != dst.shape[-1]:
            hdl = dst.shape[-1]
            x = x.narrow(-1, sharding.model_offset(hdl), hdl)
        if x.shape[-2] != dst.shape[-2]:
            kvl = dst.shape[-2]
            x = x.narrow(-2, sharding.model_offset(kvl), kvl)
        dst.index_put_(rows, x.to(dst.dtype))
    return kp, vp
"""
exec(SRC)

WORKER = """
import json, os
torch.set_num_threads(1)
pid = int(os.environ["MP_PID"]); nproc = int(os.environ["MP_NPROC"])
OUT = os.environ["MP_OUT"]
from repro_torch.distributed import runtime
assert runtime.initialize(f"localhost:{os.environ['MP_PORT']}", nproc, pid)
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import local_batch
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (data_axes, gather_cache,
                                              local_slices, param_pspecs,
                                              reshard, sanitize_spec,
                                              shard_cache, shard_params)
from repro_torch.launch.mesh import make_distributed_mesh
from repro_torch.launch.steps import (batch_pspecs, cache_pspecs,
                                      make_prefill_step, make_serve_step)
from repro_torch.launch.train import nest
from repro_torch.models import attention
from repro_torch.core import sparse_attention
from repro_torch.models.layers import ParamTree
from repro_torch.models.registry import build
MESH = {"data2_model2": make_distributed_mesh(model=2, data=2),
        "model4": make_distributed_mesh(model=4),
        "seq2_model2": make_distributed_mesh(seq=2, model=2),
        "data4": make_distributed_mesh(data=4)}
out, info = {}, {m: {"coords": mesh.coords()} for m, mesh in MESH.items()}


def whole(x, spec, mesh):
    return reshard(x, spec, (), mesh).float().numpy()


def cut(x, spec, mesh):
    return torch.as_tensor(np.ascontiguousarray(
        x[local_slices(mesh, spec, x.shape)]))


def prefill(name, key, full, local, tables=True):
    cfg, mesh = case_cfg(name), MESH[mesh_of(name)]
    batch = prefill_batch(name)
    if mesh_of(name) == "seq2_model2":
        # the port's 'seq' cut (a vlm's: of [patches, text]), the default
        specs, lb = None, local_batch(mesh, batch, "cpu")
    else:
        specs = batch_pspecs(cfg, batch, mesh)
        lb = {k: cut(v, specs[k], mesh) for k, v in batch.items()}
    with_cache = build(cfg).prefill_kv is not None
    tabs = prefill_tables(name) if tables else None
    step = make_prefill_step(cfg, spion=tabs is not None,
                             with_cache=with_cache, mesh=mesh, specs=specs,
                             halo=None if tabs is None else tabs["halo"])
    res = step(local, lb, tabs) if tabs is not None else step(local, lb)
    logits = res[0] if with_cache else res
    B, V = batch_size(name), cfg.vocab_size
    spec = sanitize_spec(mesh, (data_axes(mesh), None, "model"),
                         (B, prompt_len(name), V))
    out[f"{key}/prefill/logits"] = whole(logits, spec, mesh)
    info.setdefault("logits_shape", {})[key] = list(logits.shape)
    if with_cache:
        ks = torch.empty((cfg.num_layers, B, prompt_len(name),
                          cfg.num_kv_heads, cfg.resolved_head_dim),
                         device="meta")
        cs = cache_pspecs(cfg, {"k": ks, "v": ks}, mesh, B)
        info.setdefault("kv_shape", {})[key] = list(res[1].shape)
        for k, v in gather_cache({"k": res[1], "v": res[2]}, cs, mesh,
                                 cfg).items():
            out[f"{key}/prefill/{k}"] = v.float().numpy()


def decode(name, key, full, local, kind, paged=False):
    cfg, mesh = case_cfg(name), MESH[mesh_of(name)]
    cache = start_cache(name, full)
    if paged:
        cache = to_pool(name, cache)
    specs = cache_pspecs(cfg, cache, mesh, batch_size(name))
    shard = shard_cache(cache, specs, mesh, cfg)
    if not paged:
        info.setdefault("cache_shape", {})[key] = {
            k: list(v.shape) for k, v in shard.items()}
    else:
        info.setdefault("pool_specs", {})[key] = {
            k: list(v) for k, v in specs.items()}
    sparse = kind == "sparse"
    serve = make_serve_step(cfg, spion=sparse, mesh=mesh, specs=specs)
    toks = decode_tokens(name)
    B, V = batch_size(name), cfg.vocab_size
    tspec = batch_pspecs(cfg, {"t": toks[0]}, mesh)["t"]
    ospec = sanitize_spec(mesh, (data_axes(mesh) if B > 1 else None,
                                 "model"), (B, V))
    tabs = decode_tables(name) if sparse else None
    logits = []
    for i in range(STEPS):
        t = cut(toks[decode_start(name) + i], tspec, mesh)
        args = (local, shard, t, decode_pos(name, i))
        lg, shard = serve(*args, tabs) if sparse else serve(*args)
        logits.append(whole(lg, ospec, mesh))
    if paged:
        kind = f"paged_{kind}"
    out[f"{key}/{kind}/logits"] = np.stack(logits)
    back = gather_cache(shard, specs, mesh, cfg)
    if paged:
        for k, v in pool_records(back).items():
            out[f"{key}/{kind}/{k}"] = v
        return
    for k, v in back.items():
        out[f"{key}/{kind}/cache/{k}"] = v.float().numpy()


def shards(name, full):
    cfg, mesh = case_cfg(name), MESH[mesh_of(name)]
    specs = param_pspecs(full, mesh)
    return ParamTree(nest(shard_params(full, mesh, specs, cfg)))


for name in CASES:
    full = whole_params(name)
    local = shards(name, full)
    prefill(name, name, full, local)
    for kind in kinds(name):
        decode(name, name, full, local, kind)
        if name in PAGED:
            decode(name, name, full, local, kind, paged=True)


def zero_per_rank(m, l, o, group, stored=None, total=None):
    # the zero correction on each rank's partial terms, before the combine
    zeros = (total.float() - stored.float()).clamp(min=0)
    l = l + zeros[:, None, None, None] * torch.exp(-m)
    return sound_merge(m, l, o, group)


def every_rank(slot, start, rows):
    return slot.long() % rows, torch.ones_like(slot, dtype=torch.bool)


sound_merge = sparse_attention.merge_partials
sound_segments = sharding.packed_segments
PATCH = {"zero_per_rank": (sparse_attention, "merge_partials", zero_per_rank),
         "token_every_rank": (attention, "owned_slot", every_rank),
         "hd_unsummed": (sparse_attention, "head_dim_sum", lambda s: s),
         "conv_contiguous": (sharding, "packed_segments",
                             lambda n, cfg: None if n == "conv"
                             else sound_segments(n, cfg))}
for fault, (name, kind) in FAULTS.items():
    mod, attr, fn = PATCH[fault]
    saved = getattr(mod, attr)
    setattr(mod, attr, fn)
    try:
        full = whole_params(name)
        decode(name, f"planted_{fault}", full, shards(name, full), kind)
    finally:
        setattr(mod, attr, saved)

# the paged pool written without the gather of the new token
from repro_torch.models import transformer
saved = transformer.write_token
transformer.write_token = local_write
try:
    name = "qwen2@data2_model2"
    full = whole_params(name)
    decode(name, "planted_local_write", full, shards(name, full), "dense",
           paged=True)
finally:
    transformer.write_token = saved

# the JAX package's parameters, each rank's shard through params_from_numpy
for name in JAX_CASES:
    cfg, mesh = case_cfg(name), MESH[mesh_of(name)]
    with np.load(os.path.join(os.environ["MP_JAX"], f"{name}.npz")) as z:
        tree = nest({k.replace("/", "."): z[k] for k in z.files})
    full = params_from_numpy(tree, cfg, "cpu")
    local = params_from_numpy(tree, cfg, "cpu", mesh=mesh)
    prefill(name, f"jax_{name}", full, local, tables=False)
    for kind in kinds(name) if name == "mixtral@data4" else ("dense",):
        decode(name, f"jax_{name}", full, local, kind)

np.savez(os.path.join(OUT, f"rank{pid}.npz"), **out)
json.dump(info, open(os.path.join(OUT, f"info{pid}.json"), "w"))
print("SERVE_MESH_OK")
runtime.shutdown(0)
"""


def _jax_cfg(name):
    from repro.configs import get_config as jget
    a, _, dtype = CASES[name]
    arch, kw = ARCHS[a]
    jc = jget(arch).reduced()
    jc = jc.replace(dtype=dtype, spion=dataclasses.replace(
        jc.spion, block_size=16, kernel="fused"), **kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(case_cfg(name))
    return jc


def jax_case(name):
    """(JAX parameters as {'/'-path: array}, the reference's one-device
    prefill outputs and decode logits / final cache per kind) of case
    `name`, fp32, from the port's one-process starting cache on the same
    parameters."""
    import jax
    import jax.numpy as jnp
    from repro.launch.steps import make_prefill_step as jprefill
    from repro.launch.steps import make_serve_step as jserve
    from repro.models.registry import build as jbuild
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.train import nest
    jc = _jax_cfg(name)
    jp = jbuild(jc).init(jax.random.key(0))
    flat = {"/".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    res = {}
    batch = {k: jnp.asarray(v) for k, v in prefill_batch(name).items()}
    with_cache = jbuild(jc).prefill_kv is not None
    got = jax.jit(jprefill(jc, with_cache=with_cache))(jp, batch)
    if with_cache:
        res["prefill/logits"], res["prefill/k"], res["prefill/v"] = \
            (np.asarray(x) for x in got)
    else:
        res["prefill/logits"] = np.asarray(got)
    port = params_from_numpy(nest({k.replace("/", "."): v
                                   for k, v in flat.items()}),
                             case_cfg(name), "cpu")
    start = {k: v.numpy() for k, v in start_cache(name, port).items()}
    toks = decode_tokens(name)
    for kind in kinds(name) if name == "mixtral@data4" else ("dense",):
        sparse = kind == "sparse"
        step = jax.jit(jserve(jc, spion=sparse))
        cache = {k: jnp.asarray(v) for k, v in start.items()}
        tabs = {k: jnp.asarray(v) for k, v in decode_tables(name).items()}
        logits = []
        for i in range(STEPS):
            pos = decode_pos(name, i)
            pos = jnp.asarray(np.asarray(pos))
            t = jnp.asarray(toks[decode_start(name) + i].astype(np.int32))
            lg, cache = step(jp, cache, t, pos, tabs) if sparse else \
                step(jp, cache, t, pos)
            logits.append(np.asarray(lg))
        res[f"{kind}/logits"] = np.stack(logits)
        for k, v in cache.items():
            res[f"{kind}/cache/{k}"] = np.asarray(v, dtype=np.float32)
    return flat, res


@pytest.fixture(scope="module")
def mp_job(tmp_path_factory):
    """The 4-rank job's records (per rank its npz and info json) and the
    JAX package's one-device results of JAX_CASES."""
    d = tmp_path_factory.mktemp("serve_mesh_job")
    (d / "jax").mkdir()
    jax_runs = {}
    for name in JAX_CASES:
        flat, jax_runs[name] = jax_case(name)
        np.savez(d / "jax" / f"{name}.npz", **flat)
    outs = run_distributed_case(
        SRC + WORKER, nproc=4, timeout=600,
        env_extra=dict(MP_ENV, MP_OUT=str(d), MP_JAX=str(d / "jax")))
    assert all("SERVE_MESH_OK" in o for o in outs)
    return {"jax": jax_runs,
            "ranks": [dict(np.load(d / f"rank{i}.npz")) for i in range(4)],
            "info": [json.load(open(d / f"info{i}.json")) for i in range(4)]}


_ONE = {}


def one_process(name):
    """{record: array} of case `name` in one process (cached): the prefill's
    logits (and K/V), each decode kind's logits and final cache."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models.registry import build
    if name in _ONE:
        return _ONE[name]
    cfg = case_cfg(name)
    params = whole_params(name)
    res = {}
    batch = {k: torch.as_tensor(v) for k, v in prefill_batch(name).items()}
    tabs = prefill_tables(name)
    with_cache = build(cfg).prefill_kv is not None
    step = make_prefill_step(cfg, spion=tabs is not None,
                             with_cache=with_cache)
    with torch.no_grad():
        got = step(params, batch, tabs) if tabs is not None else \
            step(params, batch)
    if with_cache:
        res["prefill/logits"], res["prefill/k"], res["prefill/v"] = \
            (x.float().numpy() for x in got)
    else:
        res["prefill/logits"] = got.float().numpy()
    toks = torch.as_tensor(decode_tokens(name))
    for kind in kinds(name):
        sparse = kind == "sparse"
        cache = start_cache(name, params)
        serve = make_serve_step(cfg, spion=sparse)
        tables = decode_tables(name)
        logits = []
        with torch.no_grad():
            for i in range(STEPS):
                args = (params, cache, toks[decode_start(name) + i],
                        decode_pos(name, i))
                lg, cache = serve(*args, tables) if sparse else serve(*args)
                logits.append(lg.float().numpy())
        res[f"{kind}/logits"] = np.stack(logits)
        for k, v in cache.items():
            res[f"{kind}/cache/{k}"] = v.float().numpy()
    _ONE[name] = res
    return res


_PAGED = {}


def one_process_paged(name):
    """{record: array} of case `name`'s paged decode in one process
    (cached): each kind's logits, the pool's mapped pages in the
    contiguous layout and the states beside it."""
    from repro_torch.launch.steps import make_serve_step
    if name in _PAGED:
        return _PAGED[name]
    cfg, params = case_cfg(name), whole_params(name)
    toks = torch.as_tensor(decode_tokens(name))
    res = {}
    for kind in kinds(name):
        sparse = kind == "sparse"
        cache = to_pool(name, start_cache(name, params))
        serve = make_serve_step(cfg, spion=sparse)
        logits = []
        with torch.no_grad():
            for i in range(STEPS):
                args = (params, cache, toks[decode_start(name) + i],
                        decode_pos(name, i))
                lg, cache = serve(*args, decode_tables(name)) if sparse \
                    else serve(*args)
                logits.append(lg.float().numpy())
        res[f"paged_{kind}/logits"] = np.stack(logits)
        res.update({f"paged_{kind}/{k}": v
                    for k, v in pool_records(cache).items()
                    if k.startswith("cache/")})
    _PAGED[name] = res
    return res


def gap(got, want):
    """max |got - want| over want's largest |element| (inf where `got` is
    not finite)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if not np.isfinite(got).all():
        return float("inf")
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def worst_gap(rec, key, want):
    return max(gap(rec[f"{key}/{k}"], v) for k, v in want.items())


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_steps_match_one_process(mp_job, name):
    """The case's prefill logits (and K/V after gather_cache), each decode
    kind's 8 steps' logits and its final cache after gather_cache, on every
    rank, within 3e-5 of one process's (bf16: 6e-2) of each record's
    largest element; every rank gets the same whole records."""
    want = one_process(name)
    tol = TOL_BF16 if CASES[name][2] == "bfloat16" else TOL
    ranks = mp_job["ranks"]
    for r, rec in enumerate(ranks):
        for k, v in want.items():
            g = gap(rec[f"{name}/{k}"], v)
            assert g <= tol, (name, r, k, g)
            np.testing.assert_array_equal(rec[f"{name}/{k}"],
                                          ranks[0][f"{name}/{k}"])


def test_layouts_on_the_ranks(mp_job):
    """Each mesh gives the rank the layout the specs state: (data 2, model
    2) one batch row, the KV heads and the vocabulary halved; model 4 with
    2 KV heads a quarter of head_dim (4 of 16 columns); data 4 at B 1 a
    quarter of the positions (16 of 64), mixtral's ring too; (seq 2,
    model 2) the logits' whole prompt after the 'seq' gather, the K/V
    whole in S. zamba2's conv state holds its x heads and its part of B‖C
    (128 / 4 + 16 / 4 columns on model 4); rwkv6's token-shift states
    stay whole."""
    info = mp_job["info"][0]
    cs = info["cache_shape"]
    assert cs["qwen2@data2_model2"]["k"] == [2, 1, 64, 1, 16]
    assert cs["qwen2@model4"]["k"] == [2, 2, 64, 2, 4]
    assert cs["qwen2@data4"]["k"] == [2, 1, 16, 2, 16]
    assert cs["mixtral@data4"]["k"] == [2, 1, 16, 4, 16]
    assert cs["qwen2@seq2_model2"]["k"] == [2, 2, 64, 1, 16]
    assert cs["zamba2@model4"]["conv"] == [2, 2, 3, 32 + 4]
    assert cs["zamba2@model4"]["ssm"] == [2, 2, 2, 8, 16]
    assert cs["rwkv6@model4"]["tm_prev"] == [2, 2, 64]
    assert cs["rwkv6@model4"]["S"] == [2, 2, 1, 16, 16]
    assert cs["whisper6@model4"]["ck"] == [2, 2, 64, 6, 4]
    assert info["logits_shape"]["qwen2@seq2_model2"] == [2, 64, 64]
    assert info["kv_shape"]["qwen2@seq2_model2"] == [2, 2, 64, 1, 16]
    assert info["kv_shape"]["qwen2@data4"] == [2, 1, 16, 2, 16]
    assert info["logits_shape"]["qwen2@data2_model2"] == [1, 64, 64]


@pytest.mark.parametrize("name", JAX_CASES)
def test_mesh_steps_match_the_jax_package(mp_job, name):
    """The case's steps on its mesh, their shards loaded from the JAX
    package's parameters through params_from_numpy(mesh=), against the
    JAX package's one-device make_prefill_step / make_serve_step on the
    same parameters, batch and starting cache: dense prefill logits (and
    K/V), dense decode logits and final cache (mixtral's ring on data 4
    sparse too), within 3e-5."""
    want = mp_job["jax"][name]
    for rec in mp_job["ranks"]:
        for k, v in want.items():
            assert gap(rec[f"jax_{name}/{k}"], v) <= TOL, (name, k)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_miss_the_gate(mp_job, fault):
    """Each planted fault moves a decode step's logits or the gathered
    cache past 3e-5: the sparse decode's zero correction counted on each
    rank's partial sum (once a rank, not once), the new token written on
    every rank of the data line at its local slot, head_dim's partial
    q·k products left unsummed over the model line, the hybrid's conv
    state cut contiguously (the reference's column order) by shard_cache
    and gather_cache."""
    name, kind = FAULTS[fault]
    want = {k: v for k, v in one_process(name).items()
            if k.startswith(f"{kind}/")}
    assert max(worst_gap(rec, f"planted_{fault}", want)
               for rec in mp_job["ranks"]) > 10 * TOL


@pytest.mark.parametrize("name", PAGED)
def test_paged_pool_on_a_mesh(mp_job, name):
    """A paged cache under a mesh, its pool and page table replicated: each
    kind's 8 decode steps' logits and the pool's mapped pages (in the
    contiguous layout; the states beside the pool after gather_cache)
    within 3e-5 of one process's paged decode; every rank's kp and vp
    bitwise equal to every other rank's (each writes the new token's K/V
    for every row and KV head, gathered over the model line and the data
    line); the mapped pages equal to the contiguous mesh leg's cache after
    gather_cache, bitwise. The specs are the reference's: every pool leaf
    replicated."""
    want = one_process_paged(name)
    ranks = mp_job["ranks"]
    for r, rec in enumerate(ranks):
        for k, v in want.items():
            g = gap(rec[f"{name}/{k}"], v)
            assert g <= TOL, (name, r, k, g)
        for kind in kinds(name):
            for leaf in ("kp", "vp"):
                np.testing.assert_array_equal(
                    rec[f"{name}/paged_{kind}/{leaf}"],
                    ranks[0][f"{name}/paged_{kind}/{leaf}"])
            for leaf in ("k", "v"):
                np.testing.assert_array_equal(
                    rec[f"{name}/paged_{kind}/cache/{leaf}"],
                    rec[f"{name}/{kind}/cache/{leaf}"])
    specs = mp_job["info"][0]["pool_specs"][name]
    pool = [k for k in specs if k.endswith((".kp", ".vp", ".pt"))]
    assert len(pool) == 3 and all(specs[k] == [] for k in pool)


def test_paged_write_without_the_gather_leaves_pools_apart(mp_job):
    """A planted fault: each rank writes only its own rows and KV heads of
    the new token into its pool (no gather). The pools then differ across
    ranks, which no rank alone would see."""
    ranks = mp_job["ranks"]
    key = "planted_local_write/paged_dense/kp"
    assert any(not np.array_equal(rec[key], ranks[0][key])
               for rec in ranks[1:])


def test_pool_cache_pspecs_match_the_reference():
    """cache_pspecs on a paged pool, alone and under "kv" beside the
    hybrid's states, against the JAX package's cache_pspecs on the same
    PagedKVCache (its rules match no pool leaf: P() each): every pool leaf
    replicated, the states keep their rules; on three meshes."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.core.kv_pool import PagedKVCache as JPool
    from repro.launch import steps as ref
    from repro_torch.core.kv_pool import PagedKVCache
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import cache_pspecs
    for shape, axes in (((1, 2, 2), ("pod", "data", "model")),
                        ((4,), ("model",)), ((2, 1, 2),
                                             ("seq", "data", "model"))):
        mesh = Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes)
        for name in ("qwen2@data2_model2", "zamba2@data2_model2"):
            cfg = case_cfg(name)
            kp = np.zeros((2, 9, PAGE, 2, 16), np.float32)
            pt = np.zeros((2, 4), np.int32)
            mine = PagedKVCache(torch.as_tensor(kp), torch.as_tensor(kp),
                                torch.as_tensor(pt), page=PAGE)
            theirs = JPool(kp, kp, pt, page=PAGE)
            if cfg.family == "hybrid":
                st = {"conv": np.zeros((2, 2, 3, 144), np.float32),
                      "ssm": np.zeros((2, 2, 8, 8, 16), np.float32)}
                mine = dict({k: torch.as_tensor(v) for k, v in st.items()},
                            kv=mine)
                theirs = dict(st, kv=theirs)
            got = cache_pspecs(cfg, mine, mesh, 2)
            flat = jax.tree_util.tree_flatten_with_path(
                ref.cache_pspecs(_jax_cfg(name), theirs, mesh, 2),
                is_leaf=lambda x: isinstance(x, P))[0]
            want = {}
            for path, spec in flat:
                keys = [k.key for k in path]
                if isinstance(keys[-1], int):      # a pool leaf's index
                    keys[-1] = ("kp", "vp", "pt")[keys[-1]]
                    if len(keys) == 1:
                        keys.insert(0, "pool")
                want[".".join(keys)] = tuple(spec)
            assert got == want, (shape, name, got, want)
            assert all(got[f"{p}.{leaf}"] == ()
                       for p in ("pool", "kv") for leaf in ("kp", "vp", "pt")
                       if f"{p}.{leaf}" in got)


def test_serve_step_needs_specs_and_ssm_refuses_sparse():
    """A serve step on a mesh needs the cache's specs; spion=True on the
    ssm family still raises at construction. (A paged cache under a mesh
    decodes: test_paged_pool_on_a_mesh.)"""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import cache_pspecs, make_serve_step
    from repro_torch.models.registry import cache_specs
    cfg = case_cfg("qwen2@data2_model2")
    mesh = Mesh(np.arange(4).reshape(1, 2, 2), ("pod", "data", "model"))
    specs = cache_pspecs(cfg, cache_specs(cfg, 2, S_MAX), mesh, 2)
    with pytest.raises(ValueError, match="needs the cache's specs"):
        make_serve_step(cfg, mesh=mesh)
    assert callable(make_serve_step(cfg, mesh=mesh, specs=specs))
    with pytest.raises(NotImplementedError):
        make_serve_step(case_cfg("rwkv6@data4"), spion=True)
