"""One traced step's op records: collective bytes, op census, roofline terms
(the JAX package's `launch/hlo.py`, which reads XLA's partitioned HLO text).

PyTorch runs eagerly, so the port has no HLO: the dry run (launch/dryrun.py)
runs one rank's step once under `OpRecorder`, a dispatch mode that writes
one record per op the step dispatches, and these functions read the
records. A record is a dict:

  - "op": the op's name ("aten.mm", "c10d.allreduce_",
    "repro_torch.block_sparse_fwd", ...);
  - "kind": the collective kind of a c10d op, under the reference's names
    (all-reduce, all-gather, reduce-scatter, all-to-all and
    collective-permute, which the port's send / recv are), else None;
  - "bytes": a collective's operand bytes (not the result's, as in the
    reference: an all-gather counts what each rank sends);
  - "done": True for the second half of an asynchronous collective (a
    receive, a wait), which is not counted again;
  - "hbm_bytes": what the op reads and writes: its input and output
    tensors' bytes once each (eager PyTorch fuses nothing, so this is the
    eager program's traffic), none for views, allocations, collectives
    and ops that return no tensor (a size, a device), and the kernels'
    own count for the three block-sparse kernels (kernels/work.py).

torch's `CommDebugMode` counts the same c10d ops but keeps no operand
bytes; the records' counts equal its counts (tests/test_torch_dryrun.py).
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.block_sparse_attn import op_work

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d op -> (kind, index of the operand argument, counted half)
_C10D = {
    "allreduce_": ("all-reduce", 0, True),
    "allreduce_coalesced_": ("all-reduce", 0, True),
    "allgather_": ("all-gather", 1, True),
    "_allgather_base_": ("all-gather", 1, True),
    "allgather_coalesced_": ("all-gather", 1, True),
    "allgather_into_tensor_coalesced_": ("all-gather", 1, True),
    "reduce_scatter_": ("reduce-scatter", 1, True),
    "_reduce_scatter_base_": ("reduce-scatter", 1, True),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, True),
    "alltoall_": ("all-to-all", 1, True),
    "alltoall_base_": ("all-to-all", 1, True),
    "send": ("collective-permute", 0, True),
    "recv_": ("collective-permute", 0, False),
    "recv_any_source_": ("collective-permute", 0, False),
    "broadcast_": ("broadcast", 0, True),
}

# functional collectives (the start of an asynchronous pair: the result
# is waited for by wait_tensor, its "done" half)
_FUNCTIONAL = {
    "all_reduce": ("all-reduce", 0, True),
    "all_reduce_coalesced": ("all-reduce", 0, True),
    "all_gather_into_tensor": ("all-gather", 0, True),
    "all_gather_into_tensor_coalesced": ("all-gather", 0, True),
    "reduce_scatter_tensor": ("reduce-scatter", 0, True),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0, True),
    "all_to_all_single": ("all-to-all", 0, True),
    "broadcast": ("broadcast", 0, True),
    "wait_tensor": (None, 0, False),
}

# the reference's census names -> the port's ops counted under them
CENSUS = {
    "dot": ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm",
            "aten.addbmm", "aten._scaled_mm"),
    "convolution": ("aten.convolution", "aten._convolution"),
    "custom-call": ("repro_torch.block_sparse_fwd",
                    "repro_torch.block_sparse_dq",
                    "repro_torch.block_sparse_dkv"),
    "transpose": ("aten.transpose", "aten.permute", "aten.t"),
    "reshape": ("aten.view", "aten._unsafe_view", "aten.reshape"),
    "copy": ("aten.copy_", "aten._to_copy", "aten.clone"),
}

_ALLOC = ("aten.empty", "aten.empty_like", "aten.empty_strided",
          "aten.new_empty", "aten.new_empty_strided")


def _bytes(x) -> int:
    """Bytes of the tensors in `x` (a tensor, or lists, tuples and dicts
    of them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_bytes(y) for y in x)
    if isinstance(x, dict):
        return sum(_bytes(y) for y in x.values())
    return 0


def _group_size(args):
    for a in args:
        size = getattr(a, "size", None)
        if callable(size) and not isinstance(a, torch.Tensor):
            try:
                return int(size())
            except Exception:  # noqa: BLE001 - not a process group
                continue
    return None


_INFO: dict = {}


def _info(func):
    """(name, c10d entry or None, moves no bytes) of an OpOverload,
    computed once."""
    got = _INFO.get(func)
    if got is None:
        name = str(func.overloadpacket)
        ns, _, op = name.partition(".")
        rets = func._schema.returns
        # every output aliases an input without writing it: a view
        view = bool(rets) and all(r.alias_info is not None and
                                  not r.alias_info.is_write for r in rets)
        table = {"c10d": _C10D, "_c10d_functional": _FUNCTIONAL}.get(ns, {})
        got = _INFO[func] = (
            name, table.get(op),
            ns in ("c10d", "_c10d_functional", "prim") or name in _ALLOC
            or view)
    return got


def op_record(func, args, kwargs, out) -> dict:
    """The record of one call of `func` (an OpOverload) that returned
    `out`."""
    name, c10d, silent = _info(func)
    # (a c10d or functional collective: its kind, operand and counted half)
    rec = {"op": name, "kind": None, "bytes": 0, "done": False,
           "hbm_bytes": 0}
    if c10d is not None:
        kind, arg, counted = c10d
        rec.update(kind=kind, bytes=_bytes(args[arg]) if counted else 0,
                   done=not counted, group=_group_size(args))
        return rec
    out_bytes = 0 if silent else _bytes(out)
    if not out_bytes:
        return rec
    work = op_work(func, args)
    rec["hbm_bytes"] = work[1] if work is not None else \
        _bytes(args) + _bytes(kwargs) + out_bytes
    return rec


class OpRecorder(TorchDispatchMode):
    """Writes `op_record` of every op dispatched under it to `records`."""

    def __init__(self):
        super().__init__()
        self.records = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.records.append(op_record(func, args, kwargs, out))
        return out


def collective_stats(records) -> dict:
    """{'total_bytes', 'by_kind': {kind: bytes}, 'count': {kind: n}} over
    the records' collectives: operand bytes, the second half of an
    asynchronous pair ("done") skipped."""
    by_kind: dict = defaultdict(int)
    count: dict = defaultdict(int)
    for r in records:
        if r.get("kind") is None or r.get("done"):
            continue
        by_kind[r["kind"]] += int(r["bytes"])
        count[r["kind"]] += 1
    return {"total_bytes": int(sum(by_kind.values())),
            "by_kind": dict(by_kind), "count": dict(count)}


def op_census(records, ops=("fusion", "all-reduce", "all-gather",
                            "reduce-scatter", "all-to-all",
                            "collective-permute", "convolution", "dot",
                            "custom-call", "while", "transpose",
                            "reshape", "copy")) -> dict:
    """{reference op name: count} of the records: collectives by kind (a
    pair once), the port's ops under the reference's names (`CENSUS`);
    "fusion" and "while" count nothing in an eager trace, which fuses
    nothing and unrolls its loops."""
    names = defaultdict(int)
    for r in records:
        if r.get("kind") is not None:
            if not r.get("done"):
                names[r["kind"]] += 1
        else:
            names[r["op"]] += 1
    out = {}
    for op in ops:
        out[op] = names.get(op, 0) if op in COLLECTIVES else \
            sum(names.get(n, 0) for n in CENSUS.get(op, ()))
    return out


def hbm_bytes(records) -> int:
    """The records' bytes moved to and from memory (see the module
    docstring)."""
    return int(sum(r.get("hbm_bytes", 0) for r in records))


def roofline_terms(flops, hbm_bytes, coll_bytes, chips, *, peak_flops,
                   hbm_bw, link_bw):
    """The three roofline terms, in seconds (whole-mesh workload)."""
    return {
        "t_compute": flops / (chips * peak_flops),
        "t_memory": hbm_bytes / (chips * hbm_bw),
        "t_collective": coll_bytes / (chips * link_bw),
    }
