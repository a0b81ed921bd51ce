"""Port parity, the traced step's analysis (`repro_torch.launch.hlo`) against
the JAX package's HLO analysis (`repro.launch.hlo`): the roofline arithmetic
on tests/test_hlo.py's case and on seeded random inputs, and the
collective statistics and op census of op records made from
tests/test_hlo.py's SAMPLE collectives (the same operands through the
port's c10d ops) against the reference's parse of SAMPLE. No process group
is joined: `op_record` reads the ops' arguments only.
"""
import numpy as np
import pytest
import torch

SAMPLE = """
HloModule jit_step
fused_computation {
  p0 = bf16[128,256]{1,0} parameter(0)
}
ENTRY main {
  %x = bf16[128,256]{1,0} parameter(0)
  %y = f32[64]{0} parameter(1)
  %ar = bf16[128,256]{1,0} all-reduce(%x), replica_groups={}
  %ag = bf16[512,256]{1,0} all-gather(%x), dimensions={0}
  %rs = f32[16]{0} reduce-scatter(%y), dimensions={0}
  %cp = bf16[128,256]{1,0} collective-permute(%x), source_target_pairs={{0,1}}
  %a2a = bf16[128,256]{1,0} all-to-all(%x), dimensions={0}
  ROOT %out = bf16[128,256]{1,0} add(%ar, %cp)
}
"""

ASYNC = """
ENTRY main {
  %x = bf16[8,8]{1,0} parameter(0)
  %s = bf16[8,8]{1,0} all-gather-start(%x), dimensions={0}
  %d = bf16[8,8]{1,0} all-gather-done(%s)
}
"""


class _Group:
    """Stands in for a process group argument (`size()` only)."""

    def size(self):
        return 4


def _sample_records():
    """The port's records of SAMPLE's collectives: the same operands
    through the c10d ops the port's dist.* calls reach."""
    from repro_torch.launch.hlo import op_record
    c10d = torch.ops.c10d
    x = torch.zeros(128, 256, dtype=torch.bfloat16)
    y = torch.zeros(64, dtype=torch.float32)
    pg = _Group()
    calls = [
        (c10d.allreduce_.default, ([x], pg)),
        (c10d.allgather_.default, ([[torch.zeros_like(x)] * 4], [x], pg)),
        (c10d._reduce_scatter_base_.default, (torch.zeros(16), y, pg)),
        (c10d.send.default, ([x], pg, 1, 0)),
        (c10d.recv_.default, ([torch.zeros_like(x)], pg, 3, 0)),
        (c10d.alltoall_base_.default, (torch.zeros_like(x), x, pg, [], [])),
    ]
    return [op_record(f, a, {}, None) for f, a in calls]


def test_collective_stats_match_reference():
    """by_kind, count and total_bytes of SAMPLE: operand bytes (an
    all-gather's input, not its result), a send / recv pair once."""
    from repro.launch.hlo import collective_stats as ref
    from repro_torch.launch.hlo import collective_stats
    got = collective_stats(_sample_records())
    want = ref(SAMPLE)
    assert got == want
    assert got["by_kind"]["all-gather"] == 128 * 256 * 2
    assert got["count"]["collective-permute"] == 1


def test_async_start_done_counted_once():
    """An asynchronous pair (a functional all-gather and its wait) counts
    once, as the reference's -start / -done pair does."""
    from repro.launch.hlo import collective_stats as ref
    from repro_torch.launch.hlo import collective_stats, op_record
    x = torch.zeros(8, 8, dtype=torch.bfloat16)
    fc = torch.ops._c10d_functional
    recs = [op_record(fc.all_gather_into_tensor.default, (x, 1, "0"), {},
                      None),
            op_record(fc.wait_tensor.default, (x,), {}, None)]
    assert collective_stats(recs) == ref(ASYNC)


def test_op_census_matches_reference_on_collectives():
    """The census's collective entries equal the reference's on SAMPLE;
    dots, the kernels' ops, copies, transposes and views land under the
    reference's names; an eager trace has no fusion or while."""
    from repro.launch.hlo import op_census as ref
    from repro_torch.launch.hlo import COLLECTIVES, op_census, op_record
    recs = _sample_records()
    want = ref(SAMPLE)
    got = op_census(recs)
    assert {k: got[k] for k in COLLECTIVES} == {k: want[k]
                                               for k in COLLECTIVES}
    a = torch.zeros(4, 8)
    b = torch.zeros(8, 3)
    aten = torch.ops.aten
    recs = [op_record(aten.mm.default, (a, b), {}, a @ b),
            op_record(aten.bmm.default, (a[None], b[None]), {},
                      (a @ b)[None]),
            op_record(aten.t.default, (a,), {}, a.t()),
            op_record(aten.view.default, (a, [32]), {}, a.view(32)),
            op_record(aten.clone.default, (a,), {}, a.clone())]
    got = op_census(recs)
    assert (got["dot"], got["transpose"], got["reshape"], got["copy"],
            got["fusion"], got["while"]) == (2, 1, 1, 1, 0, 0)


def test_op_record_bytes():
    """An op reads and writes its tensors once (in place too); a view,
    an allocation and a collective move no HBM bytes."""
    from repro_torch.launch.hlo import hbm_bytes, op_record
    aten = torch.ops.aten
    a = torch.zeros(4, 8)
    b = torch.zeros(8, 3)
    assert op_record(aten.mm.default, (a, b), {}, a @ b)["hbm_bytes"] == \
        4 * (32 + 24 + 12)
    assert op_record(aten.add_.Tensor, (a, a), {}, a)["hbm_bytes"] == \
        4 * 32 * 3
    assert op_record(aten.t.default, (a,), {}, a.t())["hbm_bytes"] == 0
    assert op_record(aten.empty_like.default, (a,), {},
                     torch.empty_like(a))["hbm_bytes"] == 0
    recs = _sample_records()
    assert hbm_bytes(recs) == 0


def test_kernel_ops_count_their_own_work():
    """The three kernels' ops are "custom-call"s whose bytes are their
    kernels' counts (kernels/work.py), read from the call's tables."""
    from repro_torch.kernels import block_sparse_attn as bsa
    from repro_torch.kernels.work import fwd_work
    from repro_torch.launch.hlo import op_census, op_record
    q = torch.zeros(2, 3, 64, 16, dtype=torch.bfloat16)
    k = torch.zeros(2, 64, 16, dtype=torch.bfloat16)
    col = torch.tensor([[0, 0], [0, 1], [1, 2], [2, 3]], dtype=torch.int32)
    nv = torch.tensor([1, 2, 2, 2], dtype=torch.int32)
    args = (q, k, k, col, nv, 16, True, -1, 64, 0, 0, 2, 0)
    rec = op_record(bsa.OPS["block_sparse_fwd"], args, {}, (q, nv))
    assert rec["hbm_bytes"] == fwd_work(q, k, col, nv, block=16,
                                        causal=True, offsets=(0, 0))[1]
    assert op_census([rec])["custom-call"] == 1


def test_roofline_terms_match_reference_case():
    from repro.launch.hlo import roofline_terms as ref
    from repro_torch.launch.hlo import roofline_terms
    args = (197e12, 819e9, 50e9, 1)
    kw = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)
    got = roofline_terms(*args, **kw)
    assert got == ref(*args, **kw)
    assert got["t_compute"] == pytest.approx(1.0)
    assert got["t_memory"] == pytest.approx(1.0)
    assert got["t_collective"] == pytest.approx(1.0)


@pytest.mark.parametrize("seed", range(8))
def test_roofline_terms_match_reference_random(seed):
    """Bitwise the reference's arithmetic on seeded random inputs, the
    H100 constants among the peaks."""
    from repro.launch.hlo import roofline_terms as ref
    from repro_torch.launch.hlo import roofline_terms
    from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW_PER_GPU,
                                         PEAK_FLOPS_BF16)
    rng = np.random.default_rng(seed)
    flops, hbm, coll = (float(v) for v in 10.0 ** rng.uniform(6, 18, 3))
    chips = int(rng.integers(1, 513))
    peaks = [dict(peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW,
                  link_bw=NVLINK_BW_PER_GPU),
             dict(peak_flops=float(rng.uniform(1e14, 1e15)),
                  hbm_bw=float(rng.uniform(1e11, 1e13)),
                  link_bw=float(rng.uniform(1e10, 1e12)))]
    for kw in peaks:
        assert roofline_terms(flops, hbm, coll, chips, **kw) == \
            ref(flops, hbm, coll, chips, **kw)
