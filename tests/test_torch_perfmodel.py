"""The port's perf model (``repro_torch.perfmodel.ntx``) against the
reference's (``repro.perfmodel.ntx``): the Figure-5 suite, Table I
figures, the paper's headline claims and the four gain ratios the
``auto`` policy consults, equal on the same descriptors and spec.
"""
import numpy as np
import pytest

import repro.core as J
from repro.perfmodel import ntx as jntx

import repro_torch.core as T
from repro_torch.perfmodel import ntx


def _close(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert list(got) == pytest.approx(list(want), rel=1e-12)
    else:
        assert got == pytest.approx(want, rel=1e-12)


def test_figure5_suite_matches_reference():
    pts, jpts = ntx.figure5_suite(), jntx.figure5_suite()
    assert pts.keys() == jpts.keys()
    for name in pts:
        p, j = pts[name], jpts[name]
        assert (p.name, p.flops, p.bytes_dram) == (j.name, j.flops,
                                                   j.bytes_dram)
        assert p.time_s == pytest.approx(j.time_s, rel=1e-12), name
        assert p.gflops == pytest.approx(j.gflops, rel=1e-12)
        assert p.intensity == pytest.approx(j.intensity, rel=1e-12)


def test_table1_and_headline_claims():
    _close(ntx.table1_figures(), jntx.table1_figures())
    t = ntx.table1_figures()
    assert t["peak_gflops"] == pytest.approx(20.0)
    assert t["practical_gflops"] == pytest.approx(17.4)
    assert t["pj_per_flop"] == pytest.approx(9.3, rel=0.01)
    assert ntx.peak_utilization_bound() == pytest.approx(0.87)
    pts = ntx.figure5_suite()
    best = max(p.gflops for p in pts.values())
    assert 0.85 * 20.0 <= best <= 0.87 * 20.0 * 1.001
    bw_cap = T.PAPER_CLUSTER.practical_bw / 1e9
    assert pts["AXPY 4194304"].bw_gbs == pytest.approx(bw_cap, rel=0.02)


@pytest.mark.parametrize("fn,args", [
    ("axpy", (1 << 16,)), ("gemv", (512, 512)), ("gemm", (64, 64, 64)),
    ("conv2d", (256, 256, 5)), ("laplace", (2, 512)), ("diffusion", (512,)),
])
def test_kernel_points_match_reference(fn, args):
    p, j = getattr(ntx, fn)(*args), getattr(jntx, fn)(*args)
    assert (p.name, p.flops, p.bytes_dram) == (j.name, j.flops, j.bytes_dram)
    assert p.time_s == pytest.approx(j.time_s, rel=1e-12)


def _ew(m, op, n, src, dst, imm=0.0, y=None):
    return m.Descriptor(bounds=(n,), opcode=getattr(m.Opcode, op), imm=imm,
                        agu0=m.Agu(src, (1,)),
                        agu1=m.Agu(y, (1,)) if y is not None else m.Agu(),
                        agu2=m.Agu(dst, (1,)))


PROGRAMS = {
    "chains": lambda m: sum(([_ew(m, "THRESH", 256, 1024 * i, 1024 * i + 512,
                                  imm=0.2),
                              _ew(m, "RELU", 256, 1024 * i + 512,
                                  1024 * i + 512)] for i in range(4)), []),
    "dependent": lambda m: sum(([_ew(m, "THRESH", 256, 2048 * i,
                                     2048 * i + 256, imm=0.2),
                                 _ew(m, "RELU", 256, 2048 * i + 256,
                                     2048 * i + 512)] for i in range(3)), []),
    "gemm_epilogue": lambda m: [m.gemm(16, 16, 16, 0, 256, 512),
                                _ew(m, "RELU", 256, 512, 512)],
    "oversize": lambda m: [_ew(m, "THRESH", 40000, 0, 40000, imm=0.1),
                           _ew(m, "RELU", 40000, 40000, 40000)],
    "empty": lambda m: [],
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("n_clusters", [1, 4])
def test_policy_gains_match_reference(name, n_clusters):
    td, jd = PROGRAMS[name](T), PROGRAMS[name](J)
    _close(ntx.policy_gains(td, n_clusters=n_clusters),
           jntx.policy_gains(jd, n_clusters=n_clusters))
    for fn in ("stream_fusion_gain",):
        _close(getattr(ntx, fn)(td), getattr(jntx, fn)(jd))
    for fn in ("multistream_gain", "pipeline_gain"):
        _close(getattr(ntx, fn)(td, n_clusters=n_clusters),
               getattr(jntx, fn)(jd, n_clusters=n_clusters))
    tiny_t, tiny_j = T.NtxMemSpec(tcdm_bytes=4096), J.NtxMemSpec(
        tcdm_bytes=4096)
    _close(ntx.tiling_gain(td, mem=tiny_t), jntx.tiling_gain(jd,
                                                             mem=tiny_j))


def test_ratios_finite():
    g = ntx.policy_gains(PROGRAMS["oversize"](T), n_clusters=4)
    assert g["tiling"]["fits"] == 0.0
    for part in g.values():
        for v in part.values():
            if isinstance(v, float):
                assert np.isfinite(v)
