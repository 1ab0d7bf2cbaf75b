"""The port's DNN-training efficiency model (``repro_torch.perfmodel.dnn``)
against the reference's ``repro.perfmodel.dnn``: the same calibration,
Table II, the GPU comparison and every network's throughput and
efficiency at every configuration, at rel 1e-12; and the reference's own
bounds on the paper's claims (``tests/test_perfmodel.py``) held by the
port."""
import dataclasses

import pytest

from repro.perfmodel import dnn as ref
from repro_torch.perfmodel import dnn

CONFIGS = sorted(ref.PAPER_GEOMEAN)          # (node nm, clusters)
NETS = sorted(ref.NETWORKS)
REL = 1e-12


@pytest.fixture(scope="module")
def pms():
    return ref.calibrate(), dnn.calibrate()


@pytest.mark.parametrize("name", ["NETWORKS", "GPUS", "PAPER_GEOMEAN",
                                  "LIM_COUNT", "HMC_BW", "STALL",
                                  "FC_INTENSITY"])
def test_published_data_equal(name):
    assert getattr(dnn, name) == getattr(ref, name)


def test_calibrate_equal(pms):
    want, got = pms
    assert dataclasses.asdict(got) == pytest.approx(dataclasses.asdict(want),
                                                    rel=REL)


def test_table2_equal(pms):
    want, got = ref.table2(pms[0]), dnn.table2(pms[1])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == pytest.approx(w, rel=REL)


def test_gpu_comparison_equal(pms):
    assert dnn.gpu_comparison(pms[1]) == pytest.approx(
        ref.gpu_comparison(pms[0]), rel=REL)


@pytest.mark.parametrize("node_nm,n_clusters", CONFIGS)
@pytest.mark.parametrize("net", NETS)
def test_throughput_and_efficiency_equal(pms, net, node_nm, n_clusters):
    assert dnn.throughput(net, n_clusters, node_nm) == pytest.approx(
        ref.throughput(net, n_clusters, node_nm), rel=REL)
    for want_pm, got_pm in ((ref.PowerModel(), dnn.PowerModel()), pms):
        assert dnn.efficiency(net, n_clusters, node_nm, got_pm) == \
            pytest.approx(ref.efficiency(net, n_clusters, node_nm, want_pm),
                          rel=REL)


@pytest.mark.parametrize("node_nm,n_clusters", CONFIGS)
def test_geomean_and_power_equal(pms, node_nm, n_clusters):
    assert dnn.geomean_efficiency(n_clusters, node_nm, pms[1]) == \
        pytest.approx(ref.geomean_efficiency(n_clusters, node_nm, pms[0]),
                      rel=REL)
    f = 1.25e9
    assert pms[1].power(n_clusters, f, node_nm) == pytest.approx(
        pms[0].power(n_clusters, f, node_nm), rel=REL)


def test_table2_reproduction_bounds():
    """The reference's bounds: every geomean within 25 % of the published
    table, 12 % on average."""
    rows = dnn.table2(dnn.calibrate())
    errs = [r["rel_err"] for r in rows]
    assert max(errs) < 0.25, rows
    assert sum(errs) / len(errs) < 0.12


def test_gpu_ratio_headlines():
    """The paper's 2.5x (22 nm) / 3x (14 nm) energy efficiency over GPUs
    and 6.5x / 10.4x area efficiency, within the reference's bounds."""
    r = dnn.gpu_comparison()
    assert 2.2 < r["energy_ratio_22nm"] < 3.2
    assert 2.4 < r["energy_ratio_14nm"] < 3.6
    assert 5.5 < r["area_ratio_22nm"] < 7.5
    assert 9.0 < r["area_ratio_14nm"] < 12.0
