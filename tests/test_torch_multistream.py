"""The port's multi-cluster scheduler (``repro_torch.core.multistream``)
against the reference's (``repro.core.multistream``), mirroring
``tests/test_multistream.py`` on the same seeded numpy inputs: the
partition, SCCs, LPT assignment and modelled speedups, ``plan_mode``'s
choices, and results bit-equal to the reference's serial stream in every
mode (GEMM lanes within ``test_gemm_sweep``'s fp32 tolerance).

The reference's 8-device ``shard_map`` subprocess test has no CPU
counterpart (the port's ``shard_map`` puts one block of lanes on each
GPU); here ``shard_map`` on one device raises, and the lane split is
held on two CPU "devices" by standing in for the device list.
"""
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.multistream import _lpt_assign as j_lpt
from repro.core.multistream import _tarjan_scc as j_tarjan

import repro_torch.core as T
from repro_torch.core import multistream as tms
from repro_torch.kernels import ops

RNG = np.random.default_rng(7)
CPU = torch.device("cpu")


def _mem(n=1 << 14):
    return RNG.standard_normal(n).astype(np.float32)


def _ew(m, op, n, src, dst, imm=0.0, y=None):
    return m.Descriptor(bounds=(n,), opcode=getattr(m.Opcode, op), imm=imm,
                        agu0=m.Agu(src, (1,)),
                        agu1=m.Agu(y, (1,)) if y is not None else m.Agu(),
                        agu2=m.Agu(dst, (1,)))


def _chain(m, base, n=256, t_off=512):
    t = base + t_off
    return [_ew(m, "THRESH", n, base, t, imm=0.2),
            _ew(m, "RELU", n, t, t),
            _ew(m, "THRESH", n, t, t, imm=0.5)]


def _both(build):
    return build(J), build(T)


def _one_device(mode: str) -> str:
    """The reference's mode as it picks it on one device: a test process
    may hold several JAX host devices (another test file forced them),
    and then the reference's auto says shard_map where one device says
    vmap. The port's images here are on the CPU, one device."""
    import jax
    return "vmap" if mode == "shard_map" and len(jax.devices()) > 1 \
        else mode


def _ref_serial(jdescs, mem):
    return np.asarray(J.CommandStream(jdescs).execute(mem))


def _port(sched, mem, mode):
    return sched.execute(torch.from_numpy(mem.copy()), mode).numpy()


# ----------------------------------------------------------------------
# Partitioning: the same analysis as the reference
# ----------------------------------------------------------------------
PROGRAMS = {
    "disjoint_chains": lambda m: sum((_chain(m, i * 1024)
                                      for i in range(4)), []),
    "overlapping": lambda m: [_ew(m, "RELU", 128, 0, 1024),
                              _ew(m, "THRESH", 128, 1024, 2048, imm=0.1),
                              _ew(m, "COPY", 128, 3000, 1024 + 64)],
    "mixed": lambda m: [_ew(m, "RELU", 128, 0, 1024),
                        _ew(m, "THRESH", 128, 1024, 1024, imm=0.2),
                        _ew(m, "RELU", 128, 4096, 5120),
                        _ew(m, "THRESH", 128, 5120, 5120, imm=0.3)],
    "read_sharing": lambda m: [_ew(m, "AXPY", 128, 0, 1024, imm=2.0, y=512),
                               _ew(m, "AXPY", 128, 0, 2048, imm=3.0,
                                   y=512)],
    "interleaved": lambda m: [_ew(m, "RELU", 64, 0, 1024),
                              _ew(m, "RELU", 64, 4096, 5120),
                              _ew(m, "THRESH", 64, 1024, 1024, imm=0.1),
                              _ew(m, "THRESH", 64, 5120, 5120, imm=0.2)],
    "non_uniform": lambda m: (sum((_chain(m, i * 1024) for i in range(3)),
                                  []) + [m.memset(32, 1.5, 8192)]),
    "gemm_lanes": lambda m: sum(([m.gemm(16, 16, 16, 1024 * i,
                                         1024 * i + 256, 1024 * i + 512),
                                 _ew(m, "RELU", 256, 1024 * i + 512,
                                     1024 * i + 512)]
                                for i in range(3)), []),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("n_clusters", [1, 2, 4])
def test_partition_costs_and_assignment_match_reference(name, n_clusters):
    jd, td = _both(PROGRAMS[name])
    js = J.ClusterScheduler(jd, n_clusters=n_clusters)
    ts = T.ClusterScheduler(td, n_clusters=n_clusters, device=CPU)
    assert ts.graph.edges == js.graph.edges
    assert [s.indices for s in ts.substreams] == \
        [s.indices for s in js.substreams]
    assert [(s.lo, s.hi, s.write_ranges, s.read_ranges)
            for s in ts.substreams] == \
        [(s.lo, s.hi, s.write_ranges, s.read_ranges) for s in js.substreams]
    assert ts.costs == pytest.approx(js.costs, rel=1e-12)
    assert ts.assignment == js.assignment
    assert set(ts.stats) == set(js.stats)
    for k in ("n_descriptors", "n_substreams", "n_edges", "n_clusters",
              "assignment", "uniform", "traceable"):
        assert ts.stats[k] == js.stats[k], k
    assert ts.model_speedup() == pytest.approx(js.model_speedup(),
                                               rel=1e-12)
    assert ts.plan_mode() == _one_device(js.plan_mode())
    for mode in ("auto", "vmap", "interleave", "serial", "overlap"):
        assert ts.plan_mode(mode, CPU) == _one_device(js.plan_mode(mode)), \
            mode


def test_tarjan_and_lpt_match_reference():
    rng = np.random.default_rng(3)
    for _ in range(40):
        n = int(rng.integers(1, 12))
        succ = [sorted(set(int(v) for v in rng.integers(0, n, rng.integers(
            0, 4)))) for _ in range(n)]
        assert tms._tarjan_scc(n, succ) == j_tarjan(n, succ)
        costs = [float(c) for c in rng.choice([0.0, 0.5, 1.0, 3.0], n)]
        k = int(rng.integers(1, 6))
        assert tms._lpt_assign(costs, k) == j_lpt(costs, k)
    assert tms._lpt_assign([1.0], 0) == [0]
    assert tms._lpt_assign([], 5) == []


def test_scheduler_stats_and_model_speedup():
    td = PROGRAMS["disjoint_chains"](T)
    sched = T.ClusterScheduler(td, n_clusters=4)
    assert sched.stats["n_substreams"] == 4
    assert sorted(sched.stats["assignment"]) == [0, 1, 2, 3]
    assert sched.model_speedup() == pytest.approx(4.0, rel=1e-6)
    from repro_torch.perfmodel.ntx import multistream_gain
    from repro.perfmodel.ntx import multistream_gain as j_gain
    g, jg = multistream_gain(td, n_clusters=2), j_gain(
        PROGRAMS["disjoint_chains"](J), n_clusters=2)
    assert g == pytest.approx(jg, rel=1e-12)
    assert g["speedup"] == pytest.approx(2.0, rel=1e-6)


def test_cluster_count_defaults_to_the_devices():
    td = PROGRAMS["disjoint_chains"](T)
    assert T.ClusterScheduler(td).n_clusters == 1
    assert T.ClusterScheduler(td, device="cpu").n_clusters == 1
    assert tms.device_count("cpu") == 1


# ----------------------------------------------------------------------
# Execution: every mode bit-equal to the reference's serial stream
# ----------------------------------------------------------------------
STREAMING = ("disjoint_chains", "overlapping", "mixed", "read_sharing",
             "interleaved", "non_uniform")


@pytest.mark.parametrize("name", STREAMING)
def test_modes_bit_equal_to_reference_serial(name):
    jd, td = _both(PROGRAMS[name])
    mem = _mem()
    want = _ref_serial(jd, mem)
    sched = T.ClusterScheduler(td, n_clusters=4)
    modes = ["auto", "interleave", "serial"]
    if sched.uniform() and sched.traceable():
        modes.append("vmap")
    else:
        with pytest.raises(ValueError):
            sched.execute(torch.from_numpy(mem.copy()), "vmap")
    for mode in modes:
        np.testing.assert_array_equal(_port(sched, mem, mode), want,
                                      err_msg=mode)
    got = T.Executor("multistream", device="cpu").run_descriptors(td, mem)
    np.testing.assert_array_equal(got.numpy(), want)


def test_vmap_runs_each_group_once_over_all_lanes(monkeypatch):
    """Uniform lanes: one stream call per group, not one per lane — the
    structure the card runs (rows = lanes), here through the plain
    versions. Equally spaced windows are a strided view of the image."""
    td = PROGRAMS["disjoint_chains"](T)
    sched = T.ClusterScheduler(td, n_clusters=4)
    calls = []
    real = ops.elementwise_chain

    def spy(stages, x, ys=()):
        calls.append(tuple(x.shape))
        return real(stages, x, ys)

    monkeypatch.setattr(ops, "elementwise_chain", spy)
    mem = _mem()
    got = _port(sched, mem, "vmap")
    assert calls == [(4, 256)]
    assert sched.stats["lane_view"] is True
    np.testing.assert_array_equal(got,
                                  _ref_serial(PROGRAMS["disjoint_chains"](J),
                                              mem))


def test_vmap_gathers_lanes_whose_windows_overlap(monkeypatch):
    """Lanes sharing a read region have overlapping windows: gathered
    once, their write columns scattered back once."""
    jd, td = _both(lambda m: [_ew(m, "AXPY", 128, 0, 1024 * (i + 1),
                                  imm=1.5 + i, y=512) for i in range(3)])
    sched = T.ClusterScheduler(td, n_clusters=3)
    # windows [0, 1152), [0, 2176), [0, 3200): not uniform
    assert not sched.uniform()
    jd, td = _both(lambda m: [_ew(m, "AXPY", 64, 64 * i, 4096 + 64 * i,
                                  imm=2.0, y=64 * i + 32) for i in range(4)])
    sched = T.ClusterScheduler(td, n_clusters=4)
    assert sched.uniform()
    mem = _mem()
    got = _port(sched, mem, "vmap")
    assert sched.stats["lane_view"] is False
    np.testing.assert_array_equal(got, _ref_serial(jd, mem))


def test_gemm_streams_partition_and_match():
    """Independent GEMM+epilogue programs: every mode within the fp32
    tolerance of the reference's serial stream, and the vmap lanes one
    lane-batched GEMM call."""
    jd, td = _both(PROGRAMS["gemm_lanes"])
    sched = T.ClusterScheduler(td, n_clusters=2)
    assert len(sched.substreams) == 3 and sched.uniform()
    mem = _mem()
    want = _ref_serial(jd, mem)
    ops.reset_launches()
    for mode in ("interleave", "vmap", "serial"):
        got = _port(sched, mem, mode)
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3,
                                   err_msg=mode)
    assert ops.launches()["gemm"] == 0          # plain versions on the CPU


# ----------------------------------------------------------------------
# shard_map: one block of lanes per GPU
# ----------------------------------------------------------------------
def test_shard_map_needs_two_devices():
    td = PROGRAMS["disjoint_chains"](T)
    sched = T.ClusterScheduler(td, n_clusters=4)
    assert sched.plan_mode("auto", CPU) == "vmap"      # never below two
    with pytest.raises(ValueError, match="shard_map"):
        sched.execute(torch.from_numpy(_mem()), "shard_map")
    ex = T.Executor("multistream", device="cpu", transport="shard_map")
    with pytest.raises(ValueError, match="shard_map"):
        ex.run_descriptors(td, _mem())


def test_shard_map_splits_lanes_over_devices(monkeypatch):
    """With two devices (two CPU stand-ins here) the lanes split into two
    blocks, each run as lanes on its device; the result is the serial
    one."""
    monkeypatch.setattr(tms, "lane_devices", lambda mem: [CPU, CPU])
    jd, td = _both(PROGRAMS["disjoint_chains"])
    sched = T.ClusterScheduler(td, n_clusters=4)
    mem = _mem()
    got = _port(sched, mem, "shard_map")
    assert sched.stats["n_devices_used"] == 2
    np.testing.assert_array_equal(got, _ref_serial(jd, mem))


# ----------------------------------------------------------------------
# Random programs: graph == serial
# ----------------------------------------------------------------------
def _random_program(m, rng) -> list:
    descs = []
    for _ in range(rng.integers(2, 8)):
        kind = rng.integers(0, 5)
        base = int(rng.integers(0, 12)) * 1024
        if kind == 0:
            descs.append(_ew(m, str(rng.choice(["RELU", "THRESH", "COPY"])),
                             int(rng.integers(8, 200)), base,
                             int(rng.integers(0, 12)) * 1024,
                             imm=float(rng.standard_normal())))
        elif kind == 1:
            descs.append(_ew(m, str(rng.choice(["ADD", "MUL", "AXPY",
                                                "SUB"])),
                             int(rng.integers(8, 200)), base,
                             int(rng.integers(0, 12)) * 1024,
                             imm=1.5, y=int(rng.integers(0, 12)) * 1024))
        elif kind == 2:
            descs.append(m.memset(int(rng.integers(8, 128)),
                                  float(rng.standard_normal()), base))
        elif kind == 3:
            descs.append(m.argmax(int(rng.integers(8, 128)), base,
                                  int(rng.integers(12, 15)) * 1024))
        else:
            k = int(rng.integers(2, 9))
            descs.append(m.gemm(k, k, k, base, base + 256, base + 512))
    return descs


@pytest.mark.parametrize("seed", range(12))
def test_random_programs_graph_matches_reference(seed):
    jd = _random_program(J, np.random.default_rng(seed))
    td = _random_program(T, np.random.default_rng(seed))
    mem = np.random.default_rng(seed).standard_normal(1 << 14).astype(
        np.float32)
    want = _ref_serial(jd, mem)
    js = J.ClusterScheduler(jd, n_clusters=3)
    ts = T.ClusterScheduler(td, n_clusters=3)
    assert ts.assignment == js.assignment
    assert ts.plan_mode() == _one_device(js.plan_mode())
    for mode in ("auto", "interleave"):
        np.testing.assert_allclose(_port(ts, mem, mode), want, rtol=1e-3,
                                   atol=1e-3, err_msg=f"seed {seed} {mode}")


# ----------------------------------------------------------------------
# Runtime wiring
# ----------------------------------------------------------------------
def test_serve_greedy_argmax_multistream_runs_lanes():
    from repro_torch.runtime import serve as tserve
    logits = RNG.standard_normal((6, 500)).astype(np.float32)
    np.testing.assert_array_equal(
        tserve.greedy_argmax_multistream(logits, device="cpu"),
        logits.argmax(-1))
    ent = tserve._ARGMAX_PROGRAMS[(6, 500, CPU)]
    st = ent[1].stats
    assert st["policy"] == "multistream"
    assert st["scheduler"]["mode_used"] == "vmap"
    assert st["scheduler"]["lane_view"] is True
    tied = np.zeros((2, 7), np.float32)
    tied[0, 3] = tied[0, 5] = 2.0
    np.testing.assert_array_equal(
        tserve.greedy_argmax_multistream(tied, device="cpu"),
        tied.argmax(-1))


def _assert_same(got, want):
    """Nested dicts of numbers and lists: equal keys, numbers equal to
    within float rounding."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert list(got) == pytest.approx(list(want), rel=1e-12)
    else:
        assert got == pytest.approx(want, rel=1e-12)


def test_train_update_plan_multistream_matches_reference():
    from repro.runtime.train import plan_update_multistream as j_plan
    from repro_torch.runtime.train import plan_update_multistream
    params = {"layer0": {"w": np.zeros((64, 64)), "b": np.zeros((64,))},
              "layer1": {"w": np.zeros((64, 64))}}
    for n_clusters in (1, 2, 3):
        plan = plan_update_multistream(params, n_clusters=n_clusters)
        want = j_plan(params, n_clusters=n_clusters)
        _assert_same(plan, want)
    plan = plan_update_multistream(params, n_clusters=2)
    assert plan["n_substreams"] == 3 and set(plan["assignment"]) == {0, 1}
    assert plan["model_speedup"] > 1.5


def test_gemm_lanes_on_the_cpu_and_the_compensated_refusal():
    """``ops.gemm`` over (L, m, k) @ (L, k, n) lanes with per-lane bias
    and residual epilogues equals each lane's own call within the fp32
    GEMM tolerance (the plain version, as the card's lanes are its
    kernel's); the compensated GEMM refuses lanes on either device."""
    rng = np.random.default_rng(5)
    a, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((3, 7, 9), (3, 9, 5)))
    bias = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32))
    res = torch.from_numpy(rng.standard_normal((3, 7, 5)).astype(np.float32))
    got = ops.gemm(a, b, epilogue=[("bias", bias), ("residual", res),
                                   "relu"])
    assert got.shape == (3, 7, 5)
    for lane in range(3):
        one = ops.gemm(a[lane], b[lane], epilogue=[
            ("bias", bias[lane]), ("residual", res[lane]), "relu"])
        torch.testing.assert_close(got[lane], one, rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError, match="compensated"):
        ops.gemm(a, b, compensated=True)
