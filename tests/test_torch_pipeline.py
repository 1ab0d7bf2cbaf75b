"""The port's stage pipeline (``repro_torch.core.multistream.
StageSchedule``) against the reference's, mirroring
``tests/test_pipeline.py`` on the same seeded inputs: the node partition,
levels, handoff sizing and handoff-aware LPT equal to the reference's,
and every stage transport (``vmap``, ``interleave``, ``overlap``,
``serial``) bit-equal to the reference's serial stream on streaming
programs, within the fp32 GEMM tolerance on programs with MAC nests.

The reference's 8-device ``shard_map`` subprocess test has no CPU
counterpart: a stage's ``shard_map`` lanes need two or more GPUs, and on
one device it raises.
"""
import jax
import numpy as np
import pytest
import torch

import repro.core as J
from repro.perfmodel.ntx import pipeline_gain as j_pipeline_gain

import repro_torch.core as T
from repro_torch.core.stream import agu_span, program_spans, spans_overlap
from repro_torch.kernels import ops
from repro_torch.perfmodel.ntx import (multistream_gain, pipeline_gain,
                                       stream_fusion_gain)

RNG = np.random.default_rng(11)
CPU = torch.device("cpu")


def _mem(n=1 << 14):
    return RNG.standard_normal(n).astype(np.float32)


def _ew(m, op, n, src, dst, imm=0.0, y=None):
    return m.Descriptor(bounds=(n,), opcode=getattr(m.Opcode, op), imm=imm,
                        agu0=m.Agu(src, (1,)),
                        agu1=m.Agu(y, (1,)) if y is not None else m.Agu(),
                        agu2=m.Agu(dst, (1,)))


def _producer_consumer(m, n_lanes=4, n=256, lane=2048):
    descs = []
    for i in range(n_lanes):
        x, t, u = lane * i, lane * i + n, lane * i + 2 * n
        descs += [_ew(m, "THRESH", n, x, t, imm=0.2),
                  _ew(m, "RELU", n, t, t),
                  _ew(m, "THRESH", n, t, u, imm=0.1),
                  _ew(m, "RELU", n, u, u)]
    return descs


def _three_stage(m):
    descs = []
    for i in range(3):
        base = 4096 * i
        a, b, c, d = base, base + 512, base + 1024, base + 1536
        descs += [_ew(m, "RELU", 128, a, b),
                  _ew(m, "THRESH", 128, b, c, imm=0.1),
                  _ew(m, "AXPY", 128, c, d, imm=2.0, y=a)]
    return descs


PROGRAMS = {
    "producer_consumer": _producer_consumer,
    "three_stage": _three_stage,
    "scc_pingpong": lambda m: [
        _ew(m, "RELU", 64, 0, 1024), _ew(m, "THRESH", 64, 1024, 2048, imm=.1),
        _ew(m, "AXPY", 64, 2048, 1024, imm=0.5, y=2048)],
    "independent": lambda m: [_ew(m, "RELU", 128, 4096 * i, 4096 * i + 512)
                              for i in range(3)],
    "non_uniform": lambda m: (_producer_consumer(m, n_lanes=2, n=128)
                              + [m.memset(32, 1.5, 12000)]),
    "handoff_read_footprint": lambda m: [
        _ew(m, "RELU", 64, 0, 1024), _ew(m, "RELU", 64, 0, 4096),
        _ew(m, "ADD", 64, 1024, 8192, y=6144)],
}


def _ref_serial(jdescs, mem):
    return np.asarray(J.CommandStream(jdescs).execute(mem))


def _port(ss, mem, mode):
    return ss.execute(torch.from_numpy(mem.copy()), mode).numpy()


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("n_clusters", [2, 4])
def test_stage_structure_matches_reference(name, n_clusters):
    jd, td = PROGRAMS[name](J), PROGRAMS[name](T)
    js = J.StageSchedule(jd, n_clusters=n_clusters)
    ts = T.StageSchedule(td, n_clusters=n_clusters, device=CPU)
    assert [nd.indices for nd in ts.nodes] == [nd.indices for nd in js.nodes]
    assert ts.node_edges == js.node_edges
    assert ts.level == js.level and ts.stages == js.stages
    assert ts.assignment == js.assignment
    assert ts.handoffs == js.handoffs
    assert set(ts.stats) == set(js.stats)
    for k in ("n_nodes", "n_edges", "n_stages", "levels", "assignment",
              "stage_sizes", "handoff_bytes", "handoff_bytes_cross"):
        assert ts.stats[k] == js.stats[k], k
    for k in ("serial_time_s", "pipeline_time_s", "pipeline_overlap_time_s"):
        assert ts.stats[k] == pytest.approx(js.stats[k], rel=1e-12), k
    assert ts.model_speedup() == pytest.approx(js.model_speedup(), rel=1e-12)
    for stage in ts.stages:
        for mode in ("auto", "vmap", "interleave"):
            want = js.plan_stage_mode(stage, mode)
            if mode == "auto" and want == "shard_map" and \
                    len(jax.devices()) > 1:
                want = "vmap"      # the reference's pick on one device
            assert ts.plan_stage_mode(stage, mode, CPU) == want, (stage,
                                                                  mode)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_stage_modes_bit_equal_to_reference_serial(name):
    jd, td = PROGRAMS[name](J), PROGRAMS[name](T)
    mem = _mem()
    want = _ref_serial(jd, mem)
    ss = T.StageSchedule(td, n_clusters=4)
    for mode in ("auto", "interleave", "vmap", "overlap", "serial"):
        np.testing.assert_array_equal(_port(ss, mem, mode), want,
                                      err_msg=mode)
    got = T.Executor("pipeline", device="cpu",
                     n_clusters=4).run_descriptors(td, mem)
    np.testing.assert_array_equal(got.numpy(), want)


def test_stage_lanes_one_call_per_stage(monkeypatch):
    """The producer/consumer lanes level into 2 uniform stages: under vmap
    each stage's groups run once over all 4 lanes."""
    td = _producer_consumer(T)
    ss = T.StageSchedule(td, n_clusters=4)
    assert ss.stats["stage_sizes"] == [4, 4]
    calls = []
    real = ops.elementwise_chain

    def spy(stages, x, ys=()):
        calls.append(tuple(x.shape))
        return real(stages, x, ys)

    monkeypatch.setattr(ops, "elementwise_chain", spy)
    _port(ss, _mem(), "vmap")
    assert calls == [(4, 256), (4, 256)]
    assert ss.stats["stage_modes"] == ["vmap", "vmap"]


def test_stage_shard_map_needs_two_devices():
    ss = T.StageSchedule(_producer_consumer(T), n_clusters=4)
    with pytest.raises(ValueError, match="shard_map"):
        ss.execute(torch.from_numpy(_mem()), "shard_map")


def test_pipeline_gain_matches_reference():
    for name in sorted(PROGRAMS):
        g = pipeline_gain(PROGRAMS[name](T), n_clusters=4)
        jg = j_pipeline_gain(PROGRAMS[name](J), n_clusters=4)
        assert g.keys() == jg.keys()
        for k in g:
            assert g[k] == pytest.approx(jg[k], rel=1e-12), (name, k)
    g = pipeline_gain(_producer_consumer(T), n_clusters=4)
    assert g["n_stages"] == 2.0 and g["speedup"] > 1.0


def _random_dep_program(m, rng) -> list:
    descs = []
    reg = lambda i: int(i) * 1024
    for _ in range(rng.integers(3, 10)):
        kind = rng.integers(0, 6)
        n = int(rng.integers(8, 200))
        src = reg(rng.integers(0, 8))
        dst = reg(rng.integers(0, 8))
        if kind == 0:
            descs.append(_ew(m, str(rng.choice(["RELU", "THRESH", "COPY"])),
                             n, src, dst, imm=float(rng.standard_normal())))
        elif kind == 1:
            descs.append(_ew(m, str(rng.choice(["ADD", "MUL", "AXPY",
                                                "SUB"])),
                             n, src, dst, imm=1.5, y=reg(rng.integers(0, 8))))
        elif kind == 2:
            descs.append(m.memset(int(rng.integers(8, 128)),
                                  float(rng.standard_normal()), dst))
        elif kind == 3:
            descs.append(m.argmax(int(rng.integers(8, 128)), src,
                                  reg(rng.integers(12, 15))))
        elif kind == 4:
            k = int(rng.integers(2, 9))
            descs.append(m.gemm(k, k, k, src, src + 256, src + 512))
        else:
            descs.append(m.Descriptor(bounds=(0,), opcode=m.Opcode.RELU,
                                      agu0=m.Agu(src, (1,)),
                                      agu2=m.Agu(dst, (1,))))
    return descs


@pytest.mark.parametrize("seed", range(12))
def test_random_dependent_dags_match_reference(seed):
    jd = _random_dep_program(J, np.random.default_rng(seed))
    td = _random_dep_program(T, np.random.default_rng(seed))
    mem = np.random.default_rng(seed).standard_normal(1 << 14).astype(
        np.float32)
    want = _ref_serial(jd, mem)
    ss = T.StageSchedule(td, n_clusters=3)
    js = J.StageSchedule(jd, n_clusters=3)
    assert ss.assignment == js.assignment and ss.stages == js.stages
    for mode in ("auto", "interleave", "vmap", "overlap"):
        np.testing.assert_allclose(_port(ss, mem, mode), want, rtol=1e-3,
                                   atol=1e-3, err_msg=f"seed {seed} {mode}")


# ----------------------------------------------------------------------
# Span analysis, gain guards and LPT validity (the reference's satellites)
# ----------------------------------------------------------------------
def test_agu_span_degenerate_nests():
    assert agu_span(T.Agu(100, (4,)), (0,)) == (100, 100)
    assert agu_span(T.Agu(100, (1, 8)), (16, 0)) == (100, 100)
    assert agu_span(T.Agu(100, (0,)), (5,)) == (100, 101)
    assert agu_span(T.Agu(100, (-2,)), (3,)) == (96, 101)
    assert not spans_overlap((100, 100), (0, 1000))


def test_zero_trip_descriptor_conflicts_with_nothing():
    z = T.Descriptor(bounds=(0,), opcode=T.Opcode.COPY,
                     agu0=T.Agu(0, (1,)), agu2=T.Agu(50, (1,)))
    descs = [T.relu(64, 0, 32), z, T.memcpy(64, 40, 3000)]
    g = T.StreamGraph(descs)
    assert g.n_edges == 1 and len(g.partition()) == 2
    mem = _mem(4096)
    got = T.Executor("pipeline", device="cpu").run_descriptors(descs, mem)
    np.testing.assert_array_equal(
        got.numpy(), _ref_serial([J.relu(64, 0, 32), J.Descriptor(
            bounds=(0,), opcode=J.Opcode.COPY, agu0=J.Agu(0, (1,)),
            agu2=J.Agu(50, (1,))), J.memcpy(64, 40, 3000)], mem))


def test_program_spans_export():
    descs = [_ew(T, "RELU", 64, 0, 256), _ew(T, "ADD", 64, 256, 512, y=1024)]
    reads, writes = program_spans(descs)
    assert reads == [(0, 64), (256, 320), (1024, 1088)]
    assert writes == [(256, 320), (512, 576)]


def test_gain_ratios_guarded_on_degenerate_programs():
    zero_trip = T.Descriptor(bounds=(0,), opcode=T.Opcode.RELU,
                             agu0=T.Agu(0, (1,)), agu2=T.Agu(0, (1,)))
    for descs in ([], [zero_trip]):
        f = stream_fusion_gain(descs, setup_cycles=0)
        m = multistream_gain(descs, n_clusters=4, setup_cycles=0)
        p = pipeline_gain(descs, n_clusters=4, setup_cycles=0)
        assert f["speedup"] == 1.0 and p["speedup"] == 1.0
        assert m["speedup"] == 1.0 and m["dma_overlap_gain"] == 1.0


def test_scheduler_more_clusters_than_substreams():
    jd = [_ew(J, "RELU", 64, 4096 * i, 4096 * i + 512) for i in range(2)]
    td = [_ew(T, "RELU", 64, 4096 * i, 4096 * i + 512) for i in range(2)]
    mem = _mem()
    want = _ref_serial(jd, mem)
    sched = T.ClusterScheduler(td, n_clusters=16)
    assert len(sched.cluster_times()) == 16
    np.testing.assert_array_equal(_port(sched, mem, "auto"), want)
    ss = T.StageSchedule(td, n_clusters=16)
    assert np.isfinite(ss.model_speedup())
    np.testing.assert_array_equal(_port(ss, mem, "auto"), want)


# ----------------------------------------------------------------------
# Runtime wiring
# ----------------------------------------------------------------------
def test_serve_prefill_pipelined_argmax():
    from repro_torch.runtime import serve as tserve
    logits = RNG.standard_normal((6, 500)).astype(np.float32)
    np.testing.assert_array_equal(
        tserve.greedy_argmax_pipelined(logits, device="cpu"),
        logits.argmax(-1))
    _, executor, _, _ = tserve._PREFILL_PROGRAMS[(6, 500, CPU)]
    assert executor.stats["policy"] == "pipeline"
    assert executor.stats["scheduler"]["n_stages"] == 2
    assert executor.stats["scheduler"]["stage_modes"] == ["vmap", "vmap"]


def test_train_update_plan_pipelined():
    from repro_torch.runtime.train import plan_update_multistream
    params = {"l0": {"w": np.zeros((64, 64)), "b": np.zeros((64,))},
              "l1": {"w": np.zeros((64, 64))}}
    plan = plan_update_multistream(params, n_clusters=2)
    pp = plan["pipeline"]
    assert plan["n_substreams"] == 3
    assert pp["n_nodes"] == 6 and pp["n_stages"] == 2
    assert pp["model_speedup"] > 1.0 and pp["handoff_bytes"] > 0
