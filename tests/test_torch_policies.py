"""The port's Program/Executor front door under all five policies against
the reference's, mirroring ``tests/test_program.py``: every policy (and
the auto pick) bit-equal on fixed and random streaming programs and held
to the reference's results and engine oracle, the auto decision equal to
the reference's on every program here, mocked gain ratios, validation,
the handoff-aware stage LPT, the plan cache, and the allocator and
pack/unpack tests; plus ``tests/test_descriptor_engine.py``'s hw-step
encoding property.

``test_policy_backend_scopes_the_run`` has no counterpart: the port has
no backend switch (the device of the image decides).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as J
from repro.core import engine as jengine

import repro_torch.core as T
from repro_torch.core import engine as tengine
from repro_torch.core.executor import POLICIES as T_POLICIES
from repro_torch.core.stream import FusedChainReduce, plan_stream

RNG = np.random.default_rng(13)
CPU = torch.device("cpu")
POLICIES = ("serial", "fused", "multistream", "pipeline", "tiled")


def _arr(n):
    return RNG.standard_normal(n).astype(np.float32)


def _chain_program(m, n=256):
    """thresh -> relu -> axpy chain with an argmax tail, two inputs."""
    p = m.Program()
    x = p.buffer((n,), name="x")
    y = p.buffer((n,), name="y")
    t = p.thresh(x, 0.2)
    p.relu(t, out=t)
    out = p.axpy(1.5, t, y)
    s = p.reduce("argmax", out, name="amax")
    return p, x, y, out, s


def _mem_of(res):
    return res.mem.numpy() if torch.is_tensor(res.mem) else np.asarray(
        res.mem)


# ----------------------------------------------------------------------
# Allocator and pack/unpack (the reference's tests, on the port)
# ----------------------------------------------------------------------
def test_allocator_alignment_and_no_overlap():
    sizes = [int(n) for n in RNG.integers(1, 100, size=20)]
    p, jp = T.Program(align=8), J.Program(align=8)
    handles = [p.buffer((n,)) for n in sizes]
    for n in sizes:
        jp.buffer((n,))
    spans = p.spans()
    assert spans == jp.spans()
    for h, (lo, hi) in zip(handles, spans):
        assert lo % 8 == 0 and hi - lo == h.size
    for (al, ah), (bl, bh) in zip(spans, spans[1:]):
        assert ah <= bl
    assert p.size == spans[-1][1]


def test_allocator_deterministic_layout():
    def build(m):
        p = m.Program()
        a = p.buffer((37,), name="a")
        p.buffer((5, 5), name="b")
        c = p.axpy(2.0, a, a)
        p.reduce("sum", c)
        return p
    assert build(T).spans() == build(T).spans() == build(J).spans()
    assert build(T).descriptors == build(T).descriptors


def test_allocator_rejects_bad_shapes_and_names():
    p = T.Program()
    p.buffer((4,), name="x")
    with pytest.raises(ValueError):
        p.buffer((4,), name="x")
    with pytest.raises(ValueError):
        p.buffer((-1,))
    with pytest.raises(ValueError):
        T.Program(align=0)


def test_foreign_handle_rejected():
    p1, p2 = T.Program(), T.Program()
    x = p1.buffer((8,))
    with pytest.raises(ValueError):
        p2.relu(x)


def test_pack_unpack_roundtrip():
    p = T.Program()
    a = p.buffer((3, 4), name="a", init=np.arange(12, dtype=np.float32))
    b = p.buffer((5,), name="b")
    c = p.buffer((7,), name="c")
    data = _arr(5)
    mem = p.pack({b: data}, device="cpu")
    res = p.unpack(mem)
    np.testing.assert_array_equal(res[a], np.arange(12).reshape(3, 4))
    np.testing.assert_array_equal(res["b"], data)
    np.testing.assert_array_equal(res[c], np.zeros(7))
    mem2 = p.pack({a: np.ones(12, np.float32)}, device="cpu")
    np.testing.assert_array_equal(p.unpack(mem2)[a], np.ones((3, 4)))


def test_pack_validates_sizes():
    p = T.Program()
    b = p.buffer((5,))
    with pytest.raises(ValueError):
        p.pack({b: np.zeros(6, np.float32)}, device="cpu")
    with pytest.raises(ValueError):
        p.buffer((4,), init=np.zeros(3, np.float32))
    with pytest.raises(ValueError):
        p.unpack(torch.zeros(p.size + 1))


# ----------------------------------------------------------------------
# Every policy bit-equal, held to the reference and the engine oracle
# ----------------------------------------------------------------------
def test_all_policies_bit_equal_and_match_engine():
    n = 256
    tp, tx, ty, tout, ts = _chain_program(T, n)
    jp, jx, jy, *_ = _chain_program(J, n)
    xs, ys = _arr(n), _arr(n)
    ex = T.Executor(device="cpu")
    base = ex.run(tp, inputs={tx: xs, ty: ys})
    assert ex.stats["policy"] in POLICIES
    jex = J.Executor(n_clusters=1)
    want = jex.run(jp, inputs={jx: xs, jy: ys})
    assert ex.stats["policy"] == jex.stats["policy"]
    np.testing.assert_array_equal(_mem_of(base), _mem_of(want))
    mo = tp.pack({tx: xs, ty: ys}, device="cpu").numpy()
    for d in tp.descriptors:
        mo = tengine.execute(d, mo)
    np.testing.assert_allclose(_mem_of(base), mo, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(base[ts], [np.argmax(base[tout])])
    for pol in T_POLICIES:
        got = T.Executor(pol, device="cpu").run(tp, inputs={tx: xs, ty: ys})
        np.testing.assert_array_equal(_mem_of(got), _mem_of(base),
                                      err_msg=pol)


def _random_stream_program(m, rng):
    p = m.Program()
    n = int(rng.integers(8, 300))
    bufs = [p.buffer((n,), name=f"b{i}",
                     init=rng.standard_normal(n).astype(np.float32))
            for i in range(4)]
    for _ in range(int(rng.integers(2, 10))):
        kind = int(rng.integers(0, 7))
        x, y, out = (bufs[int(rng.integers(0, len(bufs)))]
                     for _ in range(3))
        if kind == 0:
            p.thresh(x, float(rng.standard_normal()), out=out)
        elif kind == 1:
            p.relu(x, out=out)
        elif kind == 2:
            p.copy(x, out=out)
        elif kind == 3:
            getattr(p, str(rng.choice(["add", "sub", "mul", "mask"])))(
                x, y, out=out)
        elif kind == 4:
            p.axpy(float(rng.standard_normal()), x, y, out=out)
        elif kind == 5:
            p.set(out, float(rng.standard_normal()))
        else:
            p.reduce(str(rng.choice(["sum", "min", "max", "argmin",
                                     "argmax"])), x)
    return p


@pytest.mark.parametrize("seed", range(16))
def test_random_programs_bit_equal_across_policies(seed):
    """A random Program is bit-equal across all five policies, every
    transport and the auto pick, and equal to the reference's serial
    result (its SUMs within 1e-5); the auto pick is the reference's."""
    tp = _random_stream_program(T, np.random.default_rng(seed))
    jp = _random_stream_program(J, np.random.default_rng(seed))
    base = _mem_of(T.Executor("serial", device="cpu").run(tp))
    # SUMs are taken in another order than XLA's: a tolerance against the
    # reference, bits within the port
    np.testing.assert_allclose(
        base, _mem_of(J.Executor(policy="serial").run(jp)), rtol=1e-5,
        atol=1e-5)
    runs = [(pol, {}) for pol in POLICIES[1:]] + [(None, {})]
    sched = T.ClusterScheduler(tp.descriptors)
    stacked = sched.uniform() and sched.traceable()
    runs += [("multistream", {"transport": t})
             for t in (("vmap",) if stacked else ()) + ("interleave",
                                                         "serial")]
    runs += [("pipeline", {"transport": t})
             for t in ("vmap", "interleave", "overlap")]
    runs += [("tiled", {"dma_overlap": False, "mem": T.NtxMemSpec(
        tcdm_bytes=1024)})]
    for pol, kw in runs:
        ex = (T.Executor(device="cpu", **kw) if pol is None
              else T.Executor(pol, device="cpu", **kw))
        np.testing.assert_array_equal(_mem_of(ex.run(tp)), base,
                                      err_msg=f"seed {seed} {pol} {kw}")
    assert T.Executor(device="cpu").plan(tp)["policy"] == \
        J.Executor(n_clusters=1).plan(jp)["policy"]


def test_program_arg_reductions_bit_equal_across_policies():
    data = [_arr(200) for _ in range(4)]

    def build(m):
        p = m.Program()
        for i in range(4):
            r = p.buffer((200,), name=f"r{i}", init=data[i])
            t = p.thresh(r, 0.0)
            p.reduce("argmax", t, name=f"amax{i}")
            p.reduce("argmin", t, name=f"amin{i}")
        return p
    tp, jp = build(T), build(J)
    base = _mem_of(T.Executor("serial", device="cpu").run(tp))
    np.testing.assert_array_equal(
        base, _mem_of(J.Executor(policy="serial").run(jp)))
    for pol in POLICIES[1:]:
        np.testing.assert_array_equal(
            _mem_of(T.Executor(pol, device="cpu").run(tp)), base,
            err_msg=pol)


def test_run_descriptors_matches_run_per_policy():
    tp, tx, ty, *_ = _chain_program(T, 128)
    inputs = {tx: _arr(128), ty: _arr(128)}
    mem = tp.pack(inputs, device="cpu")
    for pol in ("fused", "multistream", "pipeline", "tiled"):
        via_raw = T.Executor(device="cpu").run_descriptors(
            tp.descriptors, mem, policy=pol)
        want = _mem_of(T.Executor(pol, device="cpu").run(tp, inputs=inputs))
        np.testing.assert_array_equal(via_raw.numpy(), want, err_msg=pol)


def test_arg_chain_tail_fuses_and_runs_as_one_group():
    p = T.Program()
    x = p.buffer((300,), name="x", init=_arr(300))
    t = p.thresh(x, -0.5)
    p.relu(t, out=t)
    s = p.reduce("argmax", t)
    groups = plan_stream(p.descriptors)
    assert len(groups) == 1 and isinstance(groups[0], FusedChainReduce)
    res = T.Executor("fused", device="cpu").run(p)
    assert int(res[s][0]) == int(np.argmax(res[t]))


# ----------------------------------------------------------------------
# Policy auto-selection
# ----------------------------------------------------------------------
def _fake_gains(fusion, multi, pipe, fits=1.0):
    return {"fusion": {"speedup": fusion},
            "multistream": {"speedup": multi},
            "pipeline": {"speedup": pipe},
            "tiling": {"speedup": 1.0, "fits": fits}}


@pytest.mark.parametrize("fusion,multi,pipe,want", [
    (1.0, 1.0, 1.0, "serial"),
    (2.5, 1.0, 1.0, "fused"),
    (2.0, 3.0, 1.2, "multistream"),
    (1.5, 1.4, 2.8, "pipeline"),
    (0.9, 1.0, 1.0, "serial"),
    (2.0, 1.7, 1.7, "multistream"),
])
def test_auto_policy_selection_mocked_gains(monkeypatch, fusion, multi,
                                            pipe, want):
    monkeypatch.setattr("repro_torch.perfmodel.ntx.policy_gains",
                        lambda *a, **k: _fake_gains(fusion, multi, pipe))
    chosen, gains = T.Executor(device="cpu").select_policy([])
    assert chosen == want
    assert set(gains["scores"]) == {"serial", "fused", "multistream",
                                    "pipeline"}


def test_auto_policy_capacity_overrides_scores(monkeypatch):
    monkeypatch.setattr("repro_torch.perfmodel.ntx.policy_gains",
                        lambda *a, **k: _fake_gains(9.0, 9.0, 9.0, fits=0.0))
    assert T.Executor(device="cpu").select_policy([])[0] == "tiled"


def _producer_consumer_program(m, n_lanes=4, n=64):
    p = m.Program()
    for i in range(n_lanes):
        x = p.buffer((n,), name=f"x{i}", init=np.ones(n, np.float32))
        t = p.thresh(x, 0.1)
        u = p.relu(t)
        p.copy(u)
    return p


AUTO_PROGRAMS = {
    "chain": lambda m: _chain_program(m)[0],
    "producer_consumer": _producer_consumer_program,
    "random0": lambda m: _random_stream_program(m, np.random.default_rng(0)),
    "random5": lambda m: _random_stream_program(m, np.random.default_rng(5)),
}


@pytest.mark.parametrize("name", sorted(AUTO_PROGRAMS))
@pytest.mark.parametrize("n_clusters", [1, 2, 4, 8])
def test_auto_pick_and_gains_match_reference(name, n_clusters):
    from repro.perfmodel.ntx import policy_gains as j_gains
    from repro_torch.perfmodel.ntx import policy_gains
    tp, jp = AUTO_PROGRAMS[name](T), AUTO_PROGRAMS[name](J)
    plan = T.Executor(device="cpu", n_clusters=n_clusters).plan(tp)
    jplan = J.Executor(n_clusters=n_clusters).plan(jp)
    assert plan["policy"] == jplan["policy"]
    assert plan["n_clusters"] == jplan["n_clusters"] == n_clusters
    g = policy_gains(tp.descriptors, n_clusters=n_clusters)
    jg = j_gains(jp.descriptors, n_clusters=n_clusters)
    assert g.keys() == jg.keys()
    for part in g:
        for k, v in jg[part].items():
            got = g[part][k]
            if isinstance(v, list):
                assert got == pytest.approx(v, rel=1e-12), (part, k)
            else:
                assert got == pytest.approx(v, rel=1e-12), (part, k)


def test_auto_policy_override_per_call():
    tp, tx, ty, *_ = _chain_program(T, 64)
    inputs = {tx: _arr(64), ty: _arr(64)}
    ex = T.Executor(device="cpu")
    ex.run(tp, inputs=inputs, policy="pipeline")
    assert ex.stats["policy"] == "pipeline"
    assert ex.stats["scheduler"]["n_stages"] >= 1
    with pytest.raises(ValueError):
        ex.run(tp, inputs=inputs, policy="warp")


def test_plan_reports_policy_without_running():
    tp, *_ = _chain_program(T, 64)
    plan = T.Executor(device="cpu").plan(tp)
    assert plan["policy"] in POLICIES
    assert set(plan["gains"]["scores"]) == {"serial", "fused",
                                            "multistream", "pipeline"}
    assert T.Executor("pipeline", device="cpu").plan(tp)["policy"] == \
        "pipeline"
    assert not hasattr(tp, "_plan_cache")          # nothing ran


def test_policy_validation():
    with pytest.raises(ValueError):
        T.ExecutionPolicy(policy="warp")
    with pytest.raises(ValueError):
        T.ExecutionPolicy(transport="bus")
    with pytest.raises(ValueError):
        T.ExecutionPolicy(autotune="guess")
    pol = T.ExecutionPolicy()
    assert (pol.policy, pol.transport, pol.n_clusters, pol.dma_overlap) == \
        ("auto", "auto", None, True)
    assert not hasattr(pol, "backend")
    assert T.Executor(device="cpu")._n_clusters() == 1


# ----------------------------------------------------------------------
# Handoff-aware stage LPT
# ----------------------------------------------------------------------
def test_stage_lpt_colocates_consumers_with_producers():
    p = _producer_consumer_program(T, n_lanes=4)
    ss = T.StageSchedule(p.descriptors, n_clusters=4)
    js = J.StageSchedule(_producer_consumer_program(J).descriptors,
                         n_clusters=4)
    assert ss.assignment == js.assignment
    assert ss.stats["n_stages"] == 3 and ss.stats["handoff_bytes"] > 0
    assert ss.stats["handoff_bytes_cross"] == 0
    for stage in ss.stages:
        assert len({ss.assignment[i] for i in stage}) == len(stage)


def test_stage_lpt_balance_beats_affinity_when_dma_is_cheap():
    def build(m):
        p = m.Program()
        src = p.buffer((64,), name="src", init=np.ones(64, np.float32))
        t = p.thresh(src, 0.0)
        for _ in range(4):
            p.relu(t)
        return p
    tp = build(T)
    ss = T.StageSchedule(tp.descriptors, n_clusters=4)
    assert ss.assignment == J.StageSchedule(build(J).descriptors,
                                            n_clusters=4).assignment
    assert len({ss.assignment[i] for i in ss.stages[-1]}) > 1
    got = ss.execute(tp.pack(device="cpu")).numpy()
    want = T.CommandStream(tp.descriptors).execute(
        tp.pack(device="cpu")).numpy()
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------------------
# The plan cache
# ----------------------------------------------------------------------
def test_executor_plan_cache_reused_across_runs():
    tp, tx, ty, *_ = _chain_program(T, 64)
    ex = T.Executor(device="cpu")
    ex.run(tp, inputs={tx: _arr(64), ty: _arr(64)})
    keys = set(tp._plan_cache)
    ex.run(tp, inputs={tx: _arr(64), ty: _arr(64)})
    assert set(tp._plan_cache) == keys
    tp.relu(ty)
    ex.run(tp, inputs={tx: _arr(64), ty: _arr(64)})
    assert set(tp._plan_cache).isdisjoint(keys)
    assert all(k[0] == tp.version for k in tp._plan_cache)


def test_executor_plan_cache_keyed_by_the_new_fields():
    tp, tx, ty, *_ = _chain_program(T, 64)
    inputs = {tx: _arr(64), ty: _arr(64)}
    outs = [T.Executor("multistream", device="cpu", **kw).run(
        tp, inputs=inputs).mem for kw in (
        {}, {"transport": "interleave"}, {"n_clusters": 3},
        {"autotune": "measure"}, {"setup_cycles": 10})]
    assert len(tp._plan_cache) == 5
    assert all(torch.equal(o, outs[0]) for o in outs)


# ----------------------------------------------------------------------
# tests/test_descriptor_engine.py: the hw-step encoding property
# ----------------------------------------------------------------------
@given(st.lists(st.integers(-9, 9), min_size=5, max_size=5),
       st.lists(st.integers(1, 9), min_size=5, max_size=5))
@settings(max_examples=100, deadline=None)
def test_hw_step_encoding_roundtrip(strides, bounds):
    """The delta-step encoding is affine-equivalent (§II-D), and the
    port encodes as the reference does."""
    steps = T.strides_to_hw_steps(strides, bounds)
    assert tuple(T.hw_steps_to_strides(steps, bounds)) == tuple(strides)
    assert tuple(steps) == tuple(J.strides_to_hw_steps(strides, bounds))


def test_ntx_namespace_runs_every_policy():
    import ntx_torch as ntx
    with ntx.Program() as p:
        x = p.buffer((8,), name="x", init=np.arange(8, dtype=np.float32))
        y = p.relu(x)
    for pol in T_POLICIES:
        res = ntx.Executor(pol, device="cpu").run(p)
        np.testing.assert_array_equal(res[y], np.arange(8), err_msg=pol)
