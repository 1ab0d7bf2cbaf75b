"""The port's descriptor machine (``repro_torch.core``) against the JAX
reference's (``repro.core``) on the same seeded numpy inputs: the
engines, dispatch, the fusion planner, the Program/Executor front door
and the serving samplers' descriptor programs.

The samplers' tokens must be bit-equal to the reference's, and the
port's ``serial`` policy bit-equal to its ``fused`` one.
"""
import importlib

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import engine as jengine
from repro.core import stream as jstream
from repro.core.dispatch import dispatch as jdispatch
from repro.core import descriptor as jdesc
from repro.core import Program as JProgram
from repro.runtime import serve as jserve

import ntx_torch
from repro_torch.core import descriptor as tdesc
from repro_torch.core import engine as tengine
from repro_torch.core import stream as tstream
from repro_torch.core import Executor, ExecutionPolicy, Program
from repro_torch.core.dispatch import dispatch as tdispatch
from repro_torch.runtime import serve as tserve

tdispatch_mod = importlib.import_module("repro_torch.core.dispatch")

RNG = np.random.default_rng(7)
CPU = torch.device("cpu")


def _mem(n=4096):
    return RNG.standard_normal(n).astype(np.float32)


def _twin(jd):
    """The port's copy of a reference descriptor."""
    agu = lambda a: tdesc.Agu(a.base, a.strides)
    return tdesc.Descriptor(bounds=jd.bounds,
                            opcode=tdesc.Opcode(jd.opcode.value),
                            agu0=agu(jd.agu0), agu1=agu(jd.agu1),
                            agu2=agu(jd.agu2), init_level=jd.init_level,
                            store_level=jd.store_level, imm=jd.imm)


DESCRIPTORS = {
    "gemm": lambda m: m.gemm(12, 9, 17, 0, 1024, 2048),
    "gemv": lambda m: m.gemv(21, 33, 0, 1024, 2048),
    "axpy": lambda m: m.axpy(100, 1.7, 0, 512, 1024),
    "memcpy": lambda m: m.memcpy(64, 0, 1024),
    "memset": lambda m: m.memset(64, 3.25, 1024),
    "relu": lambda m: m.relu(128, 0, 1024),
    "argmax": lambda m: m.argmax(77, 0, 1024),
    "laplace1d": lambda m: m.laplace1d(50, 0, 200, 1024),
    "odd_nest": lambda m: m.Descriptor(
        bounds=(3, 4), opcode=m.Opcode.MAC, init_level=1, store_level=1,
        agu0=m.Agu(0, (2, 9)), agu1=m.Agu(100, (3, 0)),
        agu2=m.Agu(300, (0, 2))),
    "prefix_store": lambda m: m.Descriptor(   # running dot product
        bounds=(5,), opcode=m.Opcode.MAC, init_level=1, store_level=0,
        agu0=m.Agu(0, (1,)), agu1=m.Agu(100, (1,)),
        agu2=m.Agu(1000, (1,))),
}


# ----------------------------------------------------------------------
# Descriptors and engines
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(DESCRIPTORS))
def test_numpy_engine_matches_reference(name):
    """The numpy oracle is carried over as is: identical memory images."""
    jd, td = DESCRIPTORS[name](jdesc), DESCRIPTORS[name](tdesc)
    assert td == _twin(jd)
    mem = _mem()
    np.testing.assert_array_equal(tengine.execute(td, mem),
                                  jengine.execute(jd, mem))
    np.testing.assert_array_equal(tengine.execute_vectorized(td, mem),
                                  jengine.execute_vectorized(jd, mem))


@pytest.mark.parametrize("name", ["gemm", "gemv", "axpy", "memset", "relu",
                                  "argmax", "laplace1d", "odd_nest"])
def test_execute_torch_matches_execute_jax(name):
    jd, td = DESCRIPTORS[name](jdesc), DESCRIPTORS[name](tdesc)
    mem = _mem()
    want = np.asarray(jengine.execute_jax(jd, jnp.asarray(mem)))
    got = tengine.execute_torch(td, torch.from_numpy(mem)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_zero_trip_descriptor_is_a_no_op():
    d = tdesc.Descriptor(bounds=(0,), opcode=tdesc.Opcode.COPY,
                         agu0=tdesc.Agu(0, (1,)), agu2=tdesc.Agu(10, (1,)))
    mem = torch.from_numpy(_mem(64))
    before = mem.clone()
    assert torch.equal(tdispatch(d, mem), before)
    assert torch.equal(tengine.execute_torch(d, mem), before)


# ----------------------------------------------------------------------
# Dispatch
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(DESCRIPTORS))
def test_dispatch_matches_reference(name):
    """Kernel-matched descriptors run on the ops wrappers, the rest on the
    numpy engine (counted as fallbacks); both agree with the reference's
    dispatch."""
    jd, td = DESCRIPTORS[name](jdesc), DESCRIPTORS[name](tdesc)
    mem = _mem()
    want = np.asarray(jdispatch(jd, jnp.asarray(mem)))
    tdispatch_mod.reset_engine_fallbacks()
    got = tdispatch(td, torch.from_numpy(mem.copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    fell_back = name in ("laplace1d", "odd_nest", "prefix_store")
    assert tdispatch_mod.engine_fallbacks == int(fell_back)


def test_dispatch_updates_memory_in_place():
    d = tdesc.axpy(16, 2.0, 0, 16, 32)
    mem = torch.from_numpy(_mem(64))
    out = tdispatch(d, mem)
    assert out is mem


# ----------------------------------------------------------------------
# Fusion planner
# ----------------------------------------------------------------------
def _random_program(pkg_program, rng, n=96, n_ops=6):
    """The same random streaming program built in either package."""
    p = pkg_program()
    xs = [p.buffer((n,), name=f"in{i}") for i in range(3)]
    cur = xs[0]
    for i in range(n_ops):
        op = rng.integers(0, 6)
        if op == 0:
            cur = p.axpy(float(rng.uniform(-2, 2)), cur, xs[1])
        elif op == 1:
            p.relu(cur, out=cur)
        elif op == 2:
            p.thresh(cur, float(rng.uniform(-1, 1)), out=cur)
        elif op == 3:
            cur = p.mul(cur, xs[2])
        elif op == 4:
            p.mask(cur, xs[1], out=cur)
        else:
            cur = p.copy(cur)
    p.reduce(["argmax", "argmin", "max", "min", "sum"][rng.integers(0, 5)],
             cur, name="red")
    return p, xs


@pytest.mark.parametrize("seed", range(6))
def test_plan_stream_groups_match_reference(seed):
    jp, _ = _random_program(JProgram, np.random.default_rng(seed))
    tp, _ = _random_program(Program, np.random.default_rng(seed))
    jg = jstream.plan_stream(jp.descriptors)
    tg = tstream.plan_stream(tp.descriptors)
    assert [type(g).__name__ for g in tg] == [type(g).__name__ for g in jg]
    assert [len(g.descs) for g in tg] == [len(g.descs) for g in jg]


@pytest.mark.parametrize("seed", range(6))
def test_random_programs_serial_fused_and_reference_agree(seed):
    jp, jxs = _random_program(JProgram, np.random.default_rng(seed))
    tp, txs = _random_program(Program, np.random.default_rng(seed))
    vals = [_mem(96) for _ in range(3)]
    from repro.core import Executor as JExecutor
    want = JExecutor(policy="serial").run(
        jp, inputs=dict(zip(jxs, vals))).numpy()
    got = {pol: Executor(pol, device="cpu").run(
        tp, inputs=dict(zip(txs, vals))).numpy()
        for pol in ("serial", "fused")}
    np.testing.assert_array_equal(got["serial"], got["fused"])
    red = tp.resolve("red").offset
    sumred = tp.descriptors[-1].opcode is tdesc.Opcode.VSUM
    mask = np.ones(want.shape, bool)
    mask[red] = not sumred
    np.testing.assert_array_equal(got["fused"][mask], want[mask])
    np.testing.assert_allclose(got["fused"][red], want[red], rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------------------
# Program / Executor
# ----------------------------------------------------------------------
def test_program_layout_matches_reference():
    def build(P):
        p = P()
        a = p.buffer((13,), name="a")
        b = p.buffer((5, 7), name="b")
        c = p.axpy(0.5, a, p.buffer((13,), name="y"))
        p.argmax(c, name="slot")
        return p, (a, b, c)
    jp, jh = build(JProgram)
    tp, th = build(Program)
    assert tp.spans() == jp.spans() and tp.size == jp.size
    assert [d for d in tp.descriptors] == [_twin(d) for d in jp.descriptors]
    vals = {"a": _mem(13), "b": _mem(35), "y": _mem(13)}
    np.testing.assert_array_equal(
        tp.pack(vals, device="cpu").numpy(), np.asarray(jp.pack(vals)))
    res = tp.unpack(tp.pack(vals, device="cpu"))
    assert torch.equal(res.read_tensor("b"),
                       torch.from_numpy(vals["b"]).reshape(5, 7))
    np.testing.assert_array_equal(res["a"], vals["a"])


def test_executor_defaults_and_unported_policies():
    """The default is the reference's ``auto`` on the card, and no policy
    is left unported: every name in POLICIES runs and agrees."""
    from repro_torch.core.executor import POLICIES
    ex = Executor()
    assert ex.policy.policy == "auto" and ex.device.type == "cuda"
    p = Program()
    x = p.buffer((8,), name="x")
    p.relu(x, out=x)
    vals = _mem(8)
    for pol in POLICIES:
        res = Executor(pol, device="cpu").run(p, inputs={x: vals})
        np.testing.assert_array_equal(res[x], np.maximum(vals, 0),
                                      err_msg=pol)
    with pytest.raises(ValueError):
        ExecutionPolicy(policy="bogus")


def test_plan_cache_keyed_on_program_version():
    p = Program()
    x = p.buffer((16,), name="x")
    p.relu(x, out=x)
    ex = Executor("fused", device="cpu")
    ex.run(p, inputs={x: _mem(16)})
    first = dict(p._plan_cache)
    ex.run(p, inputs={x: _mem(16)})
    assert p._plan_cache.keys() == first.keys()
    p.thresh(x, 0.1, out=x)                      # mutation: new version
    res = ex.run(p, inputs={x: np.full(16, 0.05, np.float32)})
    assert len(p._plan_cache) == 1 and (res[x] == 0).all()


def test_run_descriptors_leaves_input_alone():
    mem = torch.from_numpy(_mem(64))
    before = mem.clone()
    out = Executor("serial", device="cpu").run_descriptors(
        [tdesc.relu(32, 0, 0)], mem)
    assert torch.equal(mem, before) and (out[:32] >= 0).all()


def test_ntx_alias_mirrors_the_core():
    import repro_torch.core as core
    for name in ntx_torch.__all__:
        assert getattr(ntx_torch, name) is getattr(core, name)


# ----------------------------------------------------------------------
# The serving samplers: bit-equal tokens
# ----------------------------------------------------------------------
def _logits(b, vocab, scale=3.0, ties=True):
    x = (RNG.standard_normal((b, vocab)) * scale).astype(np.float32)
    if ties:
        for r in range(b):
            x[r, [r + 3, vocab - 2 - r]] = x[r].max() + 1.0
    return x


def _both_policies(ent, inputs, slots):
    prog = ent[0]
    out = {}
    for pol in ("serial", "fused"):
        res = Executor(pol, device="cpu").run(prog, inputs=inputs)
        out[pol] = np.asarray([res[s][0] for s in slots]).astype(np.int64)
    np.testing.assert_array_equal(out["serial"], out["fused"])
    return out["fused"]


@pytest.mark.parametrize("staged", [False, True], ids=["decode", "prefill"])
def test_greedy_samplers_bit_equal(staged):
    b, vocab = 3, 1003
    logits = _logits(b, vocab)
    jfn = (jserve.greedy_argmax_pipelined if staged
           else jserve.greedy_argmax_multistream)
    tfn = (tserve.greedy_argmax_pipelined if staged
           else tserve.greedy_argmax_multistream)
    want = jfn(logits)
    got = tfn(logits, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.argmax(logits, -1))
    cache = tserve._PREFILL_PROGRAMS if staged else tserve._ARGMAX_PROGRAMS
    ent = cache[(b, vocab, CPU)]
    inputs = dict(zip(ent[2], torch.from_numpy(logits)))
    np.testing.assert_array_equal(_both_policies(ent, inputs, ent[3]), want)
    if staged:   # COPY -> ARGMAX fuses into one chain-reduce per request
        groups = tstream.plan_stream(ent[0].descriptors)
        assert all(isinstance(g, tstream.FusedChainReduce) for g in groups)


@pytest.mark.parametrize("min_logit", [None, 0.5, -3.0])
def test_temperature_sampler_bit_equal(min_logit):
    b, vocab, T = 4, 997, 0.8
    logits = _logits(b, vocab)
    g = RNG.gumbel(size=(b, vocab))
    want = jserve.temperature_sample_multistream(logits, T, g, min_logit)
    got = tserve.temperature_sample_multistream(logits, T, g, min_logit,
                                                device="cpu")
    np.testing.assert_array_equal(got, want)
    ent = tserve._TEMPERATURE_PROGRAMS[(b, vocab, T, min_logit, CPU)]
    prog, _, rows, noises, slots = ent
    noise = np.asarray(g, np.float32)
    if min_logit is not None:
        noise = noise + np.float32(tserve._PRUNE_SHIFT)
    inputs = dict(zip(rows, torch.from_numpy(logits)))
    inputs.update(zip(noises, torch.from_numpy(noise)))
    np.testing.assert_array_equal(_both_policies(ent, inputs, slots), want)
    groups = tstream.plan_stream(prog.descriptors)
    assert len(groups) == b and all(
        isinstance(gr, tstream.FusedChainReduce) and gr.red_op == "argmax"
        for gr in groups)


def test_sampler_stats_name_each_program():
    tserve.temperature_sample_multistream(_logits(2, 16), 1.2,
                                          RNG.gumbel(size=(2, 16)),
                                          device="cpu")
    stats = tserve.sampler_stats()
    key = "temperature_b2_v16_T1.2_cpu"
    assert stats[key]["policy"] == "multistream"      # the reference's
    assert stats[key]["n_descriptors"] == 4


def test_temperature_zero_rejected():
    with pytest.raises(ValueError):
        tserve.temperature_sample_multistream(np.zeros((1, 8)), 0.0,
                                              np.zeros((1, 8)), device="cpu")
