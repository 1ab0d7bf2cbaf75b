"""The port's capacity model and tile plans (``repro_torch.core.memory``,
``repro_torch.core.tiling``) against the reference's, mirroring
``tests/test_tiling.py`` on the same seeded inputs: ``NtxMemSpec``,
``fits`` and the working set, ``splittable``, the tile partition
property and the bank addresses equal to the reference's; tiled results
(both DMA schedules) bit-equal to serial; the ``auto`` policy's capacity
verdict; ``tiling_gain``; the measured race; and the stage ``overlap``
transport.
"""
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.tiling import splittable as j_splittable
from repro.perfmodel.ntx import tiling_gain as j_tiling_gain

import repro_torch.core as T
import ntx_torch
from repro_torch.core import scheduler as tsched
from repro_torch.core.tiling import splittable
from repro_torch.kernels import ntx_gemm
from repro_torch.perfmodel.ntx import policy_gains, tiling_gain

RNG = np.random.default_rng(7)
TINY_KW = dict(tcdm_bytes=4096)          # 1024 fp32 elements, 512 budget


def _arrs(n, lanes):
    return [RNG.standard_normal(n).astype(np.float32) for _ in range(lanes)]


def _chain_program(m, n, lanes=1, data=None):
    data = data or _arrs(n, lanes)
    prog = m.Program()
    for i in range(lanes):
        x = prog.buffer((n,), name=f"x{i}", init=data[i])
        t = prog.thresh(x, 0.2)
        prog.relu(t, out=t)
        prog.axpy(1.5, t, x, out=t)
    return prog


def _both_chain(n, lanes=1):
    data = _arrs(n, lanes)
    return _chain_program(J, n, lanes, data), _chain_program(T, n, lanes, data)


def _run(ex, prog):
    return ex.run(prog).mem.numpy()


# ----------------------------------------------------------------------
# NtxMemSpec: the paper's cluster, as the reference models it
# ----------------------------------------------------------------------
def test_memspec_matches_reference():
    assert T.PAPER_MEM == T.NtxMemSpec() and T.PAPER_MEM.tcdm_bytes == 65536
    for kw in ({}, TINY_KW, dict(tcdm_bytes=128 * 1024, dma_bytes_per_cycle=16)):
        t, j = T.NtxMemSpec(**kw), J.NtxMemSpec(**kw)
        assert dataclasses_equal(t, j)
        assert t.capacity_elems == j.capacity_elems
        assert t.buffer_budget_elems == j.buffer_budget_elems
        assert t.dma_bw == pytest.approx(j.dma_bw)
        assert t.dma_time_s(4096) == pytest.approx(j.dma_time_s(4096))
    spec = T.NtxClusterSpec(tcdm_bytes=128 * 1024, axi_bytes_per_cycle=16)
    jspec = J.NtxClusterSpec(tcdm_bytes=128 * 1024, axi_bytes_per_cycle=16)
    assert dataclasses_equal(T.NtxMemSpec.from_cluster(spec, hbm_latency_s=5e-7),
                             J.NtxMemSpec.from_cluster(jspec,
                                                       hbm_latency_s=5e-7))
    with pytest.raises(ValueError):
        T.NtxMemSpec(tcdm_bytes=4)


def dataclasses_equal(a, b) -> bool:
    import dataclasses
    return dataclasses.asdict(a) == dataclasses.asdict(b)


def test_cluster_spec_and_multi_cluster_match_reference():
    for name in ("peak_flops", "peak_bw", "practical_flops", "practical_bw",
                 "efficiency_flops_per_w", "pj_per_flop"):
        assert getattr(T.PAPER_CLUSTER, name) == pytest.approx(
            getattr(J.PAPER_CLUSTER, name), rel=1e-15), name
    from repro.core.cluster import ntx_multi_cluster as j_multi
    for node, counts in ((22, (16, 32, 64)),
                         (14, (16, 32, 64, 128, 256, 512))):
        for c in counts:
            assert T.ntx_multi_cluster(c, node) == j_multi(c, node)


def test_smem_block_sizing():
    tiny = T.NtxMemSpec(**TINY_KW)
    b = tiny.smem_block_elems(n_streams=2)
    assert b % 4 == 0 and b >= 4
    assert 2 * b <= max(8, tiny.capacity_elems)
    assert T.PAPER_MEM.smem_block_elems(1) == 4096        # capped
    assert T.PAPER_MEM.smem_block_elems(3) == 2728       # 8192 // 3, 4-aligned


def test_fits_and_working_set_match_reference():
    for n, lanes in ((256, 1), (4096, 1), (300, 3)):
        jp, tp = _both_chain(n, lanes)
        jd, td = list(jp.descriptors), list(tp.descriptors)
        assert T.working_set_spans(td) == J.working_set_spans(jd)
        assert T.working_set_bytes(td) == J.working_set_bytes(jd)
        for kw in ({}, TINY_KW):
            assert T.fits(td, T.NtxMemSpec(**kw)) == J.fits(jd, J.NtxMemSpec(
                **kw))
    tp = _chain_program(T, 256)
    assert T.working_set_bytes(list(tp.descriptors)) == 4 * 512
    assert T.working_set_elems(list(tp.descriptors)) == 512


def test_pick_matmul_blocks_sizes_against_shared_memory():
    """Aligned to the mma tile, fits one block's shared memory, and
    gives the tiles csrc/ntx_gemm.cu runs for bf16."""
    for m, n, k, dt in ((4096, 4096, 4096, 4), (4096, 4096, 4096, 2),
                        (4, 14336, 4096, 2), (7, 9, 5, 4), (300, 77, 1000, 4)):
        bm, bn, bk = T.pick_matmul_blocks(m, n, k, dtype_bytes=dt)
        assert bm % 16 == 0 and bn % 8 == 0 and bk % 16 == 0
        assert tsched._ring_bytes(bm, bn, bk, dt, 3) <= tsched.SMEM_PER_BLOCK
    assert T.pick_matmul_blocks(4096, 4096, 4096, 2) == ntx_gemm.TC_TILES[1]
    assert T.pick_matmul_blocks(4, 14336, 4096, 2) == ntx_gemm.TC_TILES[0]
    # a deep ring must shrink the tile to fit
    bm, bn, bk = T.pick_matmul_blocks(4096, 4096, 4096, 4, stages=16)
    assert tsched._ring_bytes(bm, bn, bk, 4, 16) <= tsched.SMEM_PER_BLOCK


def test_tile_schedules_match_reference():
    from repro.core import scheduler as jsched
    for fn, args in (("schedule_axpy", (1 << 20, 65536)),
                     ("schedule_gemv", (1024, 1024, 65536)),
                     ("schedule_gemm", (256, 256, 256, 65536)),
                     ("schedule_conv2d", (256, 256, 3, 3, 65536)),
                     ("schedule_stencil", ((160, 160, 160), 7, 65536))):
        t, j = getattr(tsched, fn)(*args), getattr(jsched, fn)(*args)
        assert [(x.bytes_in, x.bytes_out, x.flops) for x in t.tiles] == \
            [(x.bytes_in, x.bytes_out, x.flops) for x in j.tiles]
        assert t.buffer_bytes == j.buffer_bytes
        assert t.time_s(17.4e9, 4.35e9, setup_cycles=100, freq_hz=1.25e9) \
            == pytest.approx(j.time_s(17.4e9, 4.35e9, setup_cycles=100,
                                      freq_hz=1.25e9), rel=1e-12)


# ----------------------------------------------------------------------
# Splittability and the tile plan: the reference's, item for item
# ----------------------------------------------------------------------
SPLIT_CASES = {
    "ew": lambda m: m.Descriptor(bounds=(64,), opcode=m.Opcode.RELU,
                                 agu0=m.Agu(0, (1,)), agu2=m.Agu(64, (1,))),
    "inplace": lambda m: m.Descriptor(bounds=(64,), opcode=m.Opcode.RELU,
                                      agu0=m.Agu(0, (1,)),
                                      agu2=m.Agu(0, (1,))),
    "shifted": lambda m: m.Descriptor(bounds=(64,), opcode=m.Opcode.COPY,
                                      agu0=m.Agu(0, (1,)),
                                      agu2=m.Agu(32, (1,))),
    "reduction": lambda m: m.Descriptor(bounds=(64,), opcode=m.Opcode.VSUM,
                                        init_level=1, store_level=1,
                                        agu0=m.Agu(0, (1,)),
                                        agu2=m.Agu(100, (0,))),
    "gemm": lambda m: m.gemm(16, 16, 16, 0, 256, 512),
}


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
def test_splittable_matches_reference(name):
    assert splittable(SPLIT_CASES[name](T)) == \
        j_splittable(SPLIT_CASES[name](J))
    assert splittable(SPLIT_CASES["gemm"](T))
    assert not splittable(SPLIT_CASES["shifted"](T))


def _random_program(m, rng):
    prog = m.Program()
    has_mac = False
    for _ in range(rng.integers(1, 5)):
        kind = rng.choice(["chain", "axpy", "reduce", "set", "gemv", "gemm"])
        n = int(rng.choice([64, 256, 1024]))
        if kind == "chain":
            x = prog.buffer((n,), init=rng.standard_normal(n)
                            .astype(np.float32))
            t = prog.thresh(x, float(rng.uniform(-1, 1)))
            if rng.random() < 0.7:
                prog.relu(t, out=t)
        elif kind == "axpy":
            x = prog.buffer((n,), init=rng.standard_normal(n)
                            .astype(np.float32))
            y = prog.buffer((n,), init=rng.standard_normal(n)
                            .astype(np.float32))
            prog.axpy(float(rng.uniform(-2, 2)), x, y)
        elif kind == "reduce":
            x = prog.buffer((n,), init=rng.standard_normal(n)
                            .astype(np.float32))
            prog.reduce(str(rng.choice(["sum", "max", "argmax"])), x)
        elif kind == "set":
            out = prog.buffer((n,))
            prog.set(out, float(rng.uniform(-1, 1)))
        elif kind == "gemv":
            k = int(rng.choice([8, 24]))
            A = prog.buffer((k, 16), init=rng.standard_normal((k, 16))
                            .astype(np.float32))
            x = prog.buffer((16,), init=rng.standard_normal(16)
                            .astype(np.float32))
            prog.gemv(A, x)
            has_mac = True
        else:
            k = int(rng.choice([8, 16]))
            A = prog.buffer((k, 12), init=rng.standard_normal((k, 12))
                            .astype(np.float32))
            B = prog.buffer((12, 8), init=rng.standard_normal((12, 8))
                            .astype(np.float32))
            prog.gemm(A, B)
            has_mac = True
    return prog, has_mac


def _tiles(plan):
    return [(t.item, t.index, t.bank, t.outer, t.in_hulls, t.out_hulls,
             t.footprint_elems, len(t.dma_in), len(t.compute),
             len(t.dma_out)) for t in plan.tiles]


def _twin(jd):
    agu = lambda a: T.Agu(a.base, a.strides)
    return T.Descriptor(bounds=jd.bounds, opcode=T.Opcode(jd.opcode.value),
                        agu0=agu(jd.agu0), agu1=agu(jd.agu1),
                        agu2=agu(jd.agu2), init_level=jd.init_level,
                        store_level=jd.store_level, imm=jd.imm)


def _assert_partition(plan, spec):
    by_item = {}
    for t in plan.tiles:
        by_item.setdefault(t.item, []).append(t)
    for item_idx, tiles in by_item.items():
        if getattr(plan.items[item_idx], "spill", False):
            continue
        outer = sorted(t.outer for t in tiles)
        assert outer[0][0] == 0
        for (a0, a1), (b0, b1) in zip(outer, outer[1:]):
            assert a1 == b0
        for t in tiles:
            assert t.footprint_elems <= spec.buffer_budget_elems
        hulls = sorted(h for t in tiles for h in t.out_hulls)
        for (a0, a1), (b0, b1) in zip(hulls, hulls[1:]):
            assert a1 <= b0


@pytest.mark.parametrize("seed", range(10))
def test_tile_plans_match_reference_and_run_bit_equal(seed):
    """Random programs: the same tiles, banks, descriptors, prefetch
    legality and stats as the reference; executed, bit-equal to serial
    (within the GEMM tolerance for MAC nests) under both schedules."""
    jp, has_mac = _random_program(J, np.random.default_rng(seed))
    tp, _ = _random_program(T, np.random.default_rng(seed))
    tcdm = int(np.random.default_rng(seed).choice([1024, 4096, 16384]))
    jplan = J.TilePlan(list(jp.descriptors), J.NtxMemSpec(tcdm_bytes=tcdm),
                       image_elems=jp.size)
    spec = T.NtxMemSpec(tcdm_bytes=tcdm)
    tplan = T.TilePlan(list(tp.descriptors), spec, image_elems=tp.size)
    assert _tiles(tplan) == _tiles(jplan)
    assert tplan.descriptors == [_twin(d) for d in jplan.descriptors]
    assert tplan.can_prefetch == jplan.can_prefetch
    assert tplan.stats == jplan.stats
    _assert_partition(tplan, spec)
    mem = tp.pack(device="cpu")
    want = np.asarray(J.CommandStream(jp.descriptors).execute(jp.pack()))
    for overlap in (True, False):
        got = tplan.execute(mem.clone(), overlap=overlap).numpy()
        if has_mac:
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
        else:
            np.testing.assert_array_equal(got, want)


def test_partition_property_chain_and_resident_chain():
    tp = _chain_program(T, 4096)
    spec = T.NtxMemSpec(**TINY_KW)
    plan = T.TilePlan(list(tp.descriptors), spec, image_elems=tp.size)
    assert plan.stats["n_tiles"] > 1 and plan.stats["n_spill_items"] == 0
    assert plan.stats["n_items"] == 1
    tile = plan.tiles[0]
    assert len(tile.compute) == 3 and tile.compute_stream is not None
    assert len(tile.dma_in) == 1 and len(tile.dma_out) == 1
    _assert_partition(plan, spec)


# ----------------------------------------------------------------------
# Bit-equality through the Executor
# ----------------------------------------------------------------------
def test_tiled_4x_tcdm_bit_equal_all_policies():
    jp, tp = _both_chain(2048, lanes=2)
    assert T.working_set_bytes(list(tp.descriptors)) >= 4 * 4096
    want = np.asarray(J.CommandStream(jp.descriptors).execute(jp.pack()))
    tiny = T.NtxMemSpec(**TINY_KW)
    for overlap in (True, False):
        ex = T.Executor(T.ExecutionPolicy(policy="tiled", mem=tiny,
                                          dma_overlap=overlap), device="cpu")
        np.testing.assert_array_equal(_run(ex, tp), want)
        assert ex.stats["scheduler"]["overlap_used"] is overlap
    for pol in ("serial", "fused", "multistream", "pipeline"):
        np.testing.assert_array_equal(
            _run(T.Executor(pol, device="cpu"), tp), want, err_msg=pol)


def test_tiled_flattened_descriptor_program_is_equivalent():
    tp = _chain_program(T, 2048)
    plan = T.TilePlan(list(tp.descriptors), T.NtxMemSpec(**TINY_KW),
                      image_elems=tp.size)
    mem = tp.pack(device="cpu")
    padded = torch.cat([mem, torch.zeros(plan.total_elems - tp.size)])
    via_flat = T.CommandStream(plan.descriptors).execute(padded)[:tp.size]
    want = T.CommandStream(tp.descriptors).execute(mem.clone())
    assert torch.equal(via_flat, want)


def test_tiled_with_reduce_tail_and_gemm():
    def build(m):
        rng = np.random.default_rng(3)
        prog = m.Program()
        x = prog.buffer((3000,), name="x",
                        init=rng.standard_normal(3000).astype(np.float32))
        t = prog.thresh(x, 0.1)
        prog.relu(t, out=t)
        prog.reduce("sum", t)
        A = prog.buffer((24, 16), name="A", init=rng.standard_normal(
            (24, 16)).astype(np.float32))
        B = prog.buffer((16, 8), name="B", init=rng.standard_normal(
            (16, 8)).astype(np.float32))
        C = prog.gemm(A, B)
        prog.relu(C, out=C)
        return prog
    jp, tp = build(J), build(T)
    want = np.asarray(J.CommandStream(jp.descriptors).execute(jp.pack()))
    plan = T.TilePlan(list(tp.descriptors), T.NtxMemSpec(**TINY_KW),
                      image_elems=tp.size)
    got = plan.execute(tp.pack(device="cpu"), overlap=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert plan.stats["n_spill_items"] >= 1


# ----------------------------------------------------------------------
# The auto policy's capacity verdict and the tiling gain
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", [128, 4096])
def test_auto_capacity_verdict_matches_reference(n):
    jp, tp = _both_chain(n)
    jex = J.Executor(J.ExecutionPolicy(mem=J.NtxMemSpec(**TINY_KW),
                                       n_clusters=1))
    tex = T.Executor(T.ExecutionPolicy(mem=T.NtxMemSpec(**TINY_KW)),
                     device="cpu")
    assert tex.plan(tp)["policy"] == jex.plan(jp)["policy"]
    res = tex.run(tp)
    assert (tex.stats["policy"] == "tiled") == (n == 4096)
    want = np.asarray(J.CommandStream(jp.descriptors).execute(jp.pack()))
    np.testing.assert_array_equal(res.mem.numpy(), want)


def test_tiling_gain_matches_reference():
    for n in (64, 4096):
        jp, tp = _both_chain(n)
        g = tiling_gain(list(tp.descriptors), mem=T.NtxMemSpec(**TINY_KW))
        jg = j_tiling_gain(list(jp.descriptors),
                           mem=J.NtxMemSpec(**TINY_KW))
        assert g.keys() == jg.keys()
        for k in g:
            assert g[k] == pytest.approx(jg[k], rel=1e-12), k
    assert 1.0 <= g["speedup"] <= 2.0 and g["fits"] == 0.0
    assert policy_gains(list(tp.descriptors),
                        mem=T.NtxMemSpec(**TINY_KW))["tiling"]["fits"] == 0.0


def test_measured_auto_policy_races_and_caches():
    T.clear_measured_policy_cache()
    _, tp = _both_chain(256, lanes=4)
    ex = T.Executor(T.ExecutionPolicy(autotune="measure"), device="cpu")
    r1 = ex.run(tp)
    g = ex.stats["gains"]
    assert ex.stats["policy"] in ("serial", "fused", "multistream",
                                  "pipeline")
    assert set(g["measured"]) == {"serial", "fused", "multistream",
                                  "pipeline"}
    assert g["measured_cached"] is False
    assert ex.stats["policy"] == min(g["measured"], key=g["measured"].get)
    ex2 = T.Executor(T.ExecutionPolicy(autotune="measure"), device="cpu")
    ex2.run_descriptors(tp.descriptors, tp.pack(device="cpu"))
    assert ex2.stats["gains"]["measured_cached"] is True
    assert ex2.stats["policy"] == ex.stats["policy"]
    want = T.Executor("serial", device="cpu").run(tp).mem
    assert torch.equal(r1.mem, want)
    T.clear_measured_policy_cache()


def test_measured_race_skips_only_plans_that_raise_before_a_launch():
    """``shard_map`` on one device is an illegal plan, refused before it
    launches anything: the race skips it and races the rest."""
    T.clear_measured_policy_cache()
    _, tp = _both_chain(256, lanes=4)
    ex = T.Executor(T.ExecutionPolicy(autotune="measure",
                                      transport="shard_map"), device="cpu")
    ex.run(tp)
    assert set(ex.stats["gains"]["measured"]) == {"serial", "fused"}
    T.clear_measured_policy_cache()


# ----------------------------------------------------------------------
# The stage pipeline's overlap transport
# ----------------------------------------------------------------------
def _producer_consumer(m, data):
    prog = m.Program()
    for i, x0 in enumerate(data):
        x = prog.buffer((len(x0),), name=f"x{i}", init=x0)
        t = prog.thresh(x, 0.2)
        prog.relu(t, out=t)
        u = prog.thresh(t, 0.1)
        prog.relu(u, out=u)
    return prog


def test_stage_overlap_bit_equal():
    data = _arrs(512, 3)
    jp, tp = _producer_consumer(J, data), _producer_consumer(T, data)
    want = np.asarray(J.CommandStream(jp.descriptors).execute(jp.pack()))
    ss = T.StageSchedule(list(tp.descriptors), n_clusters=3)
    got = ss.execute(tp.pack(device="cpu"), mode="overlap").numpy()
    np.testing.assert_array_equal(got, want)
    assert ss.stats["mode_used"] == "overlap"
    ex = T.Executor(T.ExecutionPolicy(policy="pipeline", transport="overlap",
                                      n_clusters=3), device="cpu")
    np.testing.assert_array_equal(_run(ex, tp), want)


def test_stage_overlap_model_matches_reference():
    data = _arrs(512, 3)
    jp, tp = _producer_consumer(J, data), _producer_consumer(T, data)
    ss = T.StageSchedule(list(tp.descriptors), n_clusters=2)
    js = J.StageSchedule(list(jp.descriptors), n_clusters=2)
    assert ss.model_time(overlap=True) == pytest.approx(
        js.model_time(overlap=True), rel=1e-12)
    assert ss.model_time(overlap=True) <= ss.model_time(overlap=False)


def test_ntx_torch_exports_tileplan():
    assert ntx_torch.TilePlan is T.TilePlan
