"""The dry run on the meta device (``repro_torch.launch.dryrun``), the
``ops`` meta route it takes, and the H100 roofline that reads its records
(``repro_torch.perfmodel.gpu_roofline``).

* For every family, the kernel calls a train, prefill and decode step
  tallies on meta tensors equal the launches the same step counts in
  ``ops.LAUNCHES`` when its CPU tensors take the wrappers' CUDA route
  (the launchers replaced by their plain versions, a test-local spy).
* ``delta_total`` equals the direct count for every config.
* Meta outputs have the plain versions' shapes; a mix of meta and CPU
  tensors raises; the meta route refuses what the card refuses.
* The roofline's terms are the reference's scaled by the ratio of the
  two packages' constants, and ``model_flops`` equals the reference's.
* One full-size cell writes a record that ``roofline_table`` reads.

The configs are the reduced ones with head dims the card's kernels take
(``flash_attention.HEAD_PAIRS``): 64, and MLA's (192, 128).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.data import SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ntx_elementwise as ne
from repro_torch.kernels import ops, ssd_scan
from repro_torch.kernels.ntx_gemm import gemm_plain, split_k_plan
from repro_torch.launch import dryrun
from repro_torch.models import Model, transformer
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.perfmodel import gpu_roofline
from repro_torch.runtime.train import build_step_fn

ARCHS = ["llama3-8b", "yi-9b", "phi3-medium-14b", "granite-3-8b",
         "deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b", "mamba2-1.3b",
         "jamba-v0.1-52b", "whisper-medium", "qwen2-vl-2b"]
B, S = 2, 32


def card_reduced(arch: str):
    """The reduced config at head dims the card's kernels take, two
    periods of its layer pattern deep, with at most 2 microbatches
    (training and chunked prefill)."""
    cfg = configs.get_reduced(arch)
    if not cfg.encoder_decoder:
        cfg = cfg.scaled(n_layers=2 * transformer.period_len(cfg))
    if cfg.mla:
        cfg = cfg.scaled(nope_head_dim=128, rope_head_dim=64, v_head_dim=128)
    elif cfg.n_heads:
        cfg = cfg.scaled(head_dim=64, **({"mrope_sections": (16, 8, 8)}
                                         if cfg.mrope else {}))
    return cfg.scaled(grad_accum=min(cfg.grad_accum, 2),
                      prefill_microbatch=min(cfg.prefill_microbatch, 2))


@pytest.fixture
def card_route(monkeypatch):
    """CPU tensors take the wrappers' CUDA route, so ``ops.LAUNCHES``
    counts what the card would launch, with every launcher replaced by
    its plain version."""
    real = ops._on_card

    def on_card(*ts):
        return {t.device.type for t in ts if t is not None} == {"cpu"} \
            or real(*ts)

    def flash(q, k, v, *, causal=True, scale=None, kv_len=None, plan=None,
              lse=False):
        o = fa.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     kv_len=kv_len)
        return (o, fa.flash_lse_plain(q, k, causal=causal, scale=scale,
                                      kv_len=kv_len)) if lse else o

    def ssd(x, dt, A, B, C, chunk=64, final_state=False):
        f = (ssd_scan.ssd_scan_with_state_plain if final_state
             else ssd_scan.ssd_scan_plain)
        return f(x, dt, A, B, C, chunk=chunk)

    def flash_bwd(q, k, v, o, lse, do, *, causal=True, scale=None):
        return fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                            causal=causal, scale=scale)

    for name, fn in (("_on_card", on_card), ("flash_attention_cuda", flash),
                     ("flash_attention_bwd_cuda", flash_bwd),
                     ("ssd_scan_cuda", ssd),
                     ("act_bwd_cuda", ne.act_bwd_plain),
                     ("adamw_cuda", ne.adamw_plain)):
        monkeypatch.setattr(ops, name, fn)
    monkeypatch.setattr(ops, "gemm_cuda", lambda a, b, out_dtype, epilogue,
                        compensated: gemm_plain(a, b, out_dtype=out_dtype,
                                                epilogue=epilogue))
    ops.reset_launches()
    yield
    ops.reset_launches()


def _cpu_step(cfg, kind: str):
    """Run the step of ``kind`` on CPU tensors at (B, S)."""
    batch = SyntheticLM(cfg, B, S, seed=0).batch_at(0)
    if kind == "train":
        params = Model(cfg).init(0, device="cpu", trainable=True)
        opt = init_opt_state(dict(params.named_parameters()))
        build_step_fn(cfg, AdamWConfig())(params, opt, batch)
        return
    model = Model(cfg)
    params = model.init(0, device="cpu")
    with torch.inference_mode():
        if kind == "prefill":
            model.prefill(params, batch)
        else:
            tokens = torch.as_tensor(np.random.default_rng(0).integers(
                0, cfg.vocab, (B, 1)))
            model.decode(params, tokens, model.init_cache(B, S,
                                                          device="cpu"),
                         S - 1, absorbed_mla=cfg.mla_absorb)


def _meta_step(cfg, kind: str):
    if kind == "train":
        return dryrun.train_step(cfg, B, S)
    if kind == "prefill":
        return dryrun.prefill_step(cfg, B, S)
    return dryrun.decode_step(cfg, B, S, S - 1)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dry_calls_equal_cuda_route_launches(card_route, arch, kind):
    cfg = card_reduced(arch)
    _cpu_step(cfg, kind)
    want = {k: v for k, v in ops.launches().items() if v}
    got = dryrun.trace(*_flat(_meta_step(cfg, kind)))
    assert got["launches"] == want
    # a Mamba-2 decode step is plain PyTorch, as in the reference
    assert want or (cfg.family == "ssm" and kind == "decode")
    if kind == "train" and cfg.ssm:
        assert want["ssd_bwd"] and want["ssd"] == 2 * want["ssd_bwd"]


def _flat(fn_args):
    fn, args = fn_args
    return (fn, *args)


@pytest.mark.parametrize("arch", ARCHS)
def test_delta_total_equals_direct_count(arch):
    """At the training shape; the SSM families at the prefill shape,
    whose SSD runs the kernel's state route (their training trace walks
    the plain backward's 256 chunks a layer, minutes on meta tensors)."""
    cfg = card_reduced(arch)
    rec = dryrun.count_cell(cfg, "prefill_32k" if cfg.ssm else "train_4k")
    prod, delta = rec["production"], rec["delta_total"]
    assert rec["n_periods"] >= 2
    assert delta["flops"] == prod["flops"] > 0
    assert delta["bytes_accessed"] == prod["bytes_accessed"] > 0
    assert {k: v for k, v in delta["launches"].items() if v} == \
        prod["launches"]


@pytest.fixture(scope="module")
def chip_smoke():
    """``chip_smoke.py`` as a module (its imports are the standard
    library's; nothing runs at import)."""
    import importlib.util
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_model_flops_within_the_counted_flops(chip_smoke, arch, kind):
    """chip_smoke phase 19's model flops of a step count only products
    the step makes (the embedding lookup none, serving's unembedding once
    a sequence, the encoder and the cross-attention's k and v at the
    encoder's frames), so they stay within the dry
    run's count of the same step; the reference's 2 N D does not in a
    prefill."""
    cfg = card_reduced(arch)
    rec = dryrun.trace(*_flat(_meta_step(cfg, kind)))
    part = "step" if kind == "train" else kind
    mf = chip_smoke.step_model_flops(cfg, shapes.active_params(cfg),
                                     chip_smoke.frame_weights(cfg), part, B,
                                     S)
    assert 0 < mf <= rec["flops"]
    if kind == "prefill" and not cfg.encoder_decoder:
        assert gpu_roofline.model_flops(cfg, kind, B * S) > mf


def test_counts_match_their_formulas():
    """One GQA layer's prefill by hand: the MLP's three GEMMs at 2 m n k,
    the attention's causal pairs at 2 (d + dv) a pair."""
    cfg = card_reduced("llama3-8b").scaled(n_layers=1)
    rec = dryrun.trace(*_flat(dryrun.prefill_step(cfg, B, S)))
    d, f = cfg.d_model, cfg.d_ff
    m = B * S
    assert rec["kernels"]["gemm"]["flops"] == 3 * 2 * m * d * f
    pairs = B * cfg.n_heads * S * (S + 1) // 2
    assert rec["kernels"]["attention"]["flops"] == pairs * 2 * 2 * cfg.hd
    assert rec["aten_flops"] > 0 and rec["aten_bytes"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0


# ----------------------------------------------------------------------
# The meta route
# ----------------------------------------------------------------------
def _pair(shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    cpu = (torch.randn(shape, generator=g) * 0.3).to(dtype)
    return cpu, torch.empty(shape, dtype=dtype, device="meta")


def _both(fn, *pairs):
    """``fn`` on the CPU tensors and on their meta twins."""
    return fn(*(p[0] for p in pairs)), fn(*(p[1] for p in pairs))


def _same_shapes(cpu, meta):
    cpu_l = cpu if isinstance(cpu, tuple) else (cpu,)
    meta_l = meta if isinstance(meta, tuple) else (meta,)
    assert len(cpu_l) == len(meta_l)
    for c, m in zip(cpu_l, meta_l):
        if c is None:
            assert m is None
            continue
        assert m.is_meta and m.shape == c.shape and m.dtype == c.dtype


@pytest.mark.parametrize("case", ["gemm", "gemm_lanes", "fused_mlp",
                                  "act_bwd_swiglu", "act_bwd_gelu",
                                  "attention_prefill", "attention_decode",
                                  "attention_mla", "ssd", "ssd_with_state",
                                  "adamw"])
def test_meta_outputs_have_plain_shapes(case):
    bf = torch.bfloat16
    ops.reset_dry()
    if case == "gemm":
        got = _both(lambda a, b, r: ops.gemm(a, b, out_dtype=bf, epilogue=[
            ("silu",), ("residual", r)]), _pair((24, 40), bf),
            _pair((40, 56), bf), _pair((24, 56)))
    elif case == "gemm_lanes":
        got = _both(lambda a, b: ops.gemm(a, b), _pair((3, 8, 16)),
                    _pair((3, 16, 8)))
    elif case == "fused_mlp":
        got = _both(lambda x, w1, w2, w3: ops.fused_mlp(
            x, w1, w2, w3, act="swiglu", residual=x), _pair((2, 5, 32), bf),
            _pair((32, 48), bf), _pair((48, 32), bf), _pair((32, 48), bf))
    elif case.startswith("act_bwd"):
        act = case.split("_")[-1]
        got = _both(lambda dh, a1, g: ops.act_bwd(
            act, dh, a1, g if act == "swiglu" else None, bf),
            _pair((16, 24)), _pair((16, 24)), _pair((16, 24)))
    elif case.startswith("attention"):
        d, dv = (192, 128) if case == "attention_mla" else (64, 64)
        sq, skv, kv = {"attention_decode": (1, 4096, 3000)}.get(
            case, (40, 40, None))
        got = _both(lambda q, k, v: ops.attention(q, k, v, kv_len=kv),
                    _pair((1, 4, sq, d), bf), _pair((1, 2, skv, d), bf),
                    _pair((1, 2, skv, dv), bf))
        if case == "attention_decode":
            assert ops.DRY["calls"]["attention_merge"] == 1
    elif case.startswith("ssd"):
        f = ops.ssd_with_state if case == "ssd_with_state" else ops.ssd
        got = _both(lambda x, dt, B_, C: f(
            x, dt.abs(), -torch.ones(3, device=x.device), B_, C, chunk=16),
            _pair((2, 40, 3, 8)), _pair((2, 40, 3)), _pair((2, 40, 4)),
            _pair((2, 40, 4)))
    else:
        got = _both(lambda p, g, m, v: ops.adamw_update(p, g, m, v, 3,
                                                        lr=1e-3),
                    _pair((6, 10), bf), _pair((6, 10)), _pair((6, 10)),
                    _pair((6, 10)).__class__((torch.rand(6, 10),
                                              torch.empty(6, 10,
                                                          device="meta"))))
    _same_shapes(*got)
    assert sum(ops.DRY["calls"].values()) >= 1
    assert ops.launches() == dict.fromkeys(ops.LAUNCHES, 0)


@pytest.mark.parametrize("m, n, lanes, splits", [(4, 4096, 1, True),
                                                  (4, 4096, 3, True),
                                                  (4, 14336, 1, False),
                                                  (8192, 4096, 1, False)])
def test_gemm_meta_bytes_count_the_split_partials(m, n, lanes, splits):
    """A bf16 product's bytes: A and B read, C written, and where the plan
    splits k (decode's m <= 16 rows) its fp32 partials written and read
    again, as the attention route counts its split-kv partials."""
    k = 4096
    plan = split_k_plan(m, n, k)
    assert (plan.splits > 1) == splits
    lead = (lanes,) if lanes > 1 else ()
    a = torch.empty((*lead, m, k), dtype=torch.bfloat16, device="meta")
    b = torch.empty((*lead, k, n), dtype=torch.bfloat16, device="meta")
    ops.reset_dry()
    ops.gemm(a, b)
    io = lanes * (2 * (m * k + k * n) + 4 * m * n)      # C in fp32
    assert ops.DRY["bytes"]["gemm"] == io + 2 * 4 * lanes * plan.workspace
    assert ops.DRY["flops"]["gemm"] == 2 * lanes * m * n * k


def test_meta_gradients_have_plain_shapes():
    """Attention and the fused MLP under autograd on meta tensors: the
    forward with lse, the flash backward and the MLP's backward products
    tallied, gradients of the inputs' shapes."""
    bf = torch.bfloat16
    ops.reset_dry()
    q, k, v = (torch.empty(s, dtype=bf, device="meta", requires_grad=True)
               for s in ((1, 4, 64, 64), (1, 2, 64, 64), (1, 2, 64, 64)))
    gq, gk, gv = torch.autograd.grad(ops.attention(q, k, v).sum(), (q, k, v))
    assert (gq.shape, gk.shape, gv.shape) == (q.shape, k.shape, v.shape)
    x, w1, w2, w3 = (torch.empty(s, dtype=bf, device="meta",
                                 requires_grad=True)
                     for s in ((8, 32), (32, 48), (48, 32), (32, 48)))
    grads = torch.autograd.grad(ops.fused_mlp(x, w1, w2, w3, act="swiglu")
                                .sum(), (x, w1, w2, w3))
    assert [g.shape for g in grads] == [x.shape, w1.shape, w2.shape,
                                        w3.shape]
    calls = ops.dry()["calls"]
    assert (calls["attention"], calls["attention_bwd"], calls["act_bwd"],
            calls["gemm"]) == (1, 1, 1, 3 + 8)


def test_mixed_meta_and_cpu_raises():
    a = torch.randn(4, 8)
    with pytest.raises(ValueError, match="meta"):
        ops.gemm(a, torch.empty(8, 4, device="meta"))
    with pytest.raises(ValueError, match="meta"):
        ops.attention(torch.empty(1, 2, 4, 64, device="meta"),
                      torch.randn(1, 2, 4, 64), torch.randn(1, 2, 4, 64))


def test_meta_refuses_what_the_card_refuses():
    """The head pair (48, 32), which the CPU computes and the card's
    kernels are not built for; the causal backward with more queries than
    keys; a GEMM of mixed dtypes."""
    q = torch.empty(1, 2, 8, 48, device="meta")
    k = torch.empty(1, 2, 8, 48, device="meta")
    v = torch.empty(1, 2, 8, 32, device="meta")
    with pytest.raises(ValueError, match="head dims"):
        ops.attention(q, k, v)
    cpu = [torch.randn(t.shape) for t in (q, k, v)]
    assert ops.attention(*cpu).shape == (1, 2, 8, 32)
    with pytest.raises(ValueError):
        ops.gemm(torch.empty(4, 8, device="meta"),
                 torch.empty(8, 4, dtype=torch.bfloat16, device="meta"))


@pytest.mark.parametrize("call", ["compensated", "elementwise", "reduce",
                                  "conv2d", "stencil", "laplace"])
def test_wrappers_without_a_meta_route_raise(call):
    x = torch.empty(16, 16, device="meta")
    fn = {"compensated": lambda: ops.gemm(x, x, compensated=True),
          "elementwise": lambda: ops.elementwise("relu", x),
          "reduce": lambda: ops.reduce("sum", x),
          "conv2d": lambda: ops.conv2d(x, torch.empty(3, 3, device="meta")),
          "stencil": lambda: ops.stencil_axis(x, [1.0, -2.0, 1.0], 0),
          "laplace": lambda: ops.laplace(x)}[call]
    with pytest.raises(ValueError, match="dry run"):
        fn()


# ----------------------------------------------------------------------
# The roofline and the records
# ----------------------------------------------------------------------
def test_cell_roofline_scales_the_references():
    from repro.perfmodel import tpu_roofline as tpu
    rec = {"arch": "x", "shape": "train_4k", "mesh": "16x16",
           "n_devices": 256, "skipped": False,
           "production": {"flops": 1e13, "bytes_accessed": 1e11,
                          "memory": {"temp_bytes": 1}},
           "delta_total": {"flops": 2e13, "bytes_accessed": 2e11,
                           "transcendentals": 0,
                           "collective_wire_bytes_per_device": 5e9}}
    want, got = tpu.cell_roofline(rec), gpu_roofline.cell_roofline(rec)
    for term, ref_c, c in (("compute", tpu.PEAK_FLOPS,
                            gpu_roofline.PEAK_FLOPS),
                           ("memory", tpu.HBM_BW, gpu_roofline.HBM_BW),
                           ("collective", tpu.LINK_BW, gpu_roofline.LINK_BW)):
        assert got[f"t_{term}_s"] == pytest.approx(
            want[f"t_{term}_s"] * ref_c / c, rel=1e-12)
    for key in ("flops_global", "bytes_global", "collective_bytes_global",
                "chips", "memory_fit"):
        assert got[key] == want[key]
    assert got["bound_time_s"] == max(got[f"t_{t}_s"] for t in (
        "compute", "memory", "collective"))
    mine = gpu_roofline.cell_roofline(rec, peak_flops=1e15, hbm_bw=1e12)
    assert mine["t_compute_s"] == pytest.approx(2e13 / 1e15)
    assert gpu_roofline.cell_roofline({"skipped": True}) is None


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal(arch, kind):
    from repro import configs as ref_configs
    from repro.perfmodel import tpu_roofline as tpu
    tokens = 4096 * 7
    assert gpu_roofline.model_flops(configs.get(arch), kind, tokens) == \
        tpu.model_flops(ref_configs.get(arch), kind, tokens)


def test_full_size_cell_record_reads_into_the_table(tmp_path):
    dryrun.main(["--arch", "llama3-8b", "--shape", "decode_32k", "--out",
                 str(tmp_path)])
    dryrun.main(["--arch", "llama3-8b", "--shape", "long_500k", "--out",
                 str(tmp_path), "--skip-delta"])
    rows = gpu_roofline.roofline_table(str(tmp_path))
    done = [r for r in rows if not r.get("skipped")]
    skipped = [r for r in rows if r.get("skipped")]
    assert len(done) == 1 and len(skipped) == 1
    r = done[0]
    assert (r["arch"], r["shape"], r["chips"]) == ("llama3-8b", "decode_32k",
                                                   1)
    assert r["dominant"] == "memory" and r["fits"] is False
    assert 0 < r["roofline_fraction"] < 1 and 0 < r["useful_ratio"] < 1
    # the cache the step reads: 32 layers of (128, 8, 32768, 128) k and v
    assert r["bytes_global"] > 32 * 2 * 128 * 8 * 32768 * 128 * 2
    assert skipped[0]["reason"].startswith("long_500k requires")
    sh = shapes.SHAPES["decode_32k"]
    assert r["model_flops"] == 2 * shapes.active_params(
        configs.get("llama3-8b")) * sh.global_batch
