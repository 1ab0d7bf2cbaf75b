"""The port's MoE family against the JAX reference, on the CPU: training
reduced deepseek-v2-lite-16b (MLA + MoE, shared experts) and serving and
training reduced phi3.5-moe-42b (GQA + MoE, no shared expert).

Weights come from the reference's own ``Model(cfg).init(0)`` through
``convert.from_reference``; inputs from numpy seeds and
``SyntheticLM.batch_at``. fp32 (compute and parameter dtype) throughout.
Tolerances, as ``tests/test_torch_dense_train.py`` holds the dense
configs: the loss at 1e-5, every gradient leaf at rtol 1e-4 / atol
1e-4 max|g| against ``jax.grad``, a ``build_step_fn`` step with
``grad_accum`` within 2 lr and 1e-5 relative. ``apply_moe``'s backward
is held in the three router cases of ``tests/test_torch_mla_moe.py``:
normal routing, a capacity overflow (first-wins drops; the drop slot
``e * cap`` is cut off and takes no gradient) and an all-ties router.
"""
import functools
import json
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import load_pytree as jload_pytree
from repro.data import SyntheticLM as JSyntheticLM
from repro.models import Model as JModel
from repro.models import moe as jmoe
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import apply_updates as japply_updates
from repro.optim import init_opt_state as jinit_opt_state
from repro.runtime import ServeConfig as JServeConfig
from repro.runtime import Server as JServer
from repro.runtime import TrainConfig as JTrainConfig
from repro.runtime import Trainer as JTrainer
from repro.runtime.train import build_step_fn as jbuild_step_fn
from repro.runtime.train import plan_update_multistream as jplan

from repro_torch import configs as tconfigs
from repro_torch.checkpoint import load_pytree, save_pytree
from repro_torch.models import Model
from repro_torch.models import convert
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.optim import AdamWConfig, apply_updates, init_opt_state
from repro_torch.runtime import (ServeConfig, Server, TrainConfig, Trainer,
                                 build_step_fn)
from repro_torch.runtime.train import plan_update_multistream

DEEPSEEK, PHI35 = "deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b"
MOE = (DEEPSEEK, PHI35)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=20)


def _cfgs(arch, dtype="float32", **kw):
    over = dict(compute_dtype=dtype, param_dtype=dtype, **kw)
    return tuple(m.get_reduced(arch).scaled(**over)
                 for m in (jconfigs, tconfigs))


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return jax.jit(lambda: JModel(_cfgs(arch)[0]).init(0))()


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _tparams(arch, trainable=False):
    params = convert.from_reference(_np(_jparams(arch)), _cfgs(arch)[1],
                                    device="cpu")
    return params.requires_grad_(trainable)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ported(named, tc):
    """Port tensors keyed by name as the reference tree's leaves."""
    return {jax.tree_util.keystr(p): a.detach().float().numpy()
            for p, a in jax.tree_util.tree_flatten_with_path(
                convert.to_reference(dict(named), tc))[0]}


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()}


def _assert_grads(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


# ----------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------
def _n_params(cfg):
    """Parameters of an MoE decoder (GQA or MLA attention, shared experts
    or none), from its config's shapes."""
    d, h, e, ffe = cfg.d_model, cfg.n_heads, cfg.n_experts, cfg.d_ff_expert
    if cfg.mla:
        r, dv = cfg.kv_lora_rank, cfg.v_head_dim
        dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
        attn = (d * h * (dn + dr) + d * (r + dr) + r * h * (dn + dv)
                + h * dv * d + r)
    else:
        attn = d * cfg.hd * (h + 2 * cfg.n_kv_heads) + h * cfg.hd * d
    moe = d * e + 3 * e * d * ffe + 3 * d * ffe * cfg.n_shared_experts
    return cfg.n_layers * (attn + moe + 2 * d) + 2 * cfg.padded_vocab * d + d


def test_phi35_config_matches_reference():
    """``__dict__`` equal to the reference's, full and reduced; in
    ``ARCHS``, found under the reference's name and the module's."""
    for name in (PHI35, "phi3.5-moe-42b", "phi35_moe_42b"):
        assert tconfigs.get(name).__dict__ == jconfigs.get(PHI35).__dict__
    assert tconfigs.get_reduced(PHI35).__dict__ == jconfigs.get_reduced(
        PHI35).__dict__
    assert "phi35_moe_42b" in tconfigs.ARCHS
    full = tconfigs.get(PHI35)
    assert full.hd == 128 and (full.grad_accum, full.prefill_microbatch) \
        == (8, 8)


@pytest.mark.parametrize("arch", MOE)
def test_full_config_shapes(arch):
    """tests/test_models.py::test_full_config_shapes on the MoE archs, the
    port's way (no eval_shape, no allocation): the count formula holds on
    the reduced model (``Model.init`` and the converter's build) and gives
    the reference's ``count_params`` of the full config. phi3.5-moe:
    41.9 B parameters, 83.7 GB in bf16 (past one 80 GB card, so the card
    serves it with its depth cut), 6.6 B active a token; deepseek: 16.2
    B, 2.7 B active."""
    jc, tc = _cfgs(arch)
    assert sum(p.numel() for p in _tparams(arch).parameters()) == \
        _n_params(tc)
    assert sum(p.numel() for p in Model(tc).init(0, device="cpu")
               .parameters()) == _n_params(tc)
    full = tconfigs.get(arch)
    n = _n_params(full)
    assert n == jconfigs.shapes.count_params(jconfigs.get(arch))
    lo, hi, act_lo, act_hi = {PHI35: (41.8e9, 42.0e9, 6.5e9, 6.7e9),
                              DEEPSEEK: (16.1e9, 16.3e9, 2.6e9, 2.8e9)}[arch]
    assert lo < n < hi
    assert act_lo < jconfigs.shapes.active_params(jconfigs.get(arch)) < act_hi


# ----------------------------------------------------------------------
# apply_moe under autograd
# ----------------------------------------------------------------------
def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _router_case(cfg, case, rng):
    """(router or None, x): normal routing; a capacity overflow (most
    tokens pick expert 0, more than its capacity); an all-ties router
    (zero: top-k takes experts 0..k-1 for every token)."""
    d, e = cfg.d_model, cfg.n_experts
    if case == "normal":
        return None, rng.standard_normal((3, 16, d)).astype(np.float32)
    if case == "overflow":
        router = (rng.standard_normal((d, e)) * 0.02).astype(np.float32)
        router[:, 0] = 0.3
        return router, (rng.standard_normal((2, 16, d)) + 0.5).astype(
            np.float32)
    return np.zeros((d, e), np.float32), rng.standard_normal(
        (2, 16, d)).astype(np.float32)


def _moe_grads(cfg, p, x, w, dtype):
    """The port's gradients of ``sum(y * w) + 0.37 aux`` with respect to x
    and every leaf of the MoE ``p``, computed in ``dtype``."""
    cfg = cfg.scaled(compute_dtype=dtype, param_dtype=dtype)
    dt = getattr(torch, dtype)
    leaf = lambda t: t.detach().to(dt).requires_grad_()
    shared = p.shared and tmoe.MLP(*(leaf(t) for t in (
        p.shared.w1, p.shared.w2, p.shared.w3)))
    m = tmoe.MoE(*(leaf(t) for t in (p.router, p.w1, p.w2, p.w3)), shared)
    for t in m.parameters():
        t.requires_grad_(True)
    xt = leaf(torch.from_numpy(x))
    y, aux = tmoe.apply_moe(cfg, m, xt)
    loss = (y * torch.from_numpy(w).to(dt)).sum() + 0.37 * aux
    named = dict(m.named_parameters())
    grads = torch.autograd.grad(loss, [xt, *named.values()])
    return {n: g.double().numpy() for n, g in zip(["x", *named], grads)}


@pytest.mark.parametrize("case", ["normal", "overflow", "ties"])
@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_grads_match_reference(arch, case, monkeypatch):
    """The gradients of ``sum(y * w) + 0.37 aux`` with respect to x and
    every MoE leaf (router, experts, shared experts) against ``jax.grad``
    of the reference's ``apply_moe``: through the router softmax, the
    top-k renormalisation, the gathers, the capacity buffers' scatter, the
    expert products and the scatter-add combine; the aux loss (top-1
    counts from a one-hot) sends gradient through the probabilities only.

    Both are also held to the port's own arithmetic in float64. Under the
    overflow case's saturated router (expert 0's probability within fp32
    rounding of 1) the reference's fp32 router gradient is off the float64
    value by up to 2.5e-4 max|g| where the port's is off by 1e-6 max|g|
    (ROADMAP queue 3, record 7), so the reference is held there at 1e-3
    max|g|; every other leaf and case at 1e-4 max|g|."""
    jc, tc = _cfgs(arch)
    rng = np.random.default_rng({"normal": 0, "overflow": 7, "ties": 8}[case])
    router, x = _router_case(tc, case, rng)
    jp = _layer0(_jparams(arch)["layers"]["attn_moe"]["ffn"])
    tp = _tparams(arch).layers[0].ffn
    if router is not None:
        jp = dict(jp, router=jnp.asarray(router))
        tp = tmoe.MoE(torch.from_numpy(router), tp.w1, tp.w2, tp.w3,
                      tp.shared)
    w = rng.standard_normal(x.shape).astype(np.float32)
    _, _, expert = tmoe.route(tc, tp, torch.from_numpy(x))
    if case == "overflow":
        picks = (expert == 0).sum((1, 2))
        assert bool((picks > tmoe._capacity(tc, x.shape[1])).all())
    if case == "ties":
        assert bool((expert == torch.arange(tc.top_k)).all())

    def jloss(p, xx):
        y, aux = jmoe.apply_moe(jc, p, xx)
        return (y * w).sum() + 0.37 * aux
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    want = {"x": np.asarray(jgx), **{
        ".".join(str(k.key) for k in path): np.asarray(a)
        for path, a in jax.tree_util.tree_flatten_with_path(jgp)[0]}}
    got = _moe_grads(tc, tp, x, w, "float32")
    monkeypatch.setitem(tcommon._DTYPES, "float64", torch.float64)
    exact = _moe_grads(tc, tp, x, w, "float64")
    assert set(got) == set(want) == set(exact)
    for k, e in exact.items():
        top = np.abs(e).max()
        np.testing.assert_allclose(got[k], e, rtol=1e-4, atol=1e-4 * top,
                                   err_msg=k)
        loose = k == "router" and case == "overflow"
        np.testing.assert_allclose(want[k], e, rtol=1e-4,
                                   atol=(1e-3 if loose else 1e-4) * top,
                                   err_msg=k)
        if not loose:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-4 * top, err_msg=k)
    assert float(np.abs(got["router"]).max()) > 0


# ----------------------------------------------------------------------
# the model's loss and gradients, remat
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_loss_and_grads_match_reference(arch):
    """Reduced config, the reference's ``Model.init(0)`` weights: the loss
    (cross-entropy + 0.01 x the MoE aux loss summed over the layers) at
    1e-5 and every leaf's gradient against ``jax.grad``; MLA's attention
    goes through ``ops._Attention`` (the forward with lse, the flash-style
    backward's plain version) at q/k 48 / v 32, GQA's at 16."""
    jc, tc = _cfgs(arch)
    batch = JSyntheticLM(jc, 2, 24, seed=4).batch_at(0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(JModel(jc).loss, has_aux=True))(
        _jparams(arch), batch)
    tparams = _tparams(arch, trainable=True)
    tl, tm = Model(tc).loss(tparams, _tbatch(batch))
    named = dict(tparams.named_parameters())
    tg = dict(zip(named, torch.autograd.grad(tl, list(named.values()))))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["moe_aux"].detach()),
                               float(jm["moe_aux"]), rtol=1e-5)
    _assert_grads(_ported(tg, tc), _leaves(jg))


class _RouteLog:
    """Records every ``moe.route`` call's experts, with the MoE layer it
    routed (by its router's identity)."""

    def __init__(self):
        self.calls = []
        self._route = tmoe.route

    def __enter__(self):
        def recording(cfg, p, x):
            out = self._route(cfg, p, x)
            self.calls.append((id(p.router), out[2].clone()))
            return out
        tmoe.route = recording
        return self

    def __exit__(self, *exc):
        tmoe.route = self._route


@pytest.mark.parametrize("arch", MOE)
def test_remat_recompute_routes_as_the_first_forward(arch):
    """With remat="full" the backward recomputes each layer
    (``torch.utils.checkpoint``) and routes again: each layer's second
    routing picks the first forward's experts (routing depends only on
    the layer's saved input times the router). Loss and gradients equal
    those of remat="none", which routes once a layer."""
    _, tc = _cfgs(arch)
    batch = _tbatch(JSyntheticLM(_cfgs(arch)[0], 2, 24, seed=5).batch_at(0))
    out = {}
    for remat in ("full", "none"):
        cfg = tc.scaled(remat=remat)
        params = _tparams(arch, trainable=True)
        named = dict(params.named_parameters())
        with _RouteLog() as log:
            loss, _ = Model(cfg).loss(params, batch)
            n_fwd = len(log.calls)
            grads = torch.autograd.grad(loss, list(named.values()))
        assert n_fwd == cfg.n_layers
        assert len(log.calls) == (2 if remat == "full" else 1) * n_fwd
        first = dict(log.calls[:n_fwd])
        for key, expert in log.calls[n_fwd:]:
            assert torch.equal(expert, first[key])
        out[remat] = (float(loss.detach()), grads)
    assert out["full"][0] == out["none"][0]
    for a, b in zip(out["full"][1], out["none"][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------------
# the step with grad_accum, the optimizer over the MoE tree
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_step_with_grad_accum_matches_reference(arch):
    """One ``build_step_fn`` step with the config's own ``grad_accum``
    (deepseek 4, phi3.5 8; one row a microbatch), against the reference's:
    loss at 1e-5, new params within 2 lr (the first AdamW step moves each
    weight by about lr sign(g)) and 1e-5 relative. Each batch row is its
    own routing group, so the microbatches' mean loss is the whole
    batch's."""
    jc, tc = _cfgs(arch)
    accum = tc.grad_accum
    assert accum == jc.grad_accum == {DEEPSEEK: 4, PHI35: 8}[arch]
    batch = JSyntheticLM(jc, accum, 16, seed=2).batch_at(0)
    jparams = _jparams(arch)
    jp, js, jl, _ = jax.jit(jbuild_step_fn(jc, JAdamWConfig(**OPT)))(
        jparams, jinit_opt_state(jparams), batch)
    tparams = _tparams(arch, trainable=True)
    with torch.no_grad():
        whole, _ = Model(tc).loss(tparams, _tbatch(batch))
    tp, ts, tl, _ = build_step_fn(tc, AdamWConfig(**OPT))(
        tparams, init_opt_state(dict(tparams.named_parameters())),
        _tbatch(batch))
    assert ts["step"] == int(js["step"]) == 1
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tl), float(whole), rtol=1e-6)
    want = _leaves(jp)
    for k, got in _ported(tp.named_parameters(), tc).items():
        np.testing.assert_allclose(got, want[k], rtol=1e-5,
                                   atol=2 * OPT["lr"] / 2, err_msg=k)


def test_adamw_over_the_moe_tree():
    """The plain update (the Trainer's, as the reference's Trainer) over
    reduced deepseek's leaves, 3-D expert stacks included, against the
    reference's ``apply_updates`` on its stacked tree at 1e-6; with
    ``use_fused`` the port sends its per-layer 2-D leaves to the kernel
    (the reference only its stacked 2-D ones): the same step up to the
    kernel's rounding."""
    jc, tc = _cfgs(DEEPSEEK)
    jparams = _jparams(DEEPSEEK)
    rng = np.random.default_rng(6)
    jgrads = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(
        a.shape).astype(np.float32) * 0.01), jparams)
    want, wstate = japply_updates(JAdamWConfig(**OPT), jparams, jgrads,
                                  jinit_opt_state(jparams))
    named = dict(_tparams(DEEPSEEK).named_parameters())
    grads = {n: torch.from_numpy(np.array(g)) for n, g in
             convert.named_from_reference(_np(jgrads), named, tc).items()}
    assert {g.ndim for g in grads.values()} == {1, 2, 3}
    for fused in (False, True):
        got, state = apply_updates(AdamWConfig(**OPT), named, grads,
                                   init_opt_state(named), use_fused=fused)
        tol = dict(rtol=1e-6, atol=1e-7) if not fused else dict(
            rtol=1e-5, atol=1e-6)
        w = _leaves(want)
        for k, a in _ported(got, tc).items():
            np.testing.assert_allclose(a, w[k], err_msg=k, **tol)
        w = _leaves(wstate["m"])
        for k, a in _ported(state["m"], tc).items():
            np.testing.assert_allclose(a, w[k], err_msg=k, **tol)


@pytest.mark.parametrize("arch", MOE)
def test_multistream_update_plan_takes_the_moe_tree(arch):
    """``plan_update_multistream`` over the MoE tree in the reference's
    stacked layout (the Trainer's call, shapes only, meta tensors) gives
    the reference's plan of the same tree."""
    _, tc = _cfgs(arch)
    named = dict(_tparams(arch).named_parameters())
    tree = convert.to_reference({n: t.to("meta") for n, t in named.items()},
                                tc)
    got = plan_update_multistream(tree, n_clusters=4)
    want = jplan(_jparams(arch), n_clusters=4)
    assert got["n_substreams"] == want["n_substreams"] == len(
        jax.tree.leaves(_jparams(arch)))
    assert list(got["assignment"]) == list(want["assignment"])
    for key in ("critical_path_s", "serial_time_s", "model_speedup"):
        assert got[key] == pytest.approx(want[key], rel=1e-12)
    for key, v in want["pipeline"].items():
        assert got["pipeline"][key] == pytest.approx(v, rel=1e-12)


# ----------------------------------------------------------------------
# checkpoints
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_checkpoint_round_trip(arch, tmp_path):
    """A bf16 MoE state (params, the fp32 optimizer state) in the
    reference's stacked layout saved and loaded back: every leaf with its
    bits and dtype."""
    _, tc = _cfgs(arch, "bfloat16")
    params = Model(tc).init(0, device="cpu")
    named = dict(params.named_parameters())
    opt = init_opt_state(named)
    tree = {"params": convert.to_reference(named, tc),
            "opt": {k: convert.to_reference(opt[k], tc)
                    for k in ("master", "m", "v")},
            "data_step": torch.tensor(3, dtype=torch.int32)}
    save_pytree(tree, str(tmp_path / "c"))
    back = load_pytree(str(tmp_path / "c"), tree)
    got = convert.named_from_reference(back["params"], named, tc)
    master = convert.named_from_reference(back["opt"]["master"], named, tc)
    for n, p in named.items():
        assert got[n].dtype == torch.bfloat16 and torch.equal(got[n], p)
        assert master[n].dtype == torch.float32
        assert torch.equal(master[n], opt["master"][n])
    assert int(back["data_step"]) == 3


STEPS, RESUME_AT = 3, 2


def _train_cfg(cls, d):
    return cls(steps=STEPS, log_every=0, ckpt_every=1, ckpt_dir=d,
               global_batch=4, seq_len=16, multistream_plan=False)


def test_port_resumes_reference_deepseek_checkpoint(tmp_path):
    """The reference Trainer on reduced deepseek (grad_accum 4) writes a
    checkpoint every step; the port's Trainer resumes its step-RESUME_AT
    one and continues its loss stream, and the port's last checkpoint
    loads in the reference's ``load_pytree`` close to the reference's
    own."""
    jc, tc = _cfgs(DEEPSEEK)
    run = JTrainer(jc, JAdamWConfig(**OPT), _train_cfg(
        JTrainConfig, str(tmp_path / "ref"))).run()
    d = tmp_path / "port"
    d.mkdir()
    name = f"step_{RESUME_AT:09d}"
    shutil.copytree(tmp_path / "ref" / name, d / name)
    r = Trainer(tc, AdamWConfig(**OPT), _train_cfg(TrainConfig, str(d)),
                device="cpu").run()
    assert r["resumed_from"] == RESUME_AT and r["bad_steps"] == 0
    np.testing.assert_allclose(r["losses"], run["losses"][RESUME_AT:],
                               rtol=1e-4)
    last = f"step_{STEPS:09d}"
    with open(d / last / "manifest.json") as f:
        port_names = [m["name"] for m in json.load(f)]
    with open(tmp_path / "ref" / last / "manifest.json") as f:
        assert port_names == [m["name"] for m in json.load(f)]
    like = {"params": run["params"], "opt": run["opt"],
            "data_step": jnp.zeros((), jnp.int32)}
    got = _leaves(jload_pytree(str(d / last), like))
    want = _leaves(jload_pytree(str(tmp_path / "ref" / last), like))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-4 * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


# ----------------------------------------------------------------------
# phi3.5-moe serving
# ----------------------------------------------------------------------
B, PLEN, NEW = 2, 12, 6
MAX_SEQ = PLEN + NEW + 8


def _prompts(cfg, n=B, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, PLEN) for _ in range(n)]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_phi35_generate_matches_reference(temperature):
    """``Server.generate`` greedy and at temperature 0.8 (Gumbel noise
    from numpy in both) gives the reference's completions."""
    jc, tc = _cfgs(PHI35)
    kw = dict(max_seq=MAX_SEQ, max_new_tokens=NEW, eos_token=-1,
              temperature=temperature, seed=5)
    want = JServer(jc, _jparams(PHI35), JServeConfig(**kw)).generate(
        _prompts(jc))
    got = Server(tc, _tparams(PHI35), ServeConfig(**kw)).generate(
        _prompts(tc))
    assert got["completions"] == want["completions"]
    assert all(len(c) == NEW for c in got["completions"])


def test_phi35_prefill_logits_and_chunked_prefill():
    """Prefill logits at 1e-4 against the reference's; with 8 requests the
    config's prefill_microbatch 8 prefills one request a chunk, and gives
    the unchunked logits at 1e-4 and its bf16 caches at 1e-2
    (tests/test_system.py::test_prefill_microbatch_parity's limits)."""
    jc, tc = _cfgs(PHI35)
    toks = np.stack(_prompts(tc, 8)).astype(np.int32)
    jl, _, _ = JModel(jc).prefill(_jparams(PHI35),
                                  {"tokens": jnp.asarray(toks)}, cache_len=24)
    params = _tparams(PHI35)
    t = {"tokens": torch.from_numpy(toks).long()}
    with torch.inference_mode():
        l8, c8, _ = Model(tc).prefill(params, t, cache_len=24)
        l1, c1, _ = Model(tc.scaled(prefill_microbatch=1)).prefill(
            params, t, cache_len=24)
    np.testing.assert_allclose(l8.numpy(), np.asarray(jl, np.float32),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(l8.numpy(), l1.numpy(), atol=1e-4)
    for a, b in zip(c8, c1):
        assert a.keys() == b.keys() == {"k", "v"}
        for k in a:
            np.testing.assert_allclose(a[k].float().numpy(),
                                       b[k].float().numpy(), rtol=1e-2,
                                       atol=1e-2)


def test_phi35_decode_matches_prefill_continuation():
    """tests/test_models.py::test_decode_matches_prefill_continuation on
    phi3.5-moe: decoding token s+1 from a prefilled bf16 cache matches
    prefilling s+1 tokens at 2e-2. At the config's capacity factor the
    17-token prefill may drop entries that a one-token decode keeps, so
    every expert gets room for all entries (capacity factor e / k), as the
    deepseek mirror does."""
    _, tc = _cfgs(PHI35, capacity_factor=2.0)
    assert tc.capacity_factor == tc.n_experts / tc.top_k
    model = Model(tc)
    params = _tparams(PHI35)
    t = torch.from_numpy(np.random.default_rng(3).integers(
        0, tc.vocab, (1, 17))).long()
    with torch.inference_mode():
        full, _, _ = model.prefill(params, {"tokens": t}, cache_len=32)
        _, cache, fill = model.prefill(params, {"tokens": t[:, :16]},
                                       cache_len=32)
        step, _ = model.decode(params, t[:, 16:17], cache, fill)
    np.testing.assert_allclose(full.numpy(), step[:, 0].numpy(), rtol=2e-2,
                               atol=2e-2)


def test_phi35_convert_round_trip():
    """The reference tree -> the port's modules -> the reference tree, bit
    for bit: GQA's wq / wk / wv / wo and the MoE's router and stacked
    experts, no shared-expert subtree."""
    _, tc = _cfgs(PHI35)
    named = dict(_tparams(PHI35).named_parameters())
    assert "layers.3.ffn.w2" in named and not any(".shared." in n
                                                  for n in named)
    back = _leaves(convert.to_reference(named, tc))
    want = _leaves(_jparams(PHI35))
    assert back.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(back[k], w, err_msg=k)


# ----------------------------------------------------------------------
# mirrors of tests/test_models.py's smoke tests, and the launchers
# ----------------------------------------------------------------------
def _smoke_batch(cfg, b=2, s=32):
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).long()
    return {"tokens": toks, "labels": torch.roll(toks, -1, 1)}


@pytest.mark.parametrize("arch", MOE)
def test_reduced_smoke_train(arch):
    """The reduced config at its own dtypes (bf16), ``Model.init`` weights:
    a finite, positive loss and finite gradients."""
    cfg = tconfigs.get_reduced(arch)
    params = Model(cfg).init(0, device="cpu", trainable=True)
    loss, _ = Model(cfg).loss(params, _smoke_batch(cfg))
    grads = torch.autograd.grad(loss, list(params.parameters()))
    loss = float(loss.detach())
    assert np.isfinite(loss) and loss > 0
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("arch", MOE)
def test_reduced_smoke_decode(arch):
    cfg = tconfigs.get_reduced(arch)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    b, s = 2, 32
    with torch.inference_mode():
        logits, cache, fill = model.prefill(
            params, {"tokens": _smoke_batch(cfg, b, s)["tokens"]},
            cache_len=s + 8)
        assert logits.shape == (b, cfg.padded_vocab)
        tok = logits.argmax(-1)[:, None]
        logits2, _ = model.decode(params, tok, cache, fill)
    assert logits2.shape == (b, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits2.float()).all())


@pytest.mark.parametrize("arch", MOE)
def test_launcher_trains_moe_on_the_cpu(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch <moe> --reduced
    --device cpu`` at the config's grad_accum (global batch 8): finite
    losses."""
    from repro_torch.launch import train as launch_train
    assert launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                              "--steps", "2", "--global-batch", "8", "--seq",
                              "16", "--ckpt", str(tmp_path), "--resume",
                              "none"]) == 0
    out = capsys.readouterr().out
    first, last = (float(x) for x in out.split("done: loss ")[1]
                   .split(",")[0].split(" -> "))
    assert np.isfinite(first) and np.isfinite(last)


def test_launcher_serves_phi35_on_the_cpu(capsys):
    from repro_torch.launch import serve as launch
    assert launch.main(["--arch", "phi3.5-moe-42b", "--device", "cpu",
                        "--batch", "2", "--prompt-len", "8", "--new-tokens",
                        "3", "--set", "n_layers=2"]) == 0
    out = capsys.readouterr().out
    assert "tok/s" in out and out.count("req") == 2
