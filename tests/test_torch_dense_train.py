"""Dense GQA training in the port against the JAX reference, on the CPU.

The training path's pieces, each fed the same seeded numpy inputs as the
reference: the plain attention backward (``ref.mha_blocked``'s
flash-style VJP) and ``ops.attention``'s autograd Function, the fused
MLP's autograd Function and its activation backward, the engine's
prefix-store nests (the card runs them through ``engine.execute_torch``),
and the three dense configs that need no new model code (yi-9b,
phi3-medium-14b, granite-3-8b) on their reduced sizes. Tolerances are
stated with each test; fp32 throughout unless a test says otherwise.
"""
import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import configs as jconfigs
from repro.core import descriptor as jdesc
from repro.core import engine as jengine
from repro.data import SyntheticLM as JSyntheticLM
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import Model as JModel
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt_state
from repro.runtime import serve as jserve
from repro.runtime.train import build_step_fn as jbuild_step_fn

from repro_torch import configs as tconfigs
from repro_torch.core import descriptor as tdesc
from repro_torch.core import engine as tengine
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ntx_elementwise as tew
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import Model
from repro_torch.models.convert import from_reference, to_reference
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime import build_step_fn
from repro_torch.runtime import serve as tserve

tdispatch = importlib.import_module("repro_torch.core.dispatch")

DENSE = ("yi-9b", "phi3-medium-14b", "granite-3-8b")


def _rng(seed):
    return np.random.default_rng(seed)


def _np32(*shape, seed=0, scale=1.0):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _grads_torch(fn, arrays, dout):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    out = fn(*ts)
    return out.detach().numpy(), [g.numpy() for g in torch.autograd.grad(
        out, ts, torch.from_numpy(dout))]


# ----------------------------------------------------------------------
# Attention backward
# ----------------------------------------------------------------------
@pytest.mark.parametrize("sq", [512, 2048])
def test_mha_blocked_vjp_matches_reference(sq):
    """The plain backward (``ref.mha_blocked``) against ``jax.vjp`` of the
    reference's ``ref.mha_blocked`` at the shapes where its
    ``ops.attention`` takes that route (sq >= 512, skv 2048, causal), at
    the reference's own rtol 1e-3, atol 1e-4; the forward's lse against
    its ``_mha_blocked_fwd``'s."""
    b, hq, hkv, skv, d = 1, 4, 2, 2048, 16
    q, k, v = (_np32(b, h, s, d, seed=i) for i, (h, s) in enumerate(
        ((hq, sq), (hkv, skv), (hkv, skv))))
    dout = _np32(b, hq, sq, d, seed=3)
    off = skv - sq
    jout, vjp = jax.vjp(lambda a, b_, c: jref.mha_blocked(
        a, b_, c, causal=True, q_offset=off), *map(jnp.asarray, (q, k, v)))
    jg = vjp(jnp.asarray(dout))
    out, tg = _grads_torch(lambda a, b_, c: tref.mha_blocked(
        a, b_, c, causal=True, q_offset=off), (q, k, v), dout)
    np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-3, atol=1e-4)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3,
                                   atol=1e-4)
    _, res = jref._mha_blocked_fwd(*map(jnp.asarray, (q, k, v)), True,
                                   d ** -0.5, off, 512)
    _, lse = tref.mha_blocked_fwd(*map(torch.from_numpy, (q, k, v)),
                                  q_offset=off)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(res[4]).reshape(b, hq, sq),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,causal", [(16, True), (100, True), (37, False)])
def test_attention_grads_match_reference_autodiff(s, causal):
    """``ops.attention`` under autograd on CPU tensors (the plain forward
    and the flash-style backward of ``_Attention``) against ``jax.grad``
    of the reference's ``ref.mha`` at short lengths, rtol 1e-3, atol
    1e-4 (the reference's tolerance for its VJP)."""
    q, k, v = (_np32(1, h, s, 16, seed=i) for i, h in enumerate((4, 2, 2)))
    dout = _np32(1, 4, s, 16, seed=7)
    _, vjp = jax.vjp(lambda a, b, c: jref.mha(a, b, c, causal=causal),
                     *map(jnp.asarray, (q, k, v)))
    jg = vjp(jnp.asarray(dout))
    _, tg = _grads_torch(lambda a, b, c: tops.attention(a, b, c,
                                                        causal=causal),
                         (q, k, v), dout)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3,
                                   atol=1e-4)


def test_attention_function_matches_torch_autograd_of_plain():
    """``_Attention``'s gradients (its plain backward) against PyTorch
    autograd through the plain forward, GQA with g = 4, 1e-5."""
    q, k, v = (_np32(2, h, 50, 32, seed=i, scale=0.7)
               for i, h in enumerate((8, 2, 2)))
    dout = _np32(2, 8, 50, 32, seed=9)
    out, got = _grads_torch(lambda a, b, c: tops.attention(a, b, c), (q, k, v),
                            dout)
    want_out, want = _grads_torch(lambda a, b, c: tfa.flash_attention_plain(
        a, b, c, causal=True), (q, k, v), dout)
    np.testing.assert_array_equal(out, want_out)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_lse_plain_is_the_reference_logsumexp():
    """``flash_lse_plain`` (the forward kernel's lse output) equals the
    lse of the reference's blocked forward, 1e-5."""
    q, k = _np32(2, 4, 30, 64, seed=1), _np32(2, 2, 30, 64, seed=2)
    v = _np32(2, 2, 30, 64, seed=3)
    _, res = jref._mha_blocked_fwd(*map(jnp.asarray, (q, k, v)), True,
                                   64 ** -0.5, 0, 30)
    got = tfa.flash_lse_plain(torch.from_numpy(q), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(res[4]).reshape(2, 4, 30),
                               rtol=1e-5, atol=1e-5)


def test_attention_under_autograd_takes_training_shapes_only():
    q = torch.zeros(1, 4, 3, 16, requires_grad=True)
    k = torch.zeros(1, 2, 8, 16)
    with pytest.raises(NotImplementedError, match="training shapes"):
        tops.attention(q, k, k, kv_len=5)
    with pytest.raises(NotImplementedError, match="training shapes"):
        tops.attention(torch.zeros(1, 4, 9, 16, requires_grad=True), k, k)
    with torch.no_grad():
        assert tops.attention(q, k, k, kv_len=5).shape == q.shape


def test_flash_bwd_plan():
    """The backward planner: bf16 wgmma blocks of two consumer warpgroups
    (128 keys over 64-query tiles; 128 queries over 64-key tiles) in a
    3-stage ring, ~163 KB each at d 128 (one block an SM), whole groups
    at the training shape; fp32 32 x 16 FFMA tiles with the group split
    in four; causal with sq > skv refused."""
    p = tfa.flash_bwd_plan(4, 32, 8, 2048, 2048, 128, torch.bfloat16)
    assert (p.bk, p.bq, p.gs, p.dkdv_grid, p.dq_grid) == (128, 64, 1,
                                                          (32, 16),
                                                          (128, 16))
    assert (p.smem_dkdv, p.smem_dq) == (166456, 165944)
    assert max(p.smem_dkdv, p.smem_dq) <= tfa.MAX_SMEM
    f = tfa.flash_bwd_plan(1, 8, 2, 1000, 1000, 128, torch.float32)
    assert (f.bk, f.bq, f.gs, f.smem_dkdv, f.smem_dq) == (32, 16, 4, 54016,
                                                          51776)
    with pytest.raises(ValueError, match="sq <= skv"):
        tfa.flash_bwd_plan(1, 8, 2, 10, 5, 128, torch.bfloat16)
    shape = (1, 8, 2, 1024, 1024, 1024, 128, torch.bfloat16)
    assert tfa.flash_plan(*shape).splits > 1
    assert tfa.flash_plan(*shape, lse=True).splits == 1


# ----------------------------------------------------------------------
# The fused MLP's backward
# ----------------------------------------------------------------------
def _mlp_inputs(act, m=24, d=32, f=48):
    arrays = [_np32(2, m // 2, d, seed=1), _np32(d, f, seed=2,
                                                 scale=d ** -0.5),
              _np32(f, d, seed=3, scale=f ** -0.5)]
    if act == "swiglu":
        arrays.append(_np32(d, f, seed=4, scale=d ** -0.5))
    arrays.append(_np32(2, m // 2, d, seed=5))
    return arrays, _np32(2, m // 2, d, seed=6)


def _port_mlp(act):
    def fn(x, w1, w2, *rest):
        w3 = rest[0] if act == "swiglu" else None
        return tops.fused_mlp(x, w1, w2, w3, act=act, residual=rest[-1])
    return fn


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_fused_mlp_grads_match_torch_autograd(act):
    """``_FusedMLP`` (the plain versions of its GEMMs and activation
    backward) against PyTorch autograd of the plain forward (sigmoid /
    tanh GELU), fp32, 1e-5."""
    import torch.nn.functional as F
    arrays, dout = _mlp_inputs(act)

    def plain(x, w1, w2, *rest):
        a1 = x @ w1
        h = (F.silu(a1) * (x @ rest[0]) if act == "swiglu"
             else F.gelu(a1, approximate="tanh"))
        return rest[-1] + h @ w2
    _, got = _grads_torch(_port_mlp(act), arrays, dout)
    _, want = _grads_torch(plain, arrays, dout)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_fused_mlp_grads_match_reference(act):
    """Against ``jax.grad`` of the reference's ``ops.fused_mlp`` on its
    default ``ref`` backend (jnp, not the Pallas kernels), fp32, where
    both compute the same function: 1e-4."""
    assert jops.get_backend() == "ref"
    arrays, dout = _mlp_inputs(act)

    def ref_fn(x, w1, w2, *rest):
        w3 = rest[0] if act == "swiglu" else None
        return jops.fused_mlp(x, w1, w2, w3, act=act, residual=rest[-1])
    jout, vjp = jax.vjp(ref_fn, *map(jnp.asarray, arrays))
    jg = vjp(jnp.asarray(dout))
    out, tg = _grads_torch(_port_mlp(act), arrays, dout)
    np.testing.assert_allclose(out, np.asarray(jout), rtol=1e-5, atol=1e-5)
    for got, want in zip(tg, jg):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_act_bwd_plain_matches_jax_grad(act):
    """The activation backward's plain version against ``jax.vjp`` of
    ``jax.nn.silu(a) * gate`` / ``jax.nn.gelu(a)`` (the tanh form, JAX's
    default), fp32: 1e-5 relative, 1e-5 absolute (the GELU derivative's
    two terms cancel for large negative a1, where the two fp32 orders
    differ by up to 3.2e-6 on values of order 1); ``h`` is the forward's
    value."""
    a = _np32(4, 500, seed=1, scale=3.0)
    dh, gate = _np32(4, 500, seed=2), _np32(4, 500, seed=3)
    if act == "swiglu":
        h, vjp = jax.vjp(lambda x, g: jax.nn.silu(x) * g, jnp.asarray(a),
                         jnp.asarray(gate))
        want = vjp(jnp.asarray(dh))
    else:
        h, vjp = jax.vjp(jax.nn.gelu, jnp.asarray(a))
        want = vjp(jnp.asarray(dh)) + (None,)
    da1, dgate, th = tops.act_bwd(act, torch.from_numpy(dh),
                                  torch.from_numpy(a), torch.from_numpy(gate)
                                  if act == "swiglu" else None)
    np.testing.assert_allclose(th.numpy(), np.asarray(h), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(da1.numpy(), np.asarray(want[0]), rtol=1e-5,
                               atol=1e-5)
    if act == "swiglu":
        np.testing.assert_allclose(dgate.numpy(), np.asarray(want[1]),
                                   rtol=1e-5, atol=1e-6)
    else:
        assert dgate is None


def test_act_bwd_rounds_to_the_compute_dtype():
    """bf16 outputs are the fp32 values rounded once."""
    a, dh, gate = (torch.from_numpy(_np32(3, 77, seed=i)) for i in range(3))
    f = tew.act_bwd_plain("swiglu", dh, a, gate, torch.float32)
    b = tew.act_bwd_plain("swiglu", dh, a, gate, torch.bfloat16)
    for x, y in zip(f, b):
        assert y.dtype == torch.bfloat16
        assert torch.equal(x.to(torch.bfloat16), y)
    with pytest.raises(ValueError, match="activation"):
        tew.act_bwd_plain("relu", dh, a, gate)


# ----------------------------------------------------------------------
# Prefix-store nests on the torch engine
# ----------------------------------------------------------------------
PREFIX_NESTS = {
    "running_1d": ((9,), 1, 0, (1,), (1,)),
    "rows_of_4x3": ((4, 3, 2), 2, 1, (1, 4, 12), (0, 1, 3)),
    "whole_nest": ((4, 3, 2), 3, 1, (1, 4, 12), (0, 1, 3)),
    "every_step": ((6, 5), 2, 0, (1, 6), (1, 6)),
    "one_address": ((4, 3, 2), 2, 1, (1, 4, 12), (0, 0, 1)),
}


def _prefix_mem():
    mem = _np32(2048, seed=8)
    mem[[10, 30, 41]] = 9.0            # ties for MAX / ARGMAX
    mem[[12, 33, 47]] = -9.0           # ties for MIN / ARGMIN
    mem[5] = -0.0
    mem[6] = 0.0
    return mem


@pytest.mark.parametrize("op", ["MAC", "VSUM", "MAX", "MIN", "ARGMAX",
                                "ARGMIN"])
@pytest.mark.parametrize("nest", sorted(PREFIX_NESTS))
def test_prefix_store_matches_reference_engine(op, nest):
    """``engine.execute_torch`` on prefix-store nests (store_level <
    init_level) against the reference's cycle-faithful
    ``engine.execute``: MIN/MAX/arg bit-equal (ties first-wins), sums
    within 1e-5 (fp64 running sums rounded once, as the oracle's wide
    accumulator)."""
    bounds, init, store, s0, s2 = PREFIX_NESTS[nest]
    mk = lambda m: m.Descriptor(
        bounds=bounds, opcode=m.Opcode[op], init_level=init,
        store_level=store, agu0=m.Agu(0, s0), agu1=m.Agu(200, s0),
        agu2=m.Agu(1000, s2))
    mem = _prefix_mem()
    want = jengine.execute(mk(jdesc), mem)
    got = tengine.execute_torch(mk(tdesc), torch.from_numpy(mem)).numpy()
    if op in ("MAC", "VSUM"):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_prefix_store_that_reads_its_stores_is_refused():
    """Reads that alias the nest's own stores see earlier stores in the
    oracle; the gather plan refuses them rather than differ."""
    d = tdesc.Descriptor(bounds=(5,), opcode=tdesc.Opcode.VSUM,
                         init_level=1, store_level=0,
                         agu0=tdesc.Agu(0, (1,)), agu2=tdesc.Agu(2, (1,)))
    with pytest.raises(NotImplementedError, match="reads an address"):
        tengine.execute_torch(d, torch.zeros(16))


def test_prefix_store_stays_interleaved():
    """``traceable_descriptor`` keeps the reference's rule: a prefix-store
    nest is not traceable (the executor runs it ``interleave``)."""
    d = tdesc.Descriptor(bounds=(5,), opcode=tdesc.Opcode.MAC, init_level=1,
                         store_level=0, agu0=tdesc.Agu(0, (1,)),
                         agu1=tdesc.Agu(100, (1,)), agu2=tdesc.Agu(1000, (1,)))
    assert not tdispatch.traceable_descriptor(d)


# ----------------------------------------------------------------------
# The three dense configs
# ----------------------------------------------------------------------
def _pair(arch, **kw):
    return tuple(m.get_reduced(arch).scaled(compute_dtype="float32",
                                            param_dtype="float32", **kw)
                 for m in (jconfigs, tconfigs))


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(a, np.float32)
            for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()}


@pytest.mark.parametrize("arch", DENSE)
def test_config_matches_reference(arch):
    assert tconfigs.get(arch).__dict__ == jconfigs.get(arch).__dict__
    assert (tconfigs.get_reduced(arch).__dict__
            == jconfigs.get_reduced(arch).__dict__)
    assert tconfigs.get(arch).hd == 128    # a head dim the kernels take


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference(arch):
    """Reduced config, the reference's ``Model.init(0)`` weights: loss at
    1e-5 and every leaf's gradient at 1e-4 (fp32) against ``jax.grad``."""
    jc, tc = _pair(arch)
    jparams = jax.jit(lambda: JModel(jc).init(0))()
    batch = JSyntheticLM(jc, 2, 24, seed=4).batch_at(0)
    (jl, _), jg = jax.jit(jax.value_and_grad(JModel(jc).loss, has_aux=True))(
        jparams, batch)
    tparams = from_reference(_np(jparams), tc, device="cpu")
    tparams.requires_grad_(True)
    tl, _ = Model(tc).loss(tparams, _tbatch(batch))
    named = dict(tparams.named_parameters())
    tg = dict(zip(named, torch.autograd.grad(tl, list(named.values()))))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    want = _leaves(jg)
    got = {jax.tree_util.keystr(p): a.detach().numpy()
           for p, a in jax.tree_util.tree_flatten_with_path(
               to_reference(tg, tc))[0]}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_phi3_step_with_grad_accum_matches_reference():
    """One ``build_step_fn`` step of reduced phi3-medium-14b with its
    ``grad_accum=4`` (batch 4 in 4 microbatches), fp32: loss at 1e-5, new
    params within 2 lr (the first AdamW step moves each weight by about
    lr sign(g)) and 1e-5 relative."""
    jc, tc = _pair("phi3-medium-14b")
    assert jc.grad_accum == tc.grad_accum == 4
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jparams = jax.jit(lambda: JModel(jc).init(0))()
    batch = JSyntheticLM(jc, 4, 16, seed=2).batch_at(0)
    jp, js, jl, _ = jax.jit(jbuild_step_fn(jc, JAdamWConfig(**opt)))(
        jparams, jinit_opt_state(jparams), batch)
    tparams = from_reference(_np(jparams), tc, device="cpu")
    tparams.requires_grad_(True)
    tp, ts, tl, _ = build_step_fn(tc, AdamWConfig(**opt))(
        tparams, init_opt_state(dict(tparams.named_parameters())),
        _tbatch(batch))
    assert ts["step"] == int(js["step"]) == 1
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = _leaves(jp)
    for p, a in jax.tree_util.tree_flatten_with_path(
            to_reference(dict(tp.named_parameters()), tc))[0]:
        k = jax.tree_util.keystr(p)
        np.testing.assert_allclose(a.detach().numpy(), want[k], rtol=1e-5,
                                   atol=2 * 1e-3 / 2, err_msg=k)


@pytest.mark.parametrize("staged", [False, True])
def test_granite_greedy_sampler_bit_equal(staged):
    """The greedy ARGMAX sampler on granite's odd 49155-wide logits (ties
    planted first-wins) bit-equal to the reference's and to
    ``np.argmax``."""
    vocab = tconfigs.get("granite-3-8b").vocab
    assert vocab == 49155 and tconfigs.get("granite-3-8b").padded_vocab \
        == 49408
    logits = _np32(3, vocab, seed=12)
    logits[0, [17, 40000]] = logits[0].max() + 1.0
    logits[2, [49154, 3]] = logits[2].max() + 1.0
    jfn = (jserve.greedy_argmax_pipelined if staged
           else jserve.greedy_argmax_multistream)
    tfn = (tserve.greedy_argmax_pipelined if staged
           else tserve.greedy_argmax_multistream)
    want = jfn(logits)
    got = tfn(logits, device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.argmax(logits, -1))
    assert list(got[[0, 2]]) == [17, 3]


def test_launcher_trains_a_dense_config_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on reduced granite-3-8b,
    its plain versions on the CPU: finite losses."""
    from repro_torch.launch import train as launch_train
    assert launch_train.main(["--arch", "granite-3-8b", "--reduced",
                              "--device", "cpu", "--steps", "3",
                              "--global-batch", "2", "--seq", "16",
                              "--ckpt", str(tmp_path), "--resume",
                              "none"]) == 0
    out = capsys.readouterr().out
    first, last = (float(x) for x in out.split("done: loss ")[1]
                   .split(",")[0].split(" -> "))
    assert np.isfinite(first) and np.isfinite(last)


@pytest.mark.parametrize("op", ["VSUM", "ARGMAX", "MIN"])
def test_one_d_prefix_store_reduction_dispatch_matches_engine(op):
    """A 1-D reduction with store_level 0 stores every prefix (the
    reference's ``engine.execute``). The port's ``dispatch`` sends it to
    the engine; the reference's sends it to its reduce kernel, which
    stores only the last value at the base (ROADMAP queue 3, record 5):
    the port matches the oracle, MIN/arg bit-equal, sums within 1e-5."""
    mk = lambda m: m.Descriptor(
        bounds=(8,), opcode=m.Opcode[op], init_level=1, store_level=0,
        agu0=m.Agu(0, (1,)), agu2=m.Agu(32, (1,)))
    mem = _np32(64, seed=21)
    mem[[2, 6]] = mem[:8].max() + 1.0
    want = jengine.execute(mk(jdesc), mem)
    got = tdispatch.dispatch(mk(tdesc), torch.from_numpy(mem.copy())).numpy()
    if op == "VSUM":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
    from repro.core.dispatch import dispatch as jdispatch
    ref = np.asarray(jdispatch(mk(jdesc), jnp.asarray(mem)))
    np.testing.assert_array_equal(ref[33:40], mem[33:40])   # left as is
    np.testing.assert_allclose(ref[32], want[39], rtol=1e-5)


def test_prefix_store_program_under_policies_matches_engine():
    """chip_smoke's prefix-store program (a MAC stored after each of 64
    rows, a running ARGMAX over 4096 with ties) on a CPU image under the
    serial and fused policies, against ``engine.execute``; the torch
    engine's plan gives the same values."""
    import ntx_torch as ntx
    rows, cols, n = 64, 64, 4096
    xs, ys, zs = _np32(rows * cols, seed=1), _np32(rows * cols, seed=2), \
        _np32(n, seed=3)
    zs[[100, 900, 3000]] = zs.max() + 1.0
    prog = ntx.Program()
    x, y = prog.buffer((rows * cols,)), prog.buffer((rows * cols,))
    z, dots, best = (prog.buffer((n,)), prog.buffer((rows,), name="dots"),
                     prog.buffer((n,), name="best"))
    prog.emit(tdesc.Descriptor(
        bounds=(cols, rows), opcode=tdesc.Opcode.MAC, init_level=2,
        store_level=1, agu0=tdesc.Agu(x.offset, (1, cols)),
        agu1=tdesc.Agu(y.offset, (1, cols)),
        agu2=tdesc.Agu(dots.offset, (0, 1))))
    prog.emit(tdesc.Descriptor(
        bounds=(n,), opcode=tdesc.Opcode.ARGMAX, init_level=1,
        store_level=0, agu0=tdesc.Agu(z.offset, (1,)),
        agu2=tdesc.Agu(best.offset, (1,))))
    inputs = {x: xs, y: ys, z: zs}
    mem = prog.pack(inputs, device="cpu")
    want = mem.numpy()
    for d in prog.descriptors:
        want = tengine.execute(d, want)
        mem = tengine.execute_torch(d, mem)
    want = prog.unpack(torch.from_numpy(want))
    for res in [prog.unpack(mem)] + [
            ntx.Executor(p, device="cpu").run(prog, inputs=inputs)
            for p in ("serial", "fused")]:
        np.testing.assert_array_equal(res["best"], want["best"])
        np.testing.assert_allclose(res["dots"], want["dots"], rtol=1e-5,
                                   atol=1e-5)
    assert want["best"][99] != want["best"][100] == want["best"][-1] == 100


def test_ref_axpy_matches_reference():
    """``ref.axpy`` (an unpinned ``a * x + y``) against the reference's,
    bit-equal in fp32 on the CPU (neither contracts to an FMA here)."""
    x, y = _np32(3, 700, seed=31), _np32(3, 700, seed=32)
    got = tref.axpy(0.3, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.axpy(np.float32(0.3), x, y)))
