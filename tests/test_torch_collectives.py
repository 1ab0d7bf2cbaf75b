"""The port's collectives, ring products and pipeline
(``repro_torch.distributed``) against the reference's, on the CPU.

``quantize_int8`` / ``dequantize_int8`` / ``error_feedback`` are held
bit-equal to the reference's on the same numpy inputs. The rest runs on
8 gloo ranks (``tests/torch_mesh_worker.py``) on the inputs of the
reference's ``tests/test_distributed.py`` and is held against the
reference's own 8-device ``shard_map`` runs of those inputs (a
subprocess with ``--xla_force_host_platform_device_count=8``) and
against the exact answer, at the reference tests' bounds: relative 0.02
for the int8 mean, absolute 1e-4 and 1e-3 for the two rings, 1e-5 for
the pipeline. The blocks of a multi-axis spec on a (2, 2, 2) mesh equal
the ones JAX's ``NamedSharding`` gives its devices."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.distributed import collectives as ref_coll
from repro_torch.distributed import collectives
from torch_mesh_worker import collective_inputs, collectives_rank, run_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = collective_inputs()

REFERENCE = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    sys.path.insert(0, sys.argv[2])
    from torch_mesh_worker import collective_inputs
    from repro.distributed import collectives, overlap, pipeline
    from repro.distributed.compat import shard_map
    inp = collective_inputs()
    mesh = jax.make_mesh((8,), ("data",))
    f = shard_map(lambda v: collectives.compressed_psum_mean(v[0], "data")[None],
                  mesh=mesh, in_specs=P("data", None), out_specs=P("data", None))
    pm = shard_map(lambda v: collectives.psum_mean(v[0], "data")[None],
                   mesh=mesh, in_specs=P("data", None), out_specs=P("data", None))
    ag = shard_map(lambda xl, wl: overlap.ring_allgather_matmul(xl, wl, "data"),
                   mesh=mesh, in_specs=(P("data", None), P(None, "data")),
                   out_specs=P(None, "data"))
    rs = shard_map(lambda xl, wl: overlap.ring_matmul_reducescatter(xl, wl, "data"),
                   mesh=mesh, in_specs=(P(None, "data"), P("data", None)),
                   out_specs=P("data", None))
    run = pipeline.pipelined_apply(mesh, lambda p, x: jnp.maximum(x + p, 0.0),
                                   "data", P("data", None), P(None, None, None),
                                   P(None, None, None))
    out = {"compressed": jax.jit(f)(inp["x"]), "pmean": jax.jit(pm)(inp["x"]),
           "ag": jax.jit(ag)(inp["xs"], inp["w"]),
           "rs": jax.jit(rs)(inp["xs"], inp["w2"]),
           "pipeline": jax.jit(run)(inp["params"], inp["mxs"])}
    np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
    m3 = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    idx = NamedSharding(m3, P(("pod", "data"), "model")).devices_indices_map((8, 6))
    blocks = {int(d.id): [[s.start or 0, s.stop if s.stop is not None else n]
                          for s, n in zip(sl, (8, 6))] for d, sl in idx.items()}
    coords = {int(d.id): [int(c) for c in np.argwhere(m3.devices == d)[0]]
              for d in m3.devices.flat}
    print(json.dumps({"blocks": blocks, "coords": coords}))
""")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Each of the 8 ranks' outputs."""
    return run_world(collectives_rank, 8,
                     str(tmp_path_factory.mktemp("world")))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's 8-device shard_map outputs and its devices'
    blocks of ``P(("pod", "data"), "model")`` on (2, 2, 2)."""
    path = str(tmp_path_factory.mktemp("ref") / "out.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE, path,
                          os.path.join(REPO, "tests")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = dict(np.load(path))
    got.update(json.loads(out.stdout.strip().splitlines()[-1]))
    return got


@pytest.mark.parametrize("shape,scale", [((1000,), 1.0), ((8, 125), 1e-3),
                                         ((7, 3, 5), 300.0), ((64,), 0.0)])
def test_quantize_dequantize_bit_equal(shape, scale):
    x = (np.random.default_rng(0).standard_normal(shape) * scale).astype(
        np.float32)
    q, s = collectives.quantize_int8(torch.from_numpy(x))
    rq, rs = ref_coll.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    back = collectives.dequantize_int8(q, s).numpy()
    want = np.asarray(ref_coll.dequantize_int8(rq, rs))
    assert back.tobytes() == want.tobytes()
    assert np.abs(back - x).max() <= float(s) * 0.51 + 1e-6


def test_error_feedback_bit_equal():
    rng = np.random.default_rng(1)
    g, res = (rng.standard_normal((16, 40)).astype(np.float32)
              for _ in range(2))
    res *= 0.01
    out, new = collectives.error_feedback(
        torch.from_numpy(g), torch.from_numpy(res), lambda t: t * 2.0)
    rout, rnew = ref_coll.error_feedback(jnp.asarray(g), jnp.asarray(res),
                                         lambda t: t * 2.0)
    assert out.numpy().tobytes() == np.asarray(rout).tobytes()
    assert new.numpy().tobytes() == np.asarray(rnew).tobytes()


def _stack(port, key):
    return np.stack([r[key] for r in port])


def test_compressed_psum_mean(port, ref):
    """Every rank's int8 mean within relative 0.02 of the exact mean and
    of the reference's, and the ranks agree bit for bit."""
    got = _stack(port, "compressed")
    exact = INPUTS["x"].mean(0)
    scale = np.abs(exact).max()
    assert np.abs(got - exact).max() / scale < 0.02
    assert np.abs(got - ref["compressed"]).max() / scale < 0.02
    assert all((g == got[0]).all() for g in got)


def test_psum_mean(port, ref):
    got = _stack(port, "pmean")
    np.testing.assert_allclose(got, ref["pmean"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[0], INPUTS["x"].mean(0), rtol=1e-5,
                               atol=1e-6)


def test_ring_allgather_matmul(port, ref):
    """Each rank's (64, 6) column block of xs @ w: the reference's
    out_specs P(None, "data") assembles them along the columns."""
    got = np.concatenate([r["ag"] for r in port], axis=1)
    want = INPUTS["xs"] @ INPUTS["w"]
    assert np.allclose(got, want, atol=1e-4)
    assert np.allclose(got, ref["ag"], atol=1e-4)


def test_ring_matmul_reducescatter(port, ref):
    """Each rank's (8, 16) row block of xs @ w2, summed over the ranks'
    slices of the inner dimension."""
    got = np.concatenate([r["rs"] for r in port], axis=0)
    want = INPUTS["xs"] @ INPUTS["w2"]
    assert np.allclose(got, want, atol=1e-3)
    assert np.allclose(got, ref["rs"], atol=1e-3)


def test_pipelined_apply(port, ref):
    """8 stages of relu(x + p_s) over 12 microbatches: the last stage's
    result on every stage."""
    want = INPUTS["mxs"]
    for s in range(8):
        want = np.maximum(want + INPUTS["params"][s], 0.0)
    for r in port:
        assert np.allclose(r["pipeline"], want, atol=1e-5)
        assert np.allclose(r["pipeline"], ref["pipeline"], atol=1e-5)


def test_multi_axis_blocks_match_jax(port, ref):
    """``P(("pod", "data"), "model")`` on a (2, 2, 2) mesh: each rank's
    block (and its DTensor's local part) is the block JAX's
    ``NamedSharding`` gives the device at the same coordinate, and the
    DTensor gathers back whole."""
    t = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    by_coord = {tuple(ref["coords"][d]): b for d, b in ref["blocks"].items()}
    for rank, r in enumerate(port):
        coord = tuple(int(c) for c in np.unravel_index(rank, (2, 2, 2)))
        (a, b), (c, d) = by_coord[coord]
        np.testing.assert_array_equal(r["block"], t[a:b, c:d])
        np.testing.assert_array_equal(r["dtensor_local"], t[a:b, c:d])
        np.testing.assert_array_equal(r["dtensor_full"], t)
