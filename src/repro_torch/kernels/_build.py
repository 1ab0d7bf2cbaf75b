"""Build and load the hand-written Hopper kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, loaded with ``ctypes``
(route (b): no PyTorch headers, so a build takes seconds). The sources
are compiled in parallel, one ``nvcc`` each, then linked. The library is
built at first use into ``build/kernels/<hash>/`` under the checkout,
keyed on a hash of the sources and flags, so an edited kernel is never
served from a stale build. A failed build raises with nvcc's stderr.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises if it is not 0.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libntx_kernels.so"

_lock = threading.Lock()
_SAME_DEVICE = contextlib.nullcontext()
_lib: ctypes.CDLL | None = None
#: nvcc's output of the build (``-Xptxas -v``: registers, shared memory,
#: spills), kept as ``nvcc.log`` beside the library
build_log: str = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # (a, b, c, m, n, k, lanes, lda, ldb, in_bf16, out_bf16, compensated,
    #  n_stages, kinds, imms, operands, op_bf16, op_lane, tile, splits,
    #  ws, stream)
    "ntx_gemm": [_P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _I, _I, _I, _P, _P,
                 _P, _P, _P, _I, _I, _P, _P],
    # (q, k, v, o, ws, lse, params (strides, shapes, plan), scale, stream)
    "ntx_flash_attention": [_P, _P, _P, _P, _P, _P, _P, _F, _P],
    # (q, k, v, o, dout, lse, rows, ws, dq, dk, dv, params (strides,
    #  shapes, plan), scale, stream)
    "ntx_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _P, _F, _P],
    # (dh, a1, gate, da1, dgate, h, n, act, out_bf16, stream)
    "ntx_act_bwd": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _P],
    # (ws, o, o_strides, b, hq, sq, d, splits, bf16, stream)
    "ntx_flash_merge": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # (x, ldx, out, ldo, rows, n, n_valid, n_stages, ops, imms, ys, ldys,
    #  tail, red, red_int, chunk, counters, part, stream)
    "ntx_stream": [_P, _L, _P, _L, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P,
                   _I, _I, _P, _P, _P],
    # (x, dt, A, B, C, y, S, dec, S_final, b, l, h, dh, n, chunk, bf16,
    #  lp, np, dtile, heads, stream)
    "ntx_ssd_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _I, _I, _I, _I, _I, _I, _P],
    # (img, ker, out, h, w, kh, kw, in_bf16, tx, ty, rpt, ci, cj, blocks,
    #  stream)
    "ntx_conv2d": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   _P],
    # (x, coef, out, outer, n, inner, k, in_bf16, stream)
    "ntx_stencil": [_P, _P, _P, _L, _I, _L, _I, _I, _P],
    # (x, out, nd, n0, n1, n2, in_bf16, stream)
    "ntx_laplace": [_P, _P, _I, _L, _L, _L, _I, _P],
    # (p, g, m, v, p_out, m_out, v_out, n, hyper (lr, b1, 1 - b1, b2,
    #  1 - b2, eps, wd, bc1, bc2), p_bf16, head, vecs, blocks, stream)
    "ntx_adamw": [_P, _P, _P, _P, _P, _P, _P, _L, _P, _I, _L, _L, _I, _P],
    # (q, k, out, params (strides, shapes, n), stream)
    "ntx_attn_split_logits": [_P, _P, _P, _P, _P],
    # (logits, v, o, ws, params (strides, shapes, plan), scale log2 e,
    #  stream)
    "ntx_attn_split_pv": [_P, _P, _P, _P, _P, _F, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit on the machine with the card")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source in parallel and link the library; returns its
    path. A no-op when the library for these sources already exists.
    Objects go to a directory of this process's own, and the library is
    moved into place in one step, so processes that build at the same
    time do not see each other's partial files."""
    global build_log
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    log = out_dir / "nvcc.log"
    if lib.exists():
        build_log = log.read_text() if log.exists() else ""
        return lib
    work = out_dir / f"work.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        # each compiler writes to a file of its own: ptxas -v fills a pipe
        # (64 KiB) for a source with many kernels, and one left unread
        # while another is waited on would stop that compiler
        out = open(work / (src.stem + ".log"), "w+")
        procs.append((src, obj, out, subprocess.Popen(
            cmd, stdout=out, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, _, out, proc in procs:
        proc.wait()
        out.seek(0)
        text = out.read()
        out.close()
        logs.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} "
                          f"(exit {proc.returncode}):\n{text}")
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = work / LIB_NAME
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *[str(obj) for _, obj, _, _ in procs]],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
    (work / "nvcc.log").write_text(build_log)
    os.replace(work / "nvcc.log", log)
    os.replace(tmp, lib)
    shutil.rmtree(work, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ntx_error_string.argtypes = [ctypes.c_int]
            lib.ntx_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().ntx_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The SM count of a card, queried once per device."""
    import torch
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer (through
    the raw-stream query where this PyTorch has it: no Stream object is
    made on the launch path)."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream


def on_device(t):
    """A context that makes ``t``'s card current for a launch: a no-op
    when it already is (the common case, and the cheap one)."""
    import torch
    if t.get_device() == torch.cuda.current_device():
        return _SAME_DEVICE
    return torch.cuda.device(t.device)


def ptr_array(ctype, values):
    """A ctypes array (kept alive by the caller for the call)."""
    return (ctype * max(1, len(values)))(*values)
