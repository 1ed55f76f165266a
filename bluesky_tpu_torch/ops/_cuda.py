"""Build and load the hand-written CUDA kernels of ``bluesky_tpu_torch/csrc``.

Each ``.cu`` source has a plain C interface and is compiled by ``nvcc``
into a shared library under ``bluesky_tpu_torch/_build/`` on first use,
then loaded with ``ctypes``.  No PyTorch header is included, so a build
takes seconds.  The library name carries a hash of the source and the
flags, so an edited source is rebuilt.  A failed build raises; nothing
falls back to the plain PyTorch versions.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# --fmad=false: no multiply-add contraction, so the kernels round like
# the plain PyTorch versions, which run one operation per launch.
FLAGS = ["-std=c++17", "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_libs = {}
_lock = threading.Lock()

_f = ctypes.c_float
_d = ctypes.c_double
_i = ctypes.c_int
_p = ctypes.c_void_p
#: ctypes signatures of the C entry points, by source file
SIGNATURES = {
    "cd_tiles.cu": {
        "cd_sched_tiles": [_p, _i, _i, _p, _i, _p, _p, _p, _i, _p]
        + [_f] * 8 + [_d] * 2 + [_i, _i] + [_p] * 5 + [_i] * 3 + [_p] * 2,
        "cd_full_grid": [_p, _i, _i, _p, _i, _p, _p, _p, _i] + [_f] * 8
        + [_d] * 2 + [_i, _i] + [_p] * 4 + [_i] * 3 + [_p] * 2,
        "cd_cand_items": [_p, _i, _i, _p, _i, _p, _p, _p, _i, _p, _i]
        + [_f] * 8 + [_d] * 2 + [_i, _i] + [_p] * 4,
        "cd_merge_items": [_i, _i, _i, _i] + [_p] * 12 + [_i, _p],
        "cd_mask_items": [_p, _i, _i, _i] + [_p] * 5,
    },
}


def nvcc_path() -> str:
    cand = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source on first use and need the CUDA toolkit")
    return cand


def lib_path(source: str) -> str:
    with open(os.path.join(CSRC, source), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(ARCH + FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD, f"lib{stem}_{digest.hexdigest()[:12]}.so")


def _start_build(source: str, verbose: bool = False):
    """Start ``nvcc`` on one source whose library is missing.  Returns
    ``(process, tmp, out)``, or None when the library is already built.
    The library is written under a temporary name and renamed into
    place, so several processes may build at once."""
    out = lib_path(source)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *ARCH, *FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, os.path.join(CSRC, source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish_build(source: str, job) -> str:
    """Wait for one ``nvcc`` (the ``cuda.build`` span) and move its
    library into place."""
    from ..obs import devprof
    from ..obs.trace import get_recorder
    proc, tmp, out, t0 = job
    with get_recorder().span("cuda.build", cat="build", source=source):
        _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{err}")
    os.replace(tmp, out)
    devprof.compile_event("build", (time.perf_counter() - t0) * 1e3)
    return err


def build(source: str) -> str:
    """Compile one source (if its library is missing) and return the
    library path."""
    job = _start_build(source)
    if job is not None:
        _finish_build(source, job)
    return lib_path(source)


def build_all(verbose: bool = False) -> dict:
    """Compile every source of ``SIGNATURES`` at once, one ``nvcc`` per
    source started together.  Returns ``{source: compiler messages}``
    (the register and shared-memory report of ``-Xptxas -v`` when
    ``verbose``; empty for a library that was already built)."""
    jobs = {src: _start_build(src, verbose) for src in SIGNATURES}
    return {src: "" if job is None else _finish_build(src, job)
            for src, job in jobs.items()}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(build(source))
            for name, argtypes in SIGNATURES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[source] = lib
        return lib


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {rc})")


def require(t: torch.Tensor, dtype, shape, name: str):
    """Validate one kernel argument: CUDA, dtype, shape, contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
