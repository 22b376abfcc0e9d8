"""Build, load and launch-check the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper (sm_90a)
into a shared library with a plain C interface, on first use, into
``build/`` at the root of the checkout, and loaded with ``ctypes``.  The
library's name carries a hash of its source, so an edited source builds
anew and a built one is reused.  Nothing is built when a module is
imported: the CPU lane never calls into here.  The checks every wrapper
makes before and after a launch live here too.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
#: the C signature of every entry point, by library
SIGNATURES = {
    "spmm_block": {
        # vals, vals_dtype, bs, src, order, wslot, B, out, CB, L, s, t, bt,
        # wide, stream
        "spmm_block_fused": [_P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _P],
        # vals, vals_dtype, bs, src, order, wslot, dvec, B, out, CB, L, s, t,
        # bt, mn, wide, stream
        "spmm_block_fused_decode": [_P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _I, _I, _P],
        # vals, vals_dtype, bs, idx, order, B, out, CB, L, s, t, wide, stream
        "spmm_block": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        # bs, int[7] out
        "spmm_block_geometry": [_I, _P],
    },
    "coded_accum": {
        # A, a_dtype, B, b_dtype, cols, weights, out, s, r, t, br, bt, n, L,
        # wide, stream
        "coded_accum": [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _I, _P],
    },
}

_LOADED: dict[str, ctypes.CDLL] = {}
#: ptxas's report (registers, shared memory, spills) of each library this
#: process built or found built, by library (kept beside the library)
BUILD_LOG: dict[str, str] = {}


def nvcc() -> str:
    """The CUDA toolkit's compiler, found as PyTorch finds the toolkit
    (``CUDA_HOME``, then ``nvcc`` on PATH, then the default install)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME")
    return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library is built; its path."""
    out = library_path(name)
    log = out.with_suffix(".log")
    if out.exists():
        if log.exists():
            BUILD_LOG.setdefault(name, log.read_text())
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    fd, tmp_log = tempfile.mkstemp(suffix=".log", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        BUILD_LOG[name] = proc.stdout + proc.stderr
        # both atomically, the log first: whoever finds the library built
        # finds its whole log, and a concurrent loader sees all or nothing
        pathlib.Path(tmp_log).write_text(BUILD_LOG[name])
        os.replace(tmp_log, log)
        os.replace(tmp, out)
    finally:
        for path in (tmp, tmp_log):
            if os.path.exists(path):
                os.unlink(path)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if need be, with every
    entry point's argument and result types declared."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def check_cuda_operands(named: dict, device_of: torch.Tensor) -> None:
    """Every operand a contiguous CUDA tensor on ``device_of``'s device."""
    for name, x in named.items():
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got "
                             f"{getattr(x, 'device', type(x))}")
        if x.device != device_of.device:
            raise ValueError(f"{name} lies on {x.device}, not {device_of.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def raise_on_error(err: int, name: str) -> None:
    """A launch's ``cudaError_t``: a refused launch never runs, and a later
    synchronise would not report it."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
