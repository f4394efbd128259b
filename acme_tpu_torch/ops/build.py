"""Build the port's kernels and bind them with ctypes.

The fused kernel is the hand-written ``csrc/fused.cu`` (with ``df.cuh``,
``linsolve.cuh``, ``step.cuh``) plus the model header that ``emit.py``
writes; the float64 scan engine is ``csrc/scan.cu`` (with ``dense.cuh``,
``newton.cuh``) plus its engine header (``emit.engine_header``).  ``nvcc`` compiles them for ``sm_90a`` into a shared library with a
plain C interface; ``g++`` compiles the same sources as C++ for the host
tests (the step is ``__host__ __device__``; a build that couples lane
groups runs each lane of a group on a thread of its own there, hence
``-pthread``).  Builds go into
``acme_tpu_torch/_build/`` (or ``ACME_TPU_TORCH_BUILD``), keyed by a hash of
the sources, the header and the flags, and happen at first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

from .emit import write_engine_header, write_header

__all__ = ["load_kernel", "load_host", "build_dir", "compile_library",
           "compile_engine", "load_engine", "load_engine_host", "build_log",
           "NVCC_FLAGS", "HOST_FLAGS", "LAST_BUILD", "STACK_BYTES"]

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("df.cuh", "linsolve.cuh", "step.cuh", "fused.cu")
ENGINE_SOURCES = ("dense.cuh", "newton.cuh", "scan.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
HOST_FLAGS = ["-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
              "-pthread", "-x", "c++"]

# the per-thread stack ``csrc/fused.cu`` sets before its first launch: the
# frames that ptxas reports for a build must fit
STACK_BYTES = 16384

# (seconds, compiler log) of the last compile this process ran, by library
LAST_BUILD = {}
_LOADED = {}


def build_dir():
    d = os.environ.get("ACME_TPU_TORCH_BUILD")
    if d is None:
        d = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "_build")
    os.makedirs(d, exist_ok=True)
    return d


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return path


def compile_library(plan, host=False, out_dir=None):
    """Compile the kernel for ``plan`` (a prepared ``fused._Plan``); returns
    the path of the shared library, building it only if it is missing."""
    out_dir = out_dir or build_dir()
    return _compile(write_header(plan, out_dir), SOURCES, "acme_fused",
                    host, out_dir)


def compile_engine(header_text, host=False, out_dir=None):
    """Compile the scan engine for an engine header's text
    (``emit.engine_header``); returns the path of the shared library,
    building it only if it is missing."""
    out_dir = out_dir or build_dir()
    return _compile(write_engine_header(header_text, out_dir),
                    ENGINE_SOURCES, "acme_scan", host, out_dir)


def _compile(header, sources, prefix, host, out_dir):
    """nvcc (or g++ for ``host``) of ``sources``' last file with
    ``header`` included first, into ``out_dir``, keyed by a hash of the
    sources, the header and the flags."""
    compiler = shutil.which("g++") if host else _nvcc()
    if compiler is None:
        raise RuntimeError("g++ not found")
    flags = HOST_FLAGS if host else NVCC_FLAGS
    h = hashlib.sha256()
    for name in sources:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    with open(header, "rb") as f:
        h.update(f.read())
    h.update(" ".join([compiler] + flags).encode())
    tag = "host" if host else "sm90a"
    lib = os.path.join(out_dir, f"{prefix}_{tag}_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [compiler] + flags + ["-I", CSRC, "-include", header, "-o", tmp,
                                os.path.join(CSRC, sources[-1])]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    log = proc.stdout + proc.stderr
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", lib + ".log")
    os.replace(tmp, lib)
    LAST_BUILD[lib] = (time.time() - t0, log)
    return lib


def build_log(lib):
    """(seconds, compiler log) of library ``lib``'s build: this process's,
    else the log its build left beside it (``<lib>.log``, seconds 0.0);
    ptxas's registers, frames and spills are in it for a CUDA build."""
    if lib in LAST_BUILD:
        return LAST_BUILD[lib]
    try:
        with open(lib + ".log") as f:
            return 0.0, f.read()
    except OSError:
        return 0.0, ""


_PTR = ctypes.c_void_p


def _bind(path, cuda):
    lib = ctypes.CDLL(path)
    # the 26 tensors, T, L, the lane groups' barrier words and size, the
    # tier counters (or null)
    common = [_PTR] * 26 + [ctypes.c_int, ctypes.c_int, _PTR, ctypes.c_int,
                            _PTR]
    if cuda:
        lib.acme_fused_launch.argtypes = common + [ctypes.c_int, _PTR]
        lib.acme_fused_launch.restype = ctypes.c_int
        lib.acme_cuda_error.argtypes = [ctypes.c_int]
        lib.acme_cuda_error.restype = ctypes.c_char_p
        lib.acme_resident_lanes.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_int)]
        lib.acme_resident_lanes.restype = ctypes.c_int
    else:
        # the host build's entries: the step, in batches of lanes (0: all)
        lib.acme_fused_host.argtypes = common + [ctypes.c_int]
        lib.acme_fused_host.restype = ctypes.c_int
        lib.acme_df_op_host.argtypes = [ctypes.c_int, ctypes.c_int] + \
            [_PTR] * 6
        lib.acme_df_op_host.restype = ctypes.c_int
        lib.acme_solve_host.argtypes = [ctypes.c_int] * 6 + [_PTR] * 6
        lib.acme_solve_host.restype = ctypes.c_int
    return lib


def load_kernel(plan):
    """The CUDA library for ``plan``: built with nvcc at first use and kept
    on the plan, so later launches skip the header, the hash and the
    lookup."""
    if plan.cuda_lib is None:
        path = compile_library(plan, host=False)
        if path not in _LOADED:
            _LOADED[path] = _bind(path, cuda=True)
        plan.cuda_lib = _LOADED[path]
        plan.cuda_name = os.path.basename(path)
    return plan.cuda_lib


def load_host(plan, out_dir):
    """The host (g++) build of the same sources, for tests on the CPU."""
    path = compile_library(plan, host=True, out_dir=out_dir)
    if path not in _LOADED:
        _LOADED[path] = _bind(path, cuda=False)
    return _LOADED[path]


_LL = ctypes.c_longlong
# the scan engine's arguments (csrc/scan.cu ACME_SCAN_ARGS)
_SCAN_ARGS = [_PTR, _LL, _PTR, _PTR, _PTR, _LL, _LL, _PTR, _LL, _LL, _LL,
              _PTR, _LL, _PTR, _PTR, _PTR, _PTR, ctypes.c_int, ctypes.c_int,
              ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int]


def _bind_engine(path, cuda):
    lib = ctypes.CDLL(path)
    for r in ("f64", "f32"):
        if cuda:
            fn = getattr(lib, f"acme_scan_launch_{r}")
            fn.argtypes = _SCAN_ARGS + [ctypes.c_int, _PTR]
            fn.restype = ctypes.c_int
        fn = getattr(lib, f"acme_scan_host_{r}")
        fn.argtypes = _SCAN_ARGS
        fn.restype = ctypes.c_int
    if cuda:
        lib.acme_scan_cuda_error.argtypes = [ctypes.c_int]
        lib.acme_scan_cuda_error.restype = ctypes.c_char_p
    lib.acme_scan_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.acme_scan_smem_bytes.restype = ctypes.c_longlong
    lib.acme_dense_host.argtypes = [ctypes.c_int] * 4 + [_PTR] * 4
    lib.acme_dense_host.restype = ctypes.c_int
    return lib


def load_engine(header_text):
    """The scan engine's CUDA library for an engine header, built with nvcc
    at first use: (library, its file name)."""
    path = compile_engine(header_text, host=False)
    if path not in _LOADED:
        _LOADED[path] = _bind_engine(path, cuda=True)
    return _LOADED[path], os.path.basename(path)


def load_engine_host(header_text, out_dir):
    """The host (g++) build of the scan engine, for tests on the CPU."""
    path = compile_engine(header_text, host=True, out_dir=out_dir)
    if path not in _LOADED:
        _LOADED[path] = _bind_engine(path, cuda=False)
    return _LOADED[path]
