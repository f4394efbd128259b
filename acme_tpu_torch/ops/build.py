"""Build the fused kernel and bind it with ctypes.

The kernel is the hand-written ``csrc/fused.cu`` (with ``df.cuh``,
``linsolve.cuh``, ``step.cuh``) plus the model header that ``emit.py``
writes.  ``nvcc`` compiles them for ``sm_90a`` into a shared library with a
plain C interface; ``g++`` compiles the same sources as C++ for the host
tests (the step is ``__host__ __device__``).  Builds go into
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

from .emit import write_header

__all__ = ["load_kernel", "load_host", "build_dir", "compile_library",
           "NVCC_FLAGS", "HOST_FLAGS", "LAST_BUILD"]

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("df.cuh", "linsolve.cuh", "step.cuh", "fused.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
HOST_FLAGS = ["-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
              "-x", "c++"]

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
    header = write_header(plan, out_dir)
    compiler = shutil.which("g++") if host else _nvcc()
    if compiler is None:
        raise RuntimeError("g++ not found")
    flags = HOST_FLAGS if host else NVCC_FLAGS
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    with open(header, "rb") as f:
        h.update(f.read())
    h.update(" ".join([compiler] + flags).encode())
    tag = "host" if host else "sm90a"
    lib = os.path.join(out_dir, f"acme_fused_{tag}_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [compiler] + flags + ["-I", CSRC, "-include", header, "-o", tmp,
                                os.path.join(CSRC, "fused.cu")]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib)
    LAST_BUILD[lib] = (time.time() - t0, proc.stdout + proc.stderr)
    return lib


_PTR = ctypes.c_void_p


def _bind(path, cuda):
    lib = ctypes.CDLL(path)
    common = [_PTR] * 24 + [ctypes.c_int, ctypes.c_int]
    if cuda:
        lib.acme_fused_launch.argtypes = common + [ctypes.c_int, _PTR]
        lib.acme_fused_launch.restype = ctypes.c_int
    lib.acme_fused_host.argtypes = common
    lib.acme_fused_host.restype = ctypes.c_int
    lib.acme_df_op_host.argtypes = [ctypes.c_int, ctypes.c_int] + [_PTR] * 6
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
