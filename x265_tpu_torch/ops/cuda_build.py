"""Builds the CUDA kernels of csrc/ with nvcc and loads them via ctypes.

One shared library with a plain C interface: every source is compiled
to an object by its own nvcc process (all started together), then the
objects are linked. Nothing here includes PyTorch's headers, so the
whole build takes seconds. It happens at first use, into the package's
build/ directory, and raises when it fails: there is no other way to
run a kernel.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.normpath(os.path.join(_DIR, "..", "csrc"))
_BUILD = os.path.normpath(os.path.join(_DIR, "..", "build"))
LIBRARY = os.path.join(_BUILD, "libx265torch_kernels.so")
SOURCES = ("mc_gather.cu", "tile_gather.cu", "satd.cu", "sad_sweep.cu",
           "deblock_bs.cu", "rd_cost.cu", "calib.cu")
HEADERS = ("had8.cuh", "aligned_i16.cuh")   # a change rebuilds the sources
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_lib = None
build_seconds = None       # wall time of the last build in this process
build_log = ""             # ptxas -v output of the last build

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "x265_tile_gather": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "x265_tile_gather_planes": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "x265_tile_gather_planes_satd": [_P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _I, _P],
    "x265_mc_gather_interp": [_P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "x265_satd8": [_P, _P, _P, _I, _I, _P],
    "x265_satd8_intra": [_P, _P, _I, _P],
    "x265_sad_sweep": [_P, _P, _P, _I, _I, _I, _I, _P],
    "x265_sad_sweep_argmin": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "x265_sad_local_argmin": [_P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _L, _P],
    "x265_deblock_bs": [_P, _P, _P, _P, _P, _I, _I, _P],
    "x265_rd_tb_cost": [_P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # yardsticks (csrc/calib.cu): no wrapper, nothing on the encoder's path
    "x265_calib_empty_grid": [_I, _I, _I, _P],
    "x265_calib_sad_rate": [_P, _I, _I, _I, _I, ctypes.POINTER(_I), _P],
}


def nvcc() -> str:
    """The path of nvcc (cuobjdump and the other tools sit beside it)."""
    exe = shutil.which("nvcc")
    if exe is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            exe = cand
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "x265_tpu_torch cannot be built on this machine")
    return exe


def _needs_build() -> bool:
    if not os.path.exists(LIBRARY):
        return True
    mt = os.path.getmtime
    return mt(LIBRARY) < max(mt(os.path.join(_CSRC, s))
                         for s in SOURCES + HEADERS)


def _build() -> None:
    global build_seconds, build_log
    t0 = time.perf_counter()
    cc = nvcc()
    os.makedirs(_BUILD, exist_ok=True)
    tag = str(os.getpid())
    procs = []
    for s in SOURCES:
        obj = os.path.join(_BUILD, f"{s}.{tag}.o")
        cmd = [cc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
               "-Xcompiler", "-fPIC", "-c", os.path.join(_CSRC, s),
               "-o", obj]
        procs.append((s, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for s, obj, pr in procs:
        out, _ = pr.communicate()
        logs.append(f"== {s}\n{out}")
        if pr.returncode != 0:
            failed.append(s)
    build_log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{build_log}")
    tmp = f"{LIBRARY}.{tag}.tmp"
    r = subprocess.run([cc, *ARCH_FLAGS, "-shared", "-o", tmp]
                       + [obj for _, obj, _ in procs],
                       capture_output=True, text=True)
    for _, obj, _ in procs:
        os.remove(obj)
    if r.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + r.stdout + r.stderr)
    os.replace(tmp, LIBRARY)
    build_seconds = time.perf_counter() - t0


def get_lib():
    """The loaded kernel library, built first when missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _needs_build():
            _build()
        lib = ctypes.CDLL(LIBRARY)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        _lib = lib
        return _lib


def check_launch(err: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {err})")
