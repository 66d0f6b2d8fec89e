"""Build and load the port's CUDA kernels (csrc/*.cu).

nvcc compiles every source into one shared library with a plain C interface
under panmap_tpu_torch/_build/, named by the hash of the sources, at first
use (one nvcc per source, all started together, then one link); later uses
in the same tree load the built library.  The library is
bound with ctypes: every pointer and the stream pass as c_void_p, so
nothing is cut to 32 bits.  A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lib = None
_lock = threading.Lock()
# (seconds, nvcc output) of the build this process ran; None when it loaded
# a library that was already built
build_info = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = "/usr/local/cuda/bin/nvcc"
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build panmap_tpu_torch's kernels")
    return path


def sources() -> list:
    return sorted(glob.glob(os.path.join(_DIR, "csrc", "*.cu")))


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the sources (unless this exact build exists) and return the
    library path."""
    global build_info
    srcs = sources()
    so = os.path.join(BUILD_DIR, f"libpanmap_kernels_{_digest(srcs)}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj, src]
            for src, obj in zip(srcs, objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, so)  # atomic publish: a concurrent loader sees all or none
    build_info = (time.perf_counter() - t0, "".join(logs))
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            fn = handle.panmap_banded_sw
            # (q, r, qlens, out, B, LQ, LW, stream)
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fn = handle.panmap_banded_long
            # (q, ref, meta, dirs, stats, B, LQ, W, lr, match, mismatch,
            #  gap_open, gap_ext, gap_open2, gap_ext2, stream)
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = handle
        return _lib
