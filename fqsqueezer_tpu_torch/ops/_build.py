"""Build the package's CUDA kernels at first use and load them with ctypes.

Every `csrc/*.cu` file is compiled by nvcc for sm_90a into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds). The
library lands in `build/kernels/<source hash>/` at the repository root, a
git-ignored directory, so a fresh checkout builds it on its first CUDA call
and a changed source gets a new directory instead of a stale library.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "fqsqueezer_tpu_torch need the CUDA toolkit")
    return path


def build(verbose: bool = False) -> str:
    """Compile the kernels unless a library for the current sources exists;
    returns its path."""
    sources = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        with open(s, "rb") as fh:
            h.update(fh.read())
    out_dir = os.path.join(_BUILD_ROOT, h.hexdigest()[:16])
    so = os.path.join(out_dir, "libfqtz_kernels.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose and res.stderr:
        print(res.stderr.strip())
    os.replace(tmp, so)
    return so


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            # (n_streams, f[], c[], init[], w[], e[], fin[], T[], N[], sb,
            # stream): the arrays are host arrays, one entry a stream
            lib.fqtz_rans_encode_walk.argtypes = [i, p, p, p, p, p, p, p, p,
                                                  i, p]
            lib.fqtz_rans_encode_walk.restype = i
            _lib = lib
        return _lib
