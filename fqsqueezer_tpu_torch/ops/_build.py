"""Build the package's CUDA kernels at first use and load them with ctypes.

Every `csrc/*.cu` file (with the `csrc/*.cuh` headers it includes) is
compiled for sm_90a into a shared library of its own with a plain C
interface (no PyTorch headers, so a build takes seconds), one nvcc process
a source, all started together. The libraries land in
`build/kernels/<source hash>/` at the repository root, a git-ignored
directory, so a fresh checkout builds them on its first CUDA call and a
changed source gets a new directory instead of a stale library.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import types

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
    """Compile the kernels unless libraries for the current sources exist;
    returns their directory."""
    sources = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(s, "rb") as fh:
            h.update(fh.read())
    out_dir = os.path.join(_BUILD_ROOT, h.hexdigest()[:16])
    libs = [os.path.join(out_dir, f"lib{os.path.basename(s)[:-3]}.so")
            for s in sources]
    if all(os.path.exists(so) for so in libs):
        return out_dir
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    procs = [(so, subprocess.Popen(
        [nvcc, *ptxas, *NVCC_FLAGS, "-o", f"{so}.{os.getpid()}.tmp", src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for so, src in zip(libs, sources)]
    failed = []
    for so, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{err}")
            continue
        if verbose and err:
            print(err.strip())
        os.replace(f"{so}.{os.getpid()}.tmp", so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out_dir


_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # (n_streams, f[], c[], init[], w[], e[], fin[], T[], N[], sb, stream):
    # the arrays are host arrays, one entry a stream
    "fqtz_rans_encode_walk": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    # (model, A, hist_bits, n_hist, lengths, r_pl, L, words, n_words, init,
    # N, sb, syms, fin, ptr_out, lm, cap, inc, stream)
    "fqtz_qual_decode": [_P, _I, _I, _I, _P, _I, _I, _P, _I, _P, _I, _I, _P,
                         _P, _P, _P, _I, _I, _P],
    # (args, n_args, stream): args a host int64 array in the order of
    # streams/dna.py's K2_ARGS (struct Args in csrc/dna_decode.cu)
    "fqtz_dna_decode_row": [_P, _I, _P],
    # (table, slots, W, r_pl, words, n_words, init, N, sb, n_valid, M, out,
    # fin, ptr_out, stream)
    "fqtz_id_decode": [_P, _P, _I, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P,
                       _P, _P],
    # (table, W, r_pl, words, n_words, init, N, sb, out, fin, ptr_out,
    # stream)
    "fqtz_meta_decode": [_P, _I, _I, _P, _I, _P, _I, _I, _P, _P, _P, _P],
}


def load_other(src: str, tag: str) -> ctypes.CDLL:
    """Build one CUDA source from anywhere (the headers of `csrc/` on its
    include path) into `build/kernels/<tag>/` and load it with the argtypes
    of the entry points it has set: for the measuring scripts, which time a
    kernel against another source of it, e.g. an earlier revision. The
    package's own kernels never come from here."""
    out = os.path.join(_BUILD_ROOT, tag)
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "lib.so")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", _CSRC, "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(so)
    for name, argtypes in _ARGTYPES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, _I
    return lib


def kernels() -> types.SimpleNamespace:
    """Every kernel entry point, loaded from its library with its argtypes
    set, as attributes of one namespace."""
    global _lib
    with _lock:
        if _lib is None:
            out_dir = build()
            fns = {}
            for so in sorted(glob.glob(os.path.join(out_dir, "lib*.so"))):
                lib = ctypes.CDLL(so)
                for name, argtypes in _ARGTYPES.items():
                    if hasattr(lib, name):
                        fn = getattr(lib, name)
                        fn.argtypes, fn.restype = argtypes, _I
                        fns[name] = fn
            _lib = types.SimpleNamespace(**fns)
        return _lib
