"""ctypes bridge to the native C++ FASTQ scanner (csrc/fqtz_io.cpp).

The port's own copy of fqsqueezer_tpu/io/native.py. Builds the shared
library on first use with g++ (-O3 -march=native -fopenmp) into
`build/native/<source hash>/` at the repository root, a git-ignored
directory. Without a g++ toolchain get_lib() returns None and io.fastq uses
its pure-numpy path, which gives the same arrays.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "fqtz_io.cpp")
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "native")
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")


def _build() -> str:
    """Compile the scanner unless a library for the current source exists;
    returns its path. Several processes may build at once: each writes its
    own temporary file and renames it into place."""
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + fh.read())
    out_dir = os.path.join(_BUILD_ROOT, digest.hexdigest()[:16])
    so = os.path.join(out_dir, "libfqtz_io.so")
    if not os.path.exists(so):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True)
        os.replace(tmp, so)
    return so


def get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, subprocess.CalledProcessError):
            return None    # no toolchain: the numpy path does the same work

        i64 = ctypes.c_int64
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

        lib.fqtz_count_lines.restype = i64
        lib.fqtz_count_lines.argtypes = [u8p, i64]
        lib.fqtz_scan_lines.restype = i64
        lib.fqtz_scan_lines.argtypes = [u8p, i64, i64p, i64p]
        lib.fqtz_fill_records.restype = None
        lib.fqtz_fill_records.argtypes = [u8p, i64p, i64p, i64p, i64p,
                                          i64, i64, u8p, u8p, i32p]
        lib.fqtz_write_records.restype = i64
        lib.fqtz_write_records.argtypes = [u8p, u8p, i32p, u8p, i64p,
                                           i64, i64, u8p]
        _lib = lib
        return _lib


def parse_fastq_bytes_native(data: np.ndarray):
    """Native-path FASTQ parse. Returns a FastqData or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from .fastq import FastqData

    data = np.ascontiguousarray(data)
    if data.size and data[-1] != 10:  # tolerate missing trailing newline
        data = np.concatenate([data, np.array([10], np.uint8)])
    n = np.int64(data.size)
    n_lines = lib.fqtz_count_lines(data, n)
    n_lines -= n_lines % 4
    if n_lines == 0:
        # possibly missing trailing newline; let numpy path handle edge cases
        return None
    starts = np.empty(n_lines + 4, np.int64)
    ends = np.empty(n_lines + 4, np.int64)
    got = lib.fqtz_scan_lines(data, n, starts, ends)
    got -= got % 4
    R = got // 4
    lengths_all = ends[1:got:4] - starts[1:got:4]
    L = int(lengths_all.max()) if R else 0

    codes = np.empty((R, L), np.uint8)
    quals = np.empty((R, L), np.uint8)
    lengths = np.empty((R,), np.int32)
    lib.fqtz_fill_records(
        data, np.ascontiguousarray(starts[1:got:4]),
        np.ascontiguousarray(ends[1:got:4]),
        np.ascontiguousarray(starts[3:got:4]),
        np.ascontiguousarray(ends[3:got:4]),
        np.int64(R), np.int64(L), codes, quals, lengths)

    dview = data.tobytes()
    hdr_s, hdr_e = starts[0:got:4], ends[0:got:4]
    ids = [dview[int(s) + 1:int(e)] if e > s else b""
           for s, e in zip(hdr_s, hdr_e)]
    return FastqData(codes=codes, quals=quals, lengths=lengths, ids=ids)


def write_fastq_native(path: str, codes, quals, lengths, ids) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    R, L = codes.shape
    if ids is None:
        id_arrs = [b""] * R
    else:
        id_arrs = ids
    id_buf = np.frombuffer(b"".join(id_arrs), np.uint8).copy() \
        if id_arrs else np.zeros(0, np.uint8)
    id_off = np.zeros(R + 1, np.int64)
    np.cumsum([len(s) for s in id_arrs], out=id_off[1:])
    lens64 = lengths.astype(np.int64)
    total = int(np.sum(1 + (id_off[1:] - id_off[:-1]) + 1 + lens64 + 3
                       + lens64 + 1))
    out = np.empty(total, np.uint8)
    wrote = lib.fqtz_write_records(
        np.ascontiguousarray(codes, np.uint8),
        np.ascontiguousarray(quals, np.uint8),
        np.ascontiguousarray(lengths, np.int32),
        id_buf, id_off, np.int64(R), np.int64(L), out)
    out[:wrote].tofile(path)
    return True
