"""Time kernel K1 against another build of the walk, in turns, on one card.

    python3 -m fqsqueezer_tpu_torch.tools.k1_compare --other old.cu

`--other` is a CUDA source with the one-grid C entry point K1 had before its
redesign (`fqtz_rans_encode_walk(f, c, init, w, e, fin, T, N, sb, stream)`,
int32 words), for example
`git show 0378581:fqsqueezer_tpu_torch/csrc/rans_encode.cu > old.cu`. Both
walks are checked equal and then timed other, K1, K1, other with CUDA
events, each call allocating its outputs as the wrappers do: one grid at
the bench group's shape and at a full group's, and the bench flush's three
streams as one K1 launch, three K1 launches and three launches of the
other. Without `--other` only K1 is timed. Last, K1's source is built once
more with -DK1_CHAIN_ONLY (no divide, no prepared-row reads, no stores;
wrong values) and timed at the bench shape: that is the chain floor, the
time of the T dependent steps alone. Prints the card's name and power limit
first. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import torch

from ..ops import _build, rans
from ..utils.rans_grids import random_grid

SB = 14
SHAPES = ((5120, 2048), (13312, 2048))
FLUSH = ((512, 2048), (5120, 2048), (5120, 2048))


def _ms(fn, reps=20):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _load_other(src):
    out = os.path.join(os.path.dirname(_build._BUILD_ROOT), "k1_compare")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libother.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                   check=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fqtz_rans_encode_walk.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.fqtz_rans_encode_walk.restype = i

    def walk(f, c, init32):
        T, N = f.shape
        w = torch.empty((T, N), dtype=torch.int32, device="cuda")
        e = torch.empty((T, N), dtype=torch.uint8, device="cuda")
        fin = torch.empty((N,), dtype=torch.int32, device="cuda")
        rc = lib.fqtz_rans_encode_walk(
            f.data_ptr(), c.data_ptr(), init32.data_ptr(), w.data_ptr(),
            e.data_ptr(), fin.data_ptr(), T, N, SB,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the other walk failed: cudaError {rc}")
        return w, e, fin
    return walk


def _chain_floor_ms(f, c, init):
    """The -DK1_CHAIN_ONLY build of K1's source, timed on one grid with
    outputs allocated beforehand."""
    out = os.path.join(os.path.dirname(_build._BUILD_ROOT), "k1_compare")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libchain.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DK1_CHAIN_ONLY",
                    "-o", so, os.path.join(_build._CSRC, "rans_encode.cu")],
                   check=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fqtz_rans_encode_walk.argtypes = [i, p, p, p, p, p, p, p, p, i, p]
    lib.fqtz_rans_encode_walk.restype = i
    T, N = f.shape
    w = torch.empty((T, N), dtype=torch.int16, device="cuda")
    e = torch.empty((T, N), dtype=torch.uint8, device="cuda")
    fin = torch.empty((N,), dtype=torch.int64, device="cuda")
    one = lambda t: (p * 1)(t.data_ptr())

    def run():
        rc = lib.fqtz_rans_encode_walk(
            1, one(f), one(c), one(init), one(w), one(e), one(fin),
            (i * 1)(T), (i * 1)(N), SB,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the chain-only walk failed: cudaError {rc}")
    return _ms(run)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="CUDA source of the walk to compare with")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_compare: no CUDA device is visible")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    other = _load_other(args.other) if args.other else None
    grids = {s: tuple(torch.from_numpy(a).cuda()
                      for a in random_grid(i + 1, *s, SB))
             for i, s in enumerate(dict.fromkeys(SHAPES + FLUSH))}
    for T, N in SHAPES:
        f, c = grids[(T, N)]
        init = rans.rans_initial_states(N, "cuda")
        init32 = init.to(torch.int32)
        k1 = lambda: rans.rans_encode_walk(f, c, SB, init)
        line = f"walk ({T}, {N}):"
        if other is not None:
            w, e, fin = k1()
            ow, oe, ofin = other(f, c, init32)
            torch.cuda.synchronize()
            if not (torch.equal(rans.words_to_i32(w), ow)
                    and torch.equal(e, oe)
                    and torch.equal(fin, ofin.to(torch.int64) & 0xFFFFFFFF)):
                raise RuntimeError(f"the two walks differ at ({T}, {N})")
            oth = lambda: other(f, c, init32)
            t = [_ms(oth), _ms(k1), _ms(k1), _ms(oth)]
            line += (f" other {t[0]:.4f} ms, K1 {t[1]:.4f} ms, K1 "
                     f"{t[2]:.4f} ms, other {t[3]:.4f} ms (equal results);")
        else:
            line += f" K1 {_ms(k1):.4f} ms;"
        print(f"{line} K1 {_ms(k1) / T * 1e6:.2f} ns a row")
    flush = [grids[s] for s in FLUSH]
    line = (f"flush {FLUSH}: K1 one launch "
            f"{_ms(lambda: rans.rans_encode_walks(flush, SB)):.4f} ms, K1 "
            f"three launches "
            f"{_ms(lambda: [rans.rans_encode_walks([g], SB) for g in flush]):.4f}"
            f" ms")
    if other is not None:
        init32 = rans.rans_initial_states(2048, "cuda").to(torch.int32)
        line += (f", other three launches "
                 f"{_ms(lambda: [other(f, c, init32) for f, c in flush]):.4f}"
                 f" ms")
    print(line)
    T, N = SHAPES[0]
    floor = _chain_floor_ms(*grids[SHAPES[0]],
                            rans.rans_initial_states(N, "cuda"))
    print(f"chain floor ({T}, {N}): {floor:.4f} ms, {floor / T * 1e6:.2f} ns "
          f"a row (the chain-only build)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
