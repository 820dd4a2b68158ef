"""Time kernels K4 and K5 (the id and meta decode scans) against their
plain torch versions and against other sources of them, in turns, on one
card, with their bound and chain floor.

    python3 -m fqsqueezer_tpu_torch.tools.k4_compare [--qm o] [--im o]
        [--reads 20000] [--other other.cu ...]

The input is the main path's real batch: the bench corpus's first
`--reads` reads (chip_smoke.py's corpus) compressed on the card at the
bench primary row with the quality and id modes given, and the scans'
inputs of the archive's second batch (scan_batches: the id and meta
models and lane states the first batch left). Each `--other` is a CUDA
source with K4's and K5's C entry points (`fqtz_id_decode`,
`fqtz_meta_decode`, the signatures of csrc/slot_decode.cu), for example
an earlier revision of that file (`git show
<commit>:fqsqueezer_tpu_torch/csrc/slot_decode.cu`). Every scan is checked
equal to the plain scan, then timed in turns (every scan, then every
scan again in reverse order) by its kernel's device time under
torch.profiler, the mean of REPS calls, each call allocating its outputs
as the wrapper does. Then a call of the package's scan by CUDA events
(the median of REPS: the device waits for the host's work of a short
call), the plain scan's call, the chain floor (the kernel's device time
on the batch's first 32 lanes: one warp walking the same dependent
steps) and the bound. Prints the card's name and power limit first.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import tempfile

import numpy as np
import torch

from .. import cli, pipeline
from ..archive import ArchiveReader
from ..ops import _build
from ..params import Params
from ..streams import ids, meta
from ..utils.corpus import write_fastq_corpus

# the bench primary row, as chip_smoke.py gives it to the CLI, without its
# quality and id modes
BENCH_ROW = ("-s", "-om", "o", "-gs", "5", "-v", "0")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
INT_OPS_PER_S = 67e12      # published non-tensor 32-bit rate
# an active lane-slot besides its binary search (2 operations a probe, 9
# probes over 256 symbols): the two boundaries read, the state update and
# renormalisation, the word's share of the scan (K3's count,
# chip_smoke.K3_OPS_PER_POS)
OPS_PER_SLOT = 16
SEARCH_OPS = 2 * 9
CHAIN_LANES = 32
REPS = 21


def scan_batches(arc, device="cuda"):
    """Every batch's inputs of the two slot decode scans, in archive order:
    yields (meta args, id args or None) — (MetaConfig, cdfs [W, 257], R,
    words, init) and (IdConfig, cdfs [N_CTX, 257], R, words, init,
    n_valid), the arguments of meta_decode_scan and id_decode_scan — with
    the models and lane states the batches before left (each batch decoded
    through meta_decode_batch and id_decode_batch after it is yielded: the
    two streams decode apart from the others)."""
    rd = ArchiveReader(arc)
    try:
        p = Params.load_params(rd.header_blob)
        dcfg, qcfg, mcfg, icfg = pipeline.make_configs(p)
        state = pipeline.state_create(dcfg, qcfg, icfg, device=device)
        m_model, i_model = state.meta, state.id
        align = p.n_lanes * mcfg.lcp_stride
        first = pipeline._first_batch(p.n_lanes, p.max_batch_reads, 0, align)
        i_at = 2 + (qcfg is not None)
        while (g := rd.read_group(p.n_lanes)) is not None:
            gstates, batches, _ = g
            x = [torch.from_numpy(s.astype(np.int64)).to(device)
                 for s in gstates]
            m_x, i_x = x[0], (x[i_at] if icfg is not None else None)
            for take, L, streams in batches:
                padded = pipeline.canonical_padded(
                    take, first, p.max_batch_reads, align)
                caps = pipeline.stream_caps(dcfg, qcfg, mcfg, icfg, padded,
                                            L, p.n_lanes)
                m_w = pipeline.fit_words(streams[0][0], caps[0], device)
                m_args = (mcfg, meta.meta_cdfs(mcfg, m_model), padded, m_w,
                          m_x)
                i_args = None
                if icfg is not None:
                    i_w = pipeline.fit_words(streams[i_at][0], caps[i_at],
                                             device)
                    i_args = (icfg, ids._ctx_cdfs(icfg, i_model).to(
                        torch.int32).contiguous(), padded, i_w, i_x, take)
                yield m_args, i_args
                _, _, m_model, m_x, _ = meta.meta_decode_batch(
                    mcfg, m_model, padded, m_w, m_x)
                if icfg is not None:
                    *_, i_model, i_x, _ = ids.id_decode_batch(
                        icfg, i_model, padded, i_w, i_x, take)
    finally:
        rd.close()


def id_args_of(args):
    """The id scan's arguments as id_decode_scan takes them, the n_valid
    of a codec v1 batch (which codes its padding) dropped."""
    cfg, cdfs, R, words, init, n_valid = args
    return cfg, cdfs, R, words, init, (n_valid if cfg.codec_v >= 2
                                       else None)


def chain_args(args):
    """A scan's arguments cut to the batch's first CHAIN_LANES lanes (the
    chain floor: the same dependent steps for one warp)."""
    cfg, cdfs, R, words, init, *rest = args
    r_pl = R // cfg.n_lanes
    return (dataclasses.replace(cfg, n_lanes=CHAIN_LANES), cdfs,
            CHAIN_LANES * r_pl, words, init[:CHAIN_LANES].contiguous(),
            *rest)


def k4_bound_ms(args, out):
    """(ms, 'bytes' | 'operations'): the least time the card could take
    for one id scan of `args` whose result is `out`: bytes — each distinct
    cdf row its slots read once (257 int32), the slot words, the words it
    consumed (int32), the states in and out (int64), the R * w_all u8
    symbols out; operations — for each active lane-slot the binary search
    and OPS_PER_SLOT."""
    cfg, _, R, _, _, n_valid = id_args_of(args)
    grid, _, ptr = out
    flag, dsym, dmag, emat, elens = ids.planes_of_grid(cfg, grid)
    *_, active = ids.id_modeling(cfg, ids.id_state_create(grid.device),
                                 flag, dsym, dmag, emat, elens, n_valid)
    rows = len(set(ids._slot_ctx(cfg)))
    N = cfg.n_lanes
    nbytes = (rows * (ids.N_SYM + 1) * 4 + cfg.w_all * 4 + int(ptr) * 4
              + 2 * N * 8 + R * cfg.w_all)
    ops = int(active.sum()) * (SEARCH_OPS + OPS_PER_SLOT)
    return _bound(nbytes, ops)


def k5_bound_ms(args, out):
    """(ms, 'bytes' | 'operations') of one meta scan of `args` whose
    result is `out`: its W cdf rows, the words it consumed, the states in
    and out and the R * W u8 symbols out; every lane-slot active."""
    cfg, _, R, _, _ = args
    W = cfg.n_per_read
    nbytes = (W * (meta.N_SYM + 1) * 4 + int(out[2]) * 4
              + 2 * cfg.n_lanes * 8 + R * W)
    return _bound(nbytes, R * W * (SEARCH_OPS + OPS_PER_SLOT))


def _bound(nbytes, ops):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT_OPS_PER_S * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def device_ms(fn, reps=REPS, kernel="slot_decode_kernel"):
    """The mean device time of the kernels named `kernel` over `reps`
    calls of fn, from torch.profiler's CUDA activity (after one warm-up
    call): the kernel's own time, without the host's work between
    launches, which a short scan's events would measure instead."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages() if kernel in e.key)
    if us <= 0:
        raise RuntimeError(f"the profiler saw no {kernel} on the device")
    return us / reps * 1e-3


def median_ms(fn, reps=REPS):
    """The median of `reps` calls of fn, each timed by CUDA events (after
    one warm-up call): a call's device time, and the host's work that the
    device waits for where the call is shorter than it."""
    fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in evs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in evs]))


def same(got, want):
    return all(g.device == w.device and g.dtype == w.dtype
               and torch.equal(g, w) for g, w in zip(got, want))


def _load_other(src, tag):
    """K4 and K5 built from `src`, behind their wrappers' signatures."""
    lib = _build.load_other(src, tag)

    def id_scan(cfg, cdfs, R, words, init, n_valid=None):
        N = cfg.n_lanes
        grid = torch.empty((R, cfg.w_all), dtype=torch.uint8, device="cuda")
        fin = torch.empty((N,), dtype=torch.int64, device="cuda")
        ptr = torch.empty((1,), dtype=torch.int64, device="cuda")
        slots = ids.k4_slots(cfg, "cuda")
        rc = lib.fqtz_id_decode(
            cdfs.data_ptr(), slots.data_ptr(), cfg.w_all, R // N,
            words.data_ptr(), words.numel(), init.data_ptr(), N,
            cfg.scale_bits, R if n_valid is None else n_valid,
            cfg.max_id_len, grid.data_ptr(), fin.data_ptr(), ptr.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the other K4 failed: cudaError {rc}")
        return grid, fin, ptr[0]

    def meta_scan(cfg, cdfs, R, words, init):
        N, W = cfg.n_lanes, cfg.n_per_read
        syms = torch.empty((R, W), dtype=torch.uint8, device="cuda")
        fin = torch.empty((N,), dtype=torch.int64, device="cuda")
        ptr = torch.empty((1,), dtype=torch.int64, device="cuda")
        rc = lib.fqtz_meta_decode(
            cdfs.data_ptr(), W, R // N, words.data_ptr(), words.numel(),
            init.data_ptr(), N, cfg.scale_bits, syms.data_ptr(),
            fin.data_ptr(), ptr.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the other K5 failed: cudaError {rc}")
        return syms, fin, ptr[0]
    return id_scan, meta_scan


def measure(name, scan, plain, bound_fn, args, others=(), plain_reps=3):
    """Check `scan` (and each other source's) equal to `plain` on args;
    time them in turns by the profiler's device time (every scan, then
    every scan again in reverse order), then `scan`'s call by CUDA
    events, the plain scan's call, the chain floor's device time and the
    bound. Returns a dict of the numbers, printed on one line."""
    want = plain(*args)
    runs = [("kernel", scan)] + list(others)
    for tag, fn in runs:
        got = fn(*args)
        torch.cuda.synchronize()
        if not same(got, want):
            raise RuntimeError(f"{name}: {tag} differs from the plain scan")
    times = {tag: [] for tag, _ in runs}
    for tag, fn in runs + runs[::-1]:
        times[tag].append(device_ms(lambda: fn(*args)))
    call_ms = median_ms(lambda: scan(*args))
    plain_ms = median_ms(lambda: plain(*args), plain_reps)
    floor = device_ms(lambda: scan(*chain_args(args)))
    bound, by = bound_fn(args, want)
    cfg, R = args[0], args[2]
    W = cfg.w_all if hasattr(cfg, "w_all") else cfg.n_per_read
    steps = R // cfg.n_lanes * W
    t = times["kernel"]
    rec = {"ms": t[0], "ms_again": t[1], "call_ms": call_ms,
           "plain_ms": plain_ms, "chain_ms": floor, "bound_ms": bound,
           "bound_by": by, "steps": steps, "lanes": cfg.n_lanes}
    more = "".join(f"; {tag} {u[0]:.4f}/{u[1]:.4f} ms"
                   for tag, u in list(times.items())[1:])
    print(f"{name} ({cfg.n_lanes} lanes, {steps} steps): device "
          f"{t[0]:.4f}/{t[1]:.4f} ms ({t[0] / steps * 1e3:.2f} us a "
          f"step){more}; a call {call_ms:.4f} ms by events; plain "
          f"{plain_ms:.4f} ms; chain floor ({CHAIN_LANES} lanes) "
          f"{floor:.4f} ms; bound {bound:.6f} ms by {by}")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--qm", default="o", choices=("o", "8", "4", "2", "n"),
                    help="quality mode of the real batch")
    ap.add_argument("--im", default="o", choices=("o", "i"),
                    help="id mode of the real batch")
    ap.add_argument("--reads", type=int, default=20_000)
    ap.add_argument("--other", action="append", default=[],
                    help="CUDA source of K4 and K5 to compare with "
                         "(repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k4_compare: no CUDA device is visible")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as d:
        src, arc = os.path.join(d, "in.fastq"), os.path.join(d, "o.fqst")
        write_fastq_corpus(src, args.reads, 100, 4_600_000, seed=42)
        pipeline.compress_file(cli.parse_args(
            ["e", *BENCH_ROW, "-qm", args.qm, "-im", args.im, src]), src,
            arc)
        batches = scan_batches(arc)
        next(batches)
        m_args, i_args = next(batches)
        batches.close()
    others = [_load_other(s, f"k4_other{k}")
              for k, s in enumerate(args.other)]
    measure("K4", ids.id_decode_scan, ids.id_decode_scan_plain, k4_bound_ms,
            id_args_of(i_args),
            [(s, o[0]) for s, o in zip(args.other, others)])
    measure("K5", meta.meta_decode_scan, meta.meta_decode_scan_plain,
            k5_bound_ms, m_args,
            [(s, o[1]) for s, o in zip(args.other, others)])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
