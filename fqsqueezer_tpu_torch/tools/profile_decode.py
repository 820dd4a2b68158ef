"""Where a decompress spends its time, on one card.

    python3 -m fqsqueezer_tpu_torch.tools.profile_decode [--reads 100000]
        [--om o] [--qm 8] [--im n] [--pe]

Compresses the bench corpus (chip_smoke.py's: 100 bp reads of a 4.6 Mbp
genome, seed 42, the bench primary row's Params with the read order,
quality and id modes given: `-om o -qm 8 -im n` by default, `--om s --qm 8
--im i` the CLI's defaults (instrument ids); with --pe the
bench's PE corpus, reads / 2 pairs of write_pe_corpus, as -p: `--pe --qm
n` is the bench's PE row), then decompresses it
warm: once without timers, once with a `torch.cuda.synchronize()` timer
around each function of the decode (K2, `dna_decode_row`, is the row's
scan and table update), and prints seconds, calls and the share of the
timed wall for each (nested rows are part of the row above them; the
timers serialize the device, so the untimed wall stands beside the timed
one; with --pe the row-end PE step, dna._pe_row_end — candidates, pe
symbols and the anchor after each read1 row — has its own row). Then one
full batch (4096 reads) is decoded again under
`torch.profiler` with CUDA activity: its wall, the device time of its
kernels, the device's busy and idle shares, and the kernels launched a
DNA decode position. With ids, that batch's id scan alone as well
(id_decode_scan: kernel K4) and its bound (k4_compare.k4_bound_ms: the
cdf rows its slots read, the words it consumes, the states in and out,
the symbols out, over 3.35 TB/s; a binary search of the row and the
state update an active lane-slot over 67 Tops/s; the larger). Prints the
card's name and power limit first. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
import time

import torch

from .. import cli, pipeline
from ..io import fastq
from ..ops import tables
from ..params import Params
from ..streams import dna, ids, meta, quality
from . import k4_compare
from ..utils.corpus import write_fastq_corpus, write_pe_corpus

# the bench primary row, as chip_smoke.py gives it to the CLI, without its
# read order, quality and id modes
BENCH_ROW = ("-s", "-gs", "5", "-v", "0")

# dna_decode_row is K2 on the card: the row's scan and its s/b table
# update; _apply_sb_updates and k2_update (the torch update) stay listed to
# show that the card's decode calls them no more; meta_decode_scan and
# id_decode_scan are K5 and K4
TIMED = ((pipeline, "_decode_batch"), (meta, "meta_decode_batch"),
         (meta, "meta_decode_scan"),
         (dna, "dna_decode_batch"), (dna, "dna_decode_row"),
         (dna, "_pe_row_end"),
         (dna, "_apply_sb_updates"), (tables, "k2_update"),
         (dna, "dna_collect_updates"), (quality, "qual_decode_batch"),
         (quality, "qual_decode_scan"), (ids, "id_decode_batch"),
         (ids, "id_decode_scan"),
         (ids, "decode_ids_host"), (pipeline, "payload_crc"),
         (fastq.FastqWriter, "write_batch"),
         (pipeline, "fill_stats_device"), (pipeline, "grow_tables"))


def _timed(fn, acc):
    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        acc[0] += time.perf_counter() - t0
        acc[1] += 1
        return out
    return wrapper


def _device_us(prof) -> float:
    """Summed device time (us) of the kernels a profile recorded."""
    total = 0.0
    for e in prof.key_averages():
        total += getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
    return total


def _profiled(fn):
    """(fn's result, wall s, device s, device records) of one call under
    torch.profiler with CUDA activity."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return (res, wall, _device_us(prof) * 1e-6,
            sum(e.count for e in prof.key_averages()))


def _profile_one_batch(arc, out, out2):
    """Decode the archive with the profiler on around its third batch (the
    first full 4096-read one), and around that batch's id scan alone when
    the archive has ids. Returns ((wall s, device s, device records, read
    rows, L), (wall s, device s, device records, steps) of the id scan or
    None)."""
    seen = [0]
    got = {"ids": None}
    real = pipeline._decode_batch

    def probe(dcfg, qcfg, mcfg, icfg, R, L, *rest):
        seen[0] += 1
        if seen[0] != 3:
            return real(dcfg, qcfg, mcfg, icfg, R, L, *rest)
        if icfg is not None:
            state, streams, n_valid = rest
            words, states = streams[2 + (qcfg is not None)]
            args = k4_compare.id_args_of((
                icfg, ids._ctx_cdfs(icfg, state.id).to(
                    torch.int32).contiguous(), R,
                words.to(torch.int32).contiguous(), states, n_valid))
            res, wall, dev_s, n = _profiled(
                lambda: ids.id_decode_scan(*args))
            got["ids"] = (wall, dev_s, n, R // icfg.n_lanes * icfg.w_all,
                          *k4_compare.k4_bound_ms(args, res))
        res, wall, dev_s, n = _profiled(
            lambda: real(dcfg, qcfg, mcfg, icfg, R, L, *rest))
        rows = (3 * (R // 2) if dcfg.pe_log2_buckets > 0 else R)
        got["batch"] = (wall, dev_s, n, rows // dcfg.n_lanes, L)
        return res

    pipeline._decode_batch = probe
    try:
        pipeline.decompress_file(Params(), arc, out, out2)
    finally:
        pipeline._decode_batch = real
    return got["batch"], got["ids"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=100_000)
    ap.add_argument("--om", default="o", choices=("o", "s"),
                    help="read order")
    ap.add_argument("--qm", default="8", choices=("o", "8", "4", "2", "n"),
                    help="quality mode")
    ap.add_argument("--im", default="n", choices=("o", "i", "n"),
                    help="id mode (i: instrument ids, the CLI's default)")
    ap.add_argument("--pe", action="store_true",
                    help="paired-end (-p): reads / 2 pairs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: no CUDA device is visible")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as d:
        src, arc = os.path.join(d, "in.fastq"), os.path.join(d, "o.fqst")
        out, out2 = os.path.join(d, "o.fastq"), os.path.join(d, "o2.fastq")
        flags = ["-om", args.om, "-qm", args.qm, "-im", args.im]
        if args.pe:
            src2 = os.path.join(d, "in_2.fastq")
            write_pe_corpus(src, src2, args.reads // 2, 100, 4_600_000,
                            seed=42)
            pipeline.compress_pe(cli.parse_args(
                ["e", *BENCH_ROW, "-p", *flags, src, src2]), src, src2, arc)
        else:
            write_fastq_corpus(src, args.reads, 100, 4_600_000, seed=42)
            pipeline.compress_file(cli.parse_args(
                ["e", *BENCH_ROW, *flags, src]), src, arc)

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipeline.decompress_file(Params(), arc, out, out2)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        run()                                        # warm-up
        plain = run()
        accs = {}
        saved = [(o, n, getattr(o, n)) for o, n in TIMED]
        try:
            for o, n, fn in saved:
                accs[n] = [0.0, 0]
                setattr(o, n, _timed(fn, accs[n]))
            timed = run()
        finally:
            for o, n, fn in saved:
                setattr(o, n, fn)
        (wall, dev_s, kernels, rows, L), id_scan = _profile_one_batch(
            arc, out, out2)
    print(f"{args.reads} reads{' (PE)' if args.pe else ''}, -om {args.om} "
          f"-qm {args.qm} -im {args.im}, warm "
          f"decompress: {plain:.4f} s without "
          f"timers ({args.reads / plain:.1f} reads/s), {timed:.4f} s with "
          f"them")
    print("function | s | calls | share of the timed wall")
    for n, (s, calls) in accs.items():
        print(f"{n} | {s:.4f} | {calls} | {100 * s / timed:.2f}%")
    print(f"one batch ({rows} read rows x {L} positions) under the "
          f"profiler: wall {wall:.4f} s, device busy {dev_s:.4f} s "
          f"({100 * dev_s / wall:.2f}% busy, {100 - 100 * dev_s / wall:.2f}"
          f"% idle), {kernels} device records, {kernels / (rows * L):.1f} "
          f"a position")
    if id_scan is not None:
        wall, dev_s, n, steps, bound, by = id_scan
        print(f"that batch's id scan alone (id_decode_scan: K4, {steps} "
              f"steps): wall {wall * 1e3:.4f} ms, device busy "
              f"{dev_s * 1e3:.4f} ms, {n} "
              f"device records, {n / steps:.1f} a step; bound {bound:.5f} "
              f"ms by {by}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
