"""Where a compress's group flush spends its time, on one card.

    python3 -m fqsqueezer_tpu_torch.tools.profile_flush [--reads 100000]

Compresses the bench corpus (chip_smoke.py's: 100 bp reads of a 4.6 Mbp
genome, seed 42, the bench primary row's Params) warm, once without timers
and once with a `torch.cuda.synchronize()` timer around each function of
the flush and around the batch model step, and prints seconds, calls and
the share of the timed wall for each. The timers serialize the device, so
the shares are of the timed run; the untimed wall stands beside it. Prints
the card's name and power limit first. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
import time

import torch

from .. import archive, cli, pipeline
from ..io import fastq
from ..ops import rans
from ..utils.corpus import write_fastq_corpus

# the bench primary row, as chip_smoke.py gives it to the CLI
BENCH_ROW = ("-s", "-om", "o", "-qm", "8", "-im", "n", "-gs", "5", "-v", "0")

TIMED = ((pipeline, "_model_batch"), (pipeline, "_group_grid"),
         (rans, "rans_encode_groups"), (rans, "rans_encode_walks"),
         (rans, "_compact"), (archive.ArchiveWriter, "write_group"),
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=100_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_flush: no CUDA device is visible")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as d:
        src, arc = os.path.join(d, "in.fastq"), os.path.join(d, "o.fqst")
        write_fastq_corpus(src, args.reads, 100, 4_600_000, seed=42)
        data = fastq.read_fastq(src)

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipeline.compress_file(cli.parse_args(["e", *BENCH_ROW, src]),
                                   src, arc, data=data)
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
    print(f"{args.reads} reads, warm compress: {plain:.4f} s without timers, "
          f"{timed:.4f} s with them")
    print("function | s | calls | share of the timed wall")
    for n, (s, calls) in accs.items():
        print(f"{n} | {s:.4f} | {calls} | {100 * s / timed:.2f}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
