"""The port's benchmark: bench.py's rows on one CUDA card.

    python3 -m fqsqueezer_tpu_torch.tools.bench_gpu [--primary-only]

Prints ONE JSON line with bench.py's keys. The primary metric is SE
compress reads/s of the bench primary row (`e -s -om o -qm 8 -im n -gs 5`,
2048 lanes) on the 100k x 100 bp seed-42 corpus, from a warm call timed on
the host clock and ended by `torch.cuda.synchronize()`; decode reads/s,
bits/base and the walls ride along, with the peak CUDA memory of the
compress and of the decode. The ride-along rows follow bench.py:
`sorted` (`-om s -qm 8 -im n`, 1024 lanes) and `pe` (`e -p -om o -qm n
-im n`, 1024 lanes, on the 50,000-pair seed-42 corpus of write_pe_corpus)
hold compress and decode reads/s (warm-up, then a timed run each; PE
counts both mates), bits/base and bytes against the C++ reference's
archive; `se_ids` (`-qm n -im o`, 1024 lanes) and `se_real` (the primary
row on the realistic-genome corpus) hold bits/base and bytes against the
C++ reference's archive. A row that failed holds `{"error": ...}` and is
named on stderr as `RIDE-ALONG FAILURE`, as bench.py does.

`--primary-only` prints the primary row alone. Its imports are absolute, so
the same file run by path holds an earlier checkout of the package to the
same measurement, in one call on one card; tools/bench_pairs.py runs it so,
in pairs:

    PYTHONPATH=old_checkout python3 fqsqueezer_tpu_torch/tools/bench_gpu.py \
        --primary-only

`vs_baseline` (and `decode_vs_baseline`) divide by the C++ reference's
single-thread rates, which bench.py records from a run on another host:
the `note` field says so. Corpora (written anew by every run) and archives
go under build/bench_gpu/ in the repository (the directory .gitignore
lists). Imports only the port;
needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from fqsqueezer_tpu_torch import pipeline
from fqsqueezer_tpu_torch.io import fastq
from fqsqueezer_tpu_torch.params import DnaMode, IdMode, Params, QualityMode
from fqsqueezer_tpu_torch.utils.corpus import (write_fastq_corpus,
                                               write_pe_corpus)

# the C++ reference (fqs-1.1), single thread, as bench.py records it
BASELINE_READS_PER_S = 2873.0
BASELINE_BITS_PER_BASE = 2.787
BASELINE_DECODE_READS_PER_S = 3268.0
REF_SORTED_BYTES = 3_305_026     # reference `-om s -qm 8 -im n`
REF_PE_BYTES = 1_386_065         # reference `e -p -om o -qm n -im n`
REF_IDS_BYTES = 1_417_286        # reference `-om o -qm n -im o` (se_ids)
REF_REAL_BYTES = 3_382_084       # reference `-om o -qm 8 -im n`, realistic
N_READS = 100_000
N_PAIRS = 50_000
READ_LEN = 100
GENOME = 4_600_000
NOTE = ("vs_baseline and decode_vs_baseline divide by the C++ reference's "
        "single-thread reads/s (bench.py), measured on another host than "
        "this card's")
WORK = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "bench_gpu")


def base_params(om, qm, im) -> Params:
    """bench.py's base_params in the port's Params."""
    p = Params()
    p.genome_size = 5
    p.adjust_kmer_sizes()
    p.dna_mode = om
    p.quality_mode = qm
    p.id_mode = im
    p.verbosity = 0
    p.auto_tune_lanes()
    return p


def timed(fn):
    """(fn's result, its host-clock seconds), the card synchronized before
    and after."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def timed_peak(fn):
    """(fn's result, its host-clock seconds, its peak CUDA memory GiB)."""
    torch.cuda.reset_peak_memory_stats()
    out, dt = timed(fn)
    return out, dt, torch.cuda.max_memory_allocated() / 2**30


_WRITTEN = set()


def corpus(path, write, n_reads=N_READS):
    """path, written by write(path, n_reads, READ_LEN, GENOME, seed=42) once
    in this process: a file an earlier run left there is never reused."""
    if path not in _WRITTEN:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write(path, n_reads, READ_LEN, GENOME, seed=42)
        _WRITTEN.add(path)
    return path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--primary-only", action="store_true",
                    help="the primary row alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_gpu: no CUDA device is visible")
    os.makedirs(WORK, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    src = corpus(os.path.join(WORK, "bench_se.fastq"), write_fastq_corpus)
    data = fastq.read_fastq(src)
    arc = os.path.join(WORK, "bench.fqst")

    def params(om=DnaMode.SE_ORIGINAL, qm=QualityMode.ILLUMINA_8,
               im=IdMode.NONE):
        return base_params(om, qm, im)

    # ---- primary row: SE original, warm call then timed call ----------
    pipeline.compress_file(params(), src, arc + ".warm", data=data)
    stats, dt, peak = timed_peak(
        lambda: pipeline.compress_file(params(), src, arc, data=data))
    out_fq = os.path.join(WORK, "bench_out.fastq")
    pipeline.decompress_file(Params(), arc, out_fq + ".warm")
    dstats, ddt, dpeak = timed_peak(
        lambda: pipeline.decompress_file(Params(), arc, out_fq))
    reads_per_s = stats["n_reads"] / dt
    d_reads_per_s = dstats["n_reads"] / ddt
    out = {
        "metric": "se_compress_reads_per_s",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / BASELINE_READS_PER_S, 3),
        "bits_per_base": round(stats["bits_per_base"], 4),
        "bits_per_base_vs_baseline": round(
            stats["bits_per_base"] / BASELINE_BITS_PER_BASE, 3),
        "wall_s": round(dt, 2),
        "decode_reads_per_s": round(d_reads_per_s, 1),
        "decode_vs_baseline": round(
            d_reads_per_s / BASELINE_DECODE_READS_PER_S, 3),
        "decode_wall_s": round(ddt, 2),
        "peak_cuda_mem_gib": round(peak, 3),
        "decode_peak_cuda_mem_gib": round(dpeak, 3),
        "device": {"kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count(), "nvidia_smi": card},
        "package": os.path.dirname(os.path.abspath(pipeline.__file__)),
        "note": NOTE,
    }
    if args.primary_only:
        print(json.dumps(out))
        return 0

    # ---- ride-along rows: a failure never loses the primary line -------
    try:
        s_arc = os.path.join(WORK, "sorted.fqst")
        s_out = os.path.join(WORK, "sorted_out.fastq")

        def compress_sorted():
            return pipeline.compress_file(params(om=DnaMode.SE_SORTED), src,
                                          s_arc, data=data)

        compress_sorted()
        stats_s, dts = timed(compress_sorted)
        pipeline.decompress_file(Params(), s_arc, s_out + ".warm")
        dstats_s, ddts = timed(
            lambda: pipeline.decompress_file(Params(), s_arc, s_out))
        out["sorted"] = {
            "compress_reads_per_s": round(stats_s["n_reads"] / dts, 1),
            "decode_reads_per_s": round(dstats_s["n_reads"] / ddts, 1),
            "bits_per_base": round(stats_s["bits_per_base"], 4),
            "bytes_vs_ref": round(stats_s["out_bytes"] / REF_SORTED_BYTES,
                                  4),
        }
    except Exception as e:  # noqa: BLE001 - diagnostic ride-along
        out["sorted"] = {"error": f"{type(e).__name__}: {e}"[:200]}

    try:
        pe1 = os.path.join(WORK, "bench_pe_1.fastq")
        pe2 = os.path.join(WORK, "bench_pe_2.fastq")
        if pe1 not in _WRITTEN:
            write_pe_corpus(pe1, pe2, N_PAIRS, READ_LEN, GENOME, seed=42)
            _WRITTEN.add(pe1)
        p_arc = os.path.join(WORK, "pe.fqst")
        p_out = [os.path.join(WORK, f"pe_out_{k}.fastq") for k in (1, 2)]

        def compress_pe():
            return pipeline.compress_pe(
                params(DnaMode.PE_ORIGINAL, QualityMode.NONE), pe1, pe2,
                p_arc)

        def decompress_pe(suffix=""):
            return pipeline.decompress_file(
                Params(), p_arc, p_out[0] + suffix, p_out[1] + suffix)

        compress_pe()
        stats_p, dtp = timed(compress_pe)
        decompress_pe(".warm")
        dstats_p, ddtp = timed(decompress_pe)
        out["pe"] = {
            "compress_reads_per_s": round(stats_p["n_reads"] / dtp, 1),
            "decode_reads_per_s": round(dstats_p["n_reads"] / ddtp, 1),
            "bits_per_base": round(stats_p["bits_per_base"], 4),
            "bytes_vs_ref": round(stats_p["out_bytes"] / REF_PE_BYTES, 4),
        }
    except Exception as e:  # noqa: BLE001 - diagnostic ride-along
        out["pe"] = {"error": f"{type(e).__name__}: {e}"[:200]}

    try:
        stats_i = pipeline.compress_file(
            params(qm=QualityMode.NONE, im=IdMode.LOSSLESS), src,
            os.path.join(WORK, "ids.fqst"), data=data)
        out["se_ids"] = {
            "bits_per_base": round(stats_i["bits_per_base"], 4),
            "bytes_vs_ref": round(stats_i["out_bytes"] / REF_IDS_BYTES, 4),
        }
    except Exception as e:  # noqa: BLE001 - diagnostic ride-along
        out["se_ids"] = {"error": f"{type(e).__name__}: {e}"[:200]}

    try:
        from fqsqueezer_tpu_torch.utils.corpus import (
            write_fastq_corpus_realistic)

        real = corpus(os.path.join(WORK, "bench_real.fastq"),
                      write_fastq_corpus_realistic)
        stats_r = pipeline.compress_file(params(), real,
                                         os.path.join(WORK, "real.fqst"))
        out["se_real"] = {
            "bits_per_base": round(stats_r["bits_per_base"], 4),
            "bytes_vs_ref": round(stats_r["out_bytes"] / REF_REAL_BYTES, 4),
        }
    except Exception as e:  # noqa: BLE001 - diagnostic ride-along
        out["se_real"] = {"error": f"{type(e).__name__}: {e}"[:200]}

    for key in ("sorted", "pe", "se_ids", "se_real"):
        if "error" in out[key]:
            print(f"RIDE-ALONG FAILURE [{key}]: {out[key]['error']}",
                  file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
