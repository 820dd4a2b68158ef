"""Time kernel K3 against other sources of the quality decode scan, in
turns, on one card, and its chain floor.

    python3 -m fqsqueezer_tpu_torch.tools.k3_compare [--qm 8]
        [--other other.cu ...]

Each `--other` is a CUDA source with K3's C entry point
(`fqtz_qual_decode`, the signature of csrc/qual_decode.cu), for example an
earlier revision of that file (`git show
0b0dbb7:fqsqueezer_tpu_torch/csrc/qual_decode.cu`) or a candidate
redesign. The input is the main path's real batch: the bench corpus's
first 20,000 reads (chip_smoke.py's) compressed on the card at the bench
primary row with quality mode `--qm` (8, 4, 2 or o: 8, 4, 2 or 96 symbols
a model row), and the quality decode inputs of the archive's second batch
(real_quality_batch). Every scan is checked equal to the plain torch scan
and then timed with CUDA events in turns (every scan, then every scan
again in reverse order), each call allocating its outputs as the wrapper
does. Then the chain floor: K3 on the batch's first 32 lanes (one warp
walking the same dependent steps; chain_batch). Prints the card's name and
power limit first. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import tempfile

import torch

from .. import cli, pipeline
from ..archive import ArchiveReader
from ..ops import _build
from ..params import Params
from ..streams import meta, quality
from ..utils.corpus import write_fastq_corpus

# the bench primary row, as chip_smoke.py gives it to the CLI, without its
# quality mode
BENCH_ROW = ("-s", "-om", "o", "-im", "n", "-gs", "5", "-v", "0")


def real_quality_batch(arc, device="cuda"):
    """The quality decode inputs of the main path's second batch (4096
    reads, 2 read rows) of an archive's first group: (QualConfig, the
    quality model the first batch left, the batch's int32 lengths (meta
    decoded), its fitted int32 word plane, the lane states the first batch
    left, L)."""
    rd = ArchiveReader(arc)
    try:
        p = Params.load_params(rd.header_blob)
        gstates, batches, _ = rd.read_group(p.n_lanes)
    finally:
        rd.close()
    if len(batches) < 2:
        raise ValueError(f"{arc}: its first group holds fewer than 2 "
                         f"batches")
    dcfg, qcfg, mcfg, _ = pipeline.make_configs(p)
    state = pipeline.state_create(dcfg, qcfg, device=device)
    m_model, q_model = state.meta, state.qual
    m_x, q_x = (torch.from_numpy(gstates[k].astype("int64")).to(device)
                for k in (0, 2))
    first = pipeline._first_batch(p.n_lanes, p.max_batch_reads, 0, p.n_lanes)
    for k in (0, 1):
        take, L, streams = batches[k]
        padded = pipeline.canonical_padded(take, first, p.max_batch_reads,
                                           p.n_lanes)
        lengths, _, m_model, m_x, _ = meta.meta_decode_batch(
            mcfg, m_model, padded, pipeline.fit_words(
                streams[0][0], mcfg.n_per_read * padded, device), m_x)
        lengths = torch.clamp(lengths, max=L)
        q_words = pipeline.fit_words(streams[2][0], padded * max(L, 2),
                                     device)
        if k == 1:
            return (qcfg, q_model, lengths.to(torch.int32), q_words, q_x,
                    L)
        _, q_model, q_x, _ = quality.qual_decode_batch(
            qcfg, q_model, lengths, q_words, q_x, L)


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


CHAIN_LANES = 32


def chain_batch(batch, lanes=CHAIN_LANES):
    """The batch's K3 arguments cut to its first `lanes` lanes (the chain
    floor: the same dependent steps for one warp)."""
    cfg, model, lengths, words, init, L = batch
    r_pl = lengths.shape[0] // cfg.n_lanes
    return (dataclasses.replace(cfg, n_lanes=lanes), model,
            lengths[:lanes * r_pl].contiguous(), words,
            init[:lanes].contiguous(), L)


def _load_other(src, tag):
    """The scan built from `src`, behind K3's wrapper signature."""
    lib = _build.load_other(src, tag)

    def scan(cfg, model, lengths, words, init, L):
        N = cfg.n_lanes
        R = lengths.shape[0]
        syms = torch.empty((R, L), dtype=torch.uint8, device="cuda")
        fin = torch.empty((N,), dtype=torch.int64, device="cuda")
        ptr = torch.empty((1,), dtype=torch.int64, device="cuda")
        rc = lib.fqtz_qual_decode(
            model.data_ptr(), cfg.n_sym, cfg.hist_bits, cfg.n_hist,
            lengths.data_ptr(), R // N, L, words.data_ptr(), words.numel(),
            init.data_ptr(), N, cfg.scale_bits, syms.data_ptr(),
            fin.data_ptr(), ptr.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the other scan failed: cudaError {rc}")
        return syms, fin, ptr[0]
    return scan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--qm", default="8", choices=("o", "8", "4", "2"),
                    help="quality mode of the real batch")
    ap.add_argument("--other", action="append", default=[],
                    help="CUDA source of a scan to compare with (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k3_compare: no CUDA device is visible")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as d:
        src, arc = os.path.join(d, "in.fastq"), os.path.join(d, "o.fqst")
        write_fastq_corpus(src, 20_000, 100, 4_600_000, seed=42)
        pipeline.compress_file(
            cli.parse_args(["e", *BENCH_ROW, "-qm", args.qm, src]), src, arc)
        batch = real_quality_batch(arc)
    cfg, L = batch[0], batch[-1]
    steps = batch[2].shape[0] // cfg.n_lanes * L
    want = quality.qual_decode_scan_plain(*batch)
    runs = [("K3", quality.qual_decode_scan)]
    for k, src in enumerate(args.other):
        runs.append((src, _load_other(src, f"k3_other{k}")))
    for name, fn in runs:
        got = fn(*batch)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"{name} differs from the plain scan")
    times = {name: [] for name, _ in runs}
    for name, fn in runs + runs[::-1]:
        times[name].append(_ms(lambda: fn(*batch)))
    for name, t in times.items():
        print(f"{name}: {t[0]:.4f} ms, {t[1]:.4f} ms a batch "
              f"({t[0] / steps * 1e3:.2f} us a step)")
    chain = chain_batch(batch)
    floor = _ms(lambda: quality.qual_decode_scan(*chain))
    print(f"the main path's batch ({steps} steps): chain floor "
          f"({CHAIN_LANES} lanes) {floor:.4f} ms, "
          f"{floor / steps * 1e3:.2f} us a step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
