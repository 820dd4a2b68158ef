"""Check and time kernel K2 (the DNA decode scan, one launch a read row)
on one card, against its plain torch version.

    python3 -m fqsqueezer_tpu_torch.tools.k2_compare

The input is the main path's real batch: the bench corpus's first 20,000
reads (chip_smoke.py's) compressed on the card at the bench primary row,
and the DNA decode inputs of the archive's second batch with the DNA state
the first batch left (real_dna_batch). dna_decode_batch decodes it with
every read row run by K2 and by the plain row scan on the same inputs and
held equal (check_rows). Then one batch's K2 launches are timed with CUDA
events, each call allocating its outputs as the wrapper does, beside the
plain scan, the chain floor (K2 on the first 32 lanes only: one warp
walking the same dependent loads) and the bound. Prints the card's name
and power limit first. Needs a CUDA card and nvcc.
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
from ..ops import kmers, tables
from ..params import Params
from ..streams import dna, meta
from ..utils.corpus import write_fastq_corpus

# the bench primary row, as chip_smoke.py gives it to the CLI
BENCH_ROW = ("-s", "-om", "o", "-qm", "8", "-im", "n", "-gs", "5", "-v", "0")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
INT_OPS_PER_S = 67e12      # published non-tensor 32-bit rate
K2_OPS_PER_POS = 700       # an active lane-step: two queries (hash, tag,
                           # slots), two row finds, the cascade, the context
                           # (sort, quantizers), two model rows, six
                           # divides, the lookup, the scan's share, the
                           # repair and the rolls; rough probes not counted
CHAIN_LANES = 32


def real_dna_batch(arc, device="cuda"):
    """The DNA decode inputs of the main path's second batch (4096 reads,
    2 read rows) of an archive's first group: (DnaConfig, the DNA state the
    first batch left, the batch's lengths (meta decoded, clamped to L), its
    fitted int32 word plane, the lane states the first batch left, L)."""
    rd = ArchiveReader(arc)
    try:
        p = Params.load_params(rd.header_blob)
        gstates, batches, _ = rd.read_group(p.n_lanes)
    finally:
        rd.close()
    if len(batches) < 2:
        raise ValueError(f"{arc}: its first group holds fewer than 2 "
                         f"batches")
    dcfg, qcfg, mcfg = pipeline.make_configs(p)
    state = pipeline.state_create(dcfg, qcfg, device)
    m_model, d_state = state.meta, state.dna
    m_x, d_x = (torch.from_numpy(gstates[k].astype("int64")).to(device)
                for k in (0, 1))
    first = pipeline._first_batch(p.n_lanes, p.max_batch_reads, 0, p.n_lanes)
    for k in (0, 1):
        take, L, streams = batches[k]
        padded = pipeline.canonical_padded(take, first, p.max_batch_reads,
                                           p.n_lanes)
        lengths, m_model, m_x, _ = meta.meta_decode_batch(
            mcfg, m_model, padded, pipeline.fit_words(
                streams[0][0], mcfg.n_per_read * padded, device), m_x)
        lengths = torch.clamp(lengths, max=L)
        d_words = pipeline.fit_words(streams[1][0], padded * max(L, 2),
                                     device)
        if k == 1:
            return dcfg, d_state, lengths, d_words, d_x, L
        _, d_state, d_x, _, _ = dna.dna_decode_batch(
            dcfg, d_state, lengths, d_words, d_x, L)


_OUT_NAMES = ("base", "eff", "ctx", "sym", "final states", "ptr",
              "registers")


def _flat(out):
    planes, x, ptr, regs = out
    return (*planes, x, ptr, regs)


def max_abs_err(got, want):
    """Largest difference between two row results (0 when equal); a dtype,
    shape or device that differs is an error."""
    worst = 0
    for g, w, name in zip(_flat(got), _flat(want), _OUT_NAMES):
        if g.dtype != w.dtype or g.shape != w.shape or g.device != w.device:
            raise RuntimeError(f"K2's {name}: {g.dtype} {tuple(g.shape)} "
                               f"on {g.device}, plain {w.dtype} "
                               f"{tuple(w.shape)} on {w.device}")
        if g.numel():
            worst = max(worst, int((g - w).abs().max()))
    return worst


def check_rows(cfg, state, lengths, words, init, L, what="the batch"):
    """Decode one batch through dna.dna_decode_batch with every read row
    run by both K2 (dna_decode_row on CUDA tensors) and
    dna_decode_row_plain on the same inputs, raising at the first
    difference; the batch goes on with the plain results. Returns, a row,
    (its dna_decode_row arguments, the plain result)."""
    k2 = dna.dna_decode_row
    rows = []

    def both(cfg, state, length, words, x, ptr, regs, L, be=tables.LOCAL):
        args = (cfg, state, length, words, x, ptr, regs, L)
        before = dna.K2_LAUNCHES
        got = k2(*args, be)
        if dna.K2_LAUNCHES != before + 1:
            raise RuntimeError("dna_decode_row did not launch K2")
        want = dna.dna_decode_row_plain(*args, be)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            bad = [n for g, w, n in zip(_flat(got), _flat(want), _OUT_NAMES)
                   if not torch.equal(g, w)]
            raise RuntimeError(f"K2 disagrees with the plain row scan on "
                               f"{what}, row {len(rows)}: {', '.join(bad)}, "
                               f"max abs err {err}")
        rows.append((args, want))
        return want

    dna.dna_decode_row = both
    try:
        dna.dna_decode_batch(cfg, state, lengths, words, init, L)
    finally:
        dna.dna_decode_row = k2
    return rows


def chain_rows(rows, lanes=CHAIN_LANES):
    """The rows' K2 arguments cut to their first `lanes` lanes (the chain
    floor: the same dependent steps for one warp)."""
    out = []
    for (cfg, st, length, words, x, ptr, regs, L), _ in rows:
        out.append((dataclasses.replace(cfg, n_lanes=lanes), st,
                    length[:lanes].contiguous(), words,
                    x[:lanes].contiguous(), ptr,
                    regs[:, :lanes].contiguous(), L))
    return out


def _distinct(t):
    return int(torch.unique(t).numel())


def _find_rows(cfg, kc, active, tc, k, log2_base):
    """Distinct rows of a width-k table that the finds of an [N, L] row
    read: the (k-1)-base window of the row's eff bases before each position
    that has one (the windows carried from the previous row are never
    used)."""
    w = k - 1
    sr = lambda t: kmers.shift_right(t, 1)
    lo, hi = kmers.pack_windows(kc, w)
    rlo, rhi = kmers.pack_windows_rc(kc, w)
    bkt, tags4, *_ = dna._canon_query(sr(lo), sr(hi), sr(rlo), sr(rhi), k,
                                      log2_base)
    rows = tables.kbucket_of(tags4[..., 0], bkt, tc.shape[0].bit_length() - 1,
                             log2_base)
    return rows[active]


def k2_bound_ms(rows):
    """(ms, 'bytes' | 'operations'): the least time the card could take
    for these rows' K2 launches. Bytes a launch: the distinct s and b table
    rows its finds read (32 B), the distinct SIV words (8 B) and model rows
    (fine and coarse, 20 B) it reads, the words it consumes (4 B), lengths,
    states, registers and the pointer in and out, and the four int64
    [N, L] planes out; the rough probes' and the ramp's reads are not
    counted, so this bound is low. Operations: K2_OPS_PER_POS an active
    lane-position over the published 32-bit rate."""
    nbytes = 0
    n_active = 0
    for (cfg, st, length, words, x, ptr, regs, L), want in rows:
        (_, kc, ctx, _), _, ptr_end, _ = want
        N = length.shape[0]
        pos = torch.arange(L, device=kc.device)[None, :]
        active = pos < length[:, None]
        n_active += int(active.sum())
        s_w, b_w = cfg.smer_len - 1, cfg.bmer_len - 1
        s_rows = _find_rows(cfg, kc, active & (pos >= min(s_w, b_w)),
                            st.s_tc, cfg.smer_len, cfg.smer_log2_buckets)
        b_rows = _find_rows(cfg, kc, active & (pos >= b_w), st.b_tc,
                            cfg.bmer_len, cfg.bmer_log2_buckets)
        pm = kmers.shift_right(kmers.pack_windows(kc, cfg.siv_len - 1)[0], 1)
        siv = pm[active & (pos >= cfg.siv_len - 1)]
        fine = ctx.reshape(-1)
        model_rows = torch.cat([fine, dna._n_model_ctx(cfg)
                                + dna._coarse_ctx(cfg, fine)])
        nbytes += (32 * (_distinct(s_rows) + _distinct(b_rows))
                   + 8 * _distinct(siv) + 20 * _distinct(model_rows)
                   + 4 * int(ptr_end - ptr) + 8 * N
                   + 2 * 8 * (N + dna.K2_NREGS * N + 1) + 4 * N * L * 8)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_active * K2_OPS_PER_POS / INT_OPS_PER_S * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def ms(fn, reps=20):
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


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_compare: no CUDA device is visible")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as d:
        src, arc = os.path.join(d, "in.fastq"), os.path.join(d, "o.fqst")
        write_fastq_corpus(src, 20_000, 100, 4_600_000, seed=42)
        pipeline.compress_file(cli.parse_args(["e", *BENCH_ROW, src]), src,
                               arc)
        batch = real_dna_batch(arc)
    rows = check_rows(*batch)
    L = batch[-1]
    steps = len(rows) * L
    k2_ms = ms(lambda: [dna.dna_decode_row(*a) for a, _ in rows])
    chain = chain_rows(rows)
    floor_ms = ms(lambda: [dna.dna_decode_row(*a) for a in chain])
    plain_ms = ms(lambda: [dna.dna_decode_row_plain(*a) for a, _ in rows], 2)
    bound, by = k2_bound_ms(rows)
    print(f"the main path's batch ({len(rows)} rows, {steps} steps): K2 "
          f"{k2_ms:.4f} ms ({k2_ms / steps * 1e3:.2f} us a step), chain "
          f"floor ({CHAIN_LANES} lanes) {floor_ms:.4f} ms, plain torch "
          f"{plain_ms:.2f} ms, bound {bound:.4f} ms by {by}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
