"""Check and time kernel K2 (one read row of the DNA decode: the scan and
the row's s/b table update, one launch) on one card, against its plain
torch version.

    python3 -m fqsqueezer_tpu_torch.tools.k2_compare [--sorted | --pe]
        [--pos sorted|pe] [--family k2|ktable|table|local|klocal]
        [--other other.cu ...] [--other-args N]

The input is the main path's real batch: the bench corpus's first 20,000
reads (chip_smoke.py's) compressed on the card at the bench primary row
(with --sorted at the bench's sorted row, -om s: 1024 lanes, 4 read rows
a batch, each read's shared prefix copied by K2; with --pe the first
10,000 pairs of the bench's PE corpus at its PE row, -p -om o -qm n -im
n: 1024 lanes, 6 expanded rows a batch, read1, rowA and rowB a pair, the
anchored rows' first B bases copied from the anchor by K2; with --family
ktable under the H6 header of params.HEADER_GENERATIONS — row-global
ktable_* cells, ctx v2, the rough rescue — and with --family table under
H0 — the first writer's batch-frozen table_* cells, ctx v1, no mix, no
ramp, three repairs —, with --family local under H1 — H0's tables with
in-batch local_* tables and DNA deltas — and with --family klocal under
H4 — batch-frozen ktable_* cells with klocal_* tables —, each at -s -om
o -qm o -im o -gs 5, 2048 lanes, 2 read rows a batch; with --pos sorted
the sorted row under dna_sorted_ctx 1, whose read rows take K2's
sorted-mode position map, and with --pos pe the PE row under
dna_pe_pos_ctx 1, whose rowA and rowB take the paired-end map), and the
DNA decode inputs of the archive's second
batch with the DNA state the first batch left (real_dna_batch). With
--pe the row-end PE step (dna._pe_row_end, torch ops between K2's
launches) is timed too. dna_decode_batch decodes it with every read row
run by K2 and by the plain row step on the same inputs and held equal,
both updated tables included (check_rows). Then one batch's rows are
timed with CUDA events, each call allocating its outputs as the wrapper
does, and the tables restored to the row-start ones before each
repetition, outside its timed region (replay_ms), in turns: every run,
then every run again in reverse order. The runs: K2; where the tables
are row-global, two copies of its source cut at run time (CUTS) —
without the row update's atomics, and the scan alone (no decisions
either) — whose differences from K2 are the update's time; and each
`--other`, another source with K2's C entry point and struct Args (a
candidate redesign, or an earlier revision of the file). Every run is
held equal to the plain row step first: the planes, x, ptr and
registers, and the tables (updated by K2 and `--other`, left as they
were by the cut copies). Then the chain floor (K2 on the first 32 lanes
only: one warp walking the same dependent loads), the plain row step and
the bound. Prints the card's name and power limit first. Needs a CUDA
card and nvcc.
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
from ..ops import _build, kmers, tables
from ..params import Params, header_generation
from ..streams import dna, meta
from ..utils.corpus import write_fastq_corpus, write_pe_corpus

# the bench primary row, as chip_smoke.py gives it to the CLI, and the
# bench's sorted row
BENCH_ROW = ("-s", "-om", "o", "-qm", "8", "-im", "n", "-gs", "5", "-v", "0")
SORTED_ROW = ("-s", "-om", "s", "-qm", "8", "-im", "n", "-gs", "5", "-v", "0")
PE_ROW = ("-p", "-om", "o", "-qm", "n", "-im", "n", "-gs", "5", "-v", "0")
# the older writers' rows of --family: (header generation, flags)
FAMILY_ROWS = {
    "ktable": ("H6", ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs", "5",
                      "-v", "0")),
    "table": ("H0", ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs", "5",
                     "-v", "0")),
    "local": ("H1", ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs", "5",
                     "-v", "0")),
    "klocal": ("H4", ("-s", "-om", "o", "-qm", "o", "-im", "o", "-gs", "5",
                      "-v", "0")),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published
INT_OPS_PER_S = 67e12      # published non-tensor 32-bit rate
K2_OPS_PER_POS = 700       # an active lane-step: two queries (hash, tag,
                           # slots), two row finds, the cascade, the context
                           # (sort, quantizers), two model rows, six
                           # divides, the lookup, the scan's share, the
                           # repair and the rolls; rough probes not counted
K2_OPS_PER_EVENT = 30      # an insert event: the match, empty mask and slot
                           # of its decision, its store, load and atomic
CHAIN_LANES = 32


def real_dna_batch(arc, device="cuda"):
    """The DNA decode inputs of the second batch of an archive's first
    group (4096 reads: 2 read rows at the main path's 2048 lanes, 4 at
    sorted order's 1024, 6 expanded rows in PE's): (DnaConfig, the DNA
    state the first batch left, the batch's lengths (meta decoded, clamped
    to L), its fitted int32 word plane, the lane states the first batch
    left, L, its LCPs or None in original order, and for an archive with
    the PE anchors the keyword arguments of dna_decode_batch's pe stream
    and LCP stride, else None)."""
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
    m_model, d_state = state.meta, state.dna
    m_x, d_x, pe_x = (torch.from_numpy(gstates[k].astype("int64")).to(device)
                      for k in (0, 1, -1))
    with_pe = dcfg.pe_log2_buckets > 0
    align = 2 * p.n_lanes if mcfg.lcp_stride == 2 else p.n_lanes
    first = pipeline._first_batch(p.n_lanes, p.max_batch_reads, 0, align)
    for k in (0, 1):
        take, L, streams = batches[k]
        padded = pipeline.canonical_padded(take, first, p.max_batch_reads,
                                           align)
        lengths, lcp, m_model, m_x, _ = meta.meta_decode_batch(
            mcfg, m_model, padded, pipeline.fit_words(
                streams[0][0], mcfg.n_per_read * padded, device), m_x)
        lengths = torch.clamp(lengths, max=L)
        lcp = lcp if mcfg.with_lcp else None
        d_words = pipeline.fit_words(
            streams[1][0], (3 * (padded // 2) if with_pe else padded)
            * max(L, 2), device)
        pe = {"lcp_stride": mcfg.lcp_stride}
        if with_pe:
            pe.update(pe_words=pipeline.fit_words(
                streams[-1][0], 2 * padded + 4 * p.n_lanes, device),
                pe_states=pe_x)
        if k == 1:
            return (dcfg, d_state, lengths, d_words, d_x, L, lcp,
                    pe if mcfg.lcp_stride == 2 else None)
        _, d_state, d_x, _, extras = dna.dna_decode_batch(
            dcfg, d_state, lengths, d_words, d_x, L, lcp=lcp, **pe)
        if with_pe:
            pe_x = extras[4]


_OUT_NAMES = ("base", "eff", "ctx", "sym", "final states", "ptr",
              "registers", "s table", "b table")


def _flat(out):
    planes, *rest = out
    return (*planes, *rest)


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


def _row_checker(rows, what):
    """A dna_decode_row that runs both K2 (on copies of the row-start
    tables, which it updates in place) and dna_decode_row_plain on the
    same inputs, raises at the first difference in the planes (every
    position, copied bases included), final states, words consumed,
    registers or either updated table, appends (the row's arguments,
    which hold the row-start tables and the prefix source, and the plain
    result) to rows, and returns the plain result."""
    k2 = dna.dna_decode_row

    def both(cfg, state, length, words, x, ptr, regs, L, lcp=None, src=None,
             be=tables.LOCAL, loc=None, pos=None):
        args = (cfg, state, length, words, x, ptr, regs, L, lcp, src, loc,
                pos)
        want = dna.dna_decode_row_plain(*args[:10], be=be, loc=loc, pos=pos)
        work = state._replace(s_tc=state.s_tc.clone(),
                              b_tc=state.b_tc.clone())
        before = dna.K2_LAUNCHES
        got = k2(cfg, work, *args[2:10], be=be, loc=loc, pos=pos)
        if dna.K2_LAUNCHES != before + 1:
            raise RuntimeError("dna_decode_row did not launch K2")
        if got[4] is not work.s_tc or got[5] is not work.b_tc:
            raise RuntimeError("K2 did not return the tables it updated in "
                               "place")
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if err:
            bad = [n for g, w, n in zip(_flat(got), _flat(want), _OUT_NAMES)
                   if not torch.equal(g, w)]
            raise RuntimeError(f"K2 disagrees with the plain row step on "
                               f"{what}, row {len(rows)}: {', '.join(bad)}, "
                               f"max abs err {err}")
        if loc is not None:   # the batch updates its local state in place
            args = args[:10] + (tuple(t.clone() for t in loc), pos)
        rows.append((args, want))
        return want
    return both


def check_rows(cfg, state, lengths, words, init, L, lcp=None, pe=None,
               what="the batch"):
    """Decode one batch through dna.dna_decode_batch (with the batch's LCPs
    in sorted order, and pe: the keyword arguments of its pe stream and
    LCP stride, from real_dna_batch) with every read row checked
    (_row_checker): K2 against the plain row step. The batch goes on with
    the plain results, and the caller's state keeps its tables. Returns,
    a row, (its dna_decode_row arguments — cfg, state, length, words, x,
    ptr, regs, L, lcp, src, the in-batch local state the row read, or
    None, and its position map, or None —, the plain result)."""
    k2 = dna.dna_decode_row
    rows = []
    dna.dna_decode_row = _row_checker(rows, what)
    try:
        dna.dna_decode_batch(cfg, state, lengths, words, init, L, lcp=lcp,
                             **(pe or {}))
    finally:
        dna.dna_decode_row = k2
    return rows


def check_spec_rows(cfg, state, specs, words, init, L, what="the batch"):
    """check_rows for rows given one by one (utils/dna_batches.py
    pe_row_inputs): specs holds each row's (length, lcp, src, pos); x, the
    word cursor, the registers and the tables carry from row to row as in
    dna_decode_batch."""
    rows = []
    check = _row_checker(rows, what)
    N = cfg.n_lanes
    x, ptr = init, torch.zeros((), dtype=torch.int64, device=init.device)
    regs = torch.zeros((dna.K2_NREGS, N), dtype=torch.int64,
                       device=init.device)
    for length, lcp, src, pos in specs:
        _, x, ptr, regs, s_tc, b_tc = check(cfg, state, length, words, x,
                                            ptr, regs, L, lcp, src, pos=pos)
        state = state._replace(s_tc=s_tc, b_tc=b_tc)
    return rows


def chain_rows(rows, lanes=CHAIN_LANES):
    """The rows' K2 arguments cut to their first `lanes` lanes (the chain
    floor: the same dependent steps for one warp)."""
    def cut(t):
        return None if t is None else t[:lanes].contiguous()

    out = []
    for (cfg, st, length, words, x, ptr, regs, L, lcp, src, loc,
         pos), _ in rows:
        if pos is not None:
            pos = pos._replace(off=cut(pos.off), plen=cut(pos.plen))
        out.append((dataclasses.replace(cfg, n_lanes=lanes), st,
                    cut(length), words, cut(x), ptr,
                    regs[:, :lanes].contiguous(), L, cut(lcp), cut(src),
                    loc, pos))
    return out


def k2_launcher(entry=None):
    """A dna_decode_row for rows already checked (dna._check_k2): it
    launches `entry` (default K2's C entry point) with no checks and no
    launch count. A sorted row's check pulls its LCPs to the host, which a
    timed replay must not include."""
    entry = entry or _build.kernels().fqtz_dna_decode_row

    def launch(cfg, state, length, words, x, ptr, regs, L, lcp=None,
               src=None, loc=None, pos=None, be=tables.LOCAL):
        return dna._k2_launch(entry, cfg, state, length, words, x, ptr, regs,
                              L, lcp, src, loc, pos)
    return launch


def k2_updates(cfg) -> bool:
    """Whether K2 applies the row's s/b table update itself: canonical
    row-global tables (_k2_launch's row_update). Context-keyed row-global
    tables take it after K2, as torch ops (dna._dna_decode_row_cuda): not
    K2's work, so neither K2's bound nor its plain version counts it."""
    return cfg.row_global and cfg.canon


def plain_row(a):
    """K2's plain version on one row's dna_decode_row arguments a
    (check_rows'): the plain row step, without the table update where K2
    does not apply it (k2_updates). Such a config reads row_global nowhere
    else in the row: it keeps no local state (loc is None)."""
    cfg = a[0]
    if cfg.row_global and not k2_updates(cfg):
        cfg = dataclasses.replace(cfg, row_global=False)
    return dna.dna_decode_row_plain(cfg, *a[1:10], loc=a[10], pos=a[11])


def replay_ms(args, launch=None, reps=20):
    """ms a batch of `launch` (default K2, each row checked once before
    the timing) over rows' dna_decode_row arguments, the rows in order,
    timed with CUDA events. Every repetition runs on work copies of each
    row's tables, restored from the row-start ones before it and outside
    its timed region: K2 updates the tables in place, and a replay must
    not see its own events."""
    if launch is None:
        for a in args:
            dna._check_k2(*a[:10], tables.LOCAL, a[10], a[11])
        launch = k2_launcher()
    work = [(a, a[1].s_tc.clone(), a[1].b_tc.clone()) for a in args]
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps + 1)]
    for start, end in marks:            # the first repetition warms up
        for a, ws, wb in work:
            ws.copy_(a[1].s_tc)
            wb.copy_(a[1].b_tc)
        start.record()
        for a, ws, wb in work:
            launch(a[0], a[1]._replace(s_tc=ws, b_tc=wb), *a[2:])
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks[1:]) / reps


# Copies of K2's source with parts of the row's table update cut out,
# built at run time to time that update apart: (old, new) text pairs, each
# found once in csrc/dna_decode.cu.
_NO_ATOMICS = (("      apply_events<kFam>(ev_s, a.s_tc, s_w, end, N);\n"
                "      apply_events<kFam>(ev_b, a.b_tc, b_w, end, N);\n",
                ""),)
CUTS = {
    "K2 without the update's atomics": _NO_ATOMICS,
    "K2, the scan alone": _NO_ATOMICS + (
        ("        ev_s[static_cast<size_t>(i) * N] =\n", "        (void)\n"),
        ("        ev_b[static_cast<size_t>(i) * N] =\n",
         "        (void)\n")),
}


def cut_source(tag, cuts):
    """K2's source with `cuts` applied, written into the kernels' build
    directory as `<tag>.cu`; returns its path."""
    with open(os.path.join(_build._CSRC, "dna_decode.cu")) as fh:
        text = fh.read()
    for old, new in cuts:
        if text.count(old) != 1:
            raise RuntimeError(f"csrc/dna_decode.cu holds {old!r} "
                               f"{text.count(old)} times, not once")
        text = text.replace(old, new)
    os.makedirs(_build._BUILD_ROOT, exist_ok=True)
    path = os.path.join(_build._BUILD_ROOT, f"{tag}.cu")
    with open(path, "w") as fh:
        fh.write(text)
    return path


def variant(src, tag, n_args=len(dna.K2_ARGS)):
    """A dna_decode_row that launches K2 built from `src` (no checks, no
    launch count: k2_launcher). n_args: the length of that source's struct
    Args, a prefix of K2_ARGS (an earlier revision's: 41 before the local
    statistics' arguments)."""
    entry = _build.load_other(src, tag).fqtz_dna_decode_row
    return k2_launcher(lambda args, _, stream: entry(args, n_args, stream))


def _distinct(t):
    return int(torch.unique(t).numel())


def _rows_of(tc, q, log2_base):
    """Bucket rows of _canon_query results q in table tc."""
    return tables.kbucket_of(q[1][..., 0], q[0], tc.shape[0].bit_length() - 1,
                             log2_base)


def _query_rows(cfg, tc, win, k, log2_base):
    """Bucket rows in table tc of the width-k queries of windows win (the
    (lo, hi, rc lo, rc hi) halves): canonical, or context-keyed."""
    if cfg.canon:
        return _rows_of(tc, dna._canon_query(*win, k, log2_base), log2_base)
    return tables.bucket_of(win[0], win[1], tc.shape[0].bit_length() - 1,
                            log2_base)


def _local_cells(cfg, win, k):
    """Local cells of the width-k queries of windows win: the forward
    window's, or the canonical middle's (klocal)."""
    if cfg.canon:
        _, m_lo, m_hi = kmers.canon_strand(*win, k)
        return tables.local_keys(m_lo, m_hi, cfg.local_log2_cells)[0]
    return tables.local_keys(win[0], win[1], cfg.local_log2_cells)[0]


def k2_bound_ms(rows):
    """(ms, 'bytes' | 'operations'): the least time the card could take for
    these rows' K2 launches, each row's reads and writes as its data needs
    them. Bytes a launch: the distinct table rows (32 B for K2 cells, 48 B
    for ktable cells, 128 B for table cells) that its finds and its rough
    probes read, the distinct local cells (40 B for local_*, 72 B for
    klocal_*) of its s and b queries, the distinct SIV words (8 B) that its
    finds and its prefix ramp read, the distinct model rows (fine, and
    coarse with the mix, 20 B; the fine rows' deltas, 20 B),
    the words it consumes (4 B), lengths, states, registers and the pointer
    in and out, the four int64 [N, L] planes out, the table cells its
    update changes (8 B), and in sorted order the LCPs and the prefix
    source's copied bases (8 B each). Operations: K2_OPS_PER_POS an active
    lane-position and K2_OPS_PER_EVENT an insert event over the published
    32-bit rate. The update's cells and events count only where K2 applies
    it (k2_updates)."""
    nbytes = 0
    n_ops = 0
    for (cfg, st, length, words, x, ptr, regs, L, lcp, src, loc,
         pmap), want in rows:
        (_, kc, ctx, _), _, ptr_end, _, s_new, b_new = want
        N = length.shape[0]
        pos = torch.arange(L, device=kc.device)[None, :]
        (_, _, _, _, fs, fb), active = dna._window_parts(cfg, st, kc, length)
        s_w, b_w = cfg.smer_len - 1, cfg.bmer_len - 1
        sr = lambda t: kmers.shift_right(t, 1)
        s_win = tuple(sr(t) for t in (*kmers.pack_windows(kc, s_w),
                                      *kmers.pack_windows_rc(kc, s_w)))
        b_win = tuple(sr(t) for t in (*kmers.pack_windows(kc, b_w),
                                      *kmers.pack_windows_rc(kc, b_w)))
        s_rows = [_query_rows(cfg, st.s_tc, s_win, cfg.smer_len,
                              cfg.smer_log2_buckets)[
            active & (pos >= min(s_w, b_w))]]
        b_rows = _query_rows(cfg, st.b_tc, b_win, cfg.bmer_len,
                             cfg.bmer_log2_buckets)[active & (pos >= b_w)]
        if cfg.rough:
            # the rough probes: three s rows at each miss within s_w of its
            # run
            miss = active & (pos >= s_w) & ~fs & ~fb
            age = dna._miss_age(miss, pos.expand_as(miss))
            ok = miss & (age <= s_w - 1)
            r_q = dna._rough_queries(cfg, *s_win,
                                     torch.clamp(age, 0, s_w - 1))
            s_rows.append(_rows_of(st.s_tc, r_q, cfg.smer_log2_buckets)[
                ok[None].expand(3, -1, -1)])
        # the SIV: a word at each full window (below the pmer gate), and
        # the ramp's ranges
        pm = sr(kmers.pack_windows(kc, cfg.siv_len - 1)[0])
        vp = active & (pos >= cfg.siv_len - 1)
        if cfg.pmer_gate > 0:
            vp = vp & (pos < cfg.pmer_gate)
        siv = [pm[vp]]
        for q in dna._ramp_cols(cfg) if cfg.prefix_ramp else ():
            if q < L:
                w4 = 4 ** torch.arange(q - 1, -1, -1, device=kc.device)
                pfx = (kc[:, :q] * w4[None, :]).sum(dim=1)
                siv.append(dna._ramp_word_idx(cfg, pfx, q)[
                    active[:, q]].reshape(-1))
        fine = ctx.reshape(-1)
        model_rows = (torch.cat([fine, dna._n_model_ctx(cfg)
                                 + dna._coarse_ctx(cfg, fine)])
                      if cfg.mix_w > 0 else fine)
        if k2_updates(cfg):
            changed = int((s_new != st.s_tc).sum()
                          + (b_new != st.b_tc).sum())
            n_events = int((active & (pos >= s_w)).sum()
                           + (active & (pos >= b_w)).sum())
        else:
            changed = n_events = 0
        row_bytes = 8 * dna.table_family(cfg)[2]
        if loc is not None:
            # the local cells of the s and b queries (keyed as the finds)
            lw = 8 * loc[0].shape[1]
            nbytes += lw * sum(
                _distinct(_local_cells(cfg, win, k)[active & (pos >= k - 1)])
                for win, k in ((s_win, cfg.smer_len), (b_win, cfg.bmer_len)))
            if cfg.local_model_inc > 0:
                nbytes += 20 * _distinct(fine)
        n_ops += (int(active.sum()) * K2_OPS_PER_POS
                  + n_events * K2_OPS_PER_EVENT)
        nbytes += (row_bytes * (_distinct(torch.cat(s_rows))
                                + _distinct(b_rows))
                   + 8 * _distinct(torch.cat(siv))
                   + 20 * _distinct(model_rows)
                   + 4 * int(ptr_end - ptr) + 8 * N
                   + 2 * 8 * (N + dna.K2_NREGS * N + 1) + 4 * N * L * 8
                   + 8 * changed)
        if lcp is not None:
            nbytes += 8 * N + 8 * int(torch.minimum(lcp, length).sum())
        if pmap is not None:     # the map's per-lane arrays
            nbytes += 8 * N * (1 if pmap.plen is None else 2)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / INT_OPS_PER_S * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sorted", action="store_true",
                    help="the bench's sorted row (-om s) instead of the "
                    "primary row")
    ap.add_argument("--pe", action="store_true",
                    help="the bench's PE row (-p -om o -qm n -im n) instead "
                    "of the primary row")
    ap.add_argument("--pos", choices=("sorted", "pe"),
                    help="the sorted row with dna_sorted_ctx 1, or the PE "
                    "row with dna_pe_pos_ctx 1: K2's position maps (an "
                    "--other source must take them too)")
    ap.add_argument("--family", choices=("k2", *FAMILY_ROWS),
                    default="k2",
                    help="the s/b table family: K2 cells (the bench rows), "
                    "or an older writer's header (FAMILY_ROWS)")
    ap.add_argument("--other", action="append", default=[],
                    help="another CUDA source of K2 (its C entry point and "
                    "struct Args) to time beside it (repeatable)")
    ap.add_argument("--other-args", type=int, default=len(dna.K2_ARGS),
                    help="the length of the --other sources' struct Args "
                    "(41: a source from before the local statistics)")
    args = ap.parse_args()
    args.sorted = args.sorted or args.pos == "sorted"
    args.pe = args.pe or args.pos == "pe"
    if not torch.cuda.is_available():
        raise SystemExit("k2_compare: no CUDA device is visible")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as d:
        src, arc = os.path.join(d, "in.fastq"), os.path.join(d, "o.fqst")
        if args.pe:
            src2 = os.path.join(d, "in_2.fastq")
            write_pe_corpus(src, src2, 10_000, 100, 4_600_000, seed=42)
            p = cli.parse_args(["e", *PE_ROW, src, src2])
            p.dna_pe_pos_ctx = int(args.pos == "pe")
            pipeline.compress_pe(p, src, src2, arc)
        else:
            write_fastq_corpus(src, 20_000, 100, 4_600_000, seed=42)
            row = SORTED_ROW if args.sorted else BENCH_ROW
            p = cli.parse_args(["e", *row, src])
            p.dna_sorted_ctx = int(args.pos == "sorted")
            if args.family != "k2":
                gen, row = FAMILY_ROWS[args.family]
                p = header_generation(cli.parse_args(["e", *row, src]), gen)
            pipeline.compress_file(p, src, arc)
        batch = real_dna_batch(arc)
    rows = check_rows(*batch)
    L = batch[5]
    steps = len(rows) * L
    row_args = [a for a, _ in rows]
    runs = [("K2", None, True)]
    cut_runs = CUTS if k2_updates(batch[0]) else {}
    for k, (name, cuts) in enumerate(cut_runs.items()):
        runs.append((name, variant(cut_source(f"k2_cut{k}", cuts),
                                   f"k2_cut{k}"), False))
    for k, src in enumerate(args.other):
        runs.append((src, variant(src, f"k2_other{k}", args.other_args),
                     True))
    for name, launch, updates in runs[1:]:      # every run is exact
        for a, want in rows:
            st = a[1]
            got = launch(a[0], st._replace(s_tc=st.s_tc.clone(),
                                           b_tc=st.b_tc.clone()), *a[2:])
            torch.cuda.synchronize()
            if not updates:
                want = (*want[:4], st.s_tc, st.b_tc)
            if max_abs_err(got, want):
                raise RuntimeError(f"{name} differs from the plain row step")
    times = {name: [] for name, _, _ in runs}
    for name, launch, _ in runs + runs[::-1]:
        times[name].append(replay_ms(row_args, launch))
    for name, t in times.items():
        print(f"{name}: {t[0]:.4f} ms, {t[1]:.4f} ms a batch "
              f"({t[0] / steps * 1e3:.2f} us a step)")
    mean = {name: sum(t) / len(t) for name, t in times.items()}
    for name in cut_runs:
        d_ms = mean["K2"] - mean[name]
        print(f"K2 minus {name}: {d_ms:.4f} ms a batch, "
              f"{d_ms / len(rows):.4f} ms a row")
    chain = chain_rows(rows)
    floor_ms = replay_ms(chain)
    plain_ms = replay_ms(row_args, lambda *a: plain_row(a), 2)
    bound, by = k2_bound_ms(rows)
    if args.sorted or args.pe:
        name = ("sorted" if args.sorted else "PE") + (
            f" (the {args.pos} position map)" if args.pos else "")
    else:
        name = ("main" if args.family == "k2" else
                f"{FAMILY_ROWS[args.family][0]} ({args.family} cells)")
    print(f"the {name} path's batch "
          f"({len(rows)} rows, {steps} steps): chain "
          f"floor ({CHAIN_LANES} lanes) {floor_ms:.4f} ms, plain torch "
          f"{plain_ms:.2f} ms, bound {bound:.4f} ms by {by}")
    if args.pe:
        pe_ms, n_calls = pe_row_end_ms(batch)
        print(f"the row-end PE step (dna._pe_row_end, torch ops): "
              f"{pe_ms:.4f} ms a batch ({n_calls} calls, "
              f"{pe_ms / n_calls:.4f} ms a call), against K2's "
              f"{sum(times['K2']) / 2:.4f} ms")
    return 0


def pe_row_end_ms(batch, reps=5):
    """(ms a batch, calls) of the row-end PE steps of a PE batch
    (real_dna_batch's), timed with CUDA events around each call inside a
    whole decode of the batch (K2 on the row's tables each repetition:
    fresh copies, restored before it)."""
    cfg, state, lengths, words, init, L, lcp, pe = batch
    real = dna._pe_row_end
    spans = []

    def timed_step(*a, **k):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in (0, 1))
        start.record()
        out = real(*a, **k)
        end.record()
        spans.append((start, end))
        return out

    dna._pe_row_end = timed_step
    try:
        for _ in range(reps + 1):
            work = state._replace(s_tc=state.s_tc.clone(),
                                  b_tc=state.b_tc.clone())
            dna.dna_decode_batch(cfg, work, lengths, words, init, L,
                                 lcp=lcp, **pe)
    finally:
        dna._pe_row_end = real
    torch.cuda.synchronize()
    n = len(spans) // (reps + 1)
    ms = sum(s.elapsed_time(e) for s, e in spans[n:]) / reps
    return ms, n


if __name__ == "__main__":
    raise SystemExit(main())
