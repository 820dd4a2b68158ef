"""Compress and decompress orchestration — single-end and paired-end reads.

Port of fqsqueezer_tpu/pipeline.py's single-device path: single-end (SE)
and paired-end (PE) reads, original and sorted read order (-om o|s),
every quality mode (-qm o|8|4|2|n) and id mode (-im o|i|n), from RAM or
block-streamed (original order in every id mode, SE sorted order with
-im n through the external bin sort). PE interleaves the mates (even
reads mate 1, odd reads mate 2; batches hold whole pairs) and, with the
anchor machinery on, adds the pe stream (streams/dna.py, streams/pe.py);
PE sorted order sorts the pairs by mate 1 (compress_pe). Sorted order
sorts the reads (io.fastq.sort_order), codes each read's shared prefix
with the previous read of its lane as a meta symbol (meta.compute_lcp)
and leaves those bases out of the DNA stream; the decoder copies them
from the previous read row. Batches are modeled forward on
the device (tables and models evolve), their (freq, cum) grids are kept on
the device, and at each group flush every stream's grids are entropy-coded
as one reverse rANS walk each — all streams in one launch of kernel K1 on a
CUDA device — so lane states chain across the group and one state block per
stream is stored. Decompression replays it batch by batch: each batch's
words are decoded forward from the lane states the previous batch left
(meta, then DNA, then quality — K3 on a CUDA device — then ids), the state
evolves as the encoder's did, and the group end replays the encoder's
table growth. Ids are tokenized on the host into per-read planes chained
in file order (streams/ids.py); the chain restarts at every group.
The header, container, batch geometry and group boundaries are the
reference package's (through this package's own copies of params,
archive and io.fastq), so the archives are byte-identical to
fqsqueezer_tpu.pipeline.compress_file's.

Every function that creates state takes an explicit `device`. The entry
points compress_file and decompress_file run on the first CUDA card unless
the caller names another device; they never fall back to the CPU.
"""
from __future__ import annotations

import os
import zlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import archive
from .io import fastq
from .ops import models, rans, tables
from .params import DnaMode, IdMode, Params, QualityMode
from .streams import common, dna, ids, meta, quality


class CodecState(NamedTuple):
    dna: dna.DnaState
    meta: torch.Tensor
    qual: Optional[torch.Tensor]
    id: Optional[torch.Tensor] = None


def make_configs(p: Params):
    """(DnaConfig, QualConfig | None, MetaConfig, IdConfig | None) from
    Params — the same mapping as fqsqueezer_tpu.pipeline.make_configs."""
    is_pe = p.dna_mode in (DnaMode.PE_ORIGINAL, DnaMode.PE_SORTED)
    row_global = p.dna_row_global > 0
    dcfg = dna.DnaConfig(
        siv_len=p.siv_len, smer_len=p.smer_len, bmer_len=p.bmer_len,
        prefix_len=p.prefix_len, scale_bits=p.scale_bits, n_lanes=p.n_lanes,
        smer_log2_buckets=p.smer_log2_buckets,
        bmer_log2_buckets=p.bmer_log2_buckets,
        row_global=row_global,
        local_log2_cells=0 if row_global else p.local_log2_cells,
        local_model_inc=p.local_model_inc,
        canon=p.dna_canon > 0,
        mix_w=p.dna_mix_w, mix_b=p.dna_mix_b,
        repair_iters=p.dna_repair_iters,
        claim_rounds=p.dna_claim_rounds,
        local_lite=p.dna_local_lite > 0,
        local_rc=p.dna_local_rc > 0,
        pmer_gate=p.dna_pmer_gate,
        prefix_ramp=p.dna_prefix_ramp > 0,
        sorted_ctx=(p.dna_sorted_ctx > 0
                    and p.dna_mode in (DnaMode.SE_SORTED, DnaMode.PE_SORTED)),
        pe_log2_buckets=p.pe_log2_buckets if is_pe and (
            p.mesh_dp * p.mesh_tp <= 1 or p.dna_pe_mesh > 0) else 0,
        pe_pos_ctx=p.dna_pe_pos_ctx > 0,
        ctx_v=p.dna_ctx_v,
        rough=1 if (p.dna_rough > 0 and row_global and p.dna_canon > 0
                    and p.dna_ctx_v >= 2) else 0,
        sb_proto=p.dna_sb_proto if p.dna_canon > 0 else 0,
        route_sb=1 if (p.mesh_route_sb > 0 and p.mesh_dp * p.mesh_tp > 1
                       and row_global and p.dna_canon > 0) else 0,
        let_pb2=p.dna_let_pb2)
    qcfg = None
    if p.quality_mode != QualityMode.NONE:
        qcfg = quality.QualConfig(
            mode=p.quality_mode.value, qt=p.quality_thr,
            scale_bits=p.scale_bits, n_lanes=p.n_lanes,
            with_local=p.local_log2_cells > 0 and p.local_model_inc > 0,
            local_inc=p.local_model_inc)
    mcfg = meta.MetaConfig(
        scale_bits=p.scale_bits, n_lanes=p.n_lanes,
        with_lcp=p.dna_mode in (DnaMode.SE_SORTED, DnaMode.PE_SORTED),
        lcp_stride=2 if is_pe else 1)
    icfg = None
    if p.id_mode != IdMode.NONE:
        icfg = ids.IdConfig(max_id_len=p.max_id_len,
                            n_fields=p.id_n_fields, scale_bits=p.scale_bits,
                            n_lanes=p.n_lanes, codec_v=p.id_codec_v)
    return dcfg, qcfg, mcfg, icfg


def state_create(dcfg, qcfg, icfg=None, device=None) -> CodecState:
    return CodecState(
        dna=dna.dna_state_create(dcfg, device),
        meta=meta.meta_state_create(device),
        qual=None if qcfg is None else quality.qual_state_create(qcfg,
                                                                 device),
        id=None if icfg is None else ids.id_state_create(device))


def _model_rows(dcfg, qcfg, mcfg, icfg, state: CodecState,
                codes: torch.Tensor, qsyms: Optional[torch.Tensor],
                lengths: torch.Tensor, id_batch=(), n_valid=None,
                kcodes: Optional[torch.Tensor] = None):
    """Modeling of one batch, or of one dp shard of a mesh batch, against
    `state`, which is left as it was. codes: [R, L] int64 base codes (N =
    4), kcodes: the k-mer codes the DNA rows start from (default: codes
    with N as 0), qsyms: [R, L] int64 quantized qualities (None without a
    quality stream), lengths: [R] int64, id_batch: the encode_ids_host
    planes as tensors (with an id stream), n_valid: the real reads.
    Returns (grids, events, (s_tc, b_tc)): the (freq, cum) int32 [T, N]
    lane grids of each stream (meta, dna, then qual, id and pe where
    present), the batch's events as collect_batch takes them, and the s/b
    tables the DNA row loop carried (batch-frozen ones: the state's). A PE
    batch has its pairs interleaved; with the anchors on, the DNA codec
    models the anchored 3-row recoding (dna.dna_pe_encode) and the pe
    stream's grid is the last."""
    lcp = (meta.compute_lcp(codes, lengths, mcfg.n_lanes, mcfg.lcp_stride)
           if mcfg.with_lcp else None)
    m_ctx, m_syms, m_f, m_c = meta.meta_modeling(mcfg, state.meta, lengths,
                                                 lcp)

    # the DNA codec's rows: the reads, or with the PE anchors their
    # anchored 3-row recoding
    d_codes, d_lengths, d_lcp, anchor_mask = codes, lengths, lcp, None
    pos_map, pe_ev = None, ()
    if dcfg.pe_log2_buckets > 0:
        (d_codes, d_lengths, anchor_mask, d_lcp, pe_syms, pe_act, pe_f, pe_c,
         pos_map) = dna.dna_pe_encode(dcfg, state.dna, codes, lengths,
                                      lcp=lcp)
        pe_ev = (pe_syms, pe_act)
        kcodes = None          # the recoded rows have their own
    if kcodes is None:
        kcodes = torch.where(d_codes >= 4, 0, d_codes)
    (eff, d_ctx, d_sym, d_f, d_c, d_act, s_tc,
     b_tc) = dna.dna_process_batch(
        dcfg, state.dna, d_codes, kcodes, d_lengths, lcp=d_lcp,
        anchor_mask=anchor_mask, pos_map=pos_map)

    grid = common.lane_grid
    grids = [(grid(m_f, mcfg.n_lanes), grid(m_c, mcfg.n_lanes)),
             (grid(d_f, dcfg.n_lanes), grid(d_c, dcfg.n_lanes))]
    q_ev = i_ev = None
    if qcfg is not None:
        q_ctx, q_f, q_c, q_act = quality.qual_modeling(
            qcfg, state.qual, qsyms, lengths)
        q_ev = (q_ctx, qsyms, q_act)
        grids.append((grid(q_f, qcfg.n_lanes), grid(q_c, qcfg.n_lanes)))
    if icfg is not None:
        i_ctx, i_syms, i_f, i_c, i_act = ids.id_modeling(
            icfg, state.id, *id_batch, n_valid=n_valid)
        i_ev = (i_ctx, i_syms, i_act)
        grids.append((grid(i_f, icfg.n_lanes), grid(i_c, icfg.n_lanes)))
    if pe_ev:
        grids.append((grid(pe_f, dcfg.n_lanes), grid(pe_c, dcfg.n_lanes)))
    events = ((m_ctx, m_syms),
              (d_codes, eff, d_lengths, d_ctx, d_sym, d_act) + pe_ev,
              q_ev, i_ev)
    return grids, events, (s_tc, b_tc)


def collect_batch(dcfg, state: CodecState, m_ev, dna_ev, q_ev, i_ev,
                  codes_true, lengths_true,
                  skip_sb: bool = False) -> CodecState:
    """A batch's state update from its events (each the batch's, or its
    dp shards' concatenated in shard order): the meta model from (ctx,
    syms), the DNA state from its rows' (codes, eff, lengths, ctx, sym,
    active[, pe_syms, pe_act]) — codes_true, lengths_true: the
    interleaved reads the pair table takes with the PE anchors — the
    quality and id models from (ctx, syms, active) where present.
    skip_sb: the s/b tables in `state` already took the batch's rows (a
    single device's row loop over row-global tables); without it
    batch-frozen tables take the batch's s/b events, and row-global ones
    (a mesh batch, whose shards modeled against the batch-frozen tables)
    the rows' events replayed row block by row block
    (dna.dna_collect_updates)."""
    m_model = models.model_update(
        state.meta, m_ev[0].reshape(-1), m_ev[1].reshape(-1),
        torch.ones(m_ev[0].numel(), dtype=torch.bool,
                   device=m_ev[0].device))
    d_codes, eff, d_lengths, d_ctx, d_sym, d_act, *pe_ev = dna_ev
    pe_kw = {}
    if pe_ev:
        pe_kw = dict(pe_syms=pe_ev[0], pe_act=pe_ev[1],
                     codes_true=codes_true, lengths_true=lengths_true)
    d_state = dna.dna_collect_updates(
        dcfg, state.dna, d_codes, eff, d_lengths, d_ctx, d_sym, d_act,
        skip_sb=skip_sb, **pe_kw)
    q_model = i_model = None
    if q_ev is not None:
        q_model = models.model_update(state.qual,
                                      *(a.reshape(-1) for a in q_ev))
    if i_ev is not None:
        i_model = models.model_update(state.id,
                                      *(a.reshape(-1) for a in i_ev))
    return CodecState(dna=d_state, meta=m_model, qual=q_model, id=i_model)


def _model_batch(dcfg, qcfg, mcfg, icfg, state: CodecState,
                 codes: torch.Tensor, qsyms: Optional[torch.Tensor],
                 lengths: torch.Tensor, id_batch=(), n_valid=None,
                 kcodes: Optional[torch.Tensor] = None):
    """Modeling + state evolution of one batch on one device (_model_rows,
    then collect_batch on the tables the row loop carried, or on the
    batch-frozen ones). Returns (grids, new state)."""
    grids, events, (s_tc, b_tc) = _model_rows(
        dcfg, qcfg, mcfg, icfg, state, codes, qsyms, lengths, id_batch,
        n_valid, kcodes)
    rows = state._replace(dna=state.dna._replace(s_tc=s_tc, b_tc=b_tc))
    return grids, collect_batch(dcfg, rows, *events, codes, lengths,
                                skip_sb=dcfg.row_global)


def _step_inputs(qcfg, icfg, codes, kcodes, lengths, qsyms, id_batch):
    """A single-step encode's inputs as _model_rows takes them: int64
    tensors on codes' device (qsyms None without a quality stream,
    id_batch () without an id stream)."""
    codes = torch.as_tensor(codes).to(torch.int64)
    on = lambda a: torch.as_tensor(a).to(codes.device)
    return (codes, on(kcodes).to(torch.int64), on(lengths).to(torch.int64),
            None if qcfg is None else on(qsyms).to(torch.int64),
            tuple(on(a) for a in id_batch) if icfg is not None else ())


def _encode_batch(dcfg, qcfg, mcfg, icfg, state: CodecState, codes,
                  kcodes, lengths, qsyms, id_batch):
    """One batch modeled and coded from fresh lanes, every stream's walk
    in one K1 launch on a CUDA device: the reference's single-step encode
    (no group chaining; the file pipeline codes at its group flush).
    codes, kcodes: [R, L], lengths: [R], qsyms: [R, L] (unused without a
    quality stream), id_batch: the encode_ids_host planes (unused without
    an id stream); any integer dtype. Returns ((words, n_words, states)
    of meta, of id, of dna, of qual, new state) — an absent stream's
    words and states are empty and its n_words 0."""
    codes, kcodes, lengths, qsyms, id_batch = _step_inputs(
        qcfg, icfg, codes, kcodes, lengths, qsyms, id_batch)
    grids, new_state = _model_batch(dcfg, qcfg, mcfg, icfg, state, codes,
                                    qsyms, lengths, id_batch, kcodes=kcodes)
    coded = [(w, w.numel(), x) for w, _, x in
             rans.rans_encode_fresh(grids, dcfg.scale_bits)]
    empty = (codes.new_zeros((0,), dtype=torch.int32), 0,
             codes.new_zeros((0,)))
    m_out, d_out = coded[0], coded[1]
    q_out = coded[2] if qcfg is not None else empty
    i_out = coded[2 + (qcfg is not None)] if icfg is not None else empty
    return m_out, i_out, d_out, q_out, new_state


def _decode_batch(dcfg, qcfg, mcfg, icfg, R: int, L: int,
                  state: CodecState, streams, n_valid: int):
    """Decode one padded batch of R reads and L columns. streams: (words,
    initial lane states) of each stream the batch has, in archive order
    (meta, dna, then qual, id and pe where present). Returns (lengths [R]
    int64, codes [R, L] uint8, qsyms [R, L] uint8 or None, the id planes
    or None, new state, the streams' final lane states) — the last chain
    into the group's next batch. A PE batch's reads are interleaved."""
    (m_words, m_states), (d_words, d_states), *rest = streams
    pe_words = pe_states = None
    if dcfg.pe_log2_buckets > 0:
        pe_words, pe_states = rest.pop()
    lengths, lcp, m_model, m_x, _ = meta.meta_decode_batch(
        mcfg, state.meta, R, m_words, m_states)
    lengths = torch.clamp(lengths, max=L)
    codes, d_state, d_x, _, d_extras = dna.dna_decode_batch(
        dcfg, state.dna, lengths, d_words, d_states, L,
        lcp=lcp if mcfg.with_lcp else None, lcp_stride=mcfg.lcp_stride,
        pe_words=pe_words, pe_states=pe_states)
    final = [m_x, d_x]
    qsyms = q_model = None
    if qcfg is not None:
        q_words, q_states = rest.pop(0)
        qsyms, q_model, q_x, _ = quality.qual_decode_batch(
            qcfg, state.qual, lengths, q_words, q_states, L)
        # u8 planes keep the device-to-host pull at about a byte a base
        qsyms = qsyms.to(torch.uint8)
        final.append(q_x)
    id_planes = i_model = None
    if icfg is not None:
        i_words, i_states = rest.pop(0)
        (*id_planes, i_model, i_x, _) = ids.id_decode_batch(
            icfg, state.id, R, i_words, i_states, n_valid)
        final.append(i_x)
    if pe_words is not None:
        final.append(d_extras[4])
    return (lengths, codes.to(torch.uint8), qsyms, id_planes,
            CodecState(dna=d_state, meta=m_model, qual=q_model, id=i_model),
            final)


def _group_grid(fcs, scale_bits: int, n_lanes: int):
    """One stream's group grid: its per-batch (f, c) grids concatenated in
    batch order, the rows padded to GROUP_PAD_ROWS with exact no-ops.
    Returns ((f, c), row_bounds [K + 1]) on the grids' device."""
    rows = [int(f.shape[0]) for f, _ in fcs]
    bounds = np.concatenate([[0], np.cumsum(rows)]).astype(np.int64)
    T = int(bounds[-1])
    T_pad = -(-T // rans.GROUP_PAD_ROWS) * rans.GROUP_PAD_ROWS
    dev = fcs[0][0].device
    pad_f = [torch.full((T_pad - T, n_lanes), 1 << scale_bits,
                        dtype=torch.int32, device=dev)] if T_pad > T else []
    pad_c = [torch.zeros((T_pad - T, n_lanes), dtype=torch.int32,
                         device=dev)] if T_pad > T else []
    f = torch.cat([f for f, _ in fcs] + pad_f, dim=0)
    c = torch.cat([c for _, c in fcs] + pad_c, dim=0)
    return (f, c), torch.from_numpy(bounds).to(dev)


GROW_MAX_DOUBLINGS = 4     # growth bits available in cell tags
GROW_NUM, GROW_DEN = 6, 10  # grow when used/capacity > 0.6
SIV_PRUNE_NUM, SIV_PRUNE_DEN = 5, 10  # prune singletons when fill > 0.5


def fill_stats_device(dcfg, dna_state) -> torch.Tensor:
    """[s_used, b_used, siv_nz] as one device tensor."""
    su, _ = tables.sb_fill_stats(dna_state.s_tc)
    bu, _ = tables.sb_fill_stats(dna_state.b_tc)
    nz, _ = tables.siv_fill(dna_state.siv)
    return torch.stack([su, bu, nz])


def grow_tables(dcfg, dna_state, verbosity: int = 0, stats=None):
    """Group-boundary growth of the s/b tables (double when fill > 0.6) and
    SIV singleton pruning (when fill > 0.5) — the reference package's rule,
    run by encoder and decoder on identical state. stats: host values of
    fill_stats_device, when the caller already pulled them."""
    new = dna_state
    if stats is None:
        stats = fill_stats_device(dcfg, dna_state).cpu().numpy()
    for pre, base, used in (("s", dcfg.smer_log2_buckets, int(stats[0])),
                            ("b", dcfg.bmer_log2_buckets, int(stats[1]))):
        tc = getattr(new, pre + "_tc")
        cur = tc.shape[0].bit_length() - 1
        cap = tc.shape[0] * tables.sb_cells(tc)
        if verbosity >= 2:
            print(f"  {pre}mer fill: {used}/{cap} ({used / cap:.3f})"
                  f" [2^{cur} buckets]")
        if cur - base < GROW_MAX_DOUBLINGS and used * GROW_DEN > cap * GROW_NUM:
            new = new._replace(**{pre + "_tc": tables.sb_grow(tc, base)})
            if verbosity >= 1:
                print(f"  {pre}mer table grown to 2^{cur + 1} buckets "
                      f"(fill {used / cap:.2f})")
    new = new._replace(s_tc=tables.sb_clamp(new.s_tc),
                       b_tc=tables.sb_clamp(new.b_tc))
    nz = int(stats[2])
    cap = 4 * new.siv.shape[0]
    if verbosity >= 2:
        print(f"  siv fill: {nz}/{cap} ({nz / cap:.3f})")
    if nz * SIV_PRUNE_DEN > cap * SIV_PRUNE_NUM:
        new = new._replace(siv=tables.siv_prune(new.siv))
        if verbosity >= 1:
            print(f"  siv pruned (fill {nz / cap:.2f})")
    return new


def payload_crc(crc: int, codes_u8: np.ndarray, lengths: np.ndarray) -> int:
    """Rolling crc32 of the sequence payload (codes + lengths)."""
    crc = zlib.crc32(np.ascontiguousarray(codes_u8, dtype=np.uint8), crc)
    return zlib.crc32(lengths.astype("<i4").tobytes(), crc)


# --- batch geometry: verbatim from fqsqueezer_tpu.pipeline ---------------

def batch_schedule(n_reads: int, n_lanes: int, max_batch: int,
                   first_batch: int = 0, align: int = 0):
    """Doubling batch sizes [first, 2*first, ...] capped at max_batch;
    intermediate sizes are padded to max_batch. Returns (start, take,
    padded) triples."""
    align = align or n_lanes
    first_batch = _first_batch(n_lanes, max_batch, first_batch, align)
    out = []
    start = 0
    size = first_batch
    while start < n_reads:
        take = min(size, n_reads - start)
        out.append((start, take,
                    canonical_padded(take, first_batch, max_batch, align)))
        start += take
        size = min(size * 2, max_batch)
    return out


def _first_batch(n_lanes: int, max_batch: int, first_batch: int, align: int):
    if not first_batch:
        first_batch = max_batch // 16
    first_batch = max(min(first_batch, max_batch), align)
    return -(-first_batch // align) * align


def canonical_padded(take: int, first_batch: int, max_batch: int, align: int):
    """Canonical padded shape of a batch of `take` reads."""
    padded = -(-take // align) * align
    return first_batch if padded <= first_batch else max_batch


def _pad_batch(arr: np.ndarray, padded: int):
    take = arr.shape[0]
    if take == padded:
        return arr
    pad_shape = (padded - take,) + arr.shape[1:]
    return np.concatenate([arr, np.zeros(pad_shape, arr.dtype)], axis=0)


# --- block-streamed input ------------------------------------------------

def _fifo_pop(pend: list, take: int) -> fastq.FastqData:
    """Pop exactly `take` reads off a FIFO of FastqData chunks (splitting the
    head chunk if needed) as one FastqData."""
    got, need = [], take
    while need:
        d = pend[0]
        if d.n_reads <= need:
            got.append(d)
            pend.pop(0)
            need -= d.n_reads
        else:
            got.append(fastq.FastqData(d.codes[:need], d.quals[:need],
                                       d.lengths[:need], d.ids[:need]))
            pend[0] = fastq.FastqData(d.codes[need:], d.quals[need:],
                                      d.lengths[need:], d.ids[need:])
            need = 0
    return got[0] if len(got) == 1 else fastq.concat_fastq(got)


def _stream_ids(paths, chunk_bytes: int):
    """The ids of the files' complete records, a list a chunk of about
    chunk_bytes, as stream_fastq's parser keeps them (the header line
    without its first byte and a trailing CR): only header lines become
    Python objects. A last line without a newline counts, as in the
    parser; an unfinished last record does not."""
    for path in paths:
        with open(path, "rb") as f:
            tail, line_no, pending = b"", 0, []
            while True:
                blob = f.read(chunk_bytes)
                if not blob and not tail:
                    break
                buf = tail + (blob or b"\n")   # the parser ends a last line
                arr = np.frombuffer(buf, np.uint8)
                nl = np.flatnonzero(arr == 10)
                starts = np.concatenate([[0], nl + 1])[:nl.size]
                ln = line_no + np.arange(nl.size)
                for a, b in zip(starts[ln % 4 == 0].tolist(),
                                nl[ln % 4 == 0].tolist()):
                    if b > a and buf[b - 1] == 13:
                        b -= 1
                    # headers and record ends alternate: a header waits for
                    # the end of its record's fourth line
                    pending.append(buf[a + 1:b])
                done = int((ln % 4 == 3).sum())
                out, pending = pending[:done], pending[done:]
                line_no += nl.size
                tail = buf[int(nl[-1]) + 1:] if nl.size else buf
                if out:
                    yield out
                if not blob:
                    break


def _prescan_ids_stream(paths, p: Params, chunk_bytes: int):
    """Id template prescan over block-streamed input: the max id length and
    numeric-field count the archive header fixes — what the in-RAM path
    reads off the whole id list, and the values of the reference package's
    prescan — from the files' header lines alone (_stream_ids), host memory
    O(chunk). Instrument mode measures the transformed prefixes."""
    max_len, nf = 8, 1
    for idl in _stream_ids(paths, chunk_bytes):
        if p.id_mode == IdMode.INSTRUMENT:
            idl = ids.instrument_prefix(idl)
        max_len = max(max_len, max(len(s) for s in idl))
        nf = max(nf, ids.count_fields(idl))
    return max_len, nf


def _stream_interleaved_pe(paths, chunk_bytes: int):
    """Two streamed cursors over the mate files, in step, yielding
    interleaved FastqData chunks (pairs adjacent, an even read count) —
    the reference package's paired chunk reader, except that each mate
    reads chunks of half chunk_bytes, so the two buffers and the
    interleaved copy stay near chunk_bytes in all. A mate-count mismatch
    raises the reference's error, whose count is the unpaired reads
    buffered when the shorter file ended (not those left in the longer
    file). Chunk sizes do not change an archive: batches are cut from the
    stream as batch_schedule cuts them."""
    in1, in2 = paths
    its = [iter(fastq.stream_fastq(in1, max(1, chunk_bytes // 2))),
           iter(fastq.stream_fastq(in2, max(1, chunk_bytes // 2)))]
    bufs = ([], [])
    counts = [0, 0]
    done = [False, False]

    def refill(i):
        while not done[i] and counts[i] == 0:
            c = next(its[i], None)
            if c is None:
                done[i] = True
            elif c.n_reads:
                bufs[i].append(c)
                counts[i] += c.n_reads

    while True:
        refill(0)
        refill(1)
        k = min(counts)
        if k == 0:
            if counts[0] != counts[1]:
                raise ValueError(
                    f"PE mate counts differ (stream): one mate file ended "
                    f"with {max(counts)} unpaired reads in the other")
            break
        d1 = _fifo_pop(bufs[0], k)
        d2 = _fifo_pop(bufs[1], k)
        counts[0] -= k
        counts[1] -= k
        yield interleave_pe(d1, d2)


def _stream_batches(paths, p: Params, chunk_bytes: int):
    """Doubling-schedule batches from block-streamed input, the sizes
    batch_schedule gives, so the archive equals the in-RAM path's: FASTQ
    chunks (stream_fastq; external_sort_stream in SE sorted order; the
    paired chunk reader in PE original order, whose batches hold whole
    pairs: every size a multiple of 2 * n_lanes) are buffered FIFO and cut
    into batches; host memory stays O(chunk + batch). Yields (FastqData
    batch, take, padded)."""
    is_pe = p.dna_mode == DnaMode.PE_ORIGINAL
    align = 2 * p.n_lanes if is_pe else p.n_lanes
    first = _first_batch(p.n_lanes, p.max_batch_reads, 0, align)
    size = first
    pend: list = []    # FIFO of parsed chunks not yet batched
    n_pend = 0
    source = (fastq.external_sort_stream(paths, chunk_bytes)
              if p.dna_mode == DnaMode.SE_SORTED
              else _stream_interleaved_pe(paths, chunk_bytes) if is_pe
              else fastq.stream_fastq(paths, chunk_bytes))

    def pop(take):
        nonlocal n_pend
        n_pend -= take
        return _fifo_pop(pend, take)

    for chunk in source:
        if chunk.n_reads == 0:
            continue
        pend.append(chunk)
        n_pend += chunk.n_reads
        while n_pend >= size:
            yield (pop(size), size,
                   canonical_padded(size, first, p.max_batch_reads, align))
            size = min(size * 2, p.max_batch_reads)
    while n_pend > 0:
        take = min(size, n_pend)
        yield (pop(take), take,
               canonical_padded(take, first, p.max_batch_reads, align))
        size = min(size * 2, p.max_batch_reads)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device`, or the first CUDA card
    when the caller names none. Raises RuntimeError when a CUDA device is
    asked for and none is visible — there is no fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible to torch; pass device=\"cpu\" "
                "(--device cpu on the command line) to ask for the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{dev} asked for, but torch sees "
                f"{torch.cuda.device_count()} CUDA device(s)")
    return dev


def compress_file(p: Params, in_path: str, out_path: str,
                  data: Optional[fastq.FastqData] = None,
                  group_mem_bytes: int = 512 << 20,
                  snapshot_prefix: Optional[str] = None, device=None,
                  stream_chunk_bytes: int = 0) -> dict:
    """Compression, original or sorted order, of an in-RAM input (`data`,
    or the parsed `in_path`) into `out_path`, on `device` (default: the
    first CUDA card; see resolve_device). Returns the same stats dict as
    the reference package. With an id stream, p.max_id_len and
    p.id_n_fields are set from the input before the header is written, as
    the reference does. A PE input comes as `data` with its pairs
    interleaved (compress_pe), or streamed.

    snapshot_prefix: after each group's table growth, save the codec state
    (checkpoint.save_state) at checkpoint.snapshot_path(prefix, g + 1) for
    group g — what a decoder needs to start at the next group. Snapshots
    change no archive byte.

    stream_chunk_bytes > 0 (and no `data`) block-streams the input in
    chunks of about that size instead of loading it: original order in
    every id mode (a prescan of the header lines fixes the id geometry
    first; PE through the paired chunk reader, the two mate files as
    in_path), SE sorted order through the external bin sort, which
    carries no ids, so only with -im n. The archive is the in-RAM path's,
    byte for byte."""
    in_paths = list(in_path) if isinstance(in_path, (list, tuple)) else [
        in_path]
    is_pe = p.dna_mode in (DnaMode.PE_ORIGINAL, DnaMode.PE_SORTED)
    streaming = stream_chunk_bytes > 0 and data is None
    if streaming:
        if p.dna_mode == DnaMode.PE_SORTED:
            raise ValueError(
                "streamed compression does not support -om s with PE "
                "(sorting pairs by mate1 needs the whole input)")
        if p.dna_mode == DnaMode.SE_SORTED and p.id_mode != IdMode.NONE:
            raise ValueError(
                "streamed sorted-mode compression requires -im n "
                "(the external bin sort does not carry ids)")
        if p.dna_mode == DnaMode.PE_ORIGINAL and len(in_paths) != 2:
            raise ValueError("streamed PE compression needs two mate files")
    device = resolve_device(device)
    if data is None and not streaming:
        data = (fastq.concat_fastq([fastq.read_fastq(f) for f in in_paths])
                if len(in_paths) > 1 else fastq.read_fastq(in_paths[0]))
    if data is not None and p.dna_mode == DnaMode.SE_SORTED:
        order = fastq.sort_order(data.codes, data.lengths)
        data = fastq.FastqData(
            codes=data.codes[order], quals=data.quals[order],
            lengths=data.lengths[order], ids=[data.ids[i] for i in order])

    id_list = data.ids if data is not None else []
    if p.id_mode == IdMode.INSTRUMENT:
        id_list = ids.instrument_prefix(id_list)
    id_chain = None
    if p.id_mode != IdMode.NONE:
        if streaming:
            p.max_id_len, p.id_n_fields = _prescan_ids_stream(
                in_paths, p, stream_chunk_bytes)
        else:
            p.max_id_len = max(8, max((len(s) for s in id_list), default=8))
            p.id_n_fields = ids.count_fields(id_list)
        id_chain = [None]   # one file-order chain (ids.read_lanes)

    dcfg, qcfg, mcfg, icfg = make_configs(p)
    state = state_create(dcfg, qcfg, icfg, device)
    skeys = (["meta", "dna"] + (["qual"] if qcfg else [])
             + (["id"] if icfg else [])
             + (["pe"] if dcfg.pe_log2_buckets > 0 else []))
    n_streams = len(skeys)
    qfwd = quality.qual_maps(qcfg.mode, qcfg.qt)[0] if qcfg else None

    writer = archive.ArchiveWriter(out_path, p.store_params())
    stream_bytes = {"meta": 0, "dna": 0, "qual": 0, "id": 0, "pe": 0,
                    "states": 0}
    group_fc = []      # per batch: [(f, c) per stream], on the device
    group_meta = []    # per batch: (take, L8)
    group_bytes = 0
    group_crc = 0
    group_idx = 0

    def flush_group():
        nonlocal group_fc, group_meta, group_bytes, group_crc, group_idx, state
        if not group_meta:
            return
        K = len(group_meta)
        # every stream's walk in one launch, compaction after it, then the
        # pulls: no pull waits between two streams' walks
        grids, bounds = zip(*(
            _group_grid([group_fc[k][si] for k in range(K)], p.scale_bits,
                        p.n_lanes) for si in range(n_streams)))
        encoded = rans.rans_encode_groups(grids, p.scale_bits, bounds)
        states_out, per_batch = [], [[None] * n_streams for _ in range(K)]
        for si, (words, n_per, st) in enumerate(encoded):
            ns = n_per[:K].cpu().numpy()
            host = words.cpu().numpy()
            states_out.append(st.cpu().numpy())
            off = 0
            for k in range(K):
                n = int(ns[k])
                per_batch[k][si] = (host[off:off + n], n)
                stream_bytes[skeys[si]] += 2 * n
                off += n
        fills = fill_stats_device(dcfg, state.dna).cpu().numpy()
        stream_bytes["states"] += 4 * p.n_lanes * n_streams
        writer.write_group(
            states_out,
            [(take, L, per_batch[k]) for k, (take, L) in
             enumerate(group_meta)],
            payload_crc=group_crc)
        group_crc = 0
        group_fc, group_meta, group_bytes = [], [], 0
        if id_chain is not None:
            # groups stay independently decodable: the id chain restarts,
            # so a group's first read escapes to raw bytes
            id_chain[:] = [None] * len(id_chain)
        state = state._replace(
            dna=grow_tables(dcfg, state.dna, p.verbosity, stats=fills))
        if snapshot_prefix is not None:
            from . import checkpoint

            checkpoint.save_state(state, checkpoint.snapshot_path(
                snapshot_prefix, group_idx + 1))
        group_idx += 1

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(
            device)

    if streaming:
        def ids_of(d):
            if icfg is None:
                return []
            return (ids.instrument_prefix(d.ids)
                    if p.id_mode == IdMode.INSTRUMENT else d.ids)

        batches = ((d.codes, d.quals, d.lengths, ids_of(d), take, padded)
                   for d, take, padded in _stream_batches(
                       in_paths, p, stream_chunk_bytes))
    else:
        batches = ((data.codes[start:start + take],
                    data.quals[start:start + take],
                    data.lengths[start:start + take],
                    id_list[start:start + take], take, padded)
                   for start, take, padded in batch_schedule(
                       data.n_reads, p.n_lanes, p.max_batch_reads,
                       align=2 * p.n_lanes if is_pe else p.n_lanes))
    n_reads = n_bases = 0
    for codes_raw, quals_raw, lengths_raw, ids_raw, take, padded in batches:
        n_reads += take
        n_bases += int(lengths_raw.sum())
        codes_u8 = _pad_batch(codes_raw, padded)
        lengths = _pad_batch(lengths_raw, padded).astype(np.int32)
        # columns padded to a multiple of 8: the width the reference models,
        # writes as the batch's max_len and covers with the crc
        L = codes_u8.shape[1]
        L8 = -(-L // 8) * 8
        codes_u8 = np.pad(codes_u8, ((0, 0), (0, L8 - L)))
        group_crc = payload_crc(group_crc, codes_u8[:take], lengths[:take])
        qsyms = None
        if qcfg is not None:
            quals_u8 = np.pad(_pad_batch(quals_raw, padded),
                              ((0, 0), (0, L8 - L)))
            qsyms = to_dev(qfwd[np.minimum(quals_u8, 95)])
        id_batch = ()
        if icfg is not None:
            id_batch = tuple(torch.from_numpy(a).to(device) for a in
                             ids.encode_ids_host(
                                 ids_raw + [b""] * (padded - take),
                                 ids.read_lanes(padded, p.n_lanes),
                                 icfg.n_fields, icfg.max_id_len, id_chain,
                                 n_valid=ids.host_n_valid(icfg, take)))
        grids, state = _model_batch(dcfg, qcfg, mcfg, icfg, state,
                                    to_dev(codes_u8), qsyms, to_dev(lengths),
                                    id_batch, take)
        group_fc.append(grids)
        group_meta.append((take, L8))
        # u16 bytes per grid entry, whatever dtype the grids are held in
        group_bytes += sum(f.numel() * 2 + c.numel() * 2 for f, c in grids)
        if (group_bytes >= group_mem_bytes
                or len(group_meta) >= rans.GROUP_MAX_BATCHES):
            flush_group()
    flush_group()
    writer.close()

    in_bytes = sum(os.path.getsize(f) for f in in_paths if os.path.exists(f))
    out_bytes = os.path.getsize(out_path)
    if p.verbosity >= 2:
        det = "  ".join(f"{k}: {v:,}" for k, v in stream_bytes.items())
        print(f"streams: {det}")
    return {
        "n_reads": n_reads, "in_bytes": in_bytes, "out_bytes": out_bytes,
        "bits_per_base": 8.0 * out_bytes / max(1, n_bases),
        "ratio": in_bytes / max(1, out_bytes),
        "stream_bytes": stream_bytes,
    }


def decompress_file(p_cli: Params, in_path: str, out_path: str,
                    out_path2: str | None = None, start_group: int = 0,
                    init_state: Optional[CodecState] = None,
                    device=None) -> dict:
    """Decode an archive into a FASTQ file at `out_path`, on `device`
    (default: the first CUDA card; see resolve_device); a PE archive's
    mate 2 reads go to `out_path2` (or, as in the reference, to the
    Params' out_path2). The modes come from the archive's header; a mesh
    archive (parallel.mesh_pipeline decodes those), or a file that is not
    an archive, is a ValueError. Each group's payload
    checksum is held to the decoded reads. Returns {"n_reads": ...}, both
    mates counted.

    start_group, init_state: resume from a group snapshot
    (checkpoint.load_state): the groups before start_group are skipped, and
    init_state must be the snapshot taken after group start_group - 1. The
    caller's init_state is left as it was (see own_state)."""
    reader = archive.ArchiveReader(in_path)
    try:
        p = Params.load_params(reader.header_blob, base=p_cli)
        if p.mesh_dp > 1 or p.mesh_tp > 1:
            raise ValueError(
                f"archive was written on a {p.mesh_dp}x{p.mesh_tp} mesh — "
                f"use parallel.mesh_pipeline.decompress_file_mesh")
        device = resolve_device(device)
        writers = [fastq.FastqWriter(out_path)]
        try:
            if p.dna_mode in (DnaMode.PE_ORIGINAL, DnaMode.PE_SORTED):
                writers.append(fastq.FastqWriter(out_path2 or p.out_path2))
            _decode_groups(p, reader, writers, device, start_group,
                           init_state)
        finally:
            for w in writers:
                w.close()
        return {"n_reads": sum(w.n_reads for w in writers)}
    finally:
        reader.close()


def stream_caps(dcfg, qcfg, mcfg, icfg, R: int, L: int, n_lanes: int) -> list:
    """The word-plane size of each stream of a batch of R reads and L
    columns, in archive order (meta, dna, then qual, id and pe where
    present): the reference decoder's planes. The anchored 3-row recoding
    codes up to 1.5 * R * L DNA symbols, one word at most each."""
    cap = R * max(L, 2)
    with_pe = dcfg.pe_log2_buckets > 0
    caps = [mcfg.n_per_read * R, 3 * (R // 2) * max(L, 2) if with_pe else cap]
    if qcfg is not None:
        caps.append(cap)
    if icfg is not None:
        caps.append(R * icfg.w_all + 4 * n_lanes)
    if with_pe:
        caps.append(2 * R + 4 * n_lanes)
    return caps


def fit_words(words: np.ndarray, cap: int, device) -> torch.Tensor:
    """A batch's stream words as an int32 [cap] tensor on `device`, zeros
    after them: the reference decoder's fixed-size word plane (padded *
    n_per_read for meta, padded * max(L, 2) for DNA and quality)."""
    w = np.zeros((cap,), np.int32)
    w[:words.shape[0]] = words
    return torch.from_numpy(w).to(device)


def own_state(state: CodecState, device) -> CodecState:
    """A caller's codec state on `device`, with copies of its s/b tables:
    K2 updates row-global tables in place as it decodes, and a caller's
    state (a loaded snapshot, which the caller may decode from
    again) must stay as it was. The other arrays are only read; the state
    updates make new ones."""
    def on(t):
        return None if t is None else t.to(device)

    d = state.dna
    return CodecState(
        dna=d._replace(siv=on(d.siv), s_tc=d.s_tc.to(device, copy=True),
                       b_tc=d.b_tc.to(device, copy=True), model=on(d.model),
                       pe=None if d.pe is None else tuple(on(a)
                                                          for a in d.pe)),
        meta=on(state.meta), qual=on(state.qual), id=on(state.id))


def _decode_groups(p: Params, reader, writers, device, start_group=0,
                   init_state=None) -> None:
    """Decode every group from start_group on into `writers`: one FASTQ
    writer, or two for a PE archive (mate 1, mate 2); init_state: the
    state the first of them starts from (a fresh one for group 0)."""
    dcfg, qcfg, mcfg, icfg = make_configs(p)
    state = (own_state(init_state, device) if init_state is not None
             else state_create(dcfg, qcfg, icfg, device))
    qrev = quality.qual_maps(qcfg.mode, qcfg.qt)[1] if qcfg else None
    id_chain = [None] if icfg is not None else None
    align = 2 * p.n_lanes if len(writers) == 2 else p.n_lanes
    first = _first_batch(p.n_lanes, p.max_batch_reads, 0, align)
    cuda = device.type == "cuda"

    def pull(t):
        """Start the device-to-host copy of a batch output; the host reads
        it only after the batch's event (see drain)."""
        return None if t is None else t.to("cpu", non_blocking=cuda)

    gi = -1
    while True:
        rec = reader.read_group(p.n_lanes)
        if rec is None:
            break
        gi += 1
        if gi < start_group:
            continue
        gstates, batches, want_crc = rec
        got_crc = 0
        if id_chain is not None:
            id_chain[:] = [None] * len(id_chain)   # mirrors flush_group
        cur = [torch.from_numpy(st.astype(np.int64)).to(device)
               for st in gstates]
        pending = None

        def drain(pend):
            """Render one decoded batch; runs while the device works on
            the next (one-batch lookahead)."""
            nonlocal got_crc
            take, padded, done, lengths, codes, qsyms, id_planes = pend
            if done is not None:
                done.synchronize()
            lengths = lengths.numpy()
            codes = codes.numpy()
            # mask the padding columns like the encoder's input matrices
            poscols = np.arange(codes.shape[1])[None, :]
            codes = np.where(poscols < lengths[:, None], codes, 0).astype(
                np.uint8)
            got_crc = payload_crc(got_crc, codes, lengths)
            if qrev is not None:
                quals = qrev[qsyms.numpy()].astype(np.uint8)
            else:
                quals = np.full(codes.shape, p.quality_thr, np.uint8)
            id_out = None
            if id_planes is not None:
                # host detokenization replays the encoder's chain
                id_out = ids.decode_ids_host(
                    *(a.numpy() for a in id_planes),
                    ids.read_lanes(padded, p.n_lanes), id_chain,
                    n_valid=ids.host_n_valid(icfg, take))[:take]
            # PE: even reads to mate 1's file, odd reads to mate 2's
            nw = len(writers)
            for k, writer in enumerate(writers):
                writer.write_batch(
                    *(np.ascontiguousarray(a[k::nw])
                      for a in (codes, quals, lengths)),
                    ids=None if id_out is None else id_out[k::nw])

        for take, L, streams in batches:
            padded = canonical_padded(take, first, p.max_batch_reads, align)
            caps = stream_caps(dcfg, qcfg, mcfg, icfg, padded, L, p.n_lanes)
            if len(streams) != len(caps) or len(cur) != len(caps):
                raise ValueError(f"group {gi}: {len(streams)} streams, the "
                                 f"header's modes code {len(caps)}")
            (lengths, codes, qsyms, id_planes, state, cur) = _decode_batch(
                dcfg, qcfg, mcfg, icfg, padded, L, state,
                [(fit_words(w, c, device), x)
                 for (w, _), c, x in zip(streams, caps, cur)], take)
            out = (pull(lengths[:take].to(torch.int32)), pull(codes[:take]),
                   pull(None if qsyms is None else qsyms[:take]),
                   None if id_planes is None else
                   [pull(a) for a in id_planes])
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record()
            # the device starts on this batch while the host drains the last
            if pending is not None:
                drain(pending)
            pending = (take, padded, done) + out
        # the fill statistics are queued before the last drain, so their
        # pull waits on no more than it must
        fills = fill_stats_device(dcfg, state.dna)
        if pending is not None:
            drain(pending)
        if got_crc != want_crc:
            raise ValueError(f"payload checksum mismatch in group {gi} "
                             f"(archive corrupt or decoder divergence)")
        # replay the encoder's group-boundary growth and SIV prune
        state = state._replace(dna=grow_tables(
            dcfg, state.dna, p.verbosity, stats=fills.cpu().numpy()))


def interleave_pe(d1: fastq.FastqData, d2: fastq.FastqData) -> fastq.FastqData:
    """Interleave mate files so pairs are adjacent (read 2i mate 1 of pair
    i, read 2i+1 its mate 2), both padded to one width."""
    if d1.n_reads != d2.n_reads:
        raise ValueError(
            f"PE mate counts differ: {d1.n_reads} vs {d2.n_reads}")
    R = d1.n_reads
    L = max(d1.max_len, d2.max_len, 1)

    def padL(a):
        return np.pad(a, ((0, 0), (0, L - a.shape[1])))

    codes = np.empty((2 * R, L), d1.codes.dtype if R else np.uint8)
    quals = np.empty((2 * R, L), np.uint8)
    lengths = np.empty((2 * R,), np.int32)
    if R:
        codes[0::2] = padL(d1.codes)
        codes[1::2] = padL(d2.codes)
        quals[0::2] = padL(d1.quals)
        quals[1::2] = padL(d2.quals)
        lengths[0::2] = d1.lengths
        lengths[1::2] = d2.lengths
    ids = [None] * (2 * R)
    ids[0::2] = d1.ids
    ids[1::2] = d2.ids
    return fastq.FastqData(codes=codes, quals=quals, lengths=lengths, ids=ids)


def compress_pe(p: Params, in1: str, in2: str, out_path: str,
                group_mem_bytes: Optional[int] = None,
                snapshot_prefix: Optional[str] = None, device=None,
                stream_chunk_bytes: int = 0) -> dict:
    """Paired-end compression of the mate files in1, in2 into `out_path`,
    on `device` (see compress_file): the pairs interleaved, in sorted
    order sorted by mate 1's sequence (mate 2 follows its mate's
    permutation). stream_chunk_bytes > 0 block-streams both mates through
    the paired chunk reader (original order only; sorting needs the whole
    input). snapshot_prefix: group snapshots, as in compress_file; a PE
    snapshot holds the pair table and the pe model."""
    kw = {"snapshot_prefix": snapshot_prefix}
    if group_mem_bytes is not None:
        kw["group_mem_bytes"] = group_mem_bytes
    if stream_chunk_bytes > 0 and p.dna_mode == DnaMode.PE_ORIGINAL:
        stats = compress_file(p, [in1, in2], out_path, device=device,
                              stream_chunk_bytes=stream_chunk_bytes, **kw)
        stats["ratio"] = stats["in_bytes"] / max(1, stats["out_bytes"])
        return stats
    resolve_device(device)
    d1 = fastq.read_fastq(in1)
    d2 = fastq.read_fastq(in2)
    if p.dna_mode == DnaMode.PE_SORTED:
        order = fastq.sort_order(d1.codes, d1.lengths)
        d1 = fastq.FastqData(d1.codes[order], d1.quals[order],
                             d1.lengths[order], [d1.ids[i] for i in order])
        d2 = fastq.FastqData(d2.codes[order], d2.quals[order],
                             d2.lengths[order], [d2.ids[i] for i in order])
    stats = compress_file(p, in1, out_path, data=interleave_pe(d1, d2),
                          device=device, **kw)
    stats["in_bytes"] = os.path.getsize(in1) + os.path.getsize(in2)
    stats["ratio"] = stats["in_bytes"] / max(1, stats["out_bytes"])
    return stats
