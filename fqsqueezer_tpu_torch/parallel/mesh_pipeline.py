"""Mesh archives decoded on one device.

The reference package writes an archive over a dp x tp mesh of devices
(fqsqueezer_tpu/parallel/mesh_pipeline.py): a batch's reads are cut into
dp contiguous shards, each shard codes every stream in its own rANS lane
group, and the archive stores each (shard, stream) pair as a stream entry
of the group, shard-major, with the mesh in the header. Every shard models
its batch against the batch-frozen state (its row loop carrying its own
copy of the s/b tables), and the state then evolves once from the whole
batch — the shards' events gathered, the s/b tables replayed row block by
row block.

This module decodes such an archive on one device, as the reference does
with fewer devices than the mesh (decompress_file_mesh_seq): the shards in
turn against the frozen state (_seq_decode_shard; the DNA scan with
dna_decode_batch(apply_update=False), so each shard's rows update a
private copy of the s/b tables, on a CUDA device one K2 launch a read row
of the shard, and K3 once a shard and batch), then one state update from
the gathered shards (_seq_collect), and at each group end the mesh's table
maintenance (_maintenance_local: no growth — mesh tables are presized —
and the mesh's SIV prune rule). The output is the reference's, byte for
byte. Writing mesh archives is not ported (pipeline.unported_modes).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import archive
from .. import pipeline as base
from ..io import fastq
from ..ops import models, tables
from ..params import DnaMode, Params
from ..streams import dna, ids, meta, quality


def decompress_file_mesh(p_cli: Params, in_path: str, out_path: str,
                         out_path2: Optional[str] = None,
                         start_group: int = 0, init_state=None,
                         device=None) -> dict:
    """Decode a mesh archive: the reference's entry point. The mesh decode
    across several cards is not ported, so on one card every mesh — as in
    the reference with fewer devices than dp x tp — takes the sequential
    decode (decompress_file_mesh_seq), whose bytes are the mesh decode's."""
    return decompress_file_mesh_seq(p_cli, in_path, out_path, out_path2,
                                    start_group=start_group,
                                    init_state=init_state, device=device)


def decompress_file_mesh_seq(p_cli: Params, in_path: str, out_path: str,
                             out_path2: Optional[str] = None,
                             start_group: int = 0, init_state=None,
                             device=None) -> dict:
    """Decode a dp x tp mesh archive on `device` (default: the first CUDA
    card, see pipeline.resolve_device) into `out_path` (and a PE archive's
    mate 2 into `out_path2`): the shards in turn against the batch-frozen
    state, then the batch's state update once from the gathered shards.
    start_group, init_state: resume from a group snapshot, as
    pipeline.decompress_file; the caller's init_state is left as it was.
    Returns {"n_reads": ...}, both mates counted."""
    reader = archive.ArchiveReader(in_path)
    try:
        p = Params.load_params(reader.header_blob, base=p_cli)
        missing = base.unported_archive(p)
        if missing:
            raise ValueError(", ".join(missing) + " not yet ported to "
                             "fqsqueezer_tpu_torch")
        device = base.resolve_device(device)
        writers = [fastq.FastqWriter(out_path)]
        try:
            if p.dna_mode in (DnaMode.PE_ORIGINAL, DnaMode.PE_SORTED):
                writers.append(fastq.FastqWriter(out_path2 or p.out_path2))
            _decode_mesh_groups(p, reader, writers, device, start_group,
                                init_state)
        finally:
            for w in writers:
                w.close()
        return {"n_reads": sum(w.n_reads for w in writers)}
    finally:
        reader.close()


def _seq_decode_shard(dcfg, qcfg, mcfg, icfg, R_shard: int, L: int,
                      state: base.CodecState, planes, lane_states,
                      n_valid: int):
    """Decode one dp shard of a batch against the batch-frozen `state`,
    which is left as it was — the reference's dec_one. planes,
    lane_states: the shard's word plane (int32) and lane states (int64) of
    each stream, in archive order; n_valid: the shard's real reads.
    Returns (lengths [R_shard], codes [R_shard, L], qsyms or None, the id
    planes or None, the events of each stream for _seq_collect — (meta
    ctx, syms), the DNA rows', (qual ctx, syms, active) or None, (id ctx,
    syms, active) or None — and the streams' final lane states)."""
    m_w, d_w, *rest_w = planes
    m_x, d_x, *rest_x = lane_states
    with_pe = dcfg.pe_log2_buckets > 0
    pe_w, pe_x = (rest_w.pop(), rest_x.pop()) if with_pe else (None, None)
    lengths, lcp, _, m_x, _ = meta.meta_decode_batch(
        mcfg, state.meta, R_shard, m_w, m_x)
    lengths = torch.clamp(lengths, max=L)
    lcp = lcp if mcfg.with_lcp else None
    m_ctx, m_syms, _, _ = meta.meta_modeling(mcfg, state.meta, lengths, lcp)

    codes, _, d_x, _, ex = dna.dna_decode_batch(
        dcfg, state.dna, lengths, d_w, d_x, L, apply_update=False, lcp=lcp,
        lcp_stride=mcfg.lcp_stride, pe_words=pe_w, pe_states=pe_x)
    if with_pe:
        eff, ctx, sym, active, pe_x, pe_syms, pe_act, codes3, lengths3 = ex
        dna_out = (codes3, eff, lengths3, ctx, sym, active, pe_syms, pe_act)
    else:
        eff, ctx, sym, active = ex
        dna_out = (codes, eff, lengths, ctx, sym, active)
    xs = [m_x, d_x]

    qsyms = q_out = None
    if qcfg is not None:
        q_w, q_x = rest_w.pop(0), rest_x.pop(0)
        # the scan alone (K3 on a CUDA device): the shard's model update
        # would be dropped, the gathered batch's is _seq_collect's
        syms, q_x, _ = quality.qual_decode_scan(
            qcfg, state.qual, lengths.to(torch.int32).contiguous(), q_w, q_x,
            L)
        qsyms = syms.to(torch.int64)
        pos = torch.arange(L, dtype=torch.int64, device=qsyms.device)
        q_out = (quality.qual_ctx_plane(qcfg, qsyms), qsyms,
                 pos[None, :] < lengths[:, None])
        xs.append(q_x)

    id_planes = i_out = None
    if icfg is not None:
        i_w, i_x = rest_w.pop(0), rest_x.pop(0)
        *id_planes, _, i_x, _ = ids.id_decode_batch(
            icfg, state.id, R_shard, i_w, i_x, n_valid)
        i_ctx, i_syms, _, _, i_act = ids.id_modeling(
            icfg, state.id, *id_planes, n_valid=n_valid)
        i_out = (i_ctx, i_syms, i_act)
        xs.append(i_x)
    if with_pe:
        xs.append(pe_x)
    return (lengths, codes, qsyms, id_planes, (m_ctx, m_syms), dna_out,
            q_out, i_out), xs


def _seq_collect(dcfg, state: base.CodecState, m_g, dna_g, q_g, i_g,
                 codes_true_g, lengths_true_g) -> base.CodecState:
    """The batch's state update from its gathered shards (each argument
    the shards' events concatenated in shard order) — the reference's
    collect: the models take every shard's events in one update, and the
    DNA tables replay the gathered batch's s/b events row block by row
    block (dna_collect_updates without skip_sb)."""
    m_model = models.model_update(
        state.meta, m_g[0].reshape(-1), m_g[1].reshape(-1),
        torch.ones(m_g[0].numel(), dtype=torch.bool, device=m_g[0].device))
    if dcfg.pe_log2_buckets > 0:
        codes3, eff, lengths3, ctx, sym, active, pe_syms, pe_act = dna_g
        d_state = dna.dna_collect_updates(
            dcfg, state.dna, codes3, eff, lengths3, ctx, sym, active,
            pe_syms=pe_syms, pe_act=pe_act, codes_true=codes_true_g,
            lengths_true=lengths_true_g)
    else:
        d_state = dna.dna_collect_updates(dcfg, state.dna, *dna_g)
    q_model = i_model = None
    if q_g is not None:
        q_model = models.model_update(state.qual, *(a.reshape(-1)
                                                    for a in q_g))
    if i_g is not None:
        i_model = models.model_update(state.id, *(a.reshape(-1)
                                                  for a in i_g))
    return base.CodecState(dna=d_state, meta=m_model, qual=q_model,
                           id=i_model)


def _maintenance_local(dcfg):
    """The mesh's group-boundary table maintenance on one device — the
    reference's _maintenance_local, not pipeline.grow_tables: no growth
    (mesh tables are presized), the K2 clamp (a no-op), and the SIV pruned
    when its nonzero counters exceed (4 * words * SIV_PRUNE_NUM) //
    SIV_PRUNE_DEN. Returns the step, DnaState -> DnaState."""

    def step(dna_state):
        s_tc, b_tc = dna_state.s_tc, dna_state.b_tc
        if dcfg.canon:
            s_tc = tables.ktable_clamp(s_tc)
            b_tc = tables.ktable_clamp(b_tc)
        nz, _ = tables.siv_fill(dna_state.siv)
        prune = int(nz) > (4 * dna_state.siv.shape[0]
                           * base.SIV_PRUNE_NUM) // base.SIV_PRUNE_DEN
        siv = (tables.siv_prune(dna_state.siv) if prune
               else dna_state.siv)
        return dna_state._replace(siv=siv, s_tc=s_tc, b_tc=b_tc)

    return step


def _cat(parts):
    """Concatenate the shards' outputs along the reads, leaf by leaf
    (None stays None)."""
    if parts[0] is None:
        return None
    if isinstance(parts[0], (tuple, list)):
        return tuple(_cat(list(p)) for p in zip(*parts))
    return torch.cat(parts, dim=0)


def _decode_mesh_groups(p: Params, reader, writers, device, start_group,
                        init_state) -> None:
    dp = p.mesh_dp
    N = p.n_lanes
    dcfg, qcfg, mcfg, icfg = base.make_configs(p)
    state = (base.own_state(init_state, device) if init_state is not None
             else base.state_create(dcfg, qcfg, icfg, device))
    n_base = (2 + (qcfg is not None) + (icfg is not None)
              + (dcfg.pe_log2_buckets > 0))
    qrev = quality.qual_maps(qcfg.mode, qcfg.qt)[1] if qcfg else None
    maint = _maintenance_local(dcfg)
    id_chain = [None] * dp if icfg is not None else None
    nw = len(writers)
    align = dp * N * nw      # PE: pairs never straddle a lane
    first = base._first_batch(N, p.max_batch_reads, 0, align)

    gi = -1
    while True:
        rec = reader.read_group(N)
        if rec is None:
            break
        gi += 1
        if gi < start_group:
            continue
        gstates, batches, want_crc = rec
        if len(gstates) != dp * n_base:
            raise ValueError(f"group {gi}: {len(gstates)} state blocks, the "
                             f"header's {dp} shards x {n_base} streams")
        got_crc = 0
        if id_chain is not None:
            id_chain[:] = [None] * dp
        # per-(shard, stream) lane states, chained across the group
        cur = [[torch.from_numpy(gstates[s * n_base + b].astype(np.int64)).to(
            device) for b in range(n_base)] for s in range(dp)]
        for take, L, streams in batches:
            padded = base.canonical_padded(take, first, p.max_batch_reads,
                                           align)
            R_shard = padded // dp
            caps = base.stream_caps(dcfg, qcfg, mcfg, icfg, R_shard, L, N)
            if len(streams) != dp * n_base:
                raise ValueError(f"group {gi}: {len(streams)} streams, the "
                                 f"header's {dp} shards x {n_base}")
            outs = []
            for s in range(dp):
                planes = [base.fit_words(streams[s * n_base + b][0], caps[b],
                                         device) for b in range(n_base)]
                # shard s holds the batch's reads s * R_shard and on
                n_valid = max(0, min(take - s * R_shard, R_shard))
                out, cur[s] = _seq_decode_shard(
                    dcfg, qcfg, mcfg, icfg, R_shard, L, state, planes,
                    cur[s], n_valid)
                outs.append(out)
            (lengths_g, codes_g, qsyms_g, id_g, m_g, dna_g, q_g,
             i_g) = (_cat([o[i] for o in outs]) for i in range(8))
            state = _seq_collect(dcfg, state, m_g, dna_g, q_g, i_g, codes_g,
                                 lengths_g)

            lengths = lengths_g[:take].cpu().numpy().astype(np.int32)
            codes = codes_g[:take].cpu().numpy()
            poscols = np.arange(codes.shape[1])[None, :]
            codes = np.where(poscols < lengths[:, None], codes, 0).astype(
                np.uint8)
            got_crc = base.payload_crc(got_crc, codes, lengths)
            if qrev is not None:
                quals = qrev[qsyms_g[:take].cpu().numpy()].astype(np.uint8)
            else:
                quals = np.full(codes.shape, p.quality_thr, np.uint8)
            id_out = None
            if id_g is not None:
                id_out = ids.decode_ids_host(
                    *(a.cpu().numpy() for a in id_g),
                    ids.mesh_read_lanes(padded, dp, N), id_chain,
                    n_valid=take)[:take]
            # PE: even reads to mate 1's file, odd reads to mate 2's
            for k, writer in enumerate(writers):
                writer.write_batch(
                    *(np.ascontiguousarray(a[k::nw])
                      for a in (codes, quals, lengths)),
                    ids=None if id_out is None else id_out[k::nw])
        if got_crc != want_crc:
            raise ValueError("payload checksum mismatch (seq mesh decode)")
        state = state._replace(dna=maint(state.dna))
