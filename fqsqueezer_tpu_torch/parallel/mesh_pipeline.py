"""Mesh archives written and decoded on one process or on ranks.

The reference package writes an archive over a dp x tp mesh of devices
(fqsqueezer_tpu/parallel/mesh_pipeline.py): a batch's reads are cut into
dp contiguous shards, each shard codes every stream in its own rANS lane
group, and the archive stores each (shard, stream) pair as a stream entry
of the group, shard-major, with the mesh in the header. Every shard models
its batch against the batch-frozen state (a row-global row loop carrying
its own copy of the s/b tables; in-batch local statistics, H1-H4, its
own), and the state then evolves once from the whole batch — the shards'
events gathered: batch-frozen s/b tables take the batch's events,
row-global ones are replayed row block by row block, or under
mesh_route_sb take the owner-routed exchange's capped lists
(sharded.sb_routed_updates). It takes every header a reference mesh
writer stores: today's, and the older writers' (params.HEADER_GENERATIONS
H0-H6, id codec v1 among them).

This module writes such an archive (compress_file_mesh, compress_pe_mesh)
on one process, the shards of a batch in turn (sharded.sharded_model), or
on ranks (a `comm`, parallel.comm: rank r of R holds dp shards [r * dp /
R, (r + 1) * dp / R) and runs them in turn; every rank reads the input,
so all see the same batches and id chains, and holds the whole state).
A process's grids of its shards lie side by side, and at each group end
one walk a stream over the group's [T, shards x N] grid — one K1 launch a
process on a CUDA device — gives words cut by shard and batch
(rans.rans_encode_shards); rank 0 gathers every rank's
(sharded.gather_coded) and writes the group shard-major. The bytes are
the reference mesh writer's, whatever the ranks.

It decodes one (decompress_file_mesh) on ranks as the reference's mesh
decode does: every rank reads the archive and decodes its shards against
the batch-frozen state (_seq_decode_shard; the DNA scan with
dna_decode_batch(apply_update=False): on a CUDA device one K2 launch a
read row of the shard, row-global rows updating a private copy of the s/b
tables, batch-frozen ones reading the state's; K3 once a shard and batch,
with H1's deltas its own), the shards' outputs are gathered, and every
rank updates the state once from the whole batch (pipeline.collect_batch;
under mesh_route_sb the writer's routed exchange,
sharded.mesh_update); rank 0 checks the group crc and writes the
FASTQ. On one process it decodes as the reference does with fewer
devices than the mesh (decompress_file_mesh_seq): the same, the shards in
turn, but with the replicated exchange even under mesh_route_sb, so an
archive whose route cap dropped events fails its checksum there, as the
reference's does. At each group end the mesh's table maintenance runs on
every process (_maintenance_local: no growth — mesh tables are presized —
the u16 counters' clamp, and the mesh's SIV prune rule). The output is the
reference's, byte for byte.

run_ranks() spawns the ranks and runs jobs on them (_rank_jobs): nccl
with one card a rank, gloo on the CPU or on one card the ranks share. tp
stays inside a rank: K2 reads a table row at every position, and tables
split over cards would need a sum of partial finds across cards at every
position (the reference's psum in TpBackend's finds).
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from .. import archive
from .. import pipeline as base
from ..io import fastq
from ..ops import rans, tables
from ..params import DnaMode, IdMode, Params
from ..streams import dna, ids, meta, quality
from . import comm as pcomm
from . import sharded


def compress_file_mesh(p: Params, in_path: str, out_path: str, dp: int,
                       tp: int = 1, data: Optional[fastq.FastqData] = None,
                       group_mem_bytes: int = 512 << 20,
                       snapshot_prefix: Optional[str] = None,
                       device=None, comm=None) -> dict:
    """Compress `in_path` (or `data`, a PE input's pairs interleaved: see
    compress_pe_mesh) into a dp x tp mesh archive at `out_path`, on
    `device` (default: the first CUDA card, see pipeline.resolve_device;
    on ranks comm.device): the reference's compress_file_mesh, byte for
    byte. The whole input is read (no streaming), in sorted order sorted
    first. Every batch holds a multiple of dp x n_lanes reads (pairs
    whole) at the input's width; a group ends where the mesh's grids
    reach group_mem_bytes (u16 freq and cum of every stream and shard),
    whatever its batch count. snapshot_prefix: save the state after each
    group's maintenance (checkpoint.snapshot_path(prefix, g + 1) for group
    g), as pipeline.compress_file does. comm: this process's rank
    (parallel.comm), None for one process holding every shard; on ranks
    rank 0 writes the archive and the snapshots. Returns the reference's
    stats dict."""
    is_pe = p.dna_mode in (DnaMode.PE_ORIGINAL, DnaMode.PE_SORTED)
    if is_pe and data is None:
        raise ValueError("mesh PE: use compress_pe_mesh (two inputs)")
    device = _mesh_setup(p, dp, tp, device, comm)
    lead = pcomm.lead(comm)
    n_own = len(pcomm.shards(comm, dp))
    if data is None:
        data = fastq.read_fastq(in_path)
    if p.dna_mode == DnaMode.SE_SORTED:
        order = fastq.sort_order(data.codes, data.lengths)
        data = fastq.FastqData(data.codes[order], data.quals[order],
                               data.lengths[order],
                               [data.ids[i] for i in order])
    id_list = data.ids
    if p.id_mode == IdMode.INSTRUMENT:
        id_list = ids.instrument_prefix(id_list)
    id_chain = None
    if p.id_mode != IdMode.NONE:
        p.max_id_len = max(8, max((len(s) for s in id_list), default=8))
        p.id_n_fields = ids.count_fields(id_list)
        id_chain = [None] * dp       # one file-order chain a dp shard

    dcfg, qcfg, mcfg, icfg = base.make_configs(p)
    state = base.state_create(dcfg, qcfg, icfg, device)
    maint = _maintenance_local(dcfg)
    n_streams = (2 + (qcfg is not None) + (icfg is not None)
                 + (dcfg.pe_log2_buckets > 0))
    qfwd = quality.qual_maps(qcfg.mode, qcfg.qt)[0] if qcfg else None
    writer = archive.ArchiveWriter(out_path, p.store_params()) if lead else None
    N = p.n_lanes
    align = dp * N * (2 if is_pe else 1)   # PE: pairs never straddle a lane

    drops = []         # the routed exchange's dropped events, a batch each
    group_fc = []      # per batch: [(f, c) [T, shards * N] per stream]
    group_meta = []    # per batch: (take, L)
    group_bytes = group_crc = group_idx = 0

    def flush_group():
        nonlocal group_fc, group_meta, group_bytes, group_crc, group_idx, state
        if not group_meta:
            return
        grids, bounds = zip(*(
            base._group_grid([fc[si] for fc in group_fc], p.scale_bits,
                             n_own * N) for si in range(n_streams)))
        coded = sharded.gather_coded(comm, rans.rans_encode_shards(
            grids, p.scale_bits, bounds, n_own))
        if writer is not None:
            coded = [(w.cpu().numpy(), n.cpu().numpy(), x.cpu().numpy())
                     for w, n, x in coded]
            # shard-major (shard, stream) state blocks and word runs; a
            # stream's words run shard by shard, batch by batch within one
            starts = [(np.cumsum(n) - n.reshape(-1)).reshape(n.shape)
                      for _, n, _ in coded]
            states = [x[s * N:(s + 1) * N] for s in range(dp)
                      for _, _, x in coded]
            batches = [(take, L, [(w[at[s, k]:at[s, k] + n[s, k]], n[s, k])
                                  for s in range(dp)
                                  for (w, n, _), at in zip(coded, starts)])
                       for k, (take, L) in enumerate(group_meta)]
            writer.write_group(states, batches, payload_crc=group_crc)
        group_fc, group_meta, group_bytes, group_crc = [], [], 0, 0
        if id_chain is not None:
            # groups stay independently decodable: the chains restart
            id_chain[:] = [None] * dp
        state = _run_maintenance(p, dcfg, maint, state, verbose=lead)
        if snapshot_prefix is not None and lead:
            from .. import checkpoint

            checkpoint.save_state(state, checkpoint.snapshot_path(
                snapshot_prefix, group_idx + 1))
        group_idx += 1

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(
            device)

    for start, take, padded in base.batch_schedule(
            data.n_reads, N, p.max_batch_reads, align=align):
        codes = base._pad_batch(data.codes[start:start + take], padded)
        lengths = base._pad_batch(data.lengths[start:start + take],
                                  padded).astype(np.int32)
        qsyms = None
        if qfwd is not None:
            qsyms = to_dev(qfwd[np.minimum(base._pad_batch(
                data.quals[start:start + take], padded), 95)])
        id_batch = ()
        if icfg is not None:
            id_batch = tuple(torch.from_numpy(a).to(device) for a in
                             ids.encode_ids_host(
                                 id_list[start:start + take]
                                 + [b""] * (padded - take),
                                 ids.mesh_read_lanes(padded, dp, N),
                                 icfg.n_fields, icfg.max_id_len, id_chain,
                                 n_valid=ids.host_n_valid(icfg, take)))
        grids, state = sharded.sharded_model(
            dcfg, qcfg, mcfg, icfg, state, to_dev(codes), qsyms,
            to_dev(lengths), id_batch, take, dp, tp=tp, drops=drops,
            comm=comm)
        L = codes.shape[1]
        if lead:
            group_crc = base.payload_crc(group_crc, np.where(
                np.arange(L)[None, :] < lengths[:take, None], codes[:take],
                0).astype(np.uint8), lengths[:take])
        group_fc.append(grids)
        group_meta.append((take, L))
        # every shard's grid has this process's shape: the mesh's bytes
        group_bytes += (dp // n_own) * sum(f.numel() * 2 + c.numel() * 2
                                           for f, c in grids)
        if group_bytes >= group_mem_bytes:
            flush_group()
    flush_group()
    if writer is not None:
        writer.close()
    pcomm.barrier(comm)        # the archive is whole before any rank goes on

    in_paths = (list(in_path) if isinstance(in_path, (list, tuple))
                else [in_path])
    in_bytes = sum(os.path.getsize(f) for f in in_paths
                   if os.path.exists(f))
    out_bytes = os.path.getsize(out_path) if lead else 0
    return {"n_reads": data.n_reads, "out_bytes": out_bytes,
            "in_bytes": in_bytes,
            "bits_per_base": 8.0 * out_bytes / max(1, int(
                data.lengths.sum())),
            "route_dropped": int(sum(drops)) if drops else 0}


def compress_pe_mesh(p: Params, in1: str, in2: str, out_path: str, dp: int,
                     tp: int = 1, snapshot_prefix: Optional[str] = None,
                     device=None, group_mem_bytes: int = 512 << 20,
                     comm=None) -> dict:
    """Paired-end over a mesh: the mates read whole (in PE sorted order
    sorted by mate 1), their pairs interleaved, then compress_file_mesh
    (on ranks every rank reads both mates)."""
    device = _mesh_setup(p, dp, tp, device, comm)
    d1 = fastq.read_fastq(in1)
    d2 = fastq.read_fastq(in2)
    if p.dna_mode == DnaMode.PE_SORTED:
        order = fastq.sort_order(d1.codes, d1.lengths)
        d1 = fastq.FastqData(d1.codes[order], d1.quals[order],
                             d1.lengths[order], [d1.ids[i] for i in order])
        d2 = fastq.FastqData(d2.codes[order], d2.quals[order],
                             d2.lengths[order], [d2.ids[i] for i in order])
    stats = compress_file_mesh(p, in1, out_path, dp, tp,
                               data=base.interleave_pe(d1, d2),
                               group_mem_bytes=group_mem_bytes,
                               snapshot_prefix=snapshot_prefix,
                               device=device, comm=comm)
    stats["in_bytes"] = os.path.getsize(in1) + os.path.getsize(in2)
    return stats


def _mesh_setup(p: Params, dp: int, tp: int, device, comm=None):
    """Set the mesh in the Params (it gates make_configs' knobs: the PE
    anchors, route_sb), refuse with one line (ValueError) a mesh that
    cannot shard the tables or that the ranks cannot split, and resolve
    the device (a rank's is its comm's) — all before the input is read."""
    p.mesh_dp, p.mesh_tp = dp, tp
    sharded.check_mesh(base.make_configs(p)[0], dp, tp)
    pcomm.shards(comm, dp)
    return comm.device if comm is not None else base.resolve_device(device)


def _run_maintenance(p: Params, dcfg, maint, state: base.CodecState,
                     verbose: bool = True):
    """The group-end maintenance (_maintenance_local) with the reference's
    telemetry: at verbosity 1 the fills [s_used, b_used, siv_nz], and a
    warning where an s/b table passes the single-device growth threshold
    (mesh tables are presized, so new k-mers start to drop); on ranks
    rank 0 alone prints (verbose)."""
    if p.verbosity >= 1 and verbose:
        f = base.fill_stats_device(dcfg, state.dna).cpu().numpy()
        print(f"  mesh fills: smer {int(f[0]):,} bmer {int(f[1]):,} "
              f"siv nz {int(f[2]):,}")
        for name, used, log2b in (("smer", int(f[0]), dcfg.smer_log2_buckets),
                                  ("bmer", int(f[1]), dcfg.bmer_log2_buckets)):
            cap = (1 << log2b) * tables.KBUCKET
            if used * base.GROW_DEN > cap * base.GROW_NUM:
                print(f"  WARNING: mesh {name} table fill "
                      f"{used / cap:.2f} exceeds the growth threshold; "
                      f"mesh tables are presized (no sharded growth) — "
                      f"new k-mers are being dropped. Raise -gs.")
    return state._replace(dna=maint(state.dna))


def decompress_file_mesh(p_cli: Params, in_path: str, out_path: str,
                         out_path2: Optional[str] = None,
                         start_group: int = 0, init_state=None,
                         device=None, comm=None) -> dict:
    """Decode a mesh archive: the reference's entry point. On ranks (a
    comm, see run_ranks) it is the reference's mesh decode: each rank
    decodes its shards, the shards' outputs are gathered, and the state
    follows the writer's exchange — routed under mesh_route_sb, so an
    archive whose route cap dropped events decodes. On one process it is
    the reference's decode with fewer devices than the mesh
    (decompress_file_mesh_seq), whose replicated exchange fails such an
    archive's checksum, as the reference's does; every other archive
    gives the same bytes both ways."""
    if comm is None:
        return decompress_file_mesh_seq(p_cli, in_path, out_path, out_path2,
                                        start_group=start_group,
                                        init_state=init_state, device=device)
    return _decompress_mesh(p_cli, in_path, out_path, out_path2,
                            start_group, init_state, comm.device, comm)


def decompress_file_mesh_seq(p_cli: Params, in_path: str, out_path: str,
                             out_path2: Optional[str] = None,
                             start_group: int = 0, init_state=None,
                             device=None) -> dict:
    """Decode a dp x tp mesh archive on `device` (default: the first CUDA
    card, see pipeline.resolve_device) into `out_path` (and a PE archive's
    mate 2 into `out_path2`) on one process: the shards in turn against
    the batch-frozen state, then the batch's state update once from the
    gathered shards, the s/b tables by the replicated exchange.
    start_group, init_state: resume from a group snapshot, as
    pipeline.decompress_file; the caller's init_state is left as it was.
    Returns {"n_reads": ...}, both mates counted."""
    return _decompress_mesh(p_cli, in_path, out_path, out_path2,
                            start_group, init_state, device, None)


def _decompress_mesh(p_cli, in_path, out_path, out_path2, start_group,
                     init_state, device, comm) -> dict:
    reader = archive.ArchiveReader(in_path)
    try:
        p = Params.load_params(reader.header_blob, base=p_cli)
        sharded.check_mesh(base.make_configs(p)[0], p.mesh_dp, p.mesh_tp)
        pcomm.shards(comm, p.mesh_dp)
        device = base.resolve_device(device)
        is_pe = p.dna_mode in (DnaMode.PE_ORIGINAL, DnaMode.PE_SORTED)
        writers = []
        try:
            if pcomm.lead(comm):
                writers.append(fastq.FastqWriter(out_path))
                if is_pe:
                    writers.append(fastq.FastqWriter(out_path2
                                                     or p.out_path2))
            _decode_mesh_groups(p, reader, writers, device, start_group,
                                init_state, comm)
        finally:
            for w in writers:
                w.close()
        pcomm.barrier(comm)    # the FASTQ is whole before any rank goes on
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
    planes or None, the events of each stream for collect_batch — (meta
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
        # the scan alone (K3 on a CUDA device; under H1 with the shard's
        # own in-batch deltas, zeroed for this call): the shard's model
        # update would be dropped, the gathered batch's is collect_batch's,
        # on qual_modeling's (ctx, syms, active)
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


def _maintenance_local(dcfg):
    """The mesh's group-boundary table maintenance, the same on every
    process — the reference's _maintenance_local, not pipeline.grow_tables: no growth
    (mesh tables are presized, whatever their family), the canonical
    tables' clamp (ktable_* u16 counters; a no-op on K2 cells), and the
    SIV pruned
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


def _decode_mesh_groups(p: Params, reader, writers, device, start_group,
                        init_state, comm=None) -> None:
    """Decode every group from start_group on: this process's shards of
    each batch (all of them without a comm), the batch's state update from
    every shard's outputs (sharded.mesh_update: on ranks the writer's
    exchange, on one process the replicated one), and where
    `writers` are given (one process, or rank 0) the FASTQ and the group
    crc."""
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
    own = pcomm.shards(comm, dp)
    nw = 2 if p.dna_mode in (DnaMode.PE_ORIGINAL, DnaMode.PE_SORTED) else 1
    align = dp * N * nw      # PE: pairs never straddle a lane
    first = base._first_batch(N, p.max_batch_reads, 0, align)
    where = "seq mesh decode" if comm is None else "mesh decode"

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
        cur = {s: [torch.from_numpy(gstates[s * n_base + b].astype(
            np.int64)).to(device) for b in range(n_base)] for s in own}
        for take, L, streams in batches:
            padded = base.canonical_padded(take, first, p.max_batch_reads,
                                           align)
            R_shard = padded // dp
            caps = base.stream_caps(dcfg, qcfg, mcfg, icfg, R_shard, L, N)
            if len(streams) != dp * n_base:
                raise ValueError(f"group {gi}: {len(streams)} streams, the "
                                 f"header's {dp} shards x {n_base}")
            outs = []
            for s in own:
                planes = [base.fit_words(streams[s * n_base + b][0], caps[b],
                                         device) for b in range(n_base)]
                out, cur[s] = _seq_decode_shard(
                    dcfg, qcfg, mcfg, icfg, R_shard, L, state, planes,
                    cur[s], sharded.shard_n_valid(take, R_shard, s))
                outs.append(out)
            local = [sharded.cat_shards([o[i] for o in outs])
                     for i in range(8)]
            local[2] = None            # the qualities ride in their events
            g = pcomm.gather_tree(comm, local)
            lengths_g, codes_g, _, id_g, *events = g
            state = sharded.mesh_update(dcfg, state, events, local[5],
                                        codes_g, lengths_g, dp, p.mesh_tp,
                                        comm, routed=comm is not None)
            if not writers:
                continue

            lengths = lengths_g[:take].cpu().numpy().astype(np.int32)
            codes = codes_g[:take].cpu().numpy()
            poscols = np.arange(codes.shape[1])[None, :]
            codes = np.where(poscols < lengths[:, None], codes, 0).astype(
                np.uint8)
            got_crc = base.payload_crc(got_crc, codes, lengths)
            if qrev is not None:
                quals = qrev[events[2][1][:take].cpu().numpy()].astype(
                    np.uint8)
            else:
                quals = np.full(codes.shape, p.quality_thr, np.uint8)
            id_out = None
            if id_g is not None:
                id_out = ids.decode_ids_host(
                    *(a.cpu().numpy() for a in id_g),
                    ids.mesh_read_lanes(padded, dp, N), id_chain,
                    n_valid=ids.host_n_valid(icfg, take))[:take]
            # PE: even reads to mate 1's file, odd reads to mate 2's
            for k, writer in enumerate(writers):
                writer.write_batch(
                    *(np.ascontiguousarray(a[k::nw])
                      for a in (codes, quals, lengths)),
                    ids=None if id_out is None else id_out[k::nw])
        if writers and got_crc != want_crc:
            raise ValueError(f"payload checksum mismatch ({where})")
        state = state._replace(dna=maint(state.dna))


# --- ranks ----------------------------------------------------------------------

def run_ranks(jobs, world: int, backend: str = "nccl", device=None,
              timeout: Optional[float] = None) -> list:
    """Run `jobs` in order on `world` spawned ranks (parallel.comm.launch:
    nccl with rank r on cuda:r, gloo on `device`, the CPU or one CUDA card
    the ranks share; the ranks must divide each job's dp). A job is
    (kind, kwargs):

      "compress"     compress_file_mesh(**kwargs)
      "compress_pe"  compress_pe_mesh(**kwargs)
      "decompress"   decompress_file_mesh(**kwargs); kwargs["snapshot"],
                     where given, is a group snapshot's path that every
                     rank loads as init_state (resume with start_group)
      "encode"       the single-step mesh encode (sharded.sharded_encode)
                     of kwargs["batches"], [(the batch's numpy arrays as
                     pipeline._encode_batch takes them, take)], chained
                     from a fresh state at kwargs["p"], dp, tp: the last
                     step's outputs as sharded_encode returns them, the
                     streams' (words, n_words, states) as numpy, the new
                     state on the CPU
      "gather"       the collectives alone on given data: kwargs["trees"]
                     one tree of numpy arrays a rank, kwargs["words"] one
                     1-D array a rank; every rank returns comm.gather_tree
                     of its tree and comm.gather_padded of its words

    Returns a list a rank, in rank order, of one record a job: "result"
    (what the call returned; tensors as numpy), "seconds" (its wall on
    that rank) and "launches" (the K1-K5 launches it made there).
    A job that fails on any rank ends every rank: comm.RankError, one
    line."""
    for kind, _ in jobs:
        if kind not in _JOBS:
            raise ValueError(f"job {kind!r}: use one of {sorted(_JOBS)}")
    return pcomm.launch(_rank_jobs, (list(jobs),), world, backend, device,
                        timeout)


def _gather_job(comm, trees, words):
    def to_np(tree):
        if isinstance(tree, (tuple, list)):
            return type(tree)(to_np(t) for t in tree)
        return None if tree is None else tree.cpu().numpy()

    def to_dev(tree):
        if isinstance(tree, (tuple, list)):
            return type(tree)(to_dev(t) for t in tree)
        return None if tree is None else torch.from_numpy(tree).to(
            comm.device)

    return {"tree": to_np(pcomm.gather_tree(comm, to_dev(trees[comm.rank]))),
            "words": pcomm.gather_padded(
                comm, to_dev(words[comm.rank]),
                [len(w) for w in words]).cpu().numpy()}


def _encode_job(comm, p, batches, dp, tp):
    cfgs = base.make_configs(p)
    state = base.state_create(*cfgs[:2], cfgs[3], comm.device)
    on = lambda a: torch.from_numpy(np.asarray(a)).to(comm.device)
    for (codes, kcodes, lengths, qsyms, id_batch), take in batches:
        outs = sharded.sharded_encode(
            *cfgs, state, on(codes), on(kcodes), on(lengths), on(qsyms),
            tuple(on(a) for a in id_batch), take, dp, tp, comm=comm)
        state = outs[4]
    return ([tuple(t.cpu().numpy() for t in o) for o in outs[:4]]
            + [base.own_state(state, torch.device("cpu"))])


def _decompress_job(comm, snapshot=None, **kw):
    if snapshot is not None:
        from .. import checkpoint

        kw["init_state"] = checkpoint.load_state(snapshot, comm.device)
    return decompress_file_mesh(**kw, comm=comm)


_JOBS = {
    "compress": lambda comm, kw: compress_file_mesh(**kw, comm=comm),
    "compress_pe": lambda comm, kw: compress_pe_mesh(**kw, comm=comm),
    "decompress": lambda comm, kw: _decompress_job(comm, **kw),
    "encode": lambda comm, kw: _encode_job(comm, **kw),
    "gather": lambda comm, kw: _gather_job(comm, **kw),
}


def _launches() -> dict:
    return {"K1": rans.K1_LAUNCHES, "K2": dna.K2_LAUNCHES,
            "K3": quality.K3_LAUNCHES, "K4": ids.K4_LAUNCHES,
            "K5": meta.K5_LAUNCHES}


def _rank_jobs(comm, jobs) -> list:
    """A rank's side of run_ranks."""
    out = []
    for kind, kw in jobs:
        before = _launches()
        t0 = time.perf_counter()
        result = _JOBS[kind](comm, dict(kw))
        if comm.device.type == "cuda":
            torch.cuda.synchronize(comm.device)
        dt = time.perf_counter() - t0
        out.append({"result": result, "seconds": dt, "launches": {
            k: v - before[k] for k, v in _launches().items()}})
    return out
