"""The dp x tp mesh's compress step, on one process or on ranks.

Port of the writer side of fqsqueezer_tpu/parallel/sharded.py. There a
batch's reads are cut into dp contiguous shards, one a row of devices;
each shard is modeled against the batch-frozen state (its DNA row loop
carrying its own copy of the s/b tables, which is then dropped) and codes
every stream in its own N rANS lanes; the shards' events are gathered and
every device evolves the state once from the whole batch. The tp axis
shards the s/b tables and the SIV by rows: its finds sum the shards'
answers to the local one, and each owner applies the events of its rows,
so with the replicated exchange it changes no value. With the
owner-routed exchange (mesh_route_sb, sb_routed_updates) it does: each
owner takes at most route_cap events a dp shard and row block.

Here the dp shards run on one process, or on ranks (a `comm`, see
parallel.comm: rank r of R holds shards [r * dp / R, (r + 1) * dp / R));
each process runs its shards in turn (sharded_model), each through
pipeline._model_rows against the frozen state, gathers their events in
shard order (comm.gather_tree; on one process they are simply
concatenated) and runs the same pipeline.collect_batch — every rank holds
the whole state, so the state stays replicated, as on the reference's
mesh. tp stays inside a process: every rank holds whole s/b tables and
the whole SIV, and tp only sets the routed exchange's caps and owner
ranges. A process's grid of a stream is its shards' [T, N] grids side by
side, [T, shards * N], so one walk codes all of them
(rans.rans_encode_shards): one K1 launch a group flush on a CUDA device,
or for the single-step encode (sharded_encode, rans.rans_encode_fresh)
one a batch; gather_coded then puts every rank's words, counts and lane
states together. Under mesh_route_sb the batch's s/b tables take the
routed exchange's capped event lists (sb_routed_updates, each process
routing its own shards' events) in place of the replicated replay.
"""
from __future__ import annotations

import torch

from .. import pipeline as base
from ..ops import rans, tables
from ..streams import common, dna
from . import comm as pcomm


def shard_n_valid(take: int, R_shard: int, s: int) -> int:
    """Real reads of dp shard s of a batch of `take` reads: shard s holds
    the batch's rows [s * R_shard, (s + 1) * R_shard), so its padding rows
    (the id codec v2 mask) are a suffix."""
    return max(0, min(take - s * R_shard, R_shard))


def check_mesh(dcfg, dp: int, tp: int) -> None:
    """Raise ValueError, one line, for a mesh the reference cannot lay out:
    dp or tp below 1, or a tp that does not divide the rows of the s/b
    tables and the SIV's words, which it shards over tp."""
    sizes = (1 << dcfg.smer_log2_buckets, 1 << dcfg.bmer_log2_buckets,
             4 ** (dcfg.siv_len - 1))
    if dp < 1 or tp < 1 or any(n % tp for n in sizes):
        raise ValueError(
            f"a {dp}x{tp} mesh (-dp {dp} -tp {tp}) cannot shard the s/b "
            f"tables' {sizes[0]} and {sizes[1]} rows and the SIV's "
            f"{sizes[2]} words over tp")


def route_cap(n_events: int, n_tp: int) -> int:
    """The owner-routed exchange's event capacity a dp shard, tp owner and
    row block, of n_events events a shard and row block: twice the
    uniform-hash share, rounded up to 512, never above n_events — the
    reference's _route_cap. At n_tp <= 2 it is n_events: nothing drops."""
    if n_tp <= 1:
        return n_events
    want = -(-2 * n_events // n_tp)
    return min(n_events, -(-want // 512) * 512)


def sb_routed_updates(dcfg, s_tc, b_tc, kcodes, active, dp: int, tp: int,
                      comm=None):
    """The owner-routed s/b update exchange (mesh_route_sb): the
    reference's sb_routed_updates. kcodes, active: [shards * R_shard, L],
    the DNA rows (repaired k-mer codes and in-length mask) of the shards
    this process holds (all dp without a comm), shard after shard. Each
    shard's rows are cut into blocks of n_lanes / dp lanes, so that block
    rd of every shard holds the reads of global row rd; a block's
    canonical insert events (dna.sb_canon_events) that fall in tp owner
    t's bucket range keep their order, and past route_cap of them the rest
    drop. Every shard's events are gathered with their keep mask
    (comm.gather_tree: the reference's all_gather over dp of its owners'
    capped lists, whose tp x route_cap columns a row are no fewer than
    the E events masked here), and every global row then takes the kept events of all shards and
    owners in one update (tables.ktable_update, K2 cells through
    k2_update) — the reference's per-owner updates, since owners' bucket
    ranges are disjoint and an update decides bucket by bucket. Returns
    (s_tc, b_tc, the dropped events of every shard as a 0-d int64
    tensor)."""
    N = dcfg.n_lanes
    if N % dp:
        raise ValueError(f"the routed exchange needs n_lanes ({N}) "
                         f"divisible by dp ({dp})")
    n_own = len(pcomm.shards(comm, dp))
    rows = [(common.to_row_blocks(k, N // dp), common.to_row_blocks(a,
                                                                    N // dp))
            for k, a in zip(kcodes.chunk(n_own), active.chunk(n_own))]
    n_rows = rows[0][0].shape[0]
    dropped = torch.zeros((), dtype=torch.int64, device=kcodes.device)

    def route(tc, k, log2b):
        """This process's shards' kept lists, [shards, n_rows, E] each."""
        nonlocal dropped
        owner_rows = tc.shape[0] // tp
        kept = []
        for kc_r, act_r in rows:                 # shard by shard
            L = kc_r.shape[2]
            bkt, tag, valid = (x.reshape(n_rows, -1) for x in
                               dna.sb_canon_events(
                                   dcfg, kc_r.reshape(-1, L),
                                   act_r.reshape(-1, L), k, log2b))
            cap = route_cap(bkt.shape[1], tp)
            owner = bkt // owner_rows
            rank = torch.zeros_like(bkt)
            for t in range(tp):
                own = valid & (owner == t)
                rank = torch.where(own, torch.cumsum(own.to(torch.int64),
                                                     dim=1) - 1, rank)
            dropped = dropped + (valid & (rank >= cap)).sum()
            kept.append((bkt, tag, valid & (rank < cap) & (tag != 0)))
        return tuple(torch.stack(e) for e in zip(*kept))

    def update(tc, kept, log2b):
        bkt, tag, keep = kept                     # [dp, n_rows, E]
        for rd in range(n_rows):
            tc = tables.ktable_update(
                tc, bkt[:, rd].reshape(-1), tag[:, rd].reshape(-1),
                keep[:, rd].reshape(-1), log2_base=log2b)
        return tc

    s_kept = route(s_tc, dcfg.smer_len, dcfg.smer_log2_buckets)
    b_kept = route(b_tc, dcfg.bmer_len, dcfg.bmer_log2_buckets)
    s_kept, b_kept, dropped = pcomm.gather_tree(comm, (s_kept, b_kept,
                                                       dropped))
    return (update(s_tc, s_kept, dcfg.smer_log2_buckets),
            update(b_tc, b_kept, dcfg.bmer_log2_buckets), dropped.sum())


def cat_shards(parts):
    """Concatenate the shards' outputs along the reads, leaf by leaf
    (None stays None)."""
    if parts[0] is None:
        return None
    if isinstance(parts[0], (tuple, list)):
        return tuple(cat_shards(list(p)) for p in zip(*parts))
    return torch.cat(parts, dim=0)


def mesh_update(dcfg, state: base.CodecState, events, dna_local, codes,
                lengths, dp: int, tp: int, comm=None, routed: bool = True,
                drops: list | None = None) -> base.CodecState:
    """A mesh batch's state update, the same on every process:
    pipeline.collect_batch of the whole batch's events (every shard's, in
    shard order: on ranks gathered with comm.gather_tree). codes, lengths:
    the whole batch's true reads (the pair table's input with the PE
    anchors). Under mesh_route_sb with `routed` the s/b tables take the
    owner-routed exchange in place of the replicated replay:
    sb_routed_updates of dna_local, the DNA row events of this process's
    shards; routed=False is the sequential mesh decode's rule, which
    replays the replicated exchange. drops: a list that takes the routed
    exchange's dropped events (a 0-d tensor a batch)."""
    route = bool(dcfg.route_sb) and routed
    new = base.collect_batch(dcfg, state, *events, codes, lengths,
                             skip_sb=route)
    if route:
        _, eff, d_lengths = dna_local[:3]
        pos = torch.arange(eff.shape[1], device=eff.device)[None, :]
        s_tc, b_tc, dropped = sb_routed_updates(
            dcfg, state.dna.s_tc, state.dna.b_tc, eff,
            pos < d_lengths[:, None], dp, tp, comm)
        new = new._replace(dna=new.dna._replace(s_tc=s_tc, b_tc=b_tc))
        if drops is not None:
            drops.append(dropped)
    return new


def sharded_model(dcfg, qcfg, mcfg, icfg, state: base.CodecState,
                  codes: torch.Tensor, qsyms, lengths: torch.Tensor,
                  id_batch, take: int, dp: int, kcodes=None, tp: int = 1,
                  drops: list | None = None, comm=None):
    """One batch's mesh modeling step: the reference's make_sharded_model.
    codes (and kcodes, default codes with N as 0): [R, L] int64, the whole
    batch, R a multiple of dp x n_lanes; qsyms: [R, L] int64 or None;
    lengths: [R]; id_batch: the encode_ids_host planes (mesh_read_lanes)
    as tensors, or (); take: the batch's real reads; tp: the mesh's table
    shards, which the routed exchange (dcfg.route_sb) owns by; drops: a
    list that takes the routed exchange's dropped events (a 0-d tensor a
    batch); comm: this process's rank (parallel.comm), None for one
    process holding every shard. Returns ([(freq, cum) int32 [T, shards *
    N] per stream, archive order] of this process's shards, new state);
    `state` is left as it was."""
    R_shard = codes.shape[0] // dp
    grids, events = [], []
    for s in pcomm.shards(comm, dp):
        rows = slice(s * R_shard, (s + 1) * R_shard)
        g, ev, _ = base._model_rows(
            dcfg, qcfg, mcfg, icfg, state, codes[rows],
            None if qsyms is None else qsyms[rows], lengths[rows],
            tuple(a[rows] for a in id_batch),
            shard_n_valid(take, R_shard, s),
            None if kcodes is None else kcodes[rows])
        grids.append(g)
        events.append(ev)
    side_by_side = [tuple(torch.cat([g[si][k] for g in grids], dim=1)
                          for k in (0, 1)) for si in range(len(grids[0]))]
    local = cat_shards(events)
    new = mesh_update(dcfg, state, pcomm.gather_tree(comm, local), local[1],
                      codes, lengths, dp, tp, comm, drops=drops)
    return side_by_side, new


def gather_coded(comm, coded):
    """rans_encode_shards' (or rans_encode_fresh's) output of every rank
    put together in shard order: per stream (words of every shard, in
    shard order, n_per of every shard, lane states of every shard). The
    counts and states are gathered in one collective, then the words,
    whose lengths differ by rank, padded to the longest rank's
    (comm.gather_padded). Without a comm `coded` comes back as it is."""
    if comm is None:
        return coded
    ns, xs = pcomm.gather_tree(comm, ([n for _, n, _ in coded],
                                      [x for _, _, x in coded]))
    out = []
    for (w, _, _), n, x in zip(coded, ns, xs):
        per_rank = n.reshape(comm.world, -1).sum(dim=1)
        out.append((pcomm.gather_padded(comm, w, per_rank.tolist()), n, x))
    return out


def sharded_encode(dcfg, qcfg, mcfg, icfg, state: base.CodecState, codes,
                   kcodes, lengths, qsyms, id_batch, take: int, dp: int,
                   tp: int = 1, comm=None):
    """The single-step mesh encode (the reference's make_sharded_encode):
    sharded_model, then every shard of every stream coded from fresh lanes
    in one walk a stream, all in one K1 launch a process on a CUDA device,
    and on ranks the coded shards gathered (gather_coded). Returns
    ((words, n_words [dp], states [dp * N]) of meta, of id, of dna, of
    qual, new state): words shard-major, shard s's the n_words[s] after
    those of the shards before it; an absent stream has no words or
    states and n_words 0. codes, kcodes, lengths, qsyms, id_batch: the
    whole batch, as pipeline._encode_batch takes them; tp, comm as
    sharded_model takes them. SE only, as in the reference (no pe
    slot)."""
    if dcfg.pe_log2_buckets > 0:
        raise ValueError("single-step sharded encode has no pe-stream slot; "
                         "use sharded_model and rans.rans_encode_shards (the "
                         "file pipeline path)")
    codes, kcodes, lengths, qsyms, id_batch = base._step_inputs(
        qcfg, icfg, codes, kcodes, lengths, qsyms, id_batch)
    grids, new_state = sharded_model(dcfg, qcfg, mcfg, icfg, state, codes,
                                     qsyms, lengths, id_batch, take, dp,
                                     kcodes, tp, comm=comm)
    coded = gather_coded(comm, rans.rans_encode_fresh(
        grids, dcfg.scale_bits, len(pcomm.shards(comm, dp))))
    empty = (codes.new_zeros((0,), dtype=torch.int32),
             codes.new_zeros((dp,)), codes.new_zeros((0,)))
    q_out = coded[2] if qcfg is not None else empty
    i_out = coded[2 + (qcfg is not None)] if icfg is not None else empty
    return coded[0], i_out, coded[1], q_out, new_state
