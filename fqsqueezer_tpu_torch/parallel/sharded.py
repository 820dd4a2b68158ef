"""The dp x tp mesh's compress step, run on one device.

Port of the writer side of fqsqueezer_tpu/parallel/sharded.py. There a
batch's reads are cut into dp contiguous shards, one a row of devices;
each shard is modeled against the batch-frozen state (its DNA row loop
carrying its own copy of the s/b tables, which is then dropped) and codes
every stream in its own N rANS lanes; the shards' events are gathered and
every device evolves the state once from the whole batch. The tp axis
shards the s/b tables and the SIV by rows, and its finds sum the shards'
answers to the local one, so it changes no value.

Here the shards run in turn on one device (sharded_model): each through
pipeline._model_rows against the frozen state, then one
pipeline.collect_batch of their events concatenated in shard order — the
update the sequential mesh decode replays (parallel.mesh_pipeline). A
stream's grid is the shards' [T, N] grids side by side, [T, dp * N], so
one walk codes every shard (rans.rans_encode_shards): one K1 launch a
group flush on a CUDA device, or for the single-step encode
(sharded_encode, rans.rans_encode_fresh) one a batch.
"""
from __future__ import annotations

import torch

from .. import pipeline as base
from ..ops import rans


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


def cat_shards(parts):
    """Concatenate the shards' outputs along the reads, leaf by leaf
    (None stays None)."""
    if parts[0] is None:
        return None
    if isinstance(parts[0], (tuple, list)):
        return tuple(cat_shards(list(p)) for p in zip(*parts))
    return torch.cat(parts, dim=0)


def sharded_model(dcfg, qcfg, mcfg, icfg, state: base.CodecState,
                  codes: torch.Tensor, qsyms, lengths: torch.Tensor,
                  id_batch, take: int, dp: int, kcodes=None):
    """One batch's mesh modeling step: the reference's make_sharded_model.
    codes (and kcodes, default codes with N as 0): [R, L] int64, R a
    multiple of dp x n_lanes; qsyms: [R, L] int64 or None; lengths: [R];
    id_batch: the encode_ids_host planes (mesh_read_lanes) as tensors, or
    (); take: the batch's real reads. Returns ([(freq, cum) int32 [T, dp *
    N] per stream, archive order], new state); `state` is left as it
    was."""
    R_shard = codes.shape[0] // dp
    grids, events = [], []
    for s in range(dp):
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
    return side_by_side, base.collect_batch(dcfg, state, *cat_shards(events),
                                            codes, lengths)


def sharded_encode(dcfg, qcfg, mcfg, icfg, state: base.CodecState, codes,
                   kcodes, lengths, qsyms, id_batch, take: int, dp: int):
    """The single-step mesh encode (the reference's make_sharded_encode):
    sharded_model, then every shard of every stream coded from fresh lanes
    in one walk a stream, all in one K1 launch on a CUDA device. Returns
    ((words, n_words [dp], states [dp * N]) of meta, of id, of dna, of
    qual, new state): words shard-major, shard s's the n_words[s] after
    those of the shards before it; an absent stream has no words or
    states and n_words 0. codes, kcodes, lengths, qsyms, id_batch: as
    pipeline._encode_batch takes them. SE only, as in the reference (no
    pe slot)."""
    if dcfg.pe_log2_buckets > 0:
        raise ValueError("single-step sharded encode has no pe-stream slot; "
                         "use sharded_model and rans.rans_encode_shards (the "
                         "file pipeline path)")
    codes, kcodes, lengths, qsyms, id_batch = base._step_inputs(
        qcfg, icfg, codes, kcodes, lengths, qsyms, id_batch)
    grids, new_state = sharded_model(dcfg, qcfg, mcfg, icfg, state, codes,
                                     qsyms, lengths, id_batch, take, dp,
                                     kcodes)
    coded = rans.rans_encode_fresh(grids, dcfg.scale_bits, dp)
    empty = (codes.new_zeros((0,), dtype=torch.int32),
             codes.new_zeros((dp,)), codes.new_zeros((0,)))
    q_out = coded[2] if qcfg is not None else empty
    i_out = coded[2 + (qcfg is not None)] if icfg is not None else empty
    return coded[0], i_out, coded[1], q_out, new_state
