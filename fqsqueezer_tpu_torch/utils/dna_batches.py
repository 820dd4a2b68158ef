"""Encoded DNA batches for checking and timing the DNA decode scan (K2).

A batch is made the way the compressor makes one: reads sampled from a
random genome (numpy, from a seed), two warm-up batches through the port's
encoder and state update so that the tables and the model hold real counts,
then the batch itself encoded into one rANS word stream. Decoding it walks
every path of the scan (SIV, s, b and mixed levels, the prefix ramp, rough
rescues, repairs, the letters model), and with sorted_reads the prefix
copy of sorted order (shared prefixes from none to the whole read, a
duplicate lane, the LCP cap of 255 on reads longer than it). A paired-end
batch (pe_row_inputs) is the anchored 3-row recoding of interleaved pairs
whose anchors are chosen, not searched: rows with and without an anchor,
anchors at both ends of read2, an empty rowB, read2 shorter than B. Used
by chip_smoke.py and the tests that need a card; it runs on any device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import pipeline
from ..ops import rans, tables
from ..params import Params, header_generation
from ..streams import common, dna, meta, pe
from .corpus import make_genome, sample_reads

# the s and b tables of these batches hold 2^LOG2_BUCKETS rows each, those
# of an adversarial batch 2^ADVERSARIAL_LOG2_BUCKETS
LOG2_BUCKETS = 16
ADVERSARIAL_LOG2_BUCKETS = 8


def bench_dna_config(n_lanes: int | None = None) -> dna.DnaConfig:
    """The bench primary row's DnaConfig (-gs 5: siv_len 14, s/b-mers 18
    and 21, the header defaults), at another lane count when given."""
    p = Params()
    p.genome_size = 5
    p.adjust_kmer_sizes()
    cfg = pipeline.make_configs(p)[0]
    if n_lanes is not None:
        cfg = dataclasses.replace(cfg, n_lanes=n_lanes)
    return cfg


def legacy_dna_config(gen: str, n_lanes: int | None = None) -> dna.DnaConfig:
    """The DnaConfig of an older writer's header at the bench row's -gs 5
    (params.HEADER_GENERATIONS: "H0", "H5" or "H6"), at another lane
    count when given."""
    p = Params()
    p.genome_size = 5
    header_generation(p, gen)
    cfg = pipeline.make_configs(p)[0]
    if n_lanes is not None:
        cfg = dataclasses.replace(cfg, n_lanes=n_lanes)
    return cfg


def _reads(rng, genome, R, L, seed):
    """codes [R, L] int64 (N = 4, zero past the length) and lengths [R]
    int64: a quarter each of lengths 0, 1 and L, the rest random."""
    codes, _ = sample_reads(genome, R, L, seed, err_rate=0.01, n_rate=0.005)
    lengths = rng.integers(0, L + 1, R)
    lengths[:3 * (R // 4)] = np.resize(np.array([0, 1, L]), 3 * (R // 4))
    rng.shuffle(lengths)
    tail = np.arange(L)[None, :] >= lengths[:, None]
    return (np.where(tail, 0, codes).astype(np.int64),
            lengths.astype(np.int64))


def _share_prefixes(rng, codes, lengths, r_pl):
    """Sorted order's shape on lane-major reads: most reads take a prefix
    of random length (up to the whole read) from the read before them in
    the file, and the second lane repeats one full-length read, so its
    rows after the first have lcp == length (or the cap, 255)."""
    R, L = codes.shape
    for r in range(1, R):
        if rng.random() < 0.8:
            k = int(rng.integers(0, lengths[r] + 1))
            codes[r, :k] = codes[r - 1, :k]
    if R // r_pl > 1:
        lane = slice(r_pl, 2 * r_pl)
        codes[lane] = codes[r_pl]
        lengths[lane] = L
    tail = np.arange(L)[None, :] >= lengths[:, None]
    codes[tail] = 0


def _adversarial(tc, rng):
    """A K2 table made hard for the row update: of its live cells a third
    count 255 and a third 254; in every 8th row slot 1 repeats slot 0's cell
    (a key in two cells); every 3rd row has one empty cell, every 7th two,
    so that new keys race for them."""
    t = tc.clone()
    pick = torch.from_numpy(rng.integers(0, 3, tuple(t.shape))).to(t.device)
    live = t != tables.EMPTY
    t = torch.where(live & (pick == 0), t | 0xFF, t)
    t = torch.where(live & (pick == 1), (t & ~0xFF) | 0xFE, t)
    t[::8, 1] = t[::8, 0]
    t[::3, 2] = tables.EMPTY
    t[::7, 3] = tables.EMPTY
    return t


def dna_decode_inputs(seed: int, n_lanes: int, r_pl: int, L: int, device,
                      grow: bool = False, short: bool = False,
                      adversarial: bool = False, sorted_reads: bool = False,
                      cfg: dna.DnaConfig | None = None):
    """(cfg, state, lengths [R] int64, words int32 [W], init states [N]
    int64) of one encoded batch of R = n_lanes * r_pl reads of width L,
    and with sorted_reads its LCPs ([R] int64, meta.compute_lcp) last: the
    batch's reads share prefixes (_share_prefixes) and are encoded with
    them, as in sorted order.
    grow: the s and b tables are doubled once (tables.sb_grow) before the
    batch, so every find takes a growth bit. short: the word stream is cut
    to half the words the batch needs, so the decode reads past its end
    (those reads clamp to the last word). adversarial: tables of
    2^ADVERSARIAL_LOG2_BUCKETS rows, so that most buckets are full, made
    harder before the batch (_adversarial, K2 tables only): counts at
    255, keys in two cells, new keys racing for one empty cell; the
    batch's rows repeat k-mers. cfg: the geometry and header knobs, when
    they are not the bench row's with 2^LOG2_BUCKETS-row tables; its
    n_lanes must be n_lanes."""
    if cfg is None:
        log2b = ADVERSARIAL_LOG2_BUCKETS if adversarial else LOG2_BUCKETS
        cfg = dataclasses.replace(bench_dna_config(n_lanes),
                                  smer_log2_buckets=log2b,
                                  bmer_log2_buckets=log2b)
    if cfg.n_lanes != n_lanes:
        raise ValueError(f"cfg has {cfg.n_lanes} lanes, not {n_lanes}")
    rng = np.random.default_rng(seed)
    R = n_lanes * r_pl
    genome, state, encode = _warm(cfg, rng, seed, R, L, device)
    if grow:
        state = state._replace(
            s_tc=tables.sb_grow(state.s_tc, cfg.smer_log2_buckets),
            b_tc=tables.sb_grow(state.b_tc, cfg.bmer_log2_buckets))
    if adversarial:
        state = state._replace(s_tc=_adversarial(state.s_tc, rng),
                               b_tc=_adversarial(state.b_tc, rng))
    codes, lengths = _reads(rng, genome, R, L, seed + 3)
    lcp = None
    if sorted_reads:
        _share_prefixes(rng, codes, lengths, r_pl)
        lcp = meta.compute_lcp(torch.from_numpy(codes).to(device),
                               torch.from_numpy(lengths).to(device), n_lanes)
    (_, lengths, *_), (f, cum) = encode(codes, lengths, lcp, state=state)
    plane, init = _word_plane(cfg, f, cum, R * max(L, 2), short, device)
    return (cfg, state, lengths, plane, init) + ((lcp,) if sorted_reads
                                                  else ())


def _warm(cfg, rng, seed, R, L, device):
    """(genome, the DNA state after two warm-up batches of R reads through
    the port's encoder and state update, encode): about 8x coverage a
    batch, so that a batch's k-mers hit the tables. encode(codes, lengths,
    lcp=None, anchor_mask=None, state=..., pos_map=None) models one
    batch: ((codes, lengths, eff, ctx, sym, code_active, s_tc, b_tc),
    (freq, cum))."""
    genome = make_genome(max(600, R * L // 8), seed)

    def encode(codes, lengths, lcp=None, anchor_mask=None, state=None,
               pos_map=None):
        c = torch.from_numpy(codes).to(device)
        n = torch.from_numpy(lengths).to(device)
        kc = torch.where(c >= 4, 0, c)
        eff, ctx, sym, f, cum, act, s_tc, b_tc = dna.dna_process_batch(
            cfg, state, c, kc, n, lcp=lcp, anchor_mask=anchor_mask,
            pos_map=pos_map)
        return (c, n, eff, ctx, sym, act, s_tc, b_tc), (f, cum)

    state = dna.dna_state_create(cfg, device)
    for k in range(2):
        (c, n, eff, ctx, sym, act, s_tc, b_tc), _ = encode(
            *_reads(rng, genome, R, L, seed + 1 + k), state=state)
        state = dna.dna_collect_updates(
            cfg, state._replace(s_tc=s_tc, b_tc=b_tc), c, eff, n, ctx, sym,
            act, skip_sb=cfg.row_global)
    return genome, state, encode


def _word_plane(cfg, f, cum, cap, short, device):
    """(int32 [cap] word plane, init states) of one encoded batch; short
    cuts the plane to half the words the batch needs."""
    words, n_words, init = rans.rans_encode(
        common.to_grid(f, cfg.n_lanes).to(torch.int32).contiguous(),
        common.to_grid(cum, cfg.n_lanes).to(torch.int32).contiguous(),
        cfg.scale_bits)
    n_words = int(n_words)
    cap = max(1, n_words // 2) if short else cap
    plane = torch.zeros((cap,), dtype=torch.int32, device=device)
    keep = min(cap, n_words)
    plane[:keep] = words[:keep]
    return plane, init


# the anchors of pe_row_inputs' pairs, one a pair in turn: none (rowB
# empty), at read2's start, at its end, anywhere, and on a read2 shorter
# than B (the anchor's span is the whole read)
PE_KINDS = ("none", "start", "end", "random", "short")


def pe_row_inputs(seed: int, n_lanes: int, r_pl: int, L: int, device,
                  pe_pos_ctx: bool = False):
    """(cfg, state, rows, words int32 [W], init states [N] int64, bases) of
    one encoded paired-end batch: n_lanes * r_pl interleaved pairs (r_pl pairs
    a lane), mates from one small genome, each pair's anchor of the kind
    PE_KINDS gives it (its span free of N), modeled as the anchored 3-row
    recoding (pe.expand_pe_rows, the spans left uncoded) and encoded into
    one word stream. rows: the dna_decode_row arguments of each expanded
    row, in decode order — (length [N], lcp [N] or None, src [N, L] or
    None, pos: the row's dna.PosMap or None), an anchored row's lcp
    min(B, length) on its anchored lanes and its src the anchor's bases,
    as dna_decode_batch gives them; bases: the rows' encoded base planes,
    [N, L] each, what their decode must give. pe_pos_ctx: the header's
    dna_pe_pos_ctx, so that rowA and rowB take read2's coordinates (the
    encoder's dna._pe_pos_map, the rows' PosMap)."""
    cfg = dataclasses.replace(bench_dna_config(n_lanes),
                              smer_log2_buckets=LOG2_BUCKETS,
                              bmer_log2_buckets=LOG2_BUCKETS,
                              pe_pos_ctx=pe_pos_ctx)
    B = cfg.bmer_len
    rng = np.random.default_rng(seed)
    P = n_lanes * r_pl
    genome, state, encode = _warm(cfg, rng, seed, 2 * P, L, device)
    codes, _ = sample_reads(genome, 2 * P, L, seed + 3, err_rate=0.01,
                            n_rate=0.005)
    codes = codes.astype(np.int64)
    lengths = np.full(2 * P, L, np.int64)
    kinds = np.resize(np.arange(len(PE_KINDS)), P)
    rng.shuffle(kinds)
    a = np.zeros(P, np.int64)
    has = kinds != 0
    for q in range(P):
        kind = PE_KINDS[kinds[q]]
        if kind == "short":
            lengths[2 * q + 1] = int(rng.integers(1, B))
        elif kind == "end":
            a[q] = L - B
        elif kind == "random":
            a[q] = int(rng.integers(0, L - B + 1))
        span = slice(a[q], a[q] + B)
        codes[2 * q + 1, span] = np.where(codes[2 * q + 1, span] >= 4, 0,
                                          codes[2 * q + 1, span])
    tail = np.arange(L)[None, :] >= lengths[:, None]
    codes[tail] = 0
    a_t = torch.from_numpy(a).to(device)
    has_t = torch.from_numpy(has).to(device)
    codes3, lengths3 = pe.expand_pe_rows(
        torch.from_numpy(codes).to(device),
        torch.from_numpy(lengths).to(device), a_t, has_t, B)
    mask3 = pe.expand_lengths_mask(codes3.shape[0], L, has_t, B)
    lengths_t = torch.from_numpy(lengths).to(device)
    lenB = torch.where(has_t, torch.minimum(a_t + B, lengths_t[1::2]), 0)
    pos_map = (dna._pe_pos_map(lengths_t, a_t, has_t, lenB) if pe_pos_ctx
               else None)
    _, (f, cum) = encode(codes3.cpu().numpy(), lengths3.cpu().numpy(),
                         anchor_mask=mask3, state=state, pos_map=pos_map)
    words, init = _word_plane(cfg, f, cum, codes3.shape[0] * max(L, 2),
                              False, device)
    n_rows = 3 * r_pl
    grid = lambda t: common.to_read_grid(t, n_lanes)          # [N, rows]
    len_g = grid(lengths3)
    anchored = grid(torch.stack([torch.zeros_like(has_t), has_t, has_t],
                                dim=1).reshape(-1))
    code_g = codes3.reshape(n_lanes, n_rows, L)
    maps = ([grid(t) for t in pos_map] if pe_pos_ctx else None)
    rows = []
    for rd in range(n_rows):
        length = len_g[:, rd].contiguous()
        if rd % 3 == 0:
            rows.append((length, None, None, None))
        else:
            # an expanded row's own first B bases are its anchor's
            lcp = torch.where(anchored[:, rd], torch.clamp(length, max=B), 0)
            pos = None if maps is None else dna.PosMap(
                2, maps[0][:, rd].contiguous(), maps[2][:, rd].contiguous(),
                1 if rd % 3 == 1 else -1)
            rows.append((length, lcp, code_g[:, rd].contiguous(), pos))
    return cfg, state, rows, words, init, list(code_g.unbind(1))

