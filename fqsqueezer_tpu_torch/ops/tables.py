"""k-mer counter stores as dense integer arrays.

Port of fqsqueezer_tpu/ops/tables.py: the packed SIV (u8x4 next-base counters
per (p-1)-mer context), the three s/b table families and the paired-end
pair table. All u32 words are held in int64, so a word with bit 31 set
orders correctly under a signed scatter-max, and every u32 add is masked
back to 32 bits where the reference's wraps. The reference's dropped
scatters (mode="drop") are explicit masks here: an invalid event either
adds 0, or max-es 0, into a cell, or lands in a dump slot that is cut off.

The s/b table families, by row width:
  * table_* (BUCKET = 8 cells, 16 words a row): context-keyed cells, a
    tag and 4 packed u8 next-base counts each, updated once a batch with
    claim rounds (the first writer's tables, dna_canon = 0);
  * ktable_* (KBUCKET = 4 cells, KW = 6 words a row): canonical k-mer
    cells, 4 tags then 4 u16 counters packed 2 a word, clipped to 255 at
    find (dna_canon = 1, dna_sb_proto = 0);
  * k2_* (KBUCKET single-word cells, 4 words a row): tag24 | count8
    (dna_sb_proto = 1). ktable_* dispatches to k2_* on the row width.
Beside them, the in-batch local tables of the headers without row-global
updates (local_*, klocal_*): direct-addressed cells a batch fills from
zero, read row by read row.
"""
from __future__ import annotations

import torch

from .._u32 import MASK32, mul_u32
from . import kmers

EMPTY = 0
_BYTE = 0xFF
_M7 = 0x7F7F7F7F
_H8 = 0x80808080


def unpack_counts(word: torch.Tensor) -> torch.Tensor:
    """u32 word -> [..., 4] counts."""
    return torch.stack([(word >> (8 * b)) & _BYTE for b in range(4)], dim=-1)


def pack_counts(c4: torch.Tensor) -> torch.Tensor:
    """[..., 4] counts (clamped to 255) -> u32 word."""
    c4 = torch.clamp(c4, 0, 255)
    return (c4[..., 0] | (c4[..., 1] << 8) | (c4[..., 2] << 16)
            | (c4[..., 3] << 24))


_CTZ8 = tuple((x & -x).bit_length() - 1 if x else 0 for x in range(256))


def _ctz(x: torch.Tensor) -> torch.Tensor:
    """Count trailing zeros of an 8-bit mask (0 for x == 0, where the
    reference's value differs but is never used)."""
    return torch.tensor(_CTZ8, dtype=torch.int64, device=x.device)[x]


def _claim_slot(bm, j, width: int):
    """The claim slot of a new key: the first set bit of the bucket's
    empty-cell mask bm after rotating it right by j."""
    rot = ((bm >> j) | (bm << (width - j))) & ((1 << width) - 1)
    return (j + _ctz(rot)) & (width - 1)


def _first_match(match: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 where none is)."""
    return torch.argmax(match.to(torch.int64), dim=-1)


def _empty_mask(cells: torch.Tensor) -> torch.Tensor:
    """[..., W] cells -> [...] bit mask of the empty ones."""
    w = 1 << torch.arange(cells.shape[-1], dtype=torch.int64,
                          device=cells.device)
    return torch.where(cells == EMPTY, w, 0).sum(dim=-1)


def _scatter_max(tc: torch.Tensor, idx, src) -> torch.Tensor:
    """A new table: tc's flat words max-ed with src at idx (idx [n] flat
    word indices; an event that must not land maxes 0 into word 0)."""
    return tc.reshape(-1).clone().scatter_reduce_(
        0, idx, src, "amax").reshape(tc.shape)


def swar_sat_add_u8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-byte saturating add of u8x4-packed u32 words."""
    lo7 = (a & _M7) + (b & _M7)
    s = lo7 ^ ((a ^ b) & _H8)
    ov = ((a & b) | ((a | b) & ~s)) & _H8       # carry out of each byte
    return s | ((ov >> 7) * 0xFF)


def _scatter_delta_u8(n_words: int, idx, base, valid):
    """Per-(word, base) increments accumulated in a double-length plane of
    u16x2-packed u32 words (word i = bases 0|1, word n_words+i = bases 2|3),
    collapsed to a saturated u8x4 delta word. Each count keeps its u16 half
    of a u32, exactly as in the reference: more than 65535 events on one
    (word, base) in one call carry into the neighbouring base."""
    b = base & 3
    idx2 = torch.where(valid, idx + (b >> 1) * n_words, 0)
    inc = torch.where(valid, 1 << ((b & 1) << 4), 0)
    d = torch.zeros(2 * n_words, dtype=torch.int64, device=idx.device)
    d = d.index_add_(0, idx2, inc) & MASK32
    c01 = d[:n_words]
    c23 = d[n_words:]
    c0 = torch.clamp(c01 & 0xFFFF, max=255)
    c1 = torch.clamp(c01 >> 16, max=255)
    c2 = torch.clamp(c23 & 0xFFFF, max=255)
    c3 = torch.clamp(c23 >> 16, max=255)
    return c0 | (c1 << 8) | (c2 << 16) | (c3 << 24)


# ---------------------------------------------------------------------------
# SIV: dense p-mer counters
# ---------------------------------------------------------------------------

def siv_create(siv_len: int, device=None) -> torch.Tensor:
    """Word i packs the 4 saturating u8 next-base counters of (p-1)-mer
    context i."""
    return torch.zeros((4 ** (siv_len - 1),), dtype=torch.int64,
                       device=device)


def siv_find(siv: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
    """ctx: [...] (p-1)-mer values. Returns [..., 4] counts."""
    return unpack_counts(siv[ctx])


def siv_fill(siv: torch.Tensor):
    """(nonzero counters, capacity) of the packed SIV."""
    return (unpack_counts(siv) > 0).sum(), 4 * siv.shape[0]


def siv_prune(siv: torch.Tensor) -> torch.Tensor:
    """Clear singleton counters (count == 1)."""
    c4 = unpack_counts(siv)
    return pack_counts(torch.where(c4 <= 1, 0, c4))


def siv_update(siv: torch.Tensor, keys: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """Batch-increment cells. keys: [n] packed (ctx << 2 | base); counts
    saturate at 255."""
    delta = _scatter_delta_u8(siv.shape[0], keys >> 2, keys, valid)
    return swar_sat_add_u8(siv, delta)


# ---------------------------------------------------------------------------
# K2 tables: canonical k-mer cells, tag24 | count8 in one u32
# ---------------------------------------------------------------------------
# Cell layout: [31:8] tag word (15 verification hash bits | forced 1 | 4
# mid-derived growth bits | 4-bit end-letter slot), [7:0] count. A row is
# KBUCKET cells. One update is one row gather + one scatter-max (see
# fqsqueezer_tpu/ops/tables.py for the protocol and its duplicate-count
# semantics).

KBUCKET = 4
_K2_TAG = 0xFFFFFF00


def k2_create(log2_buckets: int, device=None) -> torch.Tensor:
    return torch.zeros((1 << log2_buckets, KBUCKET), dtype=torch.int64,
                       device=device)


def k2tag(tag: torch.Tensor) -> torch.Tensor:
    """32-bit KTable tag (kmers.ktag layout) -> 24-bit cell tag word; bit
    23 is forced so a stored cell is never 0 (= EMPTY)."""
    return ((tag & 0xF) | (((tag >> 23) & 0xF) << 4)
            | (((tag >> 4) & 0x7FFF) << 8) | (1 << 23))


def kbucket_of(tag: torch.Tensor, bkt_base: torch.Tensor, log2_buckets: int,
               log2_base: int) -> torch.Tensor:
    """Bucket of a key in a table grown from 2^log2_base to 2^log2_buckets
    buckets: base bits from the middle hash, growth bits from tag bits
    [23, 27)."""
    grow = log2_buckets - log2_base
    if grow <= 0:
        return bkt_base
    return bkt_base | (((tag >> 23) & ((1 << grow) - 1)) << log2_base)


def _log2_rows(tc: torch.Tensor) -> int:
    return tc.shape[0].bit_length() - 1


def k2_find(tc: torch.Tensor, bkt: torch.Tensor, tags4: torch.Tensor,
            log2_base: int = -1):
    """4-way next-base query: bkt [...] base buckets (middle hash at
    creation size), tags4 [..., 4] candidate tags. Returns ([..., 4] counts,
    [...] found) from one row gather."""
    log2_buckets = _log2_rows(tc)
    if log2_base < 0:
        log2_base = log2_buckets
    b = kbucket_of(tags4[..., 0], bkt, log2_buckets, log2_base)
    row = tc[b]                                        # [..., KBUCKET]
    tw = k2tag(tags4) << 8                             # [..., 4]
    match = (row[..., None, :] & _K2_TAG) == tw[..., :, None]
    cnt = row & 0xFF
    counts = torch.where(match, cnt[..., None, :], 0).sum(dim=-1)
    found = match.flatten(-2).any(dim=-1)
    return counts, found


def k2_update(tc: torch.Tensor, bkt: torch.Tensor, tag: torch.Tensor,
              valid: torch.Tensor, log2_base: int = -1) -> torch.Tensor:
    """Batch insert/increment of canonical k-mer events (bkt/tag/valid [n]
    flat; tag is the 32-bit KTable tag): one row gather, one scatter-max.
    Found events write cell + 1 (saturating at count 255), new keys write
    tag | 1 into a cell that was empty in the gather snapshot; the max
    resolves every conflict. Invalid events max 0 into cell 0 — a no-op,
    since cells are >= 0. Returns a new table."""
    n_buckets = tc.shape[0]
    log2_buckets = _log2_rows(tc)
    if log2_base < 0:
        log2_base = log2_buckets
    bkt = kbucket_of(tag, bkt, log2_buckets, log2_base)
    row = tc[bkt]                                      # [n, KBUCKET]
    tw = k2tag(tag) << 8
    match = (row & _K2_TAG) == tw[:, None]
    found = match.any(dim=1) & valid
    cell = _first_match(match)
    cellv = torch.where(match, row, 0).sum(dim=1) & MASK32
    bm = _empty_mask(row)
    want = valid & ~found & (bm > 0)
    slot = _claim_slot(bm, ((tag >> 13) ^ tag) & (KBUCKET - 1), KBUCKET)
    dcell = torch.where(found, cell, slot)
    newv = torch.where(found, cellv + ((cellv & 0xFF) < 0xFF).to(torch.int64),
                       tw | 1)
    ok = found | want
    return _scatter_max(tc, torch.where(ok, bkt * KBUCKET + dcell, 0),
                        torch.where(ok, newv, 0))


def k2_grow(tc: torch.Tensor, log2_base: int) -> torch.Tensor:
    """Double the bucket count: every cell moves whole, keeping its slot, to
    bucket (old | growth bit << old_log2), the growth bit read from its tag
    word (cell bits [12, 16))."""
    n_buckets = tc.shape[0]
    log2b = _log2_rows(tc)
    live = tc != EMPTY
    gb = (tc >> (12 + log2b - log2_base)) & 1
    new_bkt = torch.arange(n_buckets, dtype=torch.int64,
                           device=tc.device)[:, None] + gb * n_buckets
    slot = torch.arange(KBUCKET, dtype=torch.int64, device=tc.device)[None, :]
    dump = 2 * n_buckets * KBUCKET
    flat = torch.where(live, new_bkt * KBUCKET + slot, dump)
    new = torch.zeros(dump + 1, dtype=torch.int64, device=tc.device)
    new.scatter_(0, flat.reshape(-1), tc.reshape(-1))
    return new[:dump].reshape(2 * n_buckets, KBUCKET)


# ---------------------------------------------------------------------------
# KTable: canonical k-mer cells with u16 counters (dna_sb_proto = 0)
# ---------------------------------------------------------------------------
# Same queries as K2 (bucket from the middle hash, the 4 candidates' 32-bit
# tags), rows of KBUCKET tags then KBUCKET u16 slot counters packed two a
# u32 word. An update is the fused 3-pass protocol: one row gather decides,
# a scatter-max claims new keys' tags, a scatter-add adds 1 << 16*(cell & 1)
# to the counter word of the decided cell. The add goes to that cell even
# where another key won its claim, and a counter at 0xFFFF carries into its
# neighbour (or out of the word): the u32 sum is masked to 32 bits, as the
# reference's wraps. Counters are clipped to 255 at find.

KW = KBUCKET + KBUCKET // 2   # row width in u32 words


def ktable_create(log2_buckets: int, device=None) -> torch.Tensor:
    return torch.zeros((1 << log2_buckets, KW), dtype=torch.int64,
                       device=device)


def _is_k2(tc: torch.Tensor) -> bool:
    return tc.shape[-1] == KBUCKET


def _counters(w: torch.Tensor) -> torch.Tensor:
    """[..., KBUCKET // 2] packed words -> [..., KBUCKET] u16 counters."""
    return torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(
        w.shape[:-1] + (KBUCKET,))


def ktable_find(tc, bkt, tags4, log2_base: int = -1):
    """4-way next-base query: bkt [...] base buckets (middle hash at
    creation size), tags4 [..., 4] candidate tags. Returns ([..., 4]
    counts, [...] found) from one row gather; K2 tables take k2_find."""
    if _is_k2(tc):
        return k2_find(tc, bkt, tags4, log2_base)
    log2_buckets = _log2_rows(tc)
    if log2_base < 0:
        log2_base = log2_buckets
    row = tc[kbucket_of(tags4[..., 0], bkt, log2_buckets, log2_base)]
    match = row[..., None, :KBUCKET] == tags4[..., :, None]  # [..., 4, KB]
    cnt = torch.clamp(_counters(row[..., KBUCKET:]), max=255)
    counts = torch.where(match, cnt[..., None, :], 0).sum(dim=-1)
    return counts, match.flatten(-2).any(dim=-1)


def ktable_update(tc, bkt, tag, valid, log2_base: int = -1):
    """Batch insert/increment of canonical k-mer events (bkt/tag/valid [n]
    flat): the fused protocol of the block comment. Returns a new table;
    K2 tables take k2_update."""
    if _is_k2(tc):
        return k2_update(tc, bkt, tag, valid, log2_base)
    log2_buckets = _log2_rows(tc)
    if log2_base < 0:
        log2_base = log2_buckets
    bkt = kbucket_of(tag, bkt, log2_buckets, log2_base)
    tags_r = tc[bkt][:, :KBUCKET]
    match = tags_r == tag[:, None]
    found = match.any(dim=1) & valid
    bm = _empty_mask(tags_r)
    want = valid & ~found & (bm > 0)
    slot = _claim_slot(bm, ((tag >> 13) ^ tag) & (KBUCKET - 1), KBUCKET)
    tc = _scatter_max(tc, torch.where(want, bkt * KW + slot, 0),
                      torch.where(want, tag, 0))
    dcell = torch.where(found, _first_match(match), slot)
    ok = found | want
    inc = torch.where(ok, 1 << ((dcell & 1) << 4), 0)
    flat = tc.reshape(-1).index_add_(
        0, torch.where(ok, bkt * KW + KBUCKET + (dcell >> 1), 0), inc)
    return (flat & MASK32).reshape(tc.shape)


def ktable_grow(tc, log2_base: int):
    """Double the bucket count: every cell moves, keeping its slot, to
    bucket (old | growth bit << old_log2), the bit read from its tag; its
    u16 counter moves with it into the destination's packed word."""
    if _is_k2(tc):
        return k2_grow(tc, log2_base)
    n_buckets = tc.shape[0]
    log2b = _log2_rows(tc)
    tags = tc[:, :KBUCKET]
    cnt16 = _counters(tc[:, KBUCKET:])
    new_bkt = torch.arange(n_buckets, dtype=torch.int64,
                           device=tc.device)[:, None] + (
        (tags >> (23 + log2b - log2_base)) & 1) * n_buckets
    slot = torch.arange(KBUCKET, dtype=torch.int64, device=tc.device)[None]
    live = tags != EMPTY
    dump = 2 * n_buckets * KW
    new = torch.zeros(dump + 1, dtype=torch.int64, device=tc.device)
    new.scatter_(0, torch.where(live, new_bkt * KW + slot, dump).reshape(-1),
                 tags.reshape(-1))
    # each destination u16 half is written by one source cell at most
    new.index_add_(0, torch.where(live, new_bkt * KW + KBUCKET + (slot >> 1),
                                  dump).reshape(-1),
                   (cnt16 << (16 * (slot & 1))).reshape(-1))
    return new[:dump].reshape(2 * n_buckets, KW)


def ktable_clamp(tc):
    """Clamp each u16 counter to 0x8000 (run at every group end by both
    sides); K2 cells saturate inside the update: a no-op."""
    if _is_k2(tc):
        return tc
    w = tc[:, KBUCKET:]
    lo = torch.clamp(w & 0xFFFF, max=0x8000)
    hi = torch.clamp(w >> 16, max=0x8000)
    return torch.cat([tc[:, :KBUCKET], lo | (hi << 16)], dim=1)


def ktable_fill_stats(tc):
    """(used cells, capacity)."""
    cells = tc if _is_k2(tc) else tc[:, :KBUCKET]
    return (cells != EMPTY).sum(), tc.shape[0] * KBUCKET


# ---------------------------------------------------------------------------
# CountTable: context-keyed (tag, u8x4 counts) cells (dna_canon = 0)
# ---------------------------------------------------------------------------
# One row a bucket: BUCKET tags, then BUCKET u8x4-packed next-base count
# words. A key is a (lo, hi) context; its bucket comes from the bucket hash
# at creation size and, once the table has grown, growth bits from tag bits
# [23, 27). Updated once a batch (tables frozen inside it), with both
# strands' events.

BUCKET = 8   # cells a bucket row, here and in the pair table
W_TABLE = 2 * BUCKET


def table_create(log2_buckets: int, device=None) -> torch.Tensor:
    return torch.zeros((1 << log2_buckets, W_TABLE), dtype=torch.int64,
                       device=device)


def bucket_of(lo, hi, log2_buckets: int, log2_base: int) -> torch.Tensor:
    """Bucket of a key in a table grown from 2^log2_base to 2^log2_buckets
    buckets."""
    b = kmers.hash_bucket(lo, hi, min(log2_buckets, log2_base))
    grow = log2_buckets - log2_base
    if grow > 0:
        t = kmers.hash_tag(lo, hi)
        b = b | (((t >> 23) & ((1 << grow) - 1)) << log2_base)
    return b


def table_grow(tc: torch.Tensor, log2_base: int) -> torch.Tensor:
    """Double the bucket count: every live cell moves, keeping its slot, to
    bucket (old | growth bit << old_log2), its tag and count together."""
    n_buckets = tc.shape[0]
    log2b = _log2_rows(tc)
    tags = tc[:, :BUCKET]
    new_bkt = torch.arange(n_buckets, dtype=torch.int64,
                           device=tc.device)[:, None] + (
        (tags >> (23 + log2b - log2_base)) & 1) * n_buckets
    slot = torch.arange(BUCKET, dtype=torch.int64, device=tc.device)[None]
    live = tags != EMPTY
    dump = 2 * n_buckets * W_TABLE
    new = torch.zeros(dump + 1, dtype=torch.int64, device=tc.device)
    for off, vals in ((0, tags), (BUCKET, tc[:, BUCKET:])):
        new.scatter_(0, torch.where(live, new_bkt * W_TABLE + off + slot,
                                    dump).reshape(-1), vals.reshape(-1))
    return new[:dump].reshape(2 * n_buckets, W_TABLE)


def table_find(tc: torch.Tensor, lo, hi, log2_base: int = -1):
    """Query contexts lo/hi [...] (u32 key halves). Returns ([..., 4]
    counts, [...] found) from one row gather."""
    log2_buckets = _log2_rows(tc)
    if log2_base < 0:
        log2_base = log2_buckets
    row = tc[bucket_of(lo, hi, log2_buckets, log2_base)]
    match = row[..., :BUCKET] == kmers.hash_tag(lo, hi)[..., None]
    word = torch.where(match, row[..., BUCKET:], 0).sum(dim=-1) & MASK32
    return unpack_counts(word), match.any(dim=-1)


def table_update(tc: torch.Tensor, lo, hi, base, valid, bkt=None, tag=None,
                 log2_base: int = -1, rounds: int = 2) -> torch.Tensor:
    """Batch insert/increment of (context -> next base) events, lo/hi/base/
    valid [n]. Returns a new table.

    rounds >= 1, the claim-round protocol: in round r every event whose
    key is absent from its bucket and whose bucket has an empty cell
    scatter-maxes its tag into the empty cell found by rotating the
    bucket's empty mask by (tag >> (13 + 3r)) & 7; then every event
    re-probes, and the events whose key is present add their base's count
    (one saturating u8 delta word a cell, _scatter_delta_u8). Keys still
    unplaced are dropped. rounds == 0, the fused protocol: one gather
    decides, claims scatter-max, and every deciding event (found, or
    claiming) adds its count to its decided cell, even where another key
    won the claim."""
    n = lo.shape[0]
    n_buckets = tc.shape[0]
    dev = tc.device
    if bkt is None:
        log2_buckets = _log2_rows(tc)
        bkt = bucket_of(lo, hi, log2_buckets,
                        log2_buckets if log2_base < 0 else log2_base)
    if tag is None:
        tag = kmers.hash_tag(lo, hi)
    bkt = torch.where(valid, bkt, torch.arange(n, dtype=torch.int64,
                                               device=dev) & (n_buckets - 1))

    def probe(tc):
        tags_r = tc[bkt][:, :BUCKET]
        match = tags_r == tag[:, None]
        return tags_r, match, match.any(dim=1) & valid

    if rounds == 0:
        tags_r, match, found = probe(tc)
        bm = _empty_mask(tags_r)
        want = valid & ~found & (bm > 0)
        slot = _claim_slot(bm, (tag >> 13) & (BUCKET - 1), BUCKET)
        tc = _scatter_max(tc, torch.where(want, bkt * W_TABLE + slot, 0),
                          torch.where(want, tag, 0))
        dcell = torch.where(found, _first_match(match), slot)
        ok = found | want
        # one u32 counter a (cell, base), saturated once at 255
        d = torch.zeros(n_buckets * 4 * BUCKET, dtype=torch.int64,
                        device=dev).index_add_(
            0, torch.where(ok, bkt * 4 * BUCKET + 4 * dcell + (base & 3), 0),
            ok.to(torch.int64))
        d = torch.clamp(d.reshape(n_buckets, BUCKET, 4), max=255)
        delta = (d[..., 0] | (d[..., 1] << 8) | (d[..., 2] << 16)
                 | (d[..., 3] << 24))
        return torch.cat([tc[:, :BUCKET],
                          swar_sat_add_u8(tc[:, BUCKET:], delta)], dim=1)

    for r in range(rounds):
        tags_r, _, found = probe(tc)
        bm = _empty_mask(tags_r)
        want = valid & ~found & (bm > 0)
        slot = _claim_slot(bm, (tag >> (13 + 3 * r)) & (BUCKET - 1), BUCKET)
        tc = _scatter_max(tc, torch.where(want, bkt * W_TABLE + slot, 0),
                          torch.where(want, tag, 0))
    _, match, found = probe(tc)
    delta = _scatter_delta_u8(n_buckets * BUCKET,
                              bkt * BUCKET + _first_match(match), base, found)
    return torch.cat([tc[:, :BUCKET], swar_sat_add_u8(
        tc[:, BUCKET:], delta.reshape(n_buckets, BUCKET))], dim=1)


def table_fill_stats(tc: torch.Tensor):
    """(used cells, capacity)."""
    return (tc[:, :BUCKET] != EMPTY).sum(), tc.shape[0] * BUCKET


# ---------------------------------------------------------------------------
# Group-end steps on an s/b table of any family, chosen by its row width
# ---------------------------------------------------------------------------

def _is_table(tc: torch.Tensor) -> bool:
    return tc.shape[-1] == W_TABLE


def sb_cells(tc: torch.Tensor) -> int:
    """Cells a bucket row."""
    return BUCKET if _is_table(tc) else KBUCKET


def sb_grow(tc: torch.Tensor, log2_base: int) -> torch.Tensor:
    """Double the bucket count by the family's grow step."""
    return table_grow(tc, log2_base) if _is_table(tc) else ktable_grow(
        tc, log2_base)


def sb_clamp(tc: torch.Tensor) -> torch.Tensor:
    """Clamp u16 counters away from their wrap; a no-op on the families
    without them (table_* u8 counts, K2 cells)."""
    return tc if _is_table(tc) else ktable_clamp(tc)


def sb_fill_stats(tc: torch.Tensor):
    """(used cells, capacity)."""
    return table_fill_stats(tc) if _is_table(tc) else ktable_fill_stats(tc)


# ---------------------------------------------------------------------------
# LocalTable: in-batch direct-addressed (tag, counts) cells
# ---------------------------------------------------------------------------
# Statistics of the k-mers seen earlier in the batch (the reference's
# ht_*_local), applied a read row at a time. A cell is one row of LOCAL_W
# words: a stamped tag, then the 4 next-base counts. The first read ROW to
# touch an empty cell owns it for the batch: the stored tag word is (31 -
# min(row, 31)) << 27 | tag27, so one scatter-max is the claim, the
# earliest row wins, and within a row the larger tag. Keys that find the
# cell owned by another tag are dropped (lite = False), or add to it all
# the same (lite = True: the 2-pass protocol; queries still check the
# tag). A batch owns its local tables, so inserts update them in place.

LOCAL_TAG_MASK = (1 << 27) - 1
LOCAL_W = 5    # row: [stamped tag, count A, C, G, T]
KLOCAL_W = 9   # row: [stamped mid-tag, 8 u16x2-packed count words]


def local_create(log2_cells: int, device=None) -> torch.Tensor:
    """[2^log2_cells, LOCAL_W] u32 words in int64, all 0."""
    return torch.zeros((1 << log2_cells, LOCAL_W), dtype=torch.int64,
                       device=device)


def local_keys(lo, hi, log2_cells: int):
    """(cell, tag27) of (lo, hi) keys; tag27 has bit 26 set, so a stored
    word is never 0."""
    tag = (kmers.hash_tag(lo, hi) & LOCAL_TAG_MASK) | (1 << 26)
    return kmers.hash_bucket(lo, hi, log2_cells), tag


def local_query(tc: torch.Tensor, cell, tag, valid) -> torch.Tensor:
    """[..., 4] counts (zeros on a miss or where not valid)."""
    row = tc[cell]
    hit = ((row[..., 0] & LOCAL_TAG_MASK) == tag) & valid
    return torch.where(hit[..., None], row[..., 1:], 0)


def _local_claim(tc, cell, tag, valid, row, lite: bool):
    """The stamped claim of every valid event, in place, and which events
    then add to their cell: all valid ones (lite), or those whose tag owns
    the cell."""
    width = tc.shape[1]
    stamped = ((31 - min(max(int(row), 0), 31)) << 27) | tag
    tc.view(-1).scatter_reduce_(0, torch.where(valid, cell * width, 0),
                                torch.where(valid, stamped, 0), "amax")
    if lite:
        return valid
    return valid & ((tc[cell, 0] & LOCAL_TAG_MASK) == tag)


def _local_add(tc, idx, inc, ok) -> torch.Tensor:
    """Add inc to the flat words idx where ok, in place, each touched word
    masked back to 32 bits as the reference's u32 add wraps."""
    flat = tc.view(-1)
    idx = torch.where(ok, idx, 0)
    flat.index_add_(0, idx, torch.where(ok, inc, 0))
    flat[idx] = flat[idx] & MASK32
    return tc


def local_insert(tc: torch.Tensor, cell, tag, base, valid, row: int = 0,
                 lite: bool = False) -> torch.Tensor:
    """Insert (context -> base) events, cell/tag/base/valid [n] flat, of
    read row `row` (the claim's priority), into tc in place; returns it."""
    ok = _local_claim(tc, cell, tag, valid, row, lite)
    return _local_add(tc, cell * LOCAL_W + 1 + base, torch.ones_like(cell),
                      ok)


# KLocal: the canonical in-batch table (dna_canon = 1). A cell is keyed by
# the canonical MIDDLE of the k-mer and holds 16 u16 counters, slot = 4 *
# first + last of the canonical end letters: one row gather answers the 4
# candidates of a query, one event covers an occurrence on both strands.
# A counter past 65535 carries into its neighbour or out of the word, as
# the reference's u32 add does.

def klocal_create(log2_cells: int, device=None) -> torch.Tensor:
    """[2^log2_cells, KLOCAL_W] u32 words in int64, all 0."""
    return torch.zeros((1 << log2_cells, KLOCAL_W), dtype=torch.int64,
                       device=device)


def klocal_query(tc: torch.Tensor, cell, tag, slots4, valid) -> torch.Tensor:
    """[..., 4] counts of the 4 next-base candidates (zeros on a miss);
    slots4 [..., 4] their canonical end-letter slots."""
    row = tc[cell]
    hit = ((row[..., 0] & LOCAL_TAG_MASK) == tag) & valid
    w = torch.gather(row[..., 1:], -1, slots4 >> 1)
    c = (w >> ((slots4 & 1) << 4)) & 0xFFFF
    return torch.where(hit[..., None], c, 0)


def klocal_insert(tc: torch.Tensor, cell, tag, slot, valid, row: int = 0,
                  lite: bool = False) -> torch.Tensor:
    """Insert canonical k-mer events, cell/tag/slot/valid [n] flat: the
    stamped claim of local_insert, then 1 << 16 * (slot & 1) into the
    slot's word, in place; returns tc."""
    ok = _local_claim(tc, cell, tag, valid, row, lite)
    return _local_add(tc, cell * KLOCAL_W + 1 + (slot >> 1),
                      1 << ((slot & 1) << 4), ok)


# ---------------------------------------------------------------------------
# PairTable: bucketed (key -> partner-minimizer, weight) slots
# ---------------------------------------------------------------------------
# The paired-end minimizer pair table of fqsqueezer_tpu/ops/tables.py: a
# slot holds (key tag, value lo, value hi, weight); several slots of a
# bucket may share the key tag with different values. Values are stored
# exactly, since the decoder rebuilds an anchor's bases from them.


def pair_create(log2_buckets: int, device=None):
    """(tags, vlo, vhi, cnt): four [2^log2_buckets, BUCKET] u32 planes in
    int64."""
    return tuple(torch.zeros((1 << log2_buckets, BUCKET), dtype=torch.int64,
                             device=device) for _ in range(4))


def pair_find(pt, klo: torch.Tensor, khi: torch.Tensor):
    """Query keys [...]: returns (vlo, vhi, cnt) rows [..., BUCKET]; cnt is 0
    on slots whose key tag does not match."""
    tags, vlo, vhi, cnt = pt
    bkt = kmers.hash_bucket(klo, khi, _log2_rows(tags))
    tag = kmers.hash_tag(klo, khi)
    match = tags[bkt] == tag[..., None]
    return vlo[bkt], vhi[bkt], torch.where(match, cnt[bkt], 0)


def pair_update(pt, klo, khi, vlo_n, vhi_n, w, valid):
    """Batch (key -> value, weight) inserts; all [n] flat. Returns the new
    planes (the given ones are left as they were).

    The reference's protocol: a slot's identity is (key tag, vlo, vhi); in
    each of two claim rounds, events whose triple is absent and whose
    bucket has an empty slot scatter-max a 32-bit ticket (a hash of tag and
    value) into a claim plane at their rotated slot, and the events that
    read their own ticket back write the three identity words. A claimed
    slot was empty in the round's snapshot, and an empty slot's three
    words are 0 (slots are never freed), so those writes are scatter-maxes
    too, and an event that does not win maxes 0 into cell 0. Then every
    event whose triple is present adds its weight to the first matching
    slot, and counts clamp at 2^20."""
    tags, vlo, vhi, cnt = pt
    n_buckets = tags.shape[0]
    dev = tags.device
    bkt = torch.where(valid, kmers.hash_bucket(klo, khi, _log2_rows(tags)),
                      torch.arange(klo.shape[0], dtype=torch.int64,
                                   device=dev) & (n_buckets - 1))
    tag = kmers.hash_tag(klo, khi)
    ticket = kmers.hash_tag(mul_u32(vlo_n, 0x9E3779B1) ^ tag, vhi_n)
    j = (ticket >> 13) & (BUCKET - 1)
    for r in range(2):
        row_t, row_l, row_h = tags[bkt], vlo[bkt], vhi[bkt]
        found = ((row_t == tag[:, None]) & (row_l == vlo_n[:, None])
                 & (row_h == vhi_n[:, None])).any(dim=1) & valid
        bm = _empty_mask(row_t)
        want = valid & ~found & (bm > 0)
        slot = _claim_slot(bm, (j + 3 * r) & (BUCKET - 1), BUCKET)
        cell = torch.where(want, bkt * BUCKET + slot, n_buckets * BUCKET)
        claim = torch.zeros(((n_buckets + 1) * BUCKET,), dtype=torch.int64,
                            device=dev).scatter_reduce_(0, cell, ticket,
                                                        "amax")
        win = want & (claim[cell] == ticket)
        at = torch.where(win, cell, 0)
        tags, vlo, vhi = (
            plane.reshape(-1).clone().scatter_reduce_(
                0, at, torch.where(win, val, 0), "amax").reshape(
                    n_buckets, BUCKET)
            for plane, val in ((tags, tag), (vlo, vlo_n), (vhi, vhi_n)))
    match2 = ((tags[bkt] == tag[:, None]) & (vlo[bkt] == vlo_n[:, None])
              & (vhi[bkt] == vhi_n[:, None]))
    found2 = match2.any(dim=1) & valid
    cnt = cnt.reshape(-1).clone().index_add_(
        0, torch.where(found2, bkt * BUCKET + _first_match(match2), 0),
        torch.where(found2, w, 0)).reshape(n_buckets, BUCKET)
    return tags, vlo, vhi, torch.clamp(cnt, max=1 << 20)


class LocalBackend:
    """Single-device table access: arrays are whole tables on this device.
    The seam where a table-sharded backend slots in (see
    fqsqueezer_tpu/parallel/sharded.py TpBackend)."""

    def siv_find(self, siv, ctx):
        return siv_find(siv, ctx)

    def siv_words(self, siv, idx):
        return siv[idx]

    def siv_update(self, siv, keys, valid):
        return siv_update(siv, keys, valid)

    def table_find(self, tc, lo, hi, log2_base=-1):
        return table_find(tc, lo, hi, log2_base)

    def table_update(self, tc, lo, hi, base, valid, log2_base=-1,
                     rounds=2):
        return table_update(tc, lo, hi, base, valid, log2_base=log2_base,
                            rounds=rounds)

    def ktable_find(self, tc, bkt, tags4, log2_base=-1):
        return ktable_find(tc, bkt, tags4, log2_base)

    def ktable_update(self, tc, bkt, tag, valid, log2_base=-1):
        return ktable_update(tc, bkt, tag, valid, log2_base)


LOCAL = LocalBackend()
