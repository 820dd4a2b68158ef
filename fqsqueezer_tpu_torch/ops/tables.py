"""k-mer counter stores as dense integer arrays — the main path's subset.

Port of fqsqueezer_tpu/ops/tables.py: the packed SIV (u8x4 next-base counters
per (p-1)-mer context) and the K2 canonical k-mer tables (single-word
tag24|count8 cells, 4 per bucket row). All u32 words are held in int64, so
K2 cells, whose bit 31 is always set, order correctly under a signed
scatter-max. The reference's dropped scatters (mode="drop") are explicit
masks here: an invalid event either adds 0, or max-es 0, into a cell, or
lands in a dump slot that is cut off.

The paired-end pair table (pair_*: bucketed minimizer -> partner-minimizer
slots, 8 cells a bucket) is ported too. Not ported yet: the legacy 8-cell
k-mer tables (table_*), the u16-counter KTable (ktable_* with
dna_sb_proto=0) and the in-batch local tables (local_*, klocal_*); they
serve only older archive headers.
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


_CTZ4 = (0, 0, 1, 0, 2, 0, 1, 0, 3, 0, 1, 0, 2, 0, 1, 0)


def _ctz4(x: torch.Tensor) -> torch.Tensor:
    """Count trailing zeros of a 4-bit mask (0 for x == 0)."""
    return torch.tensor(_CTZ4, dtype=torch.int64, device=x.device)[x]


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
    cell = torch.argmax(match.to(torch.int64), dim=1)  # first match
    cellv = torch.where(match, row, 0).sum(dim=1) & MASK32
    weights = torch.tensor([1, 2, 4, 8], dtype=torch.int64, device=tc.device)
    bm = torch.where(row == EMPTY, weights, 0).sum(dim=1)
    want = valid & ~found & (bm > 0)
    j = ((tag >> 13) ^ tag) & (KBUCKET - 1)
    rot = ((bm >> j) | (bm << (KBUCKET - j))) & ((1 << KBUCKET) - 1)
    slot = (j + _ctz4(rot)) & (KBUCKET - 1)
    dcell = torch.where(found, cell, slot)
    newv = torch.where(found, cellv + ((cellv & 0xFF) < 0xFF).to(torch.int64),
                       tw | 1)
    ok = found | want
    idx = torch.where(ok, bkt * KBUCKET + dcell, 0)
    src = torch.where(ok, newv, 0)
    return tc.reshape(-1).clone().scatter_reduce_(
        0, idx, src, "amax").reshape(n_buckets, KBUCKET)


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


def _require_k2(tc: torch.Tensor) -> None:
    if tc.shape[-1] != KBUCKET:
        raise NotImplementedError(
            "only K2 s/b tables (dna_sb_proto=1, dna_canon=1) are ported")


def ktable_find(tc, bkt, tags4, log2_base: int = -1):
    _require_k2(tc)
    return k2_find(tc, bkt, tags4, log2_base)


def ktable_update(tc, bkt, tag, valid, log2_base: int = -1):
    _require_k2(tc)
    return k2_update(tc, bkt, tag, valid, log2_base)


def ktable_grow(tc, log2_base: int):
    _require_k2(tc)
    return k2_grow(tc, log2_base)


def ktable_clamp(tc):
    """K2 cells saturate at 255 inside the update itself: a no-op."""
    _require_k2(tc)
    return tc


def ktable_fill_stats(tc):
    _require_k2(tc)
    return (tc != EMPTY).sum(), tc.shape[0] * KBUCKET


# ---------------------------------------------------------------------------
# PairTable: bucketed (key -> partner-minimizer, weight) slots
# ---------------------------------------------------------------------------
# The paired-end minimizer pair table of fqsqueezer_tpu/ops/tables.py: a
# slot holds (key tag, value lo, value hi, weight); several slots of a
# bucket may share the key tag with different values. Values are stored
# exactly, since the decoder rebuilds an anchor's bases from them.

BUCKET = 8   # cells a pair-table bucket row
_CTZ8 = tuple((x & -x).bit_length() - 1 if x else 0 for x in range(256))


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
    weights = 1 << torch.arange(BUCKET, dtype=torch.int64, device=dev)
    j = (ticket >> 13) & (BUCKET - 1)
    ctz8 = torch.tensor(_CTZ8, dtype=torch.int64, device=dev)
    for r in range(2):
        row_t, row_l, row_h = tags[bkt], vlo[bkt], vhi[bkt]
        found = ((row_t == tag[:, None]) & (row_l == vlo_n[:, None])
                 & (row_h == vhi_n[:, None])).any(dim=1) & valid
        bm = torch.where(row_t == EMPTY, weights, 0).sum(dim=1)
        want = valid & ~found & (bm > 0)
        jr = (j + 3 * r) & (BUCKET - 1)
        rot = ((bm >> jr) | (bm << (BUCKET - jr))) & ((1 << BUCKET) - 1)
        slot = (jr + ctz8[rot]) & (BUCKET - 1)
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
    cell2 = torch.argmax(match2.to(torch.int64), dim=1)   # first match
    cnt = cnt.reshape(-1).clone().index_add_(
        0, torch.where(found2, bkt * BUCKET + cell2, 0),
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

    def ktable_find(self, tc, bkt, tags4, log2_base=-1):
        return ktable_find(tc, bkt, tags4, log2_base)

    def ktable_update(self, tc, bkt, tag, valid, log2_base=-1):
        return ktable_update(tc, bkt, tag, valid, log2_base)


LOCAL = LocalBackend()
