"""DNA stream codec: k-mer-statistics modeling, encode and decode.

Port of fqsqueezer_tpu/streams/dna.py, in original and sorted read order:
the s/b tables of every family (canonical K2 cells, canonical u16-counter
ktable cells, the first writer's context-keyed table cells), updated a read
row at a time (row-global) or once a batch, and every header knob of the
cascade, the contexts and the model (ctx v1 and v2, the rough
1-substitution rescue, the two-level model mix or the fine rows alone, the
prefix ramp, the pmer gate, the repair budget, the letters' position
buckets). The method is the reference's (see that module's docstring):
per-base next-symbol counts come from a cascade of k-mer counter stores,
the actual base is coded as its rank among count-sorted candidates under
a count-conditioned context, and a
letters model covers the read prefix and positions with no counts.

Row-global encode runs one batch as a Python loop over its read rows (row
rd = read rd of every lane): per row, greedy repair against the row-fresh
tables, the cascade, contexts and (freq, cum), then the row's s/b insert
events — the order the decoder replays. Every op inside a row is [N,
L]-wide. With batch-frozen tables (dna_row_global = 0) repair, the cascade
and the contexts run once over the whole batch against the batch-start
tables, and the batch's s/b events apply after it (dna_collect_updates). In
sorted order a read's first lcp positions (meta.compute_lcp: the prefix it
shares with the previous read of its lane) are not coded: the decoder
copies them from the previous read row; they still feed repair, the
cascade's windows and the row's insert events.

Decode (dna_decode_batch) replays that order one position at a time for
all lanes: per read row a scan over the L positions, each step the cascade,
the context and cdf, one rANS step, repair and the register rolls; then the
row's s/b insert events where the tables are row-global. The reference
runs the scan through XLA (not Pallas). Here each read row — the scan and
the row's s/b table update, the reference's whole `outer` step — is one
call of dna_decode_row: on CUDA tensors kernel K2 (csrc/dna_decode.cu),
one launch a row that updates row-global tables in place; on CPU tensors
dna_decode_row_plain, the same scan as torch ops on the lanes' [N]
tensors, then _apply_sb_updates. The batch's model and SIV update, and
the s/b update of batch-frozen tables, stay torch.

Paired-end reads (pairs interleaved: even rows read1, odd rows read2)
run through the same codec. With the anchor machinery on
(cfg.pe_log2_buckets > 0) the encoder searches each pair's anchor against
the batch-start pair table (streams/pe.py), codes the pe stream's symbols
(dna_pe_encode) and models the anchored 3-row recoding (read1, rowA,
rowB); an anchored rowA or rowB does not code its first B = bmer_len
positions. The decoder walks the same 3 rows: after each read1 row it
recomputes the candidates from the decoded bases, decodes the pe symbols
and arms the pair's anchor; K2 fills an anchored row's first B positions
from the anchor's value through its prefix copy, the mechanism sorted
order's shared prefixes use (a row has either an anchor or a prefix,
never both). The pair table and the pe model evolve once a batch, from
the true interleaved reads (dna_collect_updates).

Headers without row-global updates keep in-batch local statistics beside
their batch-frozen tables (cfg.local_log2_cells > 0): local_* tables (or
klocal_* over canonical tables) of the k-mers of the batch's earlier read
rows, merged into the cascade's s and b counts, and with
cfg.local_model_inc > 0 deltas of the DNA model's fine rows, added to the
cdf. They are frozen during a read row and take the row's events at its
end (local_row_update), in the encoder's row loop and the decoder's alike;
a batch starts them from zero.

Two header knobs change the position buckets of the contexts, on both
sides alike: dna_sorted_ctx (sorted order), where a read shares a prefix
with the previous read of its lane, counts positions from the end of
that prefix (_pos_bucket_sorted); dna_pe_pos_ctx (paired-end, with the
anchors on) gives rowA and rowB read2's coordinates (_pe_pos_map). In
the decode they are K2's position maps (PosMap). Row-global updates of
the context-keyed table cells (dna_canon 0 with dna_row_global 1) run
the reference's table_update at each row end, in the encoder's row loop
and after each of the decoder's rows.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

from ..ops import kmers, models, rans, tables
from . import common, pe

A_SYM = 5                 # alphabet: 4 ranks/bases + N
CODE_CTX_BITS = 22
CODE_CTX_BITS_V1 = 20
CODE_CTX_BITS_ROUGH = 23
LET_CTX_BITS = 19


def _ctx_bits(cfg) -> int:
    if cfg.rough:
        return CODE_CTX_BITS_ROUGH
    return CODE_CTX_BITS if cfg.ctx_v >= 2 else CODE_CTX_BITS_V1


def _n_model_ctx(cfg) -> int:
    return (1 << _ctx_bits(cfg)) + (1 << LET_CTX_BITS)


LET_SENTINEL = 5          # "before start of read" letter history filler
LH_MASK = (1 << 15) - 1
LH_RESET = 0b101_101_101_101_101  # five sentinel-5 slots

# count quantization thresholds
_Q0 = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16, 24, 32, 48, 64, 128)   # 4 bits
_Q1 = (1, 2, 3, 4, 6, 8, 16)                                     # 3 bits
_Q23 = (1, 2, 4)                                                 # 2 bits

LEVEL_NONE, LEVEL_PMER, LEVEL_SMER, LEVEL_MIXED, LEVEL_BMER = 0, 1, 2, 3, 4
LEVEL_RSMER = 5

N_COARSE_CODE = 1 << 9
N_COARSE_CTX = N_COARSE_CODE + (1 << 10)
N_COARSE_CODE_ROUGH = 1 << 10
N_COARSE_CTX_ROUGH = N_COARSE_CODE_ROUGH + (1 << 10)


def _n_coarse_ctx(cfg) -> int:
    return N_COARSE_CTX_ROUGH if cfg.rough else N_COARSE_CTX


def _coarse_ctx(cfg, ctx_all):
    """Coarse (parent) context from the packed fine context."""
    is_let = ctx_all >= (1 << _ctx_bits(cfg))
    if cfg.rough:
        code_c = ctx_all & 0x3FF                   # lev3 | q0<<3 | q1<<7
        n_code = N_COARSE_CODE_ROUGH
    else:
        code_c = ctx_all & 0x1FF                   # level | q0<<2 | q1<<6
        n_code = N_COARSE_CODE
    let_c = (ctx_all & 0x3F) | (((ctx_all >> 15) & 0xF) << 6)
    return torch.where(is_let, n_code + let_c, code_c)


MAX_REPAIRS = 3
REPAIR_MIN_COUNT = 2


@dataclasses.dataclass(frozen=True)
class DnaConfig:
    """Same fields and defaults as fqsqueezer_tpu.streams.dna.DnaConfig (see
    there for what each knob does), so pipeline.make_configs maps Params
    onto both packages identically."""
    siv_len: int = 13
    smer_len: int = 15
    bmer_len: int = 26
    prefix_len: int = 14
    scale_bits: int = 14
    n_lanes: int = 1024
    smer_log2_buckets: int = 20
    bmer_log2_buckets: int = 20
    local_log2_cells: int = 22
    local_model_inc: int = 0
    pe_log2_buckets: int = 0
    mix_w: int = 0
    mix_b: int = 64
    sorted_ctx: bool = False
    repair_iters: int = MAX_REPAIRS
    claim_rounds: int = 2
    local_lite: bool = False
    local_rc: bool = True
    pmer_gate: int = 0
    prefix_ramp: bool = False
    canon: bool = False
    row_global: bool = False
    pe_pos_ctx: bool = False
    ctx_v: int = 1
    rough: int = 0
    sb_proto: int = 0
    route_sb: int = 0
    let_pb2: int = 0


class DnaState(NamedTuple):
    siv: torch.Tensor
    # s/b tables, [n_buckets, width] u32 words in int64; the width is the
    # family's: tables.KBUCKET (K2), tables.KW (ktable), tables.W_TABLE
    s_tc: torch.Tensor
    b_tc: torch.Tensor
    # [n_model (+ n_coarse if cfg.mix_w > 0), A_SYM]: the coarse parent
    # family lives behind the fine rows in the same array
    model: torch.Tensor
    # paired-end anchors: (pair tags, vlo, vhi, cnt, pe stream model), or
    # None
    pe: tuple | None = None


def dna_state_create(cfg: DnaConfig, device=None) -> DnaState:
    n_model = _n_model_ctx(cfg) + (_n_coarse_ctx(cfg) if cfg.mix_w > 0
                                   else 0)
    pe_state = None
    if cfg.pe_log2_buckets > 0:
        pe_state = tables.pair_create(cfg.pe_log2_buckets, device) + (
            models.model_create(pe.PE_N_CTX, pe.PE_N_SYM, device),)
    mk = table_family(cfg)[1]
    return DnaState(
        siv=tables.siv_create(cfg.siv_len, device),
        s_tc=mk(cfg.smer_log2_buckets, device),
        b_tc=mk(cfg.bmer_log2_buckets, device),
        model=models.model_create(n_model, A_SYM, device),
        pe=pe_state,
    )


# the s/b table families, in the order of K2's kFam template parameter
FAMILIES = ("k2", "ktable", "table")


def table_family(cfg: DnaConfig):
    """(family name, create function, row width) of cfg's s/b tables."""
    if cfg.canon and cfg.sb_proto:
        return "k2", tables.k2_create, tables.KBUCKET
    if cfg.canon:
        return "ktable", tables.ktable_create, tables.KW
    return "table", tables.table_create, tables.W_TABLE


# ---------------------------------------------------------------------------
# shared modeling math (shape-agnostic)
# ---------------------------------------------------------------------------

_CONSTS = {}


def _const(values, device) -> torch.Tensor:
    """A small int64 constant tensor, made once for each device."""
    key = (values, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(values, dtype=torch.int64,
                                        device=device)
    return t


def _quant(v, thresholds):
    """Number of (ascending) thresholds <= v."""
    return torch.searchsorted(_const(thresholds, v.device), v.contiguous(),
                              right=True)


def _pos_bucket(i, length):
    """4-bit position bucket: exact-ish early, /16 mid, end-of-read
    flagged."""
    rem = length - i
    mid = torch.clamp(6 + (i - 24) // 16, max=13)
    early = i // 4
    pb = torch.where(i < 24, early, mid)
    pb = torch.where(rem <= 4, 14, pb)
    return torch.where(rem <= 2, 15, pb)


def _pos_bucket_sorted(pb, i, length, lcp):
    """Sorted-mode position bucket (cfg.sorted_ctx): where the read shares
    a prefix with the previous read of its lane (lcp > 0), the distance
    past that prefix, capped at 13, in place of the absolute position;
    the end-of-read buckets 14 and 15 stay."""
    d = torch.clamp(i - lcp, max=13)
    rem = length - i
    pbs = torch.where(rem <= 2, 15, torch.where(rem <= 4, 14,
                                                torch.clamp(d, min=0)))
    return torch.where(lcp > 0, pbs, pb)


# the position-bucket length of a rowB under dna_pe_pos_ctx: so large that
# the end-of-read buckets (rem <= 4) never fire
_PE_NO_END = 1 << 20


def _pe_pos_map(lengths, a_start, has, lenB):
    """(off, sign, plen) [R3] each, per row of the anchored 3-row recoding
    (dna_pe_pos_ctx): read1 rows keep their coordinates (0, +1, L1); rowA
    starts at the anchor's start in read2's frame (a, +1, L2, a = 0
    without an anchor); rowB counts back toward read2's start (lenB - 1,
    -1, _PE_NO_END), with no end-of-read bucket. lengths: the interleaved
    [R] true lengths; a_start, has, lenB: [R/2] a pair."""
    L1, L2 = lengths[0::2], lengths[1::2]
    z, one = torch.zeros_like(L1), torch.ones_like(L1)
    off3 = torch.stack([z, torch.where(has, a_start, 0), lenB - 1], dim=1)
    sign3 = torch.stack([one, one, -one], dim=1)
    plen3 = torch.stack([L1, L2, torch.full_like(L1, _PE_NO_END)], dim=1)
    return off3.reshape(-1), sign3.reshape(-1), plen3.reshape(-1)


_SLOT_MASK = 0xF


def _klocal_slots(s, c0):
    """[..., 4] canonical (first, last)-letter slots of the 4 next-base
    candidates: slot = 4*first + last."""
    b4 = torch.arange(4, dtype=torch.int64, device=c0.device)
    return torch.where(s[..., None], 4 * (3 - b4) + (3 - c0)[..., None],
                       4 * c0[..., None] + b4)


def _canon_query(c_lo, c_hi, r_lo, r_hi, k: int, log2_cells: int):
    """Canonical 4-candidate query keys for the width-k table. Returns (bkt
    [...], tags4 [..., 4], strand, mid_lo, mid_hi, c0)."""
    s, m_lo, m_hi = kmers.canon_strand(c_lo, c_hi, r_lo, r_hi, k)
    bkt = kmers.hash_bucket(m_lo, m_hi, log2_cells)
    mt = kmers.hash_tag(m_lo, m_hi) & ~_SLOT_MASK
    c0 = kmers.top_base(c_lo, c_hi, k - 1)
    tags4 = mt[..., None] | _klocal_slots(s, c0)
    return bkt, tags4, s, m_lo, m_hi, c0


def _canon_insert(c_lo, c_hi, r_lo, r_hi, base, k: int, log2_cells: int):
    """(bkt, tag) of the canonical full k-mer c·base."""
    s, m_lo, m_hi = kmers.canon_strand(c_lo, c_hi, r_lo, r_hi, k)
    bkt = kmers.hash_bucket(m_lo, m_hi, log2_cells)
    mt = kmers.hash_tag(m_lo, m_hi) & ~_SLOT_MASK
    c0 = kmers.top_base(c_lo, c_hi, k - 1)
    slot = torch.where(s, 4 * (3 - base) + (3 - c0), 4 * c0 + base)
    return bkt, mt | slot


def _cascade_parts(state: DnaState, pm_ctx, s_lo, s_hi, b_lo, b_hi, vp, vs,
                   vb, be=tables.LOCAL, s_log2b=-1, b_log2b=-1):
    """Raw per-level finds over the SIV and the context-keyed s/b tables
    (keys: the forward (k-1)-base windows). Returns (cp, cs, cb [..., 4],
    fp, fs, fb)."""
    cp = be.siv_find(state.siv, pm_ctx)
    cs, fs = be.table_find(state.s_tc, s_lo, s_hi, s_log2b)
    cb, fb = be.table_find(state.b_tc, b_lo, b_hi, b_log2b)
    fp = vp & (cp.sum(dim=-1) > 0)
    return cp, cs, cb, fp, fs & vs, fb & vb


def _cascade_parts_k(state: DnaState, pm_ctx, s_q, b_q, vp, vs, vb,
                     be=tables.LOCAL, s_log2b=-1, b_log2b=-1):
    """Raw per-level finds over the SIV and the canonical s/b tables.
    Returns (cp, cs, cb [..., 4], fp, fs, fb)."""
    cp = be.siv_find(state.siv, pm_ctx)
    cs, fs = be.ktable_find(state.s_tc, s_q[0], s_q[1], s_log2b)
    cb, fb = be.ktable_find(state.b_tc, b_q[0], b_q[1], b_log2b)
    fp = vp & (cp.sum(dim=-1) > 0)
    return cp, cs, cb, fp, fs & vs, fb & vb


def _cascade_combine(cp, cs, cb, fp, fs, fb):
    """Collapse per-level finds into (counts [..., 4], level [...])."""
    nzb = (cb > 0).sum(dim=-1)
    mixed = fb & (nzb > 1)
    counts = torch.where(
        fb[..., None], cb + torch.where(mixed[..., None], cs, 0),
        torch.where(fs[..., None], cs,
                    torch.where(fp[..., None], cp, 0)))
    level = torch.where(
        fb, torch.where(mixed, LEVEL_MIXED, LEVEL_BMER),
        torch.where(fs, LEVEL_SMER,
                    torch.where(fp, LEVEL_PMER, LEVEL_NONE)))
    return counts, level


def _rough_counts(cfg, be, s_tc, lo, hi, rlo, rhi, age, valid):
    """Summed s-table counts of the 3 single-base substitutions at context
    offset `age` (the suspect position; see DnaConfig.rough in the
    reference package). lo/hi: (smer_len-1)-base context windows, rlo/rhi
    their reverse complements, age: offsets in [0, smer_len-2]. Returns
    [..., 4] counts clipped to 255."""
    q = _rough_queries(cfg, lo, hi, rlo, rhi, age)
    c, _ = be.ktable_find(s_tc, q[0], q[1], cfg.smer_log2_buckets)
    acc = c.sum(dim=0)
    return torch.clamp(torch.where(valid[..., None], acc, 0), max=255)


def _rough_queries(cfg, lo, hi, rlo, rhi, age):
    """The s-table queries (_canon_query) of the 3 single-base
    substitutions of _rough_counts, along a leading axis of 3."""
    w = cfg.smer_len - 1
    a2 = 2 * age                          # fwd bit offset
    d2 = 2 * (w - 1 - age)                # rc bit offset
    a2l = torch.clamp(a2, max=31)
    a2h = torch.where(a2 >= 32, a2 - 32, 0)
    d2l = torch.clamp(d2, max=31)
    d2h = torch.where(d2 >= 32, d2 - 32, 0)
    fwd_lo = a2 < 32
    rc_lo = d2 < 32
    orig = torch.where(fwd_lo, lo >> a2l, hi >> a2h) & 3

    def put(x, v, sh):
        return (x & ~(3 << sh)) | ((v << sh) & 0xFFFFFFFF)

    # the three substitutes of the original base, as one leading axis of 3
    k = _const((0, 1, 2), lo.device).reshape((3,) + (1,) * lo.dim())
    ju = k + (orig <= k).to(torch.int64)
    cj = 3 - ju
    lo_j = torch.where(fwd_lo, put(lo, ju, a2l), lo)
    hi_j = torch.where(fwd_lo, hi, put(hi, ju, a2h))
    rlo_j = torch.where(rc_lo, put(rlo, cj, d2l), rlo)
    rhi_j = torch.where(rc_lo, rhi, put(rhi, cj, d2h))
    return _canon_query(lo_j, hi_j, rlo_j, rhi_j, cfg.smer_len,
                        cfg.smer_log2_buckets)


def _combine_rough(counts, level, cr, fr):
    """Fold rough 1-sub evidence in: above SIV/none, below direct s/b."""
    use = fr & (level <= LEVEL_PMER)
    counts = torch.where(use[..., None], cr, counts)
    level = torch.where(use, LEVEL_RSMER, level)
    return counts, level


def _miss_age(miss, pos):
    """[.., L] suspect age per position from the consecutive-miss run
    length: pos - (last non-miss position) - 1."""
    last_hit = torch.cummax(torch.where(miss, -1, pos), dim=-1).values
    return pos - last_hit - 1


def _rank_all(counts):
    """[..., 4] rank of each base under (count desc, base asc) ordering."""
    c = counts
    gt = (c[..., None, :] > c[..., :, None]).to(torch.int64)
    eq = (c[..., None, :] == c[..., :, None]).to(torch.int64)
    lower = _const(((0, 0, 0, 0), (1, 0, 0, 0), (1, 1, 0, 0), (1, 1, 1, 0)),
                   c.device)
    return (gt + eq * lower).sum(dim=-1)


def _rank_of(counts, sym):
    """Rank of symbol (N -> 4)."""
    ranks = _rank_all(counts)
    r = torch.gather(ranks, -1, torch.clamp(sym, max=3)[..., None])[..., 0]
    return torch.where(sym >= 4, 4, r)


def _base_of_rank(counts, r):
    """Inverse of _rank_of (rank 4 -> N)."""
    ranks = _rank_all(counts)
    b4 = torch.arange(4, dtype=torch.int64, device=counts.device)
    base = (b4 * (ranks == r[..., None]).to(torch.int64)).sum(dim=-1)
    return torch.where(r >= 4, 4, base)


def _code_ctx(level, counts, pb, nz_hist, prevc=None, rough: bool = False):
    """Pack the count-conditioned context (level, quantized sorted counts,
    position bucket, rank-miss history, previous level class)."""
    cs = torch.sort(counts, dim=-1, descending=True).values
    if rough:
        ctx = torch.where(level == LEVEL_RSMER, 4, level - 1)
        ctx = ctx | (_quant(cs[..., 0], _Q0) << 3)
        ctx = ctx | (_quant(cs[..., 1], _Q1) << 7)
        ctx = ctx | (_quant(cs[..., 2], _Q23) << 10)
        ctx = ctx | (_quant(cs[..., 3], _Q23) << 12)
        ctx = ctx | (pb << 14)
        ctx = ctx | (torch.clamp(nz_hist, max=4) << 18)
        if prevc is not None:
            ctx = ctx | (prevc << 21)
        return ctx
    ctx = level - 1
    ctx = ctx | (_quant(cs[..., 0], _Q0) << 2)
    ctx = ctx | (_quant(cs[..., 1], _Q1) << 6)
    ctx = ctx | (_quant(cs[..., 2], _Q23) << 9)
    ctx = ctx | (_quant(cs[..., 3], _Q23) << 11)
    ctx = ctx | (pb << 13)
    ctx = ctx | (torch.clamp(nz_hist, max=4) << 17)
    if prevc is not None:
        ctx = ctx | (prevc << 20)
    return ctx


def _level_class(cfg, level, use_code):
    """0 = letters/none, 1 = pmer-only, 2 = s/mixed/b, 3 = rough."""
    cls = torch.where(level >= LEVEL_SMER, 2, 1)
    if cfg.rough:
        cls = torch.where(level == LEVEL_RSMER, 3, cls)
    return torch.where(use_code, cls, 0)


def _popcount4(v):
    return (v & 1) + ((v >> 1) & 1) + ((v >> 2) & 1) + ((v >> 3) & 1)


def _best_base(counts):
    """Rank-0 base: count desc, base asc. Returns (best_base, best_count)."""
    b4 = torch.arange(4, dtype=torch.int64, device=counts.device)
    best = torch.argmax((counts << 2) + (3 - b4), dim=-1)
    return best, counts.amax(dim=-1)


def _repair_trigger(counts, level, base):
    """True where the repair rule fires: confident context (>= smer level),
    actual base unseen, best base well supported and different."""
    cb = torch.gather(counts, -1, torch.clamp(base, max=3)[..., None])[..., 0]
    cb = torch.where(base >= 4, 0, cb)
    best, bestc = _best_base(counts)
    kc = torch.where(base >= 4, 0, base)
    trig = ((level >= LEVEL_SMER) & (cb == 0)
            & (bestc >= REPAIR_MIN_COUNT) & (best != kc))
    return trig, best


def _ramp_cols(cfg):
    """Read positions served by the prefix ramp: a full prefix_len-base
    prefix exists but the full (siv_len-1)-base SIV window does not."""
    return list(range(cfg.prefix_len, cfg.siv_len - 1))


def _ramp_word_idx(cfg, pfx, q: int):
    """[R, 4, nw] SIV word indices of the (prefix, candidate) ranges: the
    SIV packs the earliest base in the most significant index bits, so the
    cells of one (prefix, candidate) pair are one contiguous word range."""
    free = cfg.siv_len - 2 - q
    c4 = torch.arange(4, dtype=torch.int64, device=pfx.device)
    start = ((pfx[:, None] << 2) + c4[None, :]) << (2 * free)
    return start[:, :, None] + torch.arange(
        4 ** free, dtype=torch.int64, device=pfx.device)[None, None, :]


def _prefix_ramp_counts(cfg, be, siv, kcodes, q: int):
    """[R, 4] summed SIV counts of all siv_len-mers whose first q bases are
    the read prefix and whose base q is the candidate."""
    w = 4 ** torch.arange(q - 1, -1, -1, dtype=torch.int64,
                          device=kcodes.device)
    pfx = (kcodes[:, :q] * w[None, :]).sum(dim=1)
    c = tables.unpack_counts(be.siv_words(siv, _ramp_word_idx(cfg, pfx, q)))
    return torch.clamp(c.sum(dim=(2, 3)), max=255)


def _prefix_ramp_counts_static(cfg, be, siv, pfx, q: int):
    """_prefix_ramp_counts from packed prefixes pfx [N] (the decoder's form):
    per-word totals fold with one SWAR pass."""
    w = be.siv_words(siv, _ramp_word_idx(cfg, pfx, q))
    x = (w & 0x00FF00FF) + ((w >> 8) & 0x00FF00FF)
    tot = (x & 0xFFFF) + (x >> 16)
    return torch.clamp(tot.sum(dim=-1), max=255)


def _window_parts(cfg, state, kcodes, lengths, be=tables.LOCAL,
                  with_siv: bool = True):
    """Pack the three window widths over kcodes and run the cascade finds.
    Returns ((cp, cs, cb, fp, fs, fb), active), all [R, L(, 4)].
    with_siv=False skips the SIV (the repair pass: its triggers need level
    >= LEVEL_SMER, whose counts never include SIV)."""
    R, L = kcodes.shape
    pos = torch.arange(L, dtype=torch.int64, device=kcodes.device)[None, :]
    active = pos < lengths[:, None]
    sr = kmers.shift_right

    s_lo, s_hi = kmers.pack_windows(kcodes, cfg.smer_len - 1)
    s_lo, s_hi = sr(s_lo, 1), sr(s_hi, 1)
    b_lo, b_hi = kmers.pack_windows(kcodes, cfg.bmer_len - 1)
    b_lo, b_hi = sr(b_lo, 1), sr(b_hi, 1)
    if cfg.canon:
        rs = kmers.pack_windows_rc(kcodes, cfg.smer_len - 1)
        rb = kmers.pack_windows_rc(kcodes, cfg.bmer_len - 1)
        s_q = _canon_query(s_lo, s_hi, sr(rs[0], 1), sr(rs[1], 1),
                           cfg.smer_len, cfg.smer_log2_buckets)
        b_q = _canon_query(b_lo, b_hi, sr(rb[0], 1), sr(rb[1], 1),
                           cfg.bmer_len, cfg.bmer_log2_buckets)

    vp = pos >= cfg.siv_len - 1
    if cfg.pmer_gate > 0:
        vp = vp & (pos < cfg.pmer_gate)
    vs = pos >= cfg.smer_len - 1
    vb = pos >= cfg.bmer_len - 1
    if not with_siv:
        if cfg.canon:
            cs, fs = be.ktable_find(state.s_tc, s_q[0], s_q[1],
                                    cfg.smer_log2_buckets)
            cb, fb = be.ktable_find(state.b_tc, b_q[0], b_q[1],
                                    cfg.bmer_log2_buckets)
        else:
            cs, fs = be.table_find(state.s_tc, s_lo, s_hi,
                                   cfg.smer_log2_buckets)
            cb, fb = be.table_find(state.b_tc, b_lo, b_hi,
                                   cfg.bmer_log2_buckets)
        fp = torch.zeros_like(vp & active)
        return (torch.zeros_like(cs), cs, cb, fp, fs & vs, fb & vb), active

    pm = sr(kmers.pack_windows(kcodes, cfg.siv_len - 1)[0], 1)
    pm = pm & (4 ** (cfg.siv_len - 1) - 1)
    if cfg.canon:
        cp, cs, cb, fp, fs, fb = _cascade_parts_k(
            state, pm, s_q, b_q, vp, vs, vb, be, cfg.smer_log2_buckets,
            cfg.bmer_log2_buckets)
    else:
        cp, cs, cb, fp, fs, fb = _cascade_parts(
            state, pm, s_lo, s_hi, b_lo, b_hi, vp, vs, vb, be,
            cfg.smer_log2_buckets, cfg.bmer_log2_buckets)
    if cfg.prefix_ramp:
        cp = cp.clone()
        fp = fp.expand(R, L).clone()
        for q in _ramp_cols(cfg):
            cq = _prefix_ramp_counts(cfg, be, state.siv, kcodes, q)
            ok = (cq.sum(dim=-1) > 0) & active[:, q]
            cp[:, q] = torch.where(ok[:, None], cq, cp[:, q])
            fp[:, q] = fp[:, q] | ok
    return (cp, cs, cb, fp, fs, fb), active


def _window_lookup(cfg, state, kcodes, lengths, be=tables.LOCAL,
                   with_siv: bool = True):
    """Cascade over a whole block. Returns (counts [R, L, 4], level [R, L],
    active)."""
    parts, active = _window_parts(cfg, state, kcodes, lengths, be, with_siv)
    counts, level = _cascade_combine(*parts)
    return counts, level, active


def _dna_cdf(cfg, model, lm, ctx, sb):
    """DNA model cdf from the raw model array (fine and letters rows, then
    the coarse family): the fine row, with the in-batch deltas lm of the
    fine rows where cfg.local_model_inc > 0 (lm None: none), optionally
    mixed with its coarse parent (cfg.mix_w)."""
    local = lm if cfg.local_model_inc > 0 else None
    if cfg.mix_w > 0:
        return models.model_cdf_mix(model, ctx,
                                    _n_model_ctx(cfg) + _coarse_ctx(cfg, ctx),
                                    sb, cfg.mix_w, cfg.mix_b, local)
    if local is not None:
        return models.model_cdf_local(model, local, ctx, sb)
    return models.model_cdf(model, ctx, sb)


# ---------------------------------------------------------------------------
# in-batch local statistics, row-synced
# ---------------------------------------------------------------------------
# Within a batch the local k-mer tables and the model deltas take the
# events of one read row (read rd of every lane) at a time: a position of
# row rd sees the statistics of rows < rd. The encoder's row loop and the
# decoder, which freezes them during a row and applies the row's events
# at its end, run the same local_row_update.

def _merge_local(parts, cs_l, cb_l):
    """Fold in-batch local s/b counts into the cascade parts: counts add,
    found-ness ORs."""
    cp, cs, cb, fp, fs, fb = parts
    if cs_l is None:
        return parts
    return (cp, cs + cs_l, cb + cb_l, fp, fs | (cs_l.sum(dim=-1) > 0),
            fb | (cb_l.sum(dim=-1) > 0))


def _row_query_keys(cfg, eff_row, len_row, k):
    """(cell, tag, valid) of the width-(k-1) query context at each position
    of a row block: the window ending one base left."""
    pos = torch.arange(eff_row.shape[1], dtype=torch.int64,
                       device=eff_row.device)[None, :]
    lo, hi = (kmers.shift_right(t, 1)
              for t in kmers.pack_windows(eff_row, k - 1))
    cell, tag = tables.local_keys(lo, hi, cfg.local_log2_cells)
    return cell, tag, (pos >= k - 1) & (pos < len_row[:, None])


def _row_canon_query(cfg, eff_row, len_row, k):
    """The canonical-local variant of _row_query_keys: (cell, tag, slots4,
    valid) for tables.klocal_query."""
    pos = torch.arange(eff_row.shape[1], dtype=torch.int64,
                       device=eff_row.device)[None, :]
    lo, hi, rlo, rhi = (kmers.shift_right(t, 1) for t in (
        *kmers.pack_windows(eff_row, k - 1),
        *kmers.pack_windows_rc(eff_row, k - 1)))
    s, m_lo, m_hi = kmers.canon_strand(lo, hi, rlo, rhi, k)
    cell, tag = tables.local_keys(m_lo, m_hi, cfg.local_log2_cells)
    slots = _klocal_slots(s, kmers.top_base(lo, hi, k - 1))
    return cell, tag, slots, (pos >= k - 1) & (pos < len_row[:, None])


def _local_counts(cfg, ls, lb, eff_row, len_row):
    """The local s and b counts [N, L, 4] of a row block's queries."""
    if cfg.canon:
        return (tables.klocal_query(
                    ls, *_row_canon_query(cfg, eff_row, len_row,
                                          cfg.smer_len)),
                tables.klocal_query(
                    lb, *_row_canon_query(cfg, eff_row, len_row,
                                          cfg.bmer_len)))
    return (tables.local_query(ls, *_row_query_keys(cfg, eff_row, len_row,
                                                    cfg.smer_len)),
            tables.local_query(lb, *_row_query_keys(cfg, eff_row, len_row,
                                                    cfg.bmer_len)))


def local_row_update(cfg, ls, lb, lm, eff_row, ctx_row, sym_row, act_row,
                     len_row, row: int = 0):
    """Apply one read row's events to the in-batch local state, the same
    for encoder and decoder. k-mer events at every in-length position with
    a full window: canonical tables one event an occurrence, context-keyed
    ones the forward event (the window before i -> base i) and, with
    cfg.local_rc, the reverse complement's (the rc of the k-mer ending at i
    -> the complement of its first base). Model events (ctx, coded symbol)
    at act_row, with cfg.local_model_inc > 0. row: the read row's index
    (the claim's priority). Updates ls, lb and lm in place (a batch owns
    its local state) and returns them."""
    m = cfg.local_log2_cells
    pos = torch.arange(eff_row.shape[1], dtype=torch.int64,
                       device=eff_row.device)[None, :]
    in_len = pos < len_row[:, None]

    def upd(tbl, k):
        c0 = k - 1     # the columns with a full window
        sr = lambda t: kmers.shift_right(t, 1)[:, c0:]
        lo, hi = (sr(t) for t in kmers.pack_windows(eff_row, k - 1))
        rc = kmers.pack_windows_rc(eff_row, k - 1)
        v = in_len[:, c0:].reshape(-1)
        base = eff_row[:, c0:]
        if cfg.canon:
            s, m_lo, m_hi = kmers.canon_strand(lo, hi, sr(rc[0]), sr(rc[1]),
                                               k)
            cell, tag = tables.local_keys(m_lo, m_hi, m)
            cb0 = kmers.top_base(lo, hi, k - 1)
            slot = torch.where(s, 4 * (3 - base) + (3 - cb0), 4 * cb0 + base)
            return tables.klocal_insert(tbl, cell.reshape(-1),
                                        tag.reshape(-1), slot.reshape(-1), v,
                                        row=row, lite=cfg.local_lite)
        cell, tag = tables.local_keys(lo, hi, m)
        ev = [(cell, tag, base, v)]
        if cfg.local_rc:
            # the rc of the k-mer ending at i: its window is the unshifted
            # rc window, its next base the complement of base i-k+1
            cr, tr = tables.local_keys(rc[0][:, c0:], rc[1][:, c0:], m)
            br = (3 - kmers.shift_right(eff_row, k - 1))[:, c0:]
            ev.append((cr, tr, br, v))
        cells, tags, bases, vs = (torch.cat([e[j].reshape(-1) for e in ev])
                                  for j in range(4))
        return tables.local_insert(tbl, cells, tags, bases, vs, row=row,
                                   lite=cfg.local_lite)

    ls = upd(ls, cfg.smer_len)
    lb = upd(lb, cfg.bmer_len)
    if cfg.local_model_inc > 0:
        lm = models.local_model_update(lm, ctx_row, sym_row, act_row,
                                       inc=cfg.local_model_inc)
    return ls, lb, lm


def _local_state_create(cfg, device=None):
    """A batch's local state (ls, lb, lm), zeroed: the s and b local
    tables (klocal_* over canonical tables), and the fine rows' model
    deltas ([1, 1] without them)."""
    lm_shape = ((_n_model_ctx(cfg), A_SYM) if cfg.local_model_inc > 0
                else (1, 1))
    mk = tables.klocal_create if cfg.canon else tables.local_create
    return (mk(cfg.local_log2_cells, device),
            mk(cfg.local_log2_cells, device),
            torch.zeros(lm_shape, dtype=torch.int32, device=device))


def _with_local(cfg) -> bool:
    """Whether cfg keeps in-batch local statistics."""
    return cfg.local_log2_cells > 0 and not cfg.row_global


def dna_effective_kcodes(cfg, state, codes, kcodes, lengths,
                         be=tables.LOCAL):
    """Encoder-side repair: repair_iters committed-repair iterations, each
    recomputing the cascade over the current effective windows and
    committing the FIRST trigger per read past the previous commit — the
    decoder's sequential greedy rule."""
    R, L = kcodes.shape
    pos_row = torch.arange(L, dtype=torch.int64, device=kcodes.device)[None]
    rows = torch.arange(R, dtype=torch.int64, device=kcodes.device)
    eff = kcodes.clone()
    frontier = torch.full((R,), -1, dtype=torch.int64, device=kcodes.device)
    for _ in range(cfg.repair_iters):
        counts, level, active = _window_lookup(cfg, state, eff, lengths, be,
                                               with_siv=False)
        trig, best = _repair_trigger(counts, level, codes)
        trig = trig & active & (pos_row > frontier[:, None])
        first = torch.where(trig, pos_row, L).min(dim=1).values
        has = first < L
        idx = torch.clamp(first, max=L - 1)
        eff[rows, idx] = torch.where(has, best[rows, idx], eff[rows, idx])
        frontier = torch.where(has, first, L)
    return eff


# ---------------------------------------------------------------------------
# encoder: per-row modeling
# ---------------------------------------------------------------------------

def _ctx_sym_from_counts(cfg, counts, level, codes_blk, code_active_blk,
                         pb_blk, let_blk, pos_row):
    """From merged counts to (ctx, sym): rank the coded base, build the
    rank-miss history and the packed context."""
    ranks = _rank_of(counts, codes_blk)
    use_code = (pos_row >= cfg.prefix_len) & (level > LEVEL_NONE)
    rbit = (use_code & code_active_blk & (ranks > 0)).to(torch.int64)
    nz_hist = sum(kmers.shift_right(rbit, d) for d in (1, 2, 3, 4))
    if cfg.ctx_v >= 2:
        prevc = kmers.shift_right(_level_class(cfg, level, use_code), 1)
        code_ctx = _code_ctx(level, counts, pb_blk, nz_hist, prevc,
                             rough=cfg.rough > 0)
    else:
        code_ctx = _code_ctx(level, counts, pb_blk, nz_hist)
    ctx_all = torch.where(use_code, code_ctx,
                          (1 << _ctx_bits(cfg)) + let_blk)
    sym_enc = torch.where(use_code, ranks, codes_blk)
    return ctx_all, sym_enc


def _letters_plane(cfg, codes, pos, pb):
    lh = torch.zeros_like(codes)
    for d in (5, 4, 3, 2, 1):
        sym_d = torch.where(pos - d >= 0, kmers.shift_right(codes, d),
                            LET_SENTINEL)
        lh = (lh << 3) | sym_d
    return lh | (_let_pb(cfg, pb) << 15)


def _let_pb(cfg, pb):
    """Letters-branch position bucket: coarse 4-class under cfg.let_pb2."""
    return (pb >> 2) if cfg.let_pb2 else pb


def _pos_buckets(cfg, pos, lens, lcp=None, pos_map=None):
    """[R, L] position buckets: of each row's own positions, or through
    the paired-end coordinate map pos_map (off, sign, plen) [R] each
    (dna_pe_pos_ctx, _pe_pos_map); then, under cfg.sorted_ctx, the
    sorted-mode override past each row's lcp [R] (_pos_bucket_sorted).
    The two never meet in one row: a row with lcp > 0 is a read1 row,
    whose map is the identity."""
    if pos_map is None:
        pb = _pos_bucket(pos, lens)
    else:
        off, sign, plen = pos_map
        pb = _pos_bucket(torch.clamp(off[:, None] + sign[:, None] * pos,
                                     min=0), plen[:, None])
    if cfg.sorted_ctx and lcp is not None:
        pb = _pos_bucket_sorted(pb, pos, lens, lcp[:, None])
    return pb


def _code_active(pos, lens, lcp, anchor_mask):
    """[R, L] coded positions: in length, past the shared prefix (sorted
    order), outside an anchored row's preset span (paired-end)."""
    code_active = pos < lens
    if lcp is not None:
        code_active = code_active & (pos >= lcp[:, None])
    if anchor_mask is not None:
        code_active = code_active & ~anchor_mask
    return code_active


def dna_modeling(cfg: DnaConfig, state: DnaState, codes, kcodes, lengths,
                 be=tables.LOCAL, lcp=None, anchor_mask=None, pos_map=None):
    """Batch-frozen modeling (dna_row_global = 0): the cascade over the
    whole batch against the batch-start tables, then (ctx, coded symbol,
    freq, cum) at every position; kcodes are the repaired ones
    (dna_effective_kcodes). lcp, anchor_mask, pos_map: as in
    dna_process_batch_rg.

    With in-batch local statistics (cfg.local_log2_cells > 0) a loop over
    the read rows: each row is modeled against the batch-frozen tables
    plus the local tables and model deltas of the rows before it, then its
    events apply (local_row_update) — the order the decoder replays.
    Returns (ctx_all, sym_enc, f, c, code_active), all [R, L]."""
    R, L = codes.shape
    dev = codes.device
    pos = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    lens = lengths[:, None]
    code_active = _code_active(pos, lens, lcp, anchor_mask)
    pb = _pos_buckets(cfg, pos, lens, lcp, pos_map)
    let_ctx = _letters_plane(cfg, codes, pos, pb)
    parts, _ = _window_parts(cfg, state, kcodes, lengths, be)
    sb = cfg.scale_bits

    def code(counts, level, codes_b, cact_b, pb_b, let_b, lm):
        ctx_b, sym_b = _ctx_sym_from_counts(cfg, counts, level, codes_b,
                                            cact_b, pb_b, let_b, pos)
        f, c = models.cdf_encode_lookup(
            _dna_cdf(cfg, state.model, lm, ctx_b, sb), sym_b)
        return (ctx_b, sym_b, torch.where(cact_b, f, 1 << sb),
                torch.where(cact_b, c, 0))

    if cfg.local_log2_cells <= 0:
        return code(*_cascade_combine(*parts), codes, code_active, pb,
                    let_ctx, None) + (code_active,)

    N = cfg.n_lanes
    rb = lambda x: common.to_row_blocks(
        x.expand((R, L) + tuple(x.shape[2:])), N)
    len_rows = common.to_read_grid(lengths, N).T              # [rows, N]
    blocks = (rb(codes), rb(kcodes), rb(code_active), rb(pb), rb(let_ctx))
    parts_b = tuple(rb(p) for p in parts)
    ls, lb, lm = _local_state_create(cfg, dev)
    outs = []
    for rd in range(len_rows.shape[0]):
        codes_r, eff_r, cact_r, pb_r, let_r = (x[rd] for x in blocks)
        len_r = len_rows[rd]
        cs_l, cb_l = _local_counts(cfg, ls, lb, eff_r, len_r)
        counts, level = _cascade_combine(*_merge_local(
            tuple(p[rd] for p in parts_b), cs_l, cb_l))
        out = code(counts, level, codes_r, cact_r, pb_r, let_r, lm)
        ls, lb, lm = local_row_update(cfg, ls, lb, lm, eff_r, out[0], out[1],
                                      cact_r, len_r, row=rd)
        outs.append(out)
    return tuple(common.from_row_blocks(torch.stack(o))
                 for o in zip(*outs)) + (code_active,)


def dna_process_batch(cfg: DnaConfig, state: DnaState, codes, kcodes,
                      lengths, be=tables.LOCAL, lcp=None, anchor_mask=None,
                      pos_map=None):
    """One batch's DNA modeling, by the header's update mode: row-global
    (dna_process_batch_rg), or repair and modeling against the
    batch-frozen tables (dna_effective_kcodes, dna_modeling), which leave
    the tables as they are. Returns (eff, ctx_all, sym_enc, f, c,
    code_active, s_tc, b_tc)."""
    if cfg.row_global:
        return dna_process_batch_rg(cfg, state, codes, kcodes, lengths, be,
                                    lcp, anchor_mask, pos_map)
    eff = dna_effective_kcodes(cfg, state, codes, kcodes, lengths, be)
    return (eff,) + dna_modeling(cfg, state, codes, eff, lengths, be, lcp,
                                 anchor_mask, pos_map) + (state.s_tc,
                                                          state.b_tc)


def dna_process_batch_rg(cfg: DnaConfig, state: DnaState, codes, kcodes,
                         lengths, be=tables.LOCAL, lcp=None,
                         anchor_mask=None, pos_map=None):
    """Row-global encoder pass: a loop over the r_pl read rows carrying the
    s/b tables. Per row: greedy repair against the row-fresh tables, the
    cascade find (+ rough rescue), context/rank modeling against the
    batch-frozen model, then the row's s/b insert events.

    codes/kcodes: [R, L] int64 (N = 4 in codes, 0 in kcodes); lengths [R];
    lcp (sorted order): [R], positions below it are not coded (f, c are
    no-ops and the rank history skips them) while repair, the finds and
    the insert events keep every in-length position; anchor_mask
    (paired-end): [R, L], the anchored rows' preset spans, also left
    uncoded; pos_map (dna_pe_pos_ctx): the rows' coordinate map
    (_pe_pos_map). Under dna_sorted_ctx the position buckets past lcp
    count from it (_pos_buckets).
    Returns (eff, ctx_all, sym_enc, f, c, code_active, s_tc, b_tc)."""
    R, L = codes.shape
    dev = codes.device
    pos = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    lens = lengths[:, None]
    code_active = _code_active(pos, lens, lcp, anchor_mask)
    pb = _pos_buckets(cfg, pos, lens, lcp, pos_map)
    let_ctx = _letters_plane(cfg, codes, pos, pb)

    N = cfg.n_lanes
    rb = lambda x: common.to_row_blocks(x, N)
    len_rows = common.to_read_grid(lengths, N).T              # [rows, N]
    blocks = (rb(codes), rb(kcodes), rb(code_active), rb(pb), rb(let_ctx))
    s_tc, b_tc = state.s_tc, state.b_tc
    outs = []
    for rd in range(len_rows.shape[0]):
        codes_r, kc_r, cact_r, pb_r, let_r = (x[rd] for x in blocks)
        len_r = len_rows[rd]
        st_r = state._replace(s_tc=s_tc, b_tc=b_tc)
        eff_r = dna_effective_kcodes(cfg, st_r, codes_r, kc_r, len_r, be)
        parts_r, _ = _window_parts(cfg, st_r, eff_r, len_r, be)
        counts, level = _cascade_combine(*parts_r)
        act_r = pos < len_r[:, None]
        if cfg.rough:
            sw = cfg.smer_len - 1
            miss = act_r & (pos >= sw) & ~parts_r[4] & ~parts_r[5]
            age = _miss_age(miss, pos.expand_as(miss))
            ok = miss & (age >= 0) & (age <= sw - 1)
            s_lo, s_hi = kmers.pack_windows(eff_r, sw)
            rs_lo, rs_hi = kmers.pack_windows_rc(eff_r, sw)
            sr = lambda x: kmers.shift_right(x, 1)[:, sw:]
            cr_t = _rough_counts(cfg, be, s_tc, sr(s_lo), sr(s_hi),
                                 sr(rs_lo), sr(rs_hi),
                                 torch.clamp(age[:, sw:], 0, sw - 1),
                                 ok[:, sw:])
            cr = torch.cat([cr_t.new_zeros(ok.shape[:1] + (sw, 4)), cr_t],
                           dim=1)
            fr = ok & (cr.sum(dim=-1) > 0)
            counts, level = _combine_rough(counts, level, cr, fr)
        ctx_r, sym_r = _ctx_sym_from_counts(
            cfg, counts, level, codes_r, cact_r, pb_r, let_r, pos)
        cdf = _dna_cdf(cfg, state.model, None, ctx_r, cfg.scale_bits)
        f, c = models.cdf_encode_lookup(cdf, sym_r)
        f = torch.where(cact_r, f, 1 << cfg.scale_bits)
        c = torch.where(cact_r, c, 0)
        s_tc, b_tc = _apply_sb_updates(cfg, be, s_tc, b_tc, eff_r, act_r)
        outs.append((eff_r, ctx_r, sym_r, f, c))
    eff, ctx_all, sym_enc, f, c = (
        common.from_row_blocks(torch.stack(o)) for o in zip(*outs))
    return eff, ctx_all, sym_enc, f, c, code_active, s_tc, b_tc


def dna_pe_encode(cfg: DnaConfig, state: DnaState, codes, lengths,
                  lcp=None):
    """Encoder-side anchor pass over an interleaved PE batch: anchors
    found against the batch-start pair table, the pe stream's (id, pos
    lo, pos hi) symbols a pair, and the anchored 3-row recoding
    (pe.expand_pe_rows) that the DNA codec models. lcp (sorted order):
    [R], carried to the read1 rows.

    Returns (codes3 [R3, L], lengths3 [R3], anchor_mask3 [R3, L], lcp3
    [R3] or None, pe_syms [P, 3], pe_act [P, 3], f [P, 3], c [P, 3],
    pos_map3): the last the rows' coordinate map (_pe_pos_map) under
    cfg.pe_pos_ctx, else None."""
    B = cfg.bmer_len
    R, L = codes.shape
    raw_k = torch.where(codes >= 4, 0, codes)
    cand_any, mid, pos, _, _ = pe.find_anchors(state.pe[:4], codes, raw_k,
                                               lengths, B)
    has = cand_any & (mid < pe.N_CAND)
    codes3, lengths3 = pe.expand_pe_rows(codes, lengths, pos, has, B)
    anchor_mask3 = pe.expand_lengths_mask(codes3.shape[0], L, has, B)
    pos_map3 = None
    if cfg.pe_pos_ctx:
        lenB = torch.where(has, torch.minimum(torch.where(has, pos, 0) + B,
                                              lengths[1::2]), 0)
        pos_map3 = _pe_pos_map(lengths, pos, has, lenB)
    lcp3 = None
    if lcp is not None:
        lcp3 = torch.zeros((codes3.shape[0],), dtype=torch.int64,
                           device=codes.device)
        lcp3[0::3] = lcp[0::2]
    pe_syms = torch.stack([mid, pos & 0xFF, (pos >> 8) & 0xFF], dim=-1)
    pe_act = torch.stack([cand_any, has, has], dim=-1)
    ctx3 = torch.arange(pe.PE_N_CTX, dtype=torch.int64,
                        device=codes.device)[None, :].expand_as(pe_syms)
    cdf = models.model_cdf(state.pe[4], ctx3, cfg.scale_bits)
    f, c = models.cdf_encode_lookup(cdf, pe_syms)
    f = torch.where(pe_act, f, 1 << cfg.scale_bits)
    c = torch.where(pe_act, c, 0)
    return (codes3, lengths3, anchor_mask3, lcp3, pe_syms, pe_act, f, c,
            pos_map3)


# ---------------------------------------------------------------------------
# shared state evolution
# ---------------------------------------------------------------------------

def sb_canon_events(cfg: DnaConfig, kcodes, active, k: int, log2b: int):
    """Flat (bkt, tag, valid) canonical insert events of the width-k table
    for a [rows, L] block, sliced to the columns with a full window."""
    c0 = k - 1
    sr = lambda x: kmers.shift_right(x, 1)[:, c0:]
    ctx_lo, ctx_hi = kmers.pack_windows(kcodes, k - 1)
    r_lo, r_hi = kmers.pack_windows_rc(kcodes, k - 1)
    bkt, tag = _canon_insert(sr(ctx_lo), sr(ctx_hi), sr(r_lo), sr(r_hi),
                             kcodes[:, c0:], k, log2b)
    return bkt.reshape(-1), tag.reshape(-1), active[:, c0:].reshape(-1)


def _apply_sb_updates(cfg: DnaConfig, be, s_tc, b_tc, kcodes, active):
    """Apply one block's s/b insert events. kcodes/active: [rows, L].
    Canonical tables take one event a k-mer occurrence (it covers both
    strands); context-keyed tables take a forward event (the context
    before a base -> the base) and a reverse-complement one (the rc of the
    k-mer ending at the base -> the complement of its first base)."""

    def upd(tc, k, log2b):
        if cfg.canon:
            bkt, tag, vk = sb_canon_events(cfg, kcodes, active, k, log2b)
            return be.ktable_update(tc, bkt, tag, vk, log2_base=log2b)
        c0 = k - 1
        ctx_lo, ctx_hi = (kmers.shift_right(t, 1)[:, c0:]
                          for t in kmers.pack_windows(kcodes, k - 1))
        rc_lo, rc_hi = (t[:, c0:]
                        for t in kmers.pack_windows_rc(kcodes, k - 1))
        rc_base = (3 - kmers.shift_right(kcodes, k - 1))[:, c0:]
        vk = active[:, c0:].reshape(-1)
        return be.table_update(
            tc, torch.cat([ctx_lo.reshape(-1), rc_lo.reshape(-1)]),
            torch.cat([ctx_hi.reshape(-1), rc_hi.reshape(-1)]),
            torch.cat([kcodes[:, c0:].reshape(-1), rc_base.reshape(-1)]),
            torch.cat([vk, vk]), log2_base=log2b, rounds=cfg.claim_rounds)

    return (upd(s_tc, cfg.smer_len, cfg.smer_log2_buckets),
            upd(b_tc, cfg.bmer_len, cfg.bmer_log2_buckets))


def dna_collect_updates(cfg: DnaConfig, state: DnaState, codes, kcodes,
                        lengths, ctx_all, sym_enc, code_active,
                        be=tables.LOCAL, pe_syms=None, pe_act=None,
                        codes_true=None, lengths_true=None,
                        skip_sb: bool = False) -> DnaState:
    """Apply one batch's statistics. Model updates count only coded
    positions; the SIV ingests every in-length position, both strands. With
    the paired-end anchors on, the pair table also takes the batch's
    cross-mate minimizer events, from the true interleaved reads
    (codes_true, lengths_true: the main arguments are the anchored 3-row
    recoding), and the pe model the pe stream's symbols (pe_syms, pe_act
    [P, 3]) where they are given.

    skip_sb: the s/b tables already evolved inside the row loop (the
    encoder's dna_process_batch_rg, the decoder's rows), so they pass
    through — every single-device caller of row-global tables. Without it
    batch-frozen tables take the whole batch's s/b events at once, and
    row-global ones (the mesh decode's batch collect) the events of the
    batch's row blocks (common.to_row_blocks), replayed in order: the
    event sequence a single device's row loop applies."""
    R, L = codes.shape
    pos = torch.arange(L, dtype=torch.int64, device=codes.device)[None, :]
    active = pos < lengths[:, None]

    if cfg.mix_w > 0:
        # fine + coarse families in one array: one update for both
        mctx = torch.cat([ctx_all.reshape(-1),
                          _n_model_ctx(cfg)
                          + _coarse_ctx(cfg, ctx_all).reshape(-1)])
        msym = torch.cat([sym_enc.reshape(-1)] * 2)
        mact = torch.cat([code_active.reshape(-1)] * 2)
        model = models.model_update(state.model, mctx, msym, mact)
    else:
        model = models.model_update(
            state.model, ctx_all.reshape(-1), sym_enc.reshape(-1),
            code_active.reshape(-1))

    # packed siv_len windows are exactly (ctx << 2 | next_base) cell keys,
    # sliced to the columns where a full window exists
    c0 = cfg.siv_len - 1
    siv_f = kmers.pack_windows(kcodes, cfg.siv_len)[0][:, c0:]
    siv_r = kmers.pack_windows_rc(kcodes, cfg.siv_len)[0][:, c0:]
    v_siv = active[:, c0:].reshape(-1)
    siv = be.siv_update(
        state.siv, torch.cat([siv_f.reshape(-1), siv_r.reshape(-1)]),
        torch.cat([v_siv, v_siv]))

    s_tc, b_tc = state.s_tc, state.b_tc
    if not skip_sb and not cfg.row_global:
        s_tc, b_tc = _apply_sb_updates(cfg, be, s_tc, b_tc, kcodes, active)
    elif not skip_sb:
        for kc_r, act_r in zip(common.to_row_blocks(kcodes, cfg.n_lanes),
                               common.to_row_blocks(active, cfg.n_lanes)):
            s_tc, b_tc = _apply_sb_updates(cfg, be, s_tc, b_tc, kc_r, act_r)

    pe_state = state.pe
    if cfg.pe_log2_buckets > 0:
        c_t = codes if codes_true is None else codes_true
        l_t = lengths if lengths_true is None else lengths_true
        ev = pe.pair_events(c_t, torch.where(c_t >= 4, 0, c_t), l_t,
                            cfg.bmer_len)
        pe_model = state.pe[4]
        if pe_syms is not None:
            ctx3 = torch.arange(pe.PE_N_CTX, dtype=torch.int64,
                                device=codes.device)[None, :].expand_as(
                                    pe_syms)
            pe_model = models.model_update(
                pe_model, ctx3.reshape(-1), pe_syms.reshape(-1),
                pe_act.reshape(-1))
        pe_state = tables.pair_update(state.pe[:4], *ev) + (pe_model,)
    return state._replace(siv=siv, s_tc=s_tc, b_tc=b_tc, model=model,
                          pe=pe_state)


def dna_apply_batch(cfg: DnaConfig, state: DnaState, codes, kcodes,
                    lengths, be=tables.LOCAL, lcp=None) -> DnaState:
    """Recompute a (decoded) batch's contexts and evolve the state — the
    encoder's own pass, so both sides converge."""
    eff, ctx_all, sym_enc, _, _, code_active, s_tc, b_tc = \
        dna_process_batch(cfg, state, codes, kcodes, lengths, be, lcp)
    return dna_collect_updates(
        cfg, state._replace(s_tc=s_tc, b_tc=b_tc), codes, eff, lengths,
        ctx_all, sym_enc, code_active, be, skip_sb=cfg.row_global)


def dna_encode_batch(cfg: DnaConfig, state: DnaState, codes, kcodes, lengths,
                     lcp=None):
    """One batch coded from fresh lanes (the reference's single-step
    encode): the row loop carries row-global s/b tables, and the rest of
    the state (batch-frozen tables too) evolves from the batch. Returns
    (words, n_words, decoder initial states, new state)."""
    eff, ctx_all, sym_enc, f, c, code_active, s_tc, b_tc = \
        dna_process_batch(cfg, state, codes, kcodes, lengths, lcp=lcp)
    words, n_words, states = rans.rans_encode(
        common.lane_grid(f, cfg.n_lanes), common.lane_grid(c, cfg.n_lanes),
        cfg.scale_bits)
    new_state = dna_collect_updates(
        cfg, state._replace(s_tc=s_tc, b_tc=b_tc), codes, eff, lengths,
        ctx_all, sym_enc, code_active, skip_sb=cfg.row_global)
    return words, n_words, states, new_state


# ---------------------------------------------------------------------------
# decoder: the per-position scan
# ---------------------------------------------------------------------------

def _decode_segments(cfg: DnaConfig, L: int):
    """Static segmentation of a row's L positions, as the reference
    compiles it: a plain scan below the prefix ramp, one step per ramp
    column (its exact-width SIV range read), a plain scan after it; with
    rough evidence on, scans split at the s window (s_w) so that only steps
    at i >= s_w run the probes. Returns [(i, ramp_q or None, rough_on)]."""
    s_w = cfg.smer_len - 1
    ramp = [q for q in _ramp_cols(cfg) if q < L] if cfg.prefix_ramp else []
    segs = []
    if ramp:
        if ramp[0] > 0:
            segs.append(("scan", 0, ramp[0]))
        segs += [("ramp", q) for q in ramp]
        if ramp[-1] + 1 < L:
            segs.append(("scan", ramp[-1] + 1, L))
    else:
        segs.append(("scan", 0, L))
    if cfg.rough:
        split = []
        for sg in segs:
            if sg[0] == "scan" and sg[1] < s_w < sg[2]:
                split += [("scan", sg[1], s_w), ("scan", s_w, sg[2])]
            else:
                split.append(sg)
        segs = split
    steps = []
    for sg in segs:
        if sg[0] == "ramp":
            steps.append((sg[1], sg[1], sg[1] >= s_w))
        else:
            steps += [(i, None, sg[2] > s_w) for i in range(sg[1], sg[2])]
    return steps


def _key_mask(width_bases: int):
    bits = 2 * width_bases
    return (0xFFFFFFFF if bits >= 32 else (1 << bits) - 1,
            0 if bits <= 32 else (1 << (bits - 32)) - 1)


# Launches of K2 (the CUDA DNA decode scan, one a read row) in this process;
# the plain row scan never counts.
K2_LAUNCHES = 0
K2_MAX_LANES = 2048   # one cluster of 16 blocks x 128 (the source's kMaxLanes)
# carried registers of a row, the rows of one int64 [K2_NREGS, N] tensor:
# pkey, slo, shi, blo, bhi, rslo, rshi, rblo, rbhi (the SIV key, then the
# (lo, hi) u32 halves of the s and b windows and of their reverse
# complements)
K2_NREGS = 9
# the launch's int64 arguments, in the order of struct Args in the source
K2_ARGS = ("siv", "s_tc", "b_tc", "model", "lengths", "words", "x_in",
           "ptr_in", "regs_in", "lcp", "src", "base", "kc", "ctx", "sym",
           "x_out", "ptr_out", "regs_out", "n_words", "N", "L", "siv_len",
           "smer_len", "bmer_len", "prefix_len", "scale_bits", "s_log2_rows",
           "s_log2_base", "b_log2_rows", "b_log2_base", "mix_w", "mix_b",
           "events", "family", "row_update", "ctx_v", "rough", "let_pb2",
           "prefix_ramp", "pmer_gate", "repair_iters", "ls", "lb", "lm",
           "local", "local_log2_cells", "local_cap", "pos", "pos_off",
           "pos_len", "pos_sign")
# the in-batch local statistics K2 reads, in the order of its kLoc template
# parameter: none, local_* tables, local_* tables and the DNA model's
# deltas, klocal_* tables, klocal_* tables and the deltas
K2_LOCAL = ("none", "local", "local+deltas", "klocal", "klocal+deltas")


# a read row's position map, in the order of K2's kPos template parameter:
# the row's own positions, the sorted-mode buckets past each lane's LCP
# (dna_sorted_ctx), the paired-end coordinate map (dna_pe_pos_ctx)
K2_POS = ("plain", "sorted", "pe")
# K2's launches by the row's position map
K2_POS_LAUNCHES = dict.fromkeys(K2_POS, 0)


class PosMap(NamedTuple):
    """The position map of one decoded read row (K2's kPos), for the
    contexts' position buckets: kind 1 (dna_sorted_ctx), off the lanes'
    LCPs [N] — the prefix each read shares with the previous read of its
    lane, as meta coded it —, past which a position counts
    (_pos_bucket_sorted); kind 2 (dna_pe_pos_ctx, rowA and rowB), a
    position i stands at max(off + sign * i, 0) in a read of length plen,
    off and plen [N] (_pe_pos_map)."""
    kind: int
    off: torch.Tensor
    plen: torch.Tensor | None = None
    sign: int = 1


def _row_pos_bucket(i: int, length, pos):
    """[N] position buckets of position i of a row (PosMap pos, or None)."""
    if pos is not None and pos.kind == 2:
        return _pos_bucket(torch.clamp(pos.off + pos.sign * i, min=0),
                           pos.plen)
    pb = _pos_bucket(torch.full_like(length, i), length)
    if pos is not None:
        pb = _pos_bucket_sorted(pb, i, length, pos.off)
    return pb


def k2_local(cfg: DnaConfig) -> int:
    """cfg's index in K2_LOCAL."""
    if not _with_local(cfg):
        return 0
    return (3 if cfg.canon else 1) + int(cfg.local_model_inc > 0)


def dna_decode_row_plain(cfg: DnaConfig, state: DnaState, length, words, x,
                         ptr, regs, L: int, lcp=None, src=None,
                         be=tables.LOCAL, loc=None, pos=None):
    """K2's plain torch version, on any device: one read row of the decode,
    the reference's whole `outer` step — its `inner` step for each of the
    row's static steps (_decode_segments), then, where the tables are
    row-global, the row's s/b insert events (_apply_sb_updates). state: the
    DnaState the row reads, its row-global s/b tables fresh with every
    earlier row's events (batch-frozen ones: the batch's); the window
    registers of the reverse complements roll whatever the family, though
    only canonical tables read them; length: [N] int64; words: [W]
    integer tensor of u16 values; x: [N] int64 lane states; ptr: 0-d int64
    words consumed so far; regs: int64 [K2_NREGS, N] carried registers;
    lcp (sorted order): [N] int64 prefix lengths, 0 <= lcp <= length, and
    src: the previous read row's base plane, int64 [N, L] — a position
    below lcp takes no word and copies its base from src, and is left out
    of the rank history; None for original order. loc: the batch's
    in-batch local state (ls, lb, lm) as the earlier rows left it
    (_local_state_create, local_row_update), read only: the local s and b
    counts merge into the cascade's, and the deltas lm into the cdf; None
    without local statistics. pos: the row's position map (PosMap), or
    None for the row's own positions.
    Returns ((base, kc, ctx_all, sym) int64 [N, L], x, ptr, regs, s_tc,
    b_tc), row-global tables new tensors (the state's are left as they
    were), batch-frozen ones the state's."""
    N = length.shape[0]
    dev = x.device
    sb = cfg.scale_bits
    pm_mask = 4 ** (cfg.siv_len - 1) - 1
    s_w, b_w = cfg.smer_len - 1, cfg.bmer_len - 1
    s_mlo, s_mhi = _key_mask(s_w)
    b_mlo, b_mhi = _key_mask(b_w)
    let_base = 1 << _ctx_bits(cfg)
    m_loc = cfg.local_log2_cells
    lm = None if loc is None else loc[2]
    pkey, slo, shi, blo, bhi, rslo, rshi, rblo, rbhi = regs.unbind(0)
    zeros = torch.zeros((N,), dtype=torch.int64, device=dev)
    lh = torch.full((N,), LH_RESET, dtype=torch.int64, device=dev)
    rh = rep_cnt = prevc = srun = zeros
    ys = []
    for i, ramp_q, rough_on in _decode_segments(cfg, L):
        active = i < length
        in_prefix = active & (i < lcp) if lcp is not None else None
        coded = active if lcp is None else active & ~in_prefix
        vp_i = i >= cfg.siv_len - 1
        if cfg.pmer_gate > 0:
            vp_i = vp_i and i < cfg.pmer_gate
        vp = active & vp_i
        vs = active & (i >= s_w)
        vb = active & (i >= b_w)
        s_lo, s_hi = slo & s_mlo, shi & s_mhi
        if cfg.canon:
            s_q = _canon_query(s_lo, s_hi, rslo, rshi, cfg.smer_len,
                               cfg.smer_log2_buckets)
            b_q = _canon_query(blo & b_mlo, bhi & b_mhi, rblo, rbhi,
                               cfg.bmer_len, cfg.bmer_log2_buckets)
            parts = _cascade_parts_k(state, pkey & pm_mask, s_q, b_q, vp, vs,
                                     vb, be, cfg.smer_log2_buckets,
                                     cfg.bmer_log2_buckets)
        else:
            parts = _cascade_parts(state, pkey & pm_mask, s_lo, s_hi,
                                   blo & b_mlo, bhi & b_mhi, vp, vs, vb, be,
                                   cfg.smer_log2_buckets,
                                   cfg.bmer_log2_buckets)
        if ramp_q is not None:
            # partial-prefix SIV evidence: pkey's low 2q bits are this row's
            # decoded prefix (repair never rewrites them)
            cq = _prefix_ramp_counts_static(
                cfg, be, state.siv, pkey & (4 ** ramp_q - 1), ramp_q)
            ok = active & (cq.sum(dim=-1) > 0)
            cp_, cs_, cb_, fp_, fs_, fb_ = parts
            parts = (torch.where(ok[:, None], cq, cp_), cs_, cb_, fp_ | ok,
                     fs_, fb_)
        counts_g, level_g = _cascade_combine(*parts)
        counts, level = counts_g, level_g
        if loc is not None:
            if cfg.canon:
                cs_l = tables.klocal_query(
                    loc[0], *tables.local_keys(s_q[3], s_q[4], m_loc),
                    _klocal_slots(s_q[2], s_q[5]), vs)
                cb_l = tables.klocal_query(
                    loc[1], *tables.local_keys(b_q[3], b_q[4], m_loc),
                    _klocal_slots(b_q[2], b_q[5]), vb)
            else:
                cs_l = tables.local_query(
                    loc[0], *tables.local_keys(s_lo, s_hi, m_loc), vs)
                cb_l = tables.local_query(
                    loc[1], *tables.local_keys(blo & b_mlo, bhi & b_mhi,
                                               m_loc), vb)
            counts, level = _cascade_combine(*_merge_local(parts, cs_l,
                                                           cb_l))
        if cfg.rough and rough_on:
            # suspect-tracked 1-sub rescue; srun counts this lane's
            # consecutive s/b misses
            miss = vs & ~parts[4] & ~parts[5]
            srun = torch.where(miss, srun + 1, 0)
            age = srun - 1
            ok_r = miss & (age <= s_w - 1)
            cr = _rough_counts(cfg, be, state.s_tc, s_lo, s_hi, rslo, rshi,
                               torch.clamp(age, 0, s_w - 1), ok_r)
            fr = ok_r & (cr.sum(dim=-1) > 0)
            counts, level = _combine_rough(counts, level, cr, fr)

        use_code = (level > LEVEL_NONE) & (i >= cfg.prefix_len)
        pb = _row_pos_bucket(i, length, pos)
        nz = _popcount4(rh)
        if cfg.ctx_v >= 2:
            code_ctx = _code_ctx(level, counts, pb, nz, prevc,
                                 rough=cfg.rough > 0)
        else:
            code_ctx = _code_ctx(level, counts, pb, nz)
        let_ctx = (lh & LH_MASK) | (_let_pb(cfg, pb) << 15)
        ctx_all = torch.where(use_code, code_ctx, let_base + let_ctx)

        cdf = _dna_cdf(cfg, state.model, lm, ctx_all, sb)
        sym, f, c = rans.cdf_lookup(cdf, rans.rans_decode_slots(x, sb))
        f = torch.where(coded, f, 1 << sb)
        c = torch.where(coded, c, 0)
        x, ptr = rans.rans_decode_advance(x, ptr, words, f, c, sb)

        base = torch.where(use_code, _base_of_rank(counts, sym), sym)
        if lcp is not None:
            base = torch.where(in_prefix, src[:, i], base)
        base = torch.where(active, base, 0)
        # repair triggers on the cascade's counts, before rough evidence
        trig, best = _repair_trigger(counts_g, level_g, base)
        do_rep = trig & active & (rep_cnt < cfg.repair_iters)
        rep_cnt = rep_cnt + do_rep.to(torch.int64)
        kc = torch.where(do_rep, best, torch.where(base >= 4, 0, base))

        pkey = ((pkey << 2) | kc) & pm_mask
        shi = ((shi << 2) | (slo >> 30)) & s_mhi
        slo = ((slo << 2) | kc) & s_mlo
        bhi = ((bhi << 2) | (blo >> 30)) & b_mhi
        blo = ((blo << 2) | kc) & b_mlo
        comp = 3 - kc
        rslo, rshi = kmers.or_top_base(*kmers.shr2(rslo, rshi), comp, s_w)
        rblo, rbhi = kmers.or_top_base(*kmers.shr2(rblo, rbhi), comp, b_w)
        lh = ((lh << 3) | base) & LH_MASK
        rbit = (use_code & (sym > 0) & coded).to(torch.int64)
        rh = ((rh << 1) | rbit) & 0xF
        prevc = _level_class(cfg, level, use_code)
        ys.append((base, kc, ctx_all, sym))
    planes = tuple(torch.stack(y, dim=1) for y in zip(*ys))     # [N, L]
    s_tc, b_tc = state.s_tc, state.b_tc
    if cfg.row_global:
        pos = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
        s_tc, b_tc = _apply_sb_updates(cfg, be, s_tc, b_tc, planes[1],
                                       pos < length[:, None])
    return planes, x, ptr, torch.stack(
        [pkey, slo, shi, blo, bhi, rslo, rshi, rblo, rbhi]), s_tc, b_tc


def _check_k2(cfg, state, length, words, x, ptr, regs, L, lcp, src, be,
              loc=None, pos=None):
    if be is not tables.LOCAL:
        raise ValueError("K2 reads whole tables on one device (the local "
                         "backend)")
    N = cfg.n_lanes
    dev = state.model.device
    if not 1 <= N <= K2_MAX_LANES:
        raise ValueError(f"K2: {N} lanes, one cluster takes "
                         f"1..{K2_MAX_LANES}")
    s_rows, b_rows = state.s_tc.shape[0], state.b_tc.shape[0]
    width = table_family(cfg)[2]
    n_model = _n_model_ctx(cfg) + (_n_coarse_ctx(cfg) if cfg.mix_w > 0
                                   else 0)
    want = (("siv", state.siv, torch.int64, (4 ** (cfg.siv_len - 1),)),
            ("s_tc", state.s_tc, torch.int64, (s_rows, width)),
            ("b_tc", state.b_tc, torch.int64, (b_rows, width)),
            ("model", state.model, torch.int32, (n_model, A_SYM)),
            ("length", length, torch.int64, (N,)),
            ("words", words, torch.int32, None),
            ("x", x, torch.int64, (N,)),
            ("ptr", ptr, torch.int64, ()),
            ("regs", regs, torch.int64, (K2_NREGS, N)))
    if (lcp is None) != (src is None):
        raise ValueError("K2: lcp and src go together (sorted order) or "
                         "are both None")
    if lcp is not None:
        want += (("lcp", lcp, torch.int64, (N,)),
                 ("src", src, torch.int64, (N, L)))
    if pos is not None:
        # the maps ride on the prefix copy's instantiations: the rows that
        # take one (sorted rows, rowA, rowB) copy prefixes or anchors
        if lcp is None or pos.kind not in (1, 2) or (
                pos.kind == 1 and not cfg.sorted_ctx) or (
                pos.kind == 2 and (not cfg.pe_pos_ctx
                                   or pos.sign not in (1, -1))):
            raise ValueError(f"K2: a position map of kind {pos.kind} "
                             f"(sign {pos.sign}) on this row and header")
        want += (("pos.off", pos.off, torch.int64, (N,)),)
        if pos.kind == 2:
            want += (("pos.plen", pos.plen, torch.int64, (N,)),)
    if (loc is not None) != _with_local(cfg):
        raise ValueError("K2: the in-batch local state goes with "
                         "local_log2_cells > 0 without row-global updates")
    if loc is not None:
        cells = 1 << cfg.local_log2_cells
        lw = tables.KLOCAL_W if cfg.canon else tables.LOCAL_W
        lm_shape = ((_n_model_ctx(cfg), A_SYM) if cfg.local_model_inc > 0
                    else (1, 1))
        want += (("ls", loc[0], torch.int64, (cells, lw)),
                 ("lb", loc[1], torch.int64, (cells, lw)),
                 ("lm", loc[2], torch.int32, lm_shape))
    common.check_kernel_tensors("K2", want, dev)
    for name, rows, log2_base in (("s", s_rows, cfg.smer_log2_buckets),
                                  ("b", b_rows, cfg.bmer_log2_buckets)):
        lr = rows.bit_length() - 1
        if rows != 1 << lr or not log2_base <= lr <= min(log2_base + 4, 30):
            raise ValueError(f"K2: the {name} table has {rows} rows, not "
                             f"2^{log2_base} grown at most 4 times")
    if state.s_tc.data_ptr() % 16 or state.b_tc.data_ptr() % 16:
        raise ValueError("K2: the s/b tables' rows must be 16-byte aligned")
    s_at, b_at = state.s_tc.data_ptr(), state.b_tc.data_ptr()
    if (s_at < b_at + state.b_tc.nbytes and b_at < s_at + state.s_tc.nbytes):
        raise ValueError("K2: the s and b tables overlap (K2 updates both "
                         "in place)")
    # one pull a sorted row: the prefix copy must stay inside the read
    if lcp is not None and bool(((lcp < 0) | (lcp > length)).any()):
        raise ValueError("K2: an lcp outside 0..length")
    if (words.numel() < 1 or L < 1 or N * L >= 1 << 31
            or not 1 <= cfg.scale_bits <= 16 or not 3 <= cfg.siv_len <= 17
            or not 3 <= cfg.smer_len <= 33 or not 3 <= cfg.bmer_len <= 33
            or not 0 <= cfg.mix_w <= 1 << 18 or cfg.mix_b < 1
            or cfg.mix_w * cfg.mix_b >= 1 << 31 or cfg.pmer_gate < 0
            or not 0 <= cfg.repair_iters < 1 << 20 or cfg.ctx_v < 1
            or (cfg.rough and not (cfg.canon and cfg.row_global
                                   and cfg.ctx_v >= 2))
            or (loc is not None and not 1 <= cfg.local_log2_cells <= 30)):
        raise ValueError(f"K2: {words.numel()} words, L = {L}, or a "
                         f"geometry outside the kernel's: {cfg}")


def _k2_launch(entry, cfg, state, length, words, x, ptr, regs, L,
               lcp=None, src=None, loc=None, pos=None):
    """Allocate one row's outputs and its event scratch and launch `entry`
    (a C function with K2's signature) on the current stream. No checks:
    _check_k2 first. Returns (planes, x, ptr, regs, s_tc, b_tc), the tables
    the state's, updated in place."""
    dev = x.device
    N = cfg.n_lanes
    planes = torch.empty((4, N, L), dtype=torch.int64, device=dev)
    x_out = torch.empty((N,), dtype=torch.int64, device=dev)
    ptr_out = torch.empty((1,), dtype=torch.int64, device=dev)
    regs_out = torch.empty((K2_NREGS, N), dtype=torch.int64, device=dev)
    # the row's s, then b insert decisions, one a lane and position: K2
    # writes those of positions k-1 <= i < length and reads them back after
    # the row's scan
    events = torch.empty((2, L, N), dtype=torch.int64, device=dev)
    vals = {
        "siv": state.siv, "s_tc": state.s_tc, "b_tc": state.b_tc,
        "model": state.model, "lengths": length, "words": words, "x_in": x,
        "ptr_in": ptr, "regs_in": regs, "lcp": lcp, "src": src,
        "base": planes[0], "kc": planes[1],
        "ctx": planes[2], "sym": planes[3], "x_out": x_out,
        "ptr_out": ptr_out, "regs_out": regs_out,
        "n_words": words.numel(), "N": N, "L": L, "siv_len": cfg.siv_len,
        "smer_len": cfg.smer_len, "bmer_len": cfg.bmer_len,
        "prefix_len": cfg.prefix_len, "scale_bits": cfg.scale_bits,
        "s_log2_rows": state.s_tc.shape[0].bit_length() - 1,
        "s_log2_base": cfg.smer_log2_buckets,
        "b_log2_rows": state.b_tc.shape[0].bit_length() - 1,
        "b_log2_base": cfg.bmer_log2_buckets,
        "mix_w": cfg.mix_w, "mix_b": cfg.mix_b, "events": events,
        "family": FAMILIES.index(table_family(cfg)[0]),
        "row_update": int(cfg.row_global and cfg.canon),
        "ctx_v": cfg.ctx_v,
        "rough": int(cfg.rough > 0), "let_pb2": int(cfg.let_pb2 > 0),
        "prefix_ramp": int(cfg.prefix_ramp), "pmer_gate": cfg.pmer_gate,
        "repair_iters": cfg.repair_iters,
        "ls": None if loc is None else loc[0],
        "lb": None if loc is None else loc[1],
        "lm": None if loc is None else loc[2], "local": k2_local(cfg),
        "local_log2_cells": cfg.local_log2_cells,
        "local_cap": models.local_cap(A_SYM, cfg.scale_bits,
                                      extra=max(cfg.mix_w, 0)),
        "pos": 0 if pos is None else pos.kind,
        "pos_off": None if pos is None else pos.off,
        "pos_len": None if pos is None else pos.plen,
        "pos_sign": 0 if pos is None else pos.sign}
    args = (ctypes.c_int64 * len(K2_ARGS))(*(
        v.data_ptr() if isinstance(v, torch.Tensor) else v or 0
        for v in (vals[k] for k in K2_ARGS)))
    with torch.cuda.device(dev):
        rc = entry(args, len(K2_ARGS),
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {rc}")
    return (tuple(planes.unbind(0)), x_out, ptr_out[0], regs_out, state.s_tc,
            state.b_tc)


def _dna_decode_row_cuda(cfg, state, length, words, x, ptr, regs, L, lcp,
                         src, be, loc=None, pos=None):
    """One K2 launch for one read row, its table update included. Checks
    everything before it builds or launches. K2 updates canonical tables
    itself; context-keyed ones take the row's events after it, as torch
    ops (_apply_sb_updates, the encoder's rule), copied back in place."""
    global K2_LAUNCHES
    _check_k2(cfg, state, length, words, x, ptr, regs, L, lcp, src, be, loc,
              pos)
    from ..ops import _build

    out = _k2_launch(_build.kernels().fqtz_dna_decode_row, cfg, state,
                     length, words, x, ptr, regs, L, lcp, src, loc, pos)
    K2_LAUNCHES += 1
    K2_POS_LAUNCHES[K2_POS[0 if pos is None else pos.kind]] += 1
    if cfg.row_global and not cfg.canon:
        at = torch.arange(L, dtype=torch.int64, device=x.device)[None, :]
        for tc, new in zip(out[4:], _apply_sb_updates(
                cfg, be, state.s_tc, state.b_tc, out[0][1],
                at < length[:, None])):
            tc.copy_(new)
    return out


def dna_decode_row(cfg: DnaConfig, state: DnaState, length, words, x, ptr,
                   regs, L: int, lcp=None, src=None, be=tables.LOCAL,
                   loc=None, pos=None):
    """One read row of the decode, its s/b table update included: on CUDA
    tensors kernel K2 (a failed build or launch raises; nothing falls back
    to the plain version), which updates state.s_tc and state.b_tc IN
    PLACE and returns them; on CPU tensors dna_decode_row_plain, which
    returns new tables (see there for the arguments and the result). The
    model's device decides. K2 takes words as a contiguous int32 tensor.
    The in-batch local state loc is read, never written (the caller
    applies the row's events: local_row_update)."""
    kind = state.model.device.type
    if kind == "cuda":
        return _dna_decode_row_cuda(cfg, state, length, words, x, ptr, regs,
                                    L, lcp, src, be, loc, pos)
    if kind == "cpu":
        return dna_decode_row_plain(cfg, state, length, words, x, ptr, regs,
                                    L, lcp, src, be, loc, pos)
    raise ValueError(f"dna_decode_row: no scan for device "
                     f"{state.model.device}")


def _anchor_plane(anc_lo, anc_hi, row_is_b: bool, B: int, L: int):
    """[N, L] int64 prefix source of an anchored row: its first B columns
    hold the anchor's bases (rowA), or the reverse complement of them
    (rowB); the columns after them are never read."""
    j = torch.arange(L, dtype=torch.int64, device=anc_lo.device)[None, :]
    lo, hi = anc_lo[:, None], anc_hi[:, None]
    if row_is_b:
        return pe.comp_codes(pe.anchor_base(lo, hi, B - 1 - j, B))
    return pe.anchor_base(lo, hi, j, B)


def _pe_row_end(cfg, pe_tbl, pe_cdfs, base, length, L2, pe_x, pe_ptr,
                pe_words):
    """After a read1 row: its candidates from the decoded bases, the pe
    stream's (id, pos lo, pos hi) symbols, and the pair's anchor — the
    reference's PE step at a read1 boundary, as torch ops. pe_tbl: the
    batch-start pair table; pe_cdfs: the pe model's cdf of each context.
    Returns (pe_x, pe_ptr, anc_lo, anc_hi, a, has, lenA, lenB, syms [N,
    3], act [N, 3])."""
    B = cfg.bmer_len
    sb = cfg.scale_bits
    raw_k = torch.where(base >= 4, 0, base)
    q_lo, q_hi = pe.segment_minimizers(base, raw_k, length, B, 4)
    c_lo, c_hi, c_cnt = pe.find_candidates(pe_tbl, q_lo, q_hi, B)
    cand_any = (c_cnt > 0).any(dim=-1)
    mid = torch.full_like(length, pe.N_CAND)
    syms = []
    for j in range(3):
        act = cand_any if j == 0 else cand_any & (mid < pe.N_CAND)
        sym, f, c = rans.cdf_lookup(pe_cdfs[j],
                                    rans.rans_decode_slots(pe_x, sb))
        f = torch.where(act, f, 1 << sb)
        c = torch.where(act, c, 0)
        pe_x, pe_ptr = rans.rans_decode_advance(pe_x, pe_ptr, pe_words, f, c,
                                                sb)
        sym = torch.where(act, sym, 0)
        if j == 0:
            mid = torch.where(cand_any, sym, pe.N_CAND)
        syms.append(sym)
    has = cand_any & (mid < pe.N_CAND)
    sel = torch.clamp(mid, max=pe.N_CAND - 1)[:, None]
    anc_lo = torch.where(has, torch.gather(c_lo, 1, sel)[:, 0], 0)
    anc_hi = torch.where(has, torch.gather(c_hi, 1, sel)[:, 0], 0)
    a = torch.where(has, syms[1] | (syms[2] << 8), 0)
    lenA = L2 - a
    lenB = torch.where(has, torch.minimum(a + B, L2), 0)
    return (pe_x, pe_ptr, anc_lo, anc_hi, a, has, lenA, lenB,
            torch.stack([mid, syms[1], syms[2]], dim=-1),
            torch.stack([cand_any, has, has], dim=-1))


def dna_decode_batch(cfg: DnaConfig, state: DnaState, lengths, words,
                     init_states, L: int, be=tables.LOCAL,
                     apply_update: bool = True, lcp=None,
                     lcp_stride: int = 1, pe_words=None, pe_states=None):
    """Decode a batch — the reference's dna_decode_batch, for row-global or
    batch-frozen s/b tables of any family (the latter with or without
    in-batch local statistics), single-end or paired-end, in original or
    sorted order. lengths: [R]
    int64 (R a multiple of n_lanes); words: [W] integer tensor of u16
    values;
    init_states: [N] int64 (the encoder's final states); lcp (sorted
    order): [R] shared-prefix lengths, whose positions each row copies
    from the read lcp_stride rows back in its lane (1: single-end; 2:
    paired-end, read1 against the previous read1). pe_words, pe_states:
    the pe stream's words and lane states, with cfg.pe_log2_buckets > 0.

    A loop over the read rows: each row is one dna_decode_row (K2 on a CUDA
    device) against the carried s/b tables, the row's s/b insert events
    included, and in sorted order the base plane lcp_stride rows back as its
    prefix source (a zero plane for a lane's first rows, whose lcp is 0);
    dna_collect_updates (model and SIV, batch-frozen s/b tables, and the
    pair table and pe model) runs once after the batch. With in-batch local
    statistics, each row reads the local state the rows before it left
    (zeroed at the batch's start), and local_row_update applies the row's
    events after it: its k-mers at every in-length position, its model
    deltas at those at or past the row's lcp, the reference's act_r (an
    anchored row's preset span included). With the anchors on,
    the loop walks the anchored 3-row recoding (read1, rowA, rowB a pair;
    pe.expand_pe_rows): after each read1 row _pe_row_end decodes the pair's
    pe symbols and arms its anchor, and rowA and rowB, of the lengths the
    anchor gives, take their first B positions from the anchor through the
    row's prefix copy. In sorted order a read1 row's source is the previous
    read1, 3 rows back. Each row's position map (PosMap) follows the
    header: under dna_sorted_ctx the sorted rows' (read1 rows' in PE)
    buckets count past their meta LCP, under dna_pe_pos_ctx rowA and
    rowB take read2's coordinates (from the anchor's start a, of length
    L2, on rowA; back from lenB - 1 on rowB).
    On a CUDA device row-global s/b tables are updated in place: the
    returned state holds the same tensors, and the given one no longer
    holds the batch's starting tables.

    apply_update=False (the mesh decode: one dp shard against the
    batch-frozen state): row-global rows read and update a private copy
    of the s/b tables, made for this call (batch-frozen ones only read the
    state's), so the given state is left as it was;
    the returned state is the given one with those copies after the
    batch's rows, as the reference's (no model, SIV or pair-table update:
    the caller collects the batch's statistics itself, dna_collect_updates
    on the gathered shards).

    Returns (codes [R, L] int64 — the true interleaved reads with anchors
    —, new_state, final_states, n_words_consumed, extras): extras (eff,
    ctx_all, sym, code_active), of the walked rows, and with anchors also
    (final pe lane states, pe_syms [P, 3], pe_act [P, 3], the walked rows'
    codes [R3, L] and lengths [R3]), as the reference's."""
    if lcp is not None and lcp_stride not in (1, 2):
        raise NotImplementedError(f"LCP stride {lcp_stride}: only 1 "
                                  f"(single-end) and 2 (paired-end) are "
                                  f"written")
    with_pe = cfg.pe_log2_buckets > 0 and pe_words is not None
    B = cfg.bmer_len
    N = cfg.n_lanes
    R = lengths.shape[0]
    dev = init_states.device
    lengths = lengths.to(torch.int64)
    len_grid = common.to_read_grid(lengths, N)                 # [N, r_pl]
    n_rows = 3 * (R // 2) // N if with_pe else R // N
    lcp_rows = None
    if lcp is not None:
        lcp_e = lcp.to(torch.int64)
        if with_pe:
            lcp_e = torch.zeros((3 * (R // 2),), dtype=torch.int64,
                                device=dev)
            lcp_e[0::3] = lcp[0::2]
        lcp_rows = common.to_read_grid(lcp_e, N).t().contiguous()
    stride_rows = 3 if with_pe else lcp_stride
    prev = ([torch.zeros((N, L), dtype=torch.int64, device=dev)]
            * stride_rows if lcp is not None else None)
    words = words.to(torch.int32).contiguous()
    pos = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    x = init_states
    ptr = torch.zeros((), dtype=torch.int64, device=dev)
    regs = torch.zeros((K2_NREGS, N), dtype=torch.int64, device=dev)
    s_tc, b_tc = state.s_tc, state.b_tc
    if not apply_update and cfg.row_global:
        # only the row update writes the tables (batch-frozen ones are read)
        s_tc, b_tc = s_tc.clone(), b_tc.clone()
    if with_pe:
        pe_tbl = state.pe[:4]
        pe_cdfs = [models.model_cdf(
            state.pe[4], torch.full((N,), j, dtype=torch.int64, device=dev),
            cfg.scale_bits) for j in range(pe.PE_N_CTX)]
        pe_x = pe_states
        pe_ptr = torch.zeros((), dtype=torch.int64, device=dev)
        zeros = torch.zeros((N,), dtype=torch.int64, device=dev)
        anc_lo = anc_hi = lenA = lenB = zeros
        anc_has = torch.zeros((N,), dtype=torch.bool, device=dev)
        no_end = torch.full((N,), _PE_NO_END, dtype=torch.int64, device=dev)
        row_lens, anc_lcps, pe_rows = [], [], []
    loc = _local_state_create(cfg, dev) if _with_local(cfg) else None
    rows = []
    for rd in range(n_rows):
        k3 = rd % 3 if with_pe else 0
        if with_pe:
            length = (len_grid[:, 2 * (rd // 3)].contiguous() if k3 == 0
                      else lenA if k3 == 1 else lenB)
        else:
            length = len_grid[:, rd].contiguous()
        row_lcp = src = pos_map = None
        if k3:
            # rowA or rowB: an anchored lane's first B bases are preset
            # from the anchor (positions below the row's "lcp")
            row_lcp = torch.where(anc_has, torch.clamp(length, max=B), 0)
            src = _anchor_plane(anc_lo, anc_hi, k3 == 2, B, L)
            if cfg.pe_pos_ctx:
                # read2's coordinates: rowA from the anchor's start, rowB
                # back from lenB - 1 (_pe_pos_map)
                pos_map = (PosMap(2, a, L2, 1) if k3 == 1 else
                           PosMap(2, lenB - 1, no_end, -1))
        elif lcp is not None:
            row_lcp, src = lcp_rows[rd], prev[0]
            if cfg.sorted_ctx:
                pos_map = PosMap(1, row_lcp)
        planes, x, ptr, regs, s_tc, b_tc = dna_decode_row(
            cfg, state._replace(s_tc=s_tc, b_tc=b_tc), length, words, x, ptr,
            regs, L, row_lcp, src, be=be, loc=loc, pos=pos_map)
        if loc is not None:
            act_r = pos < length[:, None]
            if lcp is not None:
                act_r = act_r & (pos >= lcp_rows[rd][:, None])
            loc = local_row_update(cfg, *loc, planes[1], planes[2],
                                   planes[3], act_r, length, row=rd)
        if lcp is not None:
            prev = prev[1:] + [planes[0]]
        rows.append(planes)
        if with_pe:
            row_lens.append(length)
            anc_lcps.append(row_lcp if k3 else zeros)
        if with_pe and k3 == 0:
            L2 = len_grid[:, 2 * (rd // 3) + 1].contiguous()
            (pe_x, pe_ptr, anc_lo, anc_hi, a, anc_has, lenA, lenB, syms,
             act) = _pe_row_end(cfg, pe_tbl, pe_cdfs, planes[0], length, L2,
                                pe_x, pe_ptr, pe_words)
            pe_rows.append((syms, act, a, anc_has))

    codes, eff, ctx_all, sym = (common.from_row_blocks(torch.stack(r))
                                for r in zip(*rows))
    st = state._replace(s_tc=s_tc, b_tc=b_tc)
    if not with_pe:
        code_active = pos < lengths[:, None]
        if lcp is not None:
            code_active = code_active & (pos >= lcp[:, None])
        new_state = st
        if apply_update:
            new_state = dna_collect_updates(cfg, st, codes, eff, lengths,
                                            ctx_all, sym, code_active, be,
                                            skip_sb=cfg.row_global)
        return codes, new_state, x, ptr, (eff, ctx_all, sym, code_active)

    def lane_major(planes):              # [n_rows or pairs, N, ...] -> [...]
        return torch.stack(planes).transpose(0, 1).reshape(
            (-1,) + tuple(planes[0].shape[1:]))

    lengths3 = lane_major(row_lens)
    code_active = ((pos < lengths3[:, None])
                   & (pos >= lane_major(anc_lcps)[:, None]))
    if lcp is not None:
        code_active = code_active & (pos >= lcp_e[:, None])
    pe_syms, pe_act, a_pairs, has_pairs = (lane_major(list(t))
                                           for t in zip(*pe_rows))
    codes_true = pe.collapse_pe_rows(codes, lengths, a_pairs, has_pairs, B)
    new_state = st
    if apply_update:
        new_state = dna_collect_updates(
            cfg, st, codes, eff, lengths3, ctx_all, sym, code_active, be,
            pe_syms=pe_syms, pe_act=pe_act, codes_true=codes_true,
            lengths_true=lengths, skip_sb=cfg.row_global)
    return codes_true, new_state, x, ptr, (
        eff, ctx_all, sym, code_active, pe_x, pe_syms, pe_act, codes,
        lengths3)
