"""ID stream codec: tokenized numeric-delta modeling.

Port of fqsqueezer_tpu/streams/ids.py (see its docstring for the scheme).
The host half — the tokenizer, the per-batch planes and the file-order
delta chains — is the package's own copy of the reference's numpy code,
line for line. The device half codes a fixed-layout symbol grid per read
([flag | F delta syms | 4F magnitude bytes | 2 length bytes | M raw
bytes], unused slots masked rANS no-ops) under static contexts: modeling
is one vectorized pass, and decode is a scan of one step a symbol slot
(r_pl * w_all steps a batch): on CUDA tensors kernel K4
(csrc/slot_decode.cu), one launch a batch; on CPU tensors
id_decode_scan_plain, the same scan as torch ops. Both codec
versions: v2 (the per-context ALPHA masks and the n_valid padding rule)
and the legacy v1 (ALPHA on all 256 symbols of every context, and padding
reads coded like real ones).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import models, rans
from . import common

N_SYM = 256
COL_BUCKETS = 16
F_CAP = 12    # numeric fields coded per id (more -> escape path)
MAGS = 4      # magnitude bytes per field

# context layout (all static)
CTX_LEN0, CTX_LEN1 = 0, 1
CTX_BYTE0 = 2                        # + min(col, 15)
CTX_FLAG = CTX_BYTE0 + COL_BUCKETS
CTX_DELTA0 = CTX_FLAG + 1            # + field
CTX_MAG0 = CTX_DELTA0 + F_CAP        # + field*MAGS + byte
N_CTX = CTX_MAG0 + F_CAP * MAGS

# delta symbols: 0:+0  1:+1  2:-1  3/4:+-1B  5/6:+-2B  7/8:+-4B
_NB_LUT = np.array([0, 0, 0, 1, 1, 2, 2, 4, 4], np.int32)


@dataclasses.dataclass(frozen=True)
class IdConfig:
    max_id_len: int = 64          # static raw-byte cap (per-file)
    n_fields: int = 4             # numeric fields (per-file, <= F_CAP)
    scale_bits: int = 14
    n_lanes: int = 1024
    # codec version (archive header id_codec_v). v2: (a) per-context
    # sub-alphabets — the flag slot can only code {0,1} and delta slots only
    # 0..8, so ALPHA smoothing over the other ~250 symbols of the shared
    # 256-wide model is pure waste (~0.05 bits/symbol converged, 8 bits cold
    # vs 1-3.2); (b) padding reads (row >= n_valid) code NOTHING and leave
    # the host chains untouched (v1 coded an escape flag + 2 length bytes
    # per padded row and corrupted the chain into one extra escape per
    # padded batch). v1 kept for older archives.
    codec_v: int = 2

    @property
    def w_sym(self) -> int:
        return 1 + self.n_fields * (1 + MAGS)

    @property
    def w_all(self) -> int:
        return self.w_sym + 2 + self.max_id_len


def _alpha_lut_np() -> np.ndarray:
    """[N_CTX, 256] 0/1 ALPHA mask: which symbols each context can code
    (codec v2). Flag: {0, 1}; delta slots: the 9 delta symbols; magnitude /
    length / raw-byte slots: full byte alphabet."""
    lut = np.ones((N_CTX, N_SYM), np.int32)
    lut[CTX_FLAG, 2:] = 0
    lut[CTX_DELTA0:CTX_DELTA0 + F_CAP, 9:] = 0
    return lut


# ---------------------------------------------------------------------------
# host tokenizer
# ---------------------------------------------------------------------------

def tokenize_id(s: bytes):
    """Split into literal / numeric runs. Template elements: bytes (literal),
    0 (free-width numeric) or width (fixed-width zero-padded numeric).
    Returns (template tuple, list of numeric values)."""
    t = []
    vals = []
    i, n = 0, len(s)
    while i < n:
        j = i
        if 48 <= s[i] <= 57:
            while j < n and 48 <= s[j] <= 57:
                j += 1
            w = j - i
            if w <= 9:
                vals.append(int(s[i:j]))
                t.append(w if (s[i] == 48 and w > 1) else 0)
            else:
                t.append(s[i:j])   # too wide for int32 deltas: literal
        else:
            while j < n and not (48 <= s[j] <= 57):
                j += 1
            t.append(s[i:j])
        i = j
    return tuple(t), vals


def detokenize(template, vals) -> bytes:
    parts = []
    vi = 0
    for el in template:
        if isinstance(el, bytes):
            parts.append(el)
        else:
            v = str(vals[vi]).encode()
            parts.append(v.rjust(el, b"0") if el else v)
            vi += 1
    return b"".join(parts)


def count_fields(ids) -> int:
    """Per-file numeric-field count (template width), capped at F_CAP.
    Vectorized in chunks (one _ids_struct numpy pass per 64k ids)."""
    mx = 1
    CH = 65536
    for i in range(0, len(ids), CH):
        chunk = ids[i:i + CH]
        M = max((len(s) for s in chunk), default=1) or 1
        nfields = _ids_struct(chunk, M)[5]
        if nfields.size:
            mx = max(mx, int(nfields.max()))
        if mx >= F_CAP:
            return F_CAP
    return mx


def instrument_prefix(ids: list) -> list:
    """Instrument mode: keep bytes up to the first '.', ' ' or ':'
    (reference extract_instrument, id.cpp:231-238)."""
    out = []
    for s in ids:
        cut = len(s)
        for i, b in enumerate(s):
            if b in (0x2E, 0x20, 0x3A):
                cut = i
                break
        out.append(s[:cut])
    return out


def read_lanes(R: int, n_lanes: int) -> np.ndarray:
    """Chain index per read: ONE file-order chain (chain[0]) — every read's
    delta predecessor is the previous read of the file, carried across batch
    boundaries. Counter-style ids then delta by +1 everywhere (including the
    first read of each batch, since batches are consecutive file ranges);
    the earlier per-lane chains paid multi-byte escape jumps at every batch
    boundary x n_lanes (measured +17.5% on the se_ids sweep config).
    Detokenization is host-sequential on both sides, so file order is a
    valid causal order regardless of the device lane layout."""
    return np.zeros(R, np.int64)


def mesh_read_lanes(R: int, dp: int, n_lanes: int) -> np.ndarray:
    """Chain index per read of a dp-mesh archive: one file-order chain per
    dp shard (a batch's reads are dp-sharded contiguously, and each
    shard's stream decodes from its own state)."""
    return np.arange(R) // (R // dp)


def encode_ids_host_ref(ids, lanes: np.ndarray, F: int, M: int, chain: list,
                        n_valid: int | None = None):
    """Scalar reference tokenizer (the spec): one Python iteration per read.
    encode_ids_host is the vectorized production path; tests assert they
    produce identical planes and chain states on adversarial corpora.
    lanes: [R] chain index per read (read_lanes / mesh layout).
    chain: list per lane of (template, values) or None — MUTATED in place
    (the decoder replays the identical updates). n_valid (codec v2): rows
    >= n_valid are padding — they code nothing and leave the chains alone.
    Returns
    (flag [R]u8, dsym [R,F]u8, dmag [R,F,4]u8, emat [R,M]u8, elens [R]i32).
    """
    R = len(ids)
    flag = np.ones(R, np.uint8)
    dsym = np.zeros((R, F), np.uint8)
    dmag = np.zeros((R, F, MAGS), np.uint8)
    emat = np.zeros((R, M), np.uint8)
    elens = np.zeros(R, np.int32)
    if n_valid is not None:
        flag[n_valid:] = 0
        R = min(R, n_valid)
    for r in range(R):
        s = ids[r]
        lane = lanes[r]
        t, v = tokenize_id(s)
        prev = chain[lane]
        ok = (prev is not None and t == prev[0] and len(v) <= F)
        if ok:
            row_s = np.zeros(F, np.uint8)
            row_m = np.zeros((F, MAGS), np.uint8)
            for f in range(len(v)):
                d = v[f] - prev[1][f]
                if d == 0:
                    continue
                if d == 1:
                    row_s[f] = 1
                    continue
                if d == -1:
                    row_s[f] = 2
                    continue
                m = abs(d) - 2
                if m < 256:
                    row_s[f] = 3 if d > 0 else 4
                    row_m[f, 0] = m
                elif m < 65536:
                    row_s[f] = 5 if d > 0 else 6
                    row_m[f, 0] = m & 0xFF
                    row_m[f, 1] = m >> 8
                elif m < 1 << 32:
                    row_s[f] = 7 if d > 0 else 8
                    for j in range(4):
                        row_m[f, j] = (m >> (8 * j)) & 0xFF
                else:
                    ok = False
                    break
            if ok:
                flag[r] = 0
                dsym[r] = row_s
                dmag[r] = row_m
        if not ok:
            b = s[:M]
            elens[r] = len(b)
            emat[r, :len(b)] = np.frombuffer(b, np.uint8)
        chain[lane] = (t, v)
    return flag, dsym, dmag, emat, elens


def _delta_of(sym: int, mag_row) -> int:
    if sym == 0:
        return 0
    if sym == 1:
        return 1
    if sym == 2:
        return -1
    nb = int(_NB_LUT[sym])
    m = 0
    for j in range(nb):
        m |= int(mag_row[j]) << (8 * j)
    m += 2
    return m if sym % 2 == 1 else -m


def decode_ids_host_ref(flag, dsym, dmag, emat, elens, lanes: np.ndarray,
                        chain: list, n_valid: int | None = None) -> list:
    """Scalar reference detokenizer (spec for decode_ids_host)."""
    R = flag.shape[0]
    out = []
    if n_valid is not None and n_valid < R:
        out_pad = [b""] * (R - n_valid)
        R = n_valid
    else:
        out_pad = []
    for r in range(R):
        lane = lanes[r]
        if flag[r]:
            s = bytes(emat[r, :elens[r]])
            t, v = tokenize_id(s)
        else:
            t, pvals = chain[lane]
            v = [pvals[f] + _delta_of(int(dsym[r, f]), dmag[r, f])
                 for f in range(len(pvals))]
            s = detokenize(t, v)
        chain[lane] = (t, v)
        out.append(s)
    return out + out_pad


# ---------------------------------------------------------------------------
# vectorized host codec (WGS-scale: numpy passes; Python only per shard /
# per escape / per distinct number-width layout — VERDICT r3 #10)
# ---------------------------------------------------------------------------

_POW10 = 10 ** np.arange(19, dtype=np.int64)

def _ids_struct(ids, M: int):
    """One numpy pass over a batch of id byte strings: padded byte matrix,
    per-row numeric values, and an alignment-independent template SKELETON —
    literal bytes (including >9-digit runs, which tokenize_id keeps as
    literals) with each narrow (<=9 digit) run collapsed to one marker byte:
    0xE0 for a free-width element, 0xE0+w for a fixed-width (leading-zero)
    element of width w. Ids are ASCII so markers never collide; two ids have
    equal tokenize_id templates iff their skeletons are equal, even when
    free-width runs change width ("id.9" vs "id.10").

    Returns (mat [R,M]u8, lens [R], skl [R,M]u8, sklen [R],
    vals [R,F_CAP]i64, nfields [R])."""
    R = len(ids)
    # this numpy build's cumsum/repeat are ~25x slower on int64 inputs, so
    # every count/length array stays int32 (indices go int64 only at the
    # final flat-scatter arithmetic)
    lens = np.fromiter((min(len(s), M) for s in ids), np.int32, R)
    flat = np.frombuffer(b"".join(s[:M] for s in ids), np.uint8)
    matf = np.zeros(R * M, np.uint8)
    row = np.repeat(np.arange(R, dtype=np.int32), lens)
    col = np.arange(flat.size, dtype=np.int32) - np.repeat(
        (np.cumsum(lens, dtype=np.int32) - lens), lens)
    matf[row.astype(np.int64) * M + col] = flat   # flat scatter
    mat = matf.reshape(R, M)
    D = (mat >= 48) & (mat <= 57)         # padding bytes are 0: never digits
    Df = D.ravel()
    prevD = np.zeros_like(Df)
    prevD[1:] = Df[:-1]
    prevD[::M] = False                    # runs never span rows
    rsf = Df & ~prevD                     # run starts
    starts = np.flatnonzero(rsf)
    valsm = np.zeros((R, F_CAP), np.int64)
    if starts.size == 0:
        return mat, lens, mat.copy(), lens.copy(), valsm, np.zeros(R, np.int32)
    nextD = np.zeros_like(Df)
    nextD[:-1] = Df[1:]
    nextD[M - 1::M] = False
    ends = np.flatnonzero(Df & ~nextD)
    runlen = (ends - starts + 1).astype(np.int32)
    narrow = runlen <= 9                  # per run; wider stays literal
    # numeric values on COMPRESSED digit positions (≈len(id) not R*M work);
    # integer 10**exp is slow per element, so go through a lookup table
    dpos = np.flatnonzero(Df)
    rl_d = np.repeat(runlen, runlen)
    exp = np.clip(rl_d - 1 - (dpos - np.repeat(starts, runlen)),
                  0, 18).astype(np.int32)
    contrib = np.where(rl_d <= 9,
                       (matf[dpos].astype(np.int64) - 48) * _POW10.take(exp),
                       0)
    rstart_c = np.cumsum(runlen, dtype=np.int32) - runlen
    vals_run = np.add.reduceat(contrib, rstart_c)
    # field index of each narrow run within its row
    nsf = rsf.copy()
    nsf[starts] = narrow
    nstart = nsf.reshape(R, M)
    nfields = nstart.sum(axis=1, dtype=np.int32)
    srow = starts // M
    f_of_run = (np.cumsum(nsf, dtype=np.int32)[starts] - 1
                - np.concatenate(
                    [[0], np.cumsum(nfields, dtype=np.int32)[:-1]])[srow])
    sel = narrow & (f_of_run < F_CAP)
    valsm[srow[sel], f_of_run[sel]] = vals_run[sel]
    # skeleton: keep literals + wide-run digits + one marker per narrow run
    fixed = narrow & (matf[starts] == 48) & (runlen > 1)
    skel_val = matf.copy()
    skel_val[starts[narrow]] = (
        0xE0 + np.where(fixed, runlen, 0)[narrow]).astype(np.uint8)
    # keep = in-length and (not a digit of a narrow run, except its start)
    inlenf = (np.arange(M)[None, :] < lens[:, None]).ravel()
    drop = np.zeros(R * M, bool)
    drop[dpos] = rl_d <= 9                # narrow-run digits dropped...
    drop[starts[narrow]] = False          # ...except the marker at the start
    keepf = inlenf & ~drop
    kpos = np.flatnonzero(keepf)
    sklen = keepf.reshape(R, M).sum(axis=1, dtype=np.int32)
    tcol = (np.cumsum(keepf, dtype=np.int32) - 1)[kpos] - np.concatenate(
        [[0], np.cumsum(sklen, dtype=np.int32)[:-1]])[kpos // M]
    skl = np.zeros((R, M), np.uint8)
    skl.ravel()[(kpos // M) * M + tcol] = skel_val[kpos]
    return mat, lens, skl, sklen, valsm, nfields


def _shard_starts(lanes: np.ndarray, nv: int) -> np.ndarray:
    ss = np.zeros(nv, bool)
    if nv:
        ss[0] = True
        ss[1:] = lanes[1:nv] != lanes[: nv - 1]
    return ss


def encode_ids_host(ids, lanes: np.ndarray, F: int, M: int, chain: list,
                    n_valid: int | None = None):
    """Vectorized encode_ids_host_ref (bit-identical planes + chain states;
    tests/test_ids.py asserts it): numpy structural template comparison
    against the previous read, Python only at shard boundaries and for the
    per-shard chain handoff."""
    R = len(ids)
    flag = np.ones(R, np.uint8)
    dsym = np.zeros((R, F), np.uint8)
    dmag = np.zeros((R, F, MAGS), np.uint8)
    emat = np.zeros((R, M), np.uint8)
    elens = np.zeros(R, np.int32)
    nv = R if n_valid is None else min(R, n_valid)
    if n_valid is not None:
        flag[n_valid:] = 0
    if nv == 0:
        return flag, dsym, dmag, emat, elens
    mat, lens, skl, sklen, valsm, nfields = _ids_struct(ids[:nv], M)

    # template-stable vs previous row == equal skeletons (_ids_struct)
    fast = np.zeros(nv, bool)
    if nv > 1:
        fast[1:] = ((sklen[1:] == sklen[:-1])
                    & (skl[1:] == skl[:-1]).all(axis=1))
    fast &= nfields <= F
    pvals = np.zeros((nv, F_CAP), np.int64)
    pvals[1:] = valsm[:-1]

    # shard boundaries: compare against the carried chain (Python, one
    # tokenize per shard)
    ss = np.flatnonzero(_shard_starts(lanes, nv))
    for r in ss:
        prev = chain[lanes[r]]
        if prev is None:
            fast[r] = False
            continue
        t, v = tokenize_id(ids[r])
        fast[r] = len(v) <= F and t == prev[0]
        if fast[r]:
            pvals[r, : len(prev[1])] = prev[1][:F_CAP]

    d = valsm[:, :F] - pvals[:, :F]
    infield = np.arange(F)[None, :] < np.minimum(nfields, F)[:, None]
    d = np.where(infield, d, 0)
    absd = np.abs(d)
    big = absd >= 2
    m = np.where(big, absd - 2, 0)
    nbcat = np.where(m < 256, 0, np.where(m < 65536, 1, 2))
    sym = np.where(d == 1, 1, np.where(d == -1, 2, 0)).astype(np.uint8)
    sym = np.where(big, (np.array([3, 5, 7])[nbcat] + (d < 0)).astype(np.uint8),
                   sym)
    mag = ((m[:, :, None] >> (8 * np.arange(MAGS)[None, None, :])) & 0xFF
           ).astype(np.uint8)
    mag = np.where(big[:, :, None], mag, 0)

    flag[:nv] = np.where(fast, 0, 1).astype(np.uint8)
    dsym[:nv] = np.where(fast[:, None], sym, 0)
    dmag[:nv] = np.where(fast[:, None, None], mag, 0)
    emat[:nv] = np.where(fast[:, None], 0, mat)
    elens[:nv] = np.where(fast, 0, lens).astype(np.int32)

    # chain handoff: last valid row of each shard (exact tokenize — the
    # chain keeps the full template + ALL narrow-run values, even past F)
    bounds = list(ss) + [nv]
    for i in range(len(bounds) - 1):
        r_last = bounds[i + 1] - 1
        chain[lanes[r_last]] = tokenize_id(ids[r_last])
    return flag, dsym, dmag, emat, elens


def _fmt_block(out, r_lo, template, vals_blk):
    """Format one delta-block of reads sharing `template` into
    out[r_lo:r_lo+B]: split into CONTIGUOUS runs of constant per-field
    decimal widths (a new run only at decade rollovers), one vectorized
    digit fill + bulk slice conversion per run."""
    B, nf = vals_blk.shape
    if nf == 0:
        out[r_lo:r_lo + B] = [detokenize(template, [])] * B
        return
    fixed = np.array([el for el in template if not isinstance(el, bytes)],
                     np.int64)
    nd = np.ones_like(vals_blk)
    for k in range(1, 19):
        nd += vals_blk >= _POW10[k]
    widths = np.maximum(nd, fixed[None, :])
    chg = np.zeros(B, bool)
    chg[0] = True
    chg[1:] = (widths[1:] != widths[:-1]).any(axis=1)
    bounds = list(np.flatnonzero(chg)) + [B]
    for gi in range(len(bounds) - 1):
        a, b = bounds[gi], bounds[gi + 1]
        wv = widths[a]
        vg = vals_blk[a:b]
        # skeleton + digit spans for this width layout
        parts, spans, fi, pos = [], [], 0, 0
        for el in template:
            if isinstance(el, bytes):
                parts.append(np.frombuffer(el, np.uint8))
                pos += len(el)
            else:
                w = int(wv[fi])
                spans.append((pos, w, fi))
                parts.append(np.zeros(w, np.uint8))
                pos += w
                fi += 1
        skel = (np.concatenate(parts) if parts
                else np.zeros(0, np.uint8))
        blk = np.broadcast_to(skel, (b - a, pos)).copy()
        for c0, w, f in spans:
            blk[:, c0:c0 + w] = (vg[:, f, None]
                                 // _POW10[np.arange(w - 1, -1, -1)][None, :]
                                 ) % 10 + 48
        raw = blk.tobytes()
        out[r_lo + a:r_lo + b] = [raw[k * pos:(k + 1) * pos]
                                  for k in range(b - a)]


def decode_ids_host(flag, dsym, dmag, emat, elens, lanes: np.ndarray,
                    chain: list, n_valid: int | None = None) -> list:
    """Vectorized decode_ids_host_ref (identical outputs + chain states):
    per-shard cumsum of the delta planes between escape rows, Python only
    per escape row and per distinct width layout (_fmt_block)."""
    R = flag.shape[0]
    nv = R if n_valid is None else min(R, n_valid)
    out = [b""] * R
    if nv == 0:
        return out
    sym = dsym[:nv].astype(np.int64)
    m = (dmag[:nv].astype(np.int64)
         << (8 * np.arange(MAGS))[None, None, :]).sum(-1) + 2
    delta = np.where(sym == 0, 0,
                     np.where(sym == 1, 1,
                              np.where(sym == 2, -1,
                                       np.where(sym % 2 == 1, m, -m))))
    esc = flag[:nv] > 0
    ss = list(np.flatnonzero(_shard_starts(lanes, nv))) + [nv]

    def delta_block(a, b, cur):
        if a >= b:
            return cur
        t, pv = cur
        nf = len(pv)
        vals = np.asarray(pv, np.int64)[None, :] + np.cumsum(
            delta[a:b, :nf], axis=0)
        _fmt_block(out, a, t, vals)
        return (t, [int(x) for x in vals[-1]] if nf else [])

    for i in range(len(ss) - 1):
        r0, r1 = ss[i], ss[i + 1]
        cur = chain[lanes[r0]]
        prev_end = r0
        for e in np.flatnonzero(esc[r0:r1]) + r0:
            cur = delta_block(prev_end, e, cur)
            s = emat[e, :elens[e]].tobytes()
            out[e] = s
            cur = tokenize_id(s)
            prev_end = e + 1
        cur = delta_block(prev_end, r1, cur)
        chain[lanes[r0]] = cur
    return out


def zero_id_batch(R: int):
    """Placeholder device-input tuple for id_mode == none."""
    return (np.zeros(R, np.uint8), np.zeros((R, 1), np.uint8),
            np.zeros((R, 1, MAGS), np.uint8), np.zeros((R, 1), np.uint8),
            np.zeros(R, np.int32))




# ---------------------------------------------------------------------------
# device modeling (torch ops on any device)
# ---------------------------------------------------------------------------

def id_state_create(device=None) -> torch.Tensor:
    return models.model_create(N_CTX, N_SYM, device)


def _slot_ctx(cfg: IdConfig) -> list:
    """The static context of each of the w_all symbol slots of a read."""
    F, M = cfg.n_fields, cfg.max_id_len
    return ([CTX_FLAG] + [CTX_DELTA0 + f for f in range(F)]
            + [CTX_MAG0 + f * MAGS + j for f in range(F) for j in range(MAGS)]
            + [CTX_LEN0, CTX_LEN1]
            + [CTX_BYTE0 + min(c, COL_BUCKETS - 1) for c in range(M)])


def host_n_valid(cfg: IdConfig, take: int):
    """The n_valid of a batch of `take` real reads for the host planes and
    chains (encode_ids_host, decode_ids_host): codec v1 tokenizes the
    padding reads like real ones (None)."""
    return take if cfg.codec_v >= 2 else None


def _ctx_cdfs(cfg: IdConfig, model: torch.Tensor) -> torch.Tensor:
    """[N_CTX, 257] int64: every context's cdf row of the frozen model
    (codec v2: model_cdf_masked; v1: model_cdf). Every slot of every read
    reads one of these rows, so the per-slot cdf is a row lookup."""
    dev = model.device
    ctx = torch.arange(N_CTX, device=dev)
    if cfg.codec_v < 2:
        return models.model_cdf(model, ctx, cfg.scale_bits)
    return models.model_cdf_masked(
        model, torch.from_numpy(_alpha_lut_np()).to(dev), ctx,
        cfg.scale_bits)


def id_modeling(cfg: IdConfig, model: torch.Tensor, flag, dsym, dmag, emat,
                elens, n_valid=None):
    """Build the per-read symbol grid and its (static) contexts/activity.
    n_valid (codec v2; v1 ignores it): rows >= n_valid are padding and code
    nothing. Returns (ctx [R, W], syms [R, W], f, c, active), each int64
    but active (bool): the reference's id_modeling."""
    R = flag.shape[0]
    F, M = cfg.n_fields, cfg.max_id_len
    dev = model.device
    i64 = torch.int64
    flag_i = flag.to(i64)
    dsym_i = dsym.to(i64)
    elens = elens.to(i64)
    esc = flag_i > 0

    syms = torch.cat([
        flag_i[:, None], dsym_i, dmag.to(i64).reshape(R, F * MAGS),
        (elens & 0xFF)[:, None], ((elens >> 8) & 0xFF)[:, None],
        emat.to(i64)], dim=1)
    ctx = torch.tensor(_slot_ctx(cfg), dtype=i64, device=dev)[None, :].expand(
        R, -1)

    col = torch.arange(M, device=dev)[None, :]
    nb = torch.from_numpy(_NB_LUT).to(dev)[dsym_i]                 # [R, F]
    mag_act = (nb[:, :, None] > torch.arange(MAGS, device=dev)).reshape(
        R, F * MAGS)
    keep = ~esc[:, None]
    active = torch.cat([
        torch.ones((R, 1), dtype=torch.bool, device=dev),
        keep.expand(R, F), mag_act & keep,
        esc[:, None], esc[:, None], esc[:, None] & (col < elens[:, None])],
        dim=1)
    if n_valid is not None and cfg.codec_v >= 2:
        active = active & (torch.arange(R, device=dev) < n_valid)[:, None]

    cdfs = _ctx_cdfs(cfg, model)
    f = cdfs[ctx, syms + 1] - cdfs[ctx, syms]
    c = cdfs[ctx, syms]
    f = torch.where(active, f, 1 << cfg.scale_bits)
    c = torch.where(active, c, 0)
    return ctx, syms, f, c, active


def id_encode_batch(cfg: IdConfig, model: torch.Tensor, flag, dsym, dmag,
                    emat, elens, n_valid=None):
    """One batch coded from fresh lanes (the reference's single-step
    encode). Returns (words, n_words, decoder initial states, new
    model)."""
    ctx, syms, f, c, active = id_modeling(cfg, model, flag, dsym, dmag,
                                          emat, elens, n_valid)
    words, n_words, states = rans.rans_encode(
        common.lane_grid(f, cfg.n_lanes), common.lane_grid(c, cfg.n_lanes),
        cfg.scale_bits)
    new_model = models.model_update(
        model, ctx.reshape(-1), syms.reshape(-1), active.reshape(-1))
    return words, n_words, states, new_model


# ---------------------------------------------------------------------------
# decode scan: kernel K4 and its plain version
# ---------------------------------------------------------------------------

# Launches of K4 (the CUDA id decode scan) in this process; the plain scan
# never counts.
K4_LAUNCHES = 0
K4_MAX_LANES = 2048   # one cluster holds every lane (kMaxLanes in the source)
# the slot kinds of K4's rule (kFlag..kByte in csrc/slot_decode.cu)
SLOT_FLAG, SLOT_DELTA, SLOT_MAG, SLOT_LEN0, SLOT_LEN1, SLOT_BYTE = range(6)


def _slot_kinds(cfg: IdConfig) -> list:
    """(kind, arg) of each of the w_all symbol slots of a read: which
    carries decide whether a lane codes it (delta: the field; magnitude:
    field * MAGS + byte; raw byte: its column)."""
    F, M = cfg.n_fields, cfg.max_id_len
    return ([(SLOT_FLAG, 0)] + [(SLOT_DELTA, f) for f in range(F)]
            + [(SLOT_MAG, f * MAGS + j) for f in range(F)
               for j in range(MAGS)]
            + [(SLOT_LEN0, 0), (SLOT_LEN1, 0)]
            + [(SLOT_BYTE, c) for c in range(M)])


@functools.lru_cache(maxsize=16)
def k4_slots(cfg: IdConfig, device=None) -> torch.Tensor:
    """int32 [w_all]: K4's slot words, context | kind << 8 | arg << 12;
    made once a configuration and device (a copy to the card a batch
    would cost the call more than K5's whole scan)."""
    return torch.tensor([ctx | kind << 8 | arg << 12 for ctx, (kind, arg) in
                         zip(_slot_ctx(cfg), _slot_kinds(cfg))],
                        dtype=torch.int32, device=device)


def id_decode_scan_plain(cfg: IdConfig, cdfs: torch.Tensor, R: int,
                         words: torch.Tensor, init_states: torch.Tensor,
                         n_valid=None):
    """K4's plain torch version, on any device: the reference's
    id_decode_batch scan, one step a symbol slot — slot i of every lane's
    read row at once. A slot's context is the same for every lane, so its
    cdf is one row of cdfs (_ctx_cdfs), and which lanes are active follows
    from the flag, delta symbols and length the row's earlier slots
    decoded. Returns (grid [R, w_all] uint8, final states [N] int64, words
    consumed 0-d int64)."""
    N = cfg.n_lanes
    F, M = cfg.n_fields, cfg.max_id_len
    r_pl = R // N
    W = cfg.w_all
    sb = cfg.scale_bits
    dev = init_states.device
    i_len0 = 1 + F * (1 + MAGS)
    i_len1 = i_len0 + 1
    i_byte0 = i_len1 + 1
    slot_ctx = _slot_ctx(cfg)
    nb_lut = torch.from_numpy(_NB_LUT).to(dev)
    lane = torch.arange(N, device=dev)
    valid = (None if n_valid is None or cfg.codec_v < 2 else
             [lane * r_pl + rd < n_valid for rd in range(r_pl)])

    x = init_states
    ptr = torch.zeros((), dtype=torch.int64, device=dev)
    flag_c = torch.zeros((N,), dtype=torch.int64, device=dev)
    ds_c = torch.zeros((N, F), dtype=torch.int64, device=dev)
    len_c = torch.zeros((N,), dtype=torch.int64, device=dev)
    ys = torch.empty((r_pl * W, N), dtype=torch.int64, device=dev)
    for t in range(r_pl * W):
        i = t % W
        if i == 0:
            active = None                       # every lane codes its flag
        elif i <= F:
            active = flag_c == 0
        elif i < i_len0:
            f_m, j_m = divmod(i - F - 1, MAGS)
            active = (flag_c == 0) & (nb_lut[ds_c[:, f_m]] > j_m)
        elif i <= i_len1:
            active = flag_c > 0
        else:
            active = (flag_c > 0) & (len_c > i - i_byte0)
        if valid is not None:
            active = valid[t // W] if active is None else (
                active & valid[t // W])
        sym, f, c = rans.cdf_lookup(cdfs[slot_ctx[i]].expand(N, -1),
                                    rans.rans_decode_slots(x, sb))
        if active is not None:
            f = torch.where(active, f, 1 << sb)
            c = torch.where(active, c, 0)
        x, ptr = rans.rans_decode_advance(x, ptr, words, f, c, sb)
        if active is not None:
            sym = torch.where(active, sym, 0)
        if i == 0:
            flag_c = sym
        elif i <= F:
            ds_c[:, i - 1] = sym
        elif i == i_len0:
            len_c = sym
        elif i == i_len1:
            len_c = torch.clamp(len_c | (sym << 8), max=M)
        ys[t] = sym
    return common.from_grid(ys, N, W).to(torch.uint8), x, ptr


def _check_k4(cfg, cdfs, R, words, init_states):
    N = cfg.n_lanes
    dev = cdfs.device
    if not 1 <= N <= K4_MAX_LANES:
        raise ValueError(f"K4: {N} lanes, one cluster takes "
                         f"1..{K4_MAX_LANES}")
    want = (("cdfs", cdfs, torch.int32, (N_CTX, N_SYM + 1)),
            ("words", words, torch.int32, None),
            ("init_states", init_states, torch.int64, (N,)))
    common.check_kernel_tensors("K4", want, dev)
    if R < 0 or R % N or words.numel() < 1 or R * cfg.w_all >= 1 << 31:
        raise ValueError(f"K4: {R} reads over {N} lanes, {words.numel()} "
                         f"words, {cfg.w_all} slots a read")
    if not 1 <= cfg.scale_bits <= 16:
        raise ValueError(f"K4: scale_bits {cfg.scale_bits} outside [1, 16]")
    if not 0 <= cfg.n_fields <= F_CAP or not 0 <= cfg.max_id_len < 1 << 20:
        raise ValueError(f"K4: {cfg.n_fields} fields (at most {F_CAP}) or "
                         f"max_id_len {cfg.max_id_len} outside [0, 2^20)")


def _id_decode_scan_cuda(cfg, cdfs, R, words, init_states, n_valid):
    """One K4 launch for the whole batch. Checks everything before it
    builds or launches."""
    global K4_LAUNCHES
    _check_k4(cfg, cdfs, R, words, init_states)
    from ..ops import _build

    dev = cdfs.device
    N = cfg.n_lanes
    nv = R if n_valid is None or cfg.codec_v < 2 else max(
        0, min(int(n_valid), R))
    slots = k4_slots(cfg, dev)
    grid = torch.empty((R, cfg.w_all), dtype=torch.uint8, device=dev)
    fin = torch.empty((N,), dtype=torch.int64, device=dev)
    ptr = torch.empty((1,), dtype=torch.int64, device=dev)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        rc = lib.fqtz_id_decode(
            cdfs.data_ptr(), slots.data_ptr(), cfg.w_all, R // N,
            words.data_ptr(), words.numel(), init_states.data_ptr(), N,
            cfg.scale_bits, nv, cfg.max_id_len, grid.data_ptr(),
            fin.data_ptr(), ptr.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: cudaError {rc}")
    K4_LAUNCHES += 1
    return grid, fin, ptr[0]


def id_decode_scan(cfg: IdConfig, cdfs: torch.Tensor, R: int,
                   words: torch.Tensor, init_states: torch.Tensor,
                   n_valid=None):
    """The id decode scan of one batch: on a CUDA table kernel K4 (a
    failed build or launch raises; nothing falls back to the plain scan),
    on a CPU table the plain scan. cdfs: int32 [N_CTX, 257], every
    context's cdf row of the frozen model (_ctx_cdfs); words: int32 [n]
    u16 values; init_states: int64 [N]; n_valid as in id_modeling. Returns
    (grid [R, w_all] uint8, final states [N] int64, words consumed 0-d
    int64)."""
    kind = cdfs.device.type
    if kind == "cuda":
        return _id_decode_scan_cuda(cfg, cdfs, R, words, init_states,
                                    n_valid)
    if kind == "cpu":
        return id_decode_scan_plain(cfg, cdfs, R, words, init_states,
                                    n_valid)
    raise ValueError(f"id_decode_scan: no scan for device {cdfs.device}")


def planes_of_grid(cfg: IdConfig, grid: torch.Tensor):
    """The decoded [R, w_all] symbol grid as the host planes: (flag [R] u8,
    dsym [R, F] u8, dmag [R, F, 4] u8, emat [R, M] u8, elens [R] int64,
    the two length bytes joined and clamped to M)."""
    F, M = cfg.n_fields, cfg.max_id_len
    R = grid.shape[0]
    i_len0 = 1 + F * (1 + MAGS)
    grid = grid.to(torch.int64)
    u8 = torch.uint8
    elens = torch.clamp(grid[:, i_len0] | (grid[:, i_len0 + 1] << 8), max=M)
    return (grid[:, 0].to(u8), grid[:, 1:1 + F].to(u8),
            grid[:, 1 + F:i_len0].reshape(R, F, MAGS).to(u8),
            grid[:, i_len0 + 2:].to(u8), elens)


def id_decode_batch(cfg: IdConfig, model: torch.Tensor, R: int,
                    words: torch.Tensor, init_states: torch.Tensor,
                    n_valid=None):
    """Decode the symbol grid of R reads. Returns (flag [R] u8, dsym [R, F]
    u8, dmag [R, F, 4] u8, emat [R, M] u8, elens [R] int64, new_model,
    final_states [N] int64, words consumed 0-d int64) — the reference's
    id_decode_batch (n_valid as in id_modeling). Host detokenization
    (decode_ids_host) turns the planes back into id bytes. The scan is
    id_decode_scan (K4 on the card) over the batch's cdf table, built once
    here."""
    grid, x, ptr = id_decode_scan(
        cfg, _ctx_cdfs(cfg, model).to(torch.int32).contiguous(), R,
        words.to(torch.int32).contiguous(), init_states, n_valid)
    flag, dsym, dmag, emat, elens = planes_of_grid(cfg, grid)
    ctx, syms, _, _, active = id_modeling(cfg, model, flag, dsym, dmag,
                                          emat, elens, n_valid)
    new_model = models.model_update(
        model, ctx.reshape(-1), syms.reshape(-1), active.reshape(-1))
    return flag, dsym, dmag, emat, elens, new_model, x, ptr
