"""Paired-end minimizer machinery: anchor candidates and pair-table events.

Port of fqsqueezer_tpu/streams/pe.py. Minimizers of read1's quarters are
looked up in the (minimizer -> partner minimizer) pair table
(ops/tables.py pair_*); the first candidate whose partner value occurs
verbatim in read2 gives the decoder a B-base anchor (B = bmer_len) that it
places in read2 before decoding it: those B bases are never entropy-coded
and give the rest of read2 full k-mer context. The decoder recomputes the
candidate list from the decoded read1, so only the candidate id and the
anchor position travel, as 3 symbols of the pe stream (none at all when
read1 yields no candidate).

Every function is batch-vectorized math that encoder and decoder share;
u32 values live in int64 tensors, as everywhere in this package.
"""
from __future__ import annotations

import torch

from ..ops import kmers, tables

N_CAND = 15          # examined candidates; id 15 = no anchor
PE_N_CTX = 3         # pe stream model contexts: 0 = id, 1 = pos lo, 2 = pos hi
PE_N_SYM = 256


def value_mask(bmer_len: int):
    """(lo, hi) halves of a B-base value's mask: the 'no minimizer'
    sentinel."""
    bits = 2 * bmer_len
    lo = 0xFFFFFFFF if bits >= 32 else (1 << bits) - 1
    hi = 0 if bits <= 32 else (1 << (bits - 32)) - 1
    return lo, hi


def _window_info(codes, kcodes, lengths, B):
    """Rolling B-base windows ending at each position. Returns (lo, hi,
    valid, start): valid means the window is complete, N-free, inside the
    read and its first 3 bases are not AAA or AAC (the minimizer validity
    filter)."""
    L = kcodes.shape[-1]
    pos = torch.arange(L, dtype=torch.int64, device=kcodes.device)[None, :]
    lo, hi = kmers.pack_windows(kcodes, B)
    nn = torch.cumsum((codes >= 4).to(torch.int64), dim=1)
    n_in_win = nn - kmers.shift_right(nn, B)          # Ns in [i-B+1, i]
    ok = (pos >= B - 1) & (pos < lengths[:, None]) & (n_in_win == 0)
    if 2 * B > 32:
        first3 = (hi >> (2 * B - 32 - 6)) & 63
    else:
        first3 = (lo >> (2 * B - 6)) & 63
    ok = ok & (first3 >= 2)
    return lo, hi, ok, pos - (B - 1)


def _masked_min(lo, hi, mask, inv_lo, inv_hi):
    """Lexicographic (hi, lo) min over the last axis under mask; nothing
    valid reduces to the sentinel (inv_lo, inv_hi)."""
    m_hi = torch.where(mask, hi, inv_hi).amin(dim=-1)
    m_lo = torch.where(mask & (hi == m_hi[..., None]), lo,
                       inv_lo).amin(dim=-1)
    return m_lo, m_hi


def segment_minimizers(codes, kcodes, lengths, B, n_seg):
    """Each read's minimizer in each of n_seg equal parts of its window
    starts. Returns (lo, hi) [R, n_seg]."""
    inv_lo, inv_hi = value_mask(B)
    wlo, whi, ok, start = _window_info(codes, kcodes, lengths, B)
    mss = torch.clamp(lengths - B + 1, min=0)[:, None]   # window starts
    outs_lo, outs_hi = [], []
    for k in range(n_seg):
        s0 = k * mss // n_seg
        s1 = mss if k == n_seg - 1 else (k + 1) * mss // n_seg
        mlo, mhi = _masked_min(wlo, whi, ok & (start >= s0) & (start < s1),
                               inv_lo, inv_hi)
        outs_lo.append(mlo)
        outs_hi.append(mhi)
    return torch.stack(outs_lo, dim=-1), torch.stack(outs_hi, dim=-1)


def find_candidates(pair_tbl, q_lo, q_hi, B):
    """Top-N_CAND candidates for the query minimizers q_lo/q_hi [...,
    n_seg]: one bucket row a query, counts of one value merged into its
    first occurrence, then a stable (count desc, (hi, lo) asc) order.
    Returns (c_lo, c_hi, c_cnt) [..., N_CAND]; c_cnt == 0 marks an
    invalid slot."""
    inv_lo, inv_hi = value_mask(B)
    vlo, vhi, cnt = tables.pair_find(pair_tbl, q_lo, q_hi)  # [.., n_seg, S]
    is_inv = (q_lo == inv_lo) & (q_hi == inv_hi)
    cnt = torch.where(is_inv[..., None], 0, cnt)
    sh = vlo.shape[:-2]
    M = vlo.shape[-2] * vlo.shape[-1]
    vlo = vlo.reshape(sh + (M,))
    vhi = vhi.reshape(sh + (M,))
    cnt = cnt.reshape(sh + (M,))
    eq = ((vlo[..., :, None] == vlo[..., None, :])
          & (vhi[..., :, None] == vhi[..., None, :]))       # [..., M, M]
    idx = torch.arange(M, device=vlo.device)
    earlier = idx[:, None] > idx[None, :]
    dup = (eq & earlier).any(dim=-1)
    merged = torch.where(eq, cnt[..., None, :], 0).sum(dim=-1)
    cnt = torch.where(dup, 0, merged)
    neg = torch.where(cnt > 0, (1 << 22) - cnt, 1 << 23)
    # lexsort((vlo, vhi, neg)): stable sorts from the least significant key
    order = torch.arange(M, device=vlo.device).expand(vlo.shape)
    for key in (vlo, vhi, neg):
        o = torch.sort(torch.gather(key, -1, order), dim=-1,
                       stable=True).indices
        order = torch.gather(order, -1, o)
    order = order[..., :N_CAND]

    def t(a):
        return torch.gather(a, -1, order)

    return t(vlo), t(vhi), t(cnt)


def match_in_read2(c_lo, c_hi, c_cnt, codes2, kcodes2, lengths2, B):
    """The first candidate whose value occurs as a window of read2, and
    the start of its first occurrence. Returns (id [R], pos [R], a_lo,
    a_hi): id == N_CAND means no anchor; a_* is the anchor's value."""
    L = kcodes2.shape[-1]
    wlo, whi, ok, _ = _window_info(codes2, kcodes2, lengths2, B)
    eq = ((wlo[:, :, None] == c_lo[:, None, :])
          & (whi[:, :, None] == c_hi[:, None, :]) & ok[:, :, None]
          & (c_cnt[:, None, :] > 0))                         # [R, L, NC]
    found = eq.any(dim=1)                                    # [R, NC]
    any_f = found.any(dim=-1)
    # argmax over int: the first True, as jnp.argmax over bool
    mid = torch.where(any_f, torch.argmax(found.to(torch.int64), dim=-1),
                      N_CAND)
    sel = torch.clamp(mid, max=N_CAND - 1)
    col = torch.gather(eq, 2, sel[:, None, None].expand(-1, L, 1))[:, :, 0]
    pos_l = torch.arange(L, dtype=torch.int64, device=eq.device)[None, :]
    first_end = torch.where(col, pos_l, L).amin(dim=1)
    pos = torch.where(any_f, first_end - (B - 1), 0)

    def g(c):
        return torch.gather(c, -1, sel[:, None])[:, 0]

    a_lo = torch.where(any_f, g(c_lo), 0)
    a_hi = torch.where(any_f, g(c_hi), 0)
    return mid, pos, a_lo, a_hi


def anchor_base(a_lo, a_hi, j, B):
    """Base at offset j from the anchor's start in its packed value (the
    earliest base in the most significant bits). j is clamped: offsets
    outside the anchor give bases the caller masks."""
    sh = 2 * (B - 1 - torch.clamp(j, 0, B - 1))
    from_lo = (a_lo >> torch.clamp(sh, max=31)) & 3
    from_hi = (a_hi >> torch.clamp(sh - 32, min=0)) & 3
    return torch.where(sh >= 32, from_hi, from_lo)


def anchor_span_mask(a_start, has_anchor, L, B):
    """[R, L] True inside the preset anchor span [a, a+B)."""
    pos = torch.arange(L, dtype=torch.int64, device=a_start.device)[None, :]
    return (has_anchor[:, None] & (pos >= a_start[:, None])
            & (pos < (a_start + B)[:, None]))


# insert weights of the cross-mate third-minimizer associations
_INS = ((0, 0, 2), (0, 2, 4), (1, 0, 3), (1, 2, 3), (2, 0, 4), (2, 2, 2))


def pair_events(codes, kcodes, lengths, B):
    """Cross-insert (key, value, weight) events of a PE batch: the thirds
    minimizers of each mate associated with those of the other. codes and
    kcodes [R, L] with pairs interleaved (even rows read1, odd rows read2).
    Returns flat (klo, khi, vlo, vhi, w, valid)."""
    m_lo, m_hi = segment_minimizers(codes, kcodes, lengths, B, 3)   # [R, 3]
    inv_lo, inv_hi = value_mask(B)
    r1_lo, r2_lo = m_lo[0::2], m_lo[1::2]                            # [P, 3]
    r1_hi, r2_hi = m_hi[0::2], m_hi[1::2]
    ks, vs, ws = [], [], []
    for a, b, w in _INS:
        # read1 segment a -> read2 segment b, and the mirror image
        ks.append((r1_lo[:, a], r1_hi[:, a]))
        vs.append((r2_lo[:, b], r2_hi[:, b]))
        ws.append(w)
        ks.append((r2_lo[:, a], r2_hi[:, a]))
        vs.append((r1_lo[:, b], r1_hi[:, b]))
        ws.append(w)
    klo = torch.cat([k[0] for k in ks])
    khi = torch.cat([k[1] for k in ks])
    vlo = torch.cat([v[0] for v in vs])
    vhi = torch.cat([v[1] for v in vs])
    w = torch.cat([torch.full_like(ks[0][0], wi) for wi in ws])
    valid = ~(((klo == inv_lo) & (khi == inv_hi))
              | ((vlo == inv_lo) & (vhi == inv_hi)))
    return klo, khi, vlo, vhi, w, valid


def comp_codes(c):
    """Complement base codes; N (4) stays N."""
    return torch.where(c >= 4, c, 3 - c)


def expand_pe_rows(codes, lengths, a_start, has, B):
    """The anchored 3-row recoding of an interleaved PE batch:

      row 3q   = read1 (unchanged)
      row 3q+1 = rowA  = read2[a:]        (anchor bases first, then the
                                           right part)
      row 3q+2 = rowB  = rc(read2[:a+B])  (the reverse-complemented anchor
                                           first, then the left part)

    Without an anchor rowA = read2 and rowB is empty. codes [R, L]
    interleaved; a_start, has per pair [P]. Returns (codes3 [3P, L],
    lengths3 [3P])."""
    R, L = codes.shape
    P = R // 2
    r2 = codes[1::2]
    l2 = lengths[1::2]
    a = torch.where(has, a_start, 0)
    lenA = l2 - a
    lenB = torch.where(has, torch.minimum(a + B, l2), 0)
    j = torch.arange(L, dtype=torch.int64, device=codes.device)[None, :]
    rowA = torch.gather(r2, 1, torch.clamp(j + a[:, None], max=L - 1))
    rowA = torch.where(j < lenA[:, None], rowA, 0)
    idxB = torch.clamp((a + B)[:, None] - 1 - j, 0, L - 1)
    rowB = comp_codes(torch.gather(r2, 1, idxB))
    rowB = torch.where(j < lenB[:, None], rowB, 0)
    codes3 = torch.stack([codes[0::2], rowA, rowB], dim=1).reshape(3 * P, L)
    lengths3 = torch.stack([lengths[0::2], lenA, lenB],
                           dim=1).reshape(3 * P)
    return codes3, lengths3


def collapse_pe_rows(codes3, lengths, a_start, has, B):
    """Inverse of expand_pe_rows: [3P, L] decoded rows -> [R, L]
    interleaved true reads. lengths: [R] true read lengths."""
    P, L = codes3.shape[0] // 3, codes3.shape[1]
    rowA = codes3[1::3]
    rowB = codes3[2::3]
    l2 = lengths[1::2]
    a = torch.where(has, a_start, 0)
    i = torch.arange(L, dtype=torch.int64, device=codes3.device)[None, :]
    from_a = torch.gather(rowA, 1, torch.clamp(i - a[:, None], 0, L - 1))
    from_b = comp_codes(torch.gather(
        rowB, 1, torch.clamp((a + B)[:, None] - 1 - i, 0, L - 1)))
    r2 = torch.where(i >= a[:, None], from_a, from_b)
    r2 = torch.where(i < l2[:, None], r2, 0)
    return torch.stack([codes3[0::3], r2], dim=1).reshape(2 * P, L)


def expand_lengths_mask(R3, L, has, B):
    """[R3, L] anchor-preset mask of the expanded rows: positions < B of
    rowA and rowB of anchored pairs."""
    pos = torch.arange(L, dtype=torch.int64, device=has.device)[None, :]
    preset = torch.stack([torch.zeros_like(has), has, has],
                         dim=1).reshape(R3)
    return preset[:, None] & (pos < B)


def find_anchors(pair_tbl, codes, kcodes, lengths, B):
    """Encoder-side anchor search over a whole interleaved PE batch.
    Returns per pair (cand_any [P], id [P], pos [P], a_lo, a_hi); cand_any
    tells 'no candidate list' (nothing coded) from 'a list but no match'
    (id = N_CAND)."""
    q_lo, q_hi = segment_minimizers(codes[0::2], kcodes[0::2],
                                    lengths[0::2], B, 4)
    c_lo, c_hi, c_cnt = find_candidates(pair_tbl, q_lo, q_hi, B)
    cand_any = (c_cnt > 0).any(dim=-1)
    mid, pos, a_lo, a_hi = match_in_read2(
        c_lo, c_hi, c_cnt, codes[1::2], kcodes[1::2], lengths[1::2], B)
    return cand_any, torch.where(cand_any, mid, N_CAND), pos, a_lo, a_hi
