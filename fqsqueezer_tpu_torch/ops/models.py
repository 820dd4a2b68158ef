"""Adaptive context-conditioned frequency models, frozen per batch.

Port of fqsqueezer_tpu/ops/models.py: a model family is one dense int32
[n_ctx, A] array, read from a frozen snapshot for a whole batch and updated
once after it (scatter-add, then deterministic halving). The JAX package's
division-free helpers (floor_div_prod, the f32-exponent log2) are exact by
correction; here they are plain integer ops with the same values.
"""
from __future__ import annotations

import torch

ALPHA = 1          # additive smoothing per symbol
RAW_CAP_BITS = 13  # raw row totals kept below 2^RAW_CAP_BITS via halving


def model_create(n_ctx: int, n_sym: int, device=None) -> torch.Tensor:
    return torch.zeros((n_ctx, n_sym), dtype=torch.int32, device=device)


def _rows_to_cdf(rows: torch.Tensor, scale_bits: int) -> torch.Tensor:
    """[..., A] smoothed counts -> [..., A+1] int64 cdf, floor(cum << SB /
    total)."""
    cum = torch.cumsum(rows.to(torch.int64), dim=-1)
    total = cum[..., -1:]
    cum = torch.cat([torch.zeros_like(total), cum], dim=-1)
    return (cum << scale_bits) // total


def model_cdf(freqs: torch.Tensor, ctx: torch.Tensor,
              scale_bits: int) -> torch.Tensor:
    """Quantized cdf rows [..., A+1] for contexts ctx [...]."""
    return _rows_to_cdf(freqs[ctx] + ALPHA, scale_bits)


def model_cdf_masked(freqs: torch.Tensor, alpha_lut: torch.Tensor,
                     ctx: torch.Tensor, scale_bits: int) -> torch.Tensor:
    """model_cdf with a per-context ALPHA mask (alpha_lut: [n_ctx, A] 0/1):
    a context smooths only the symbols it can code, so the others quantize
    to zero-width cdf steps (cdf_lookup resolves those as the reference
    does). The id stream's cdf (codec v2)."""
    return _rows_to_cdf(freqs[ctx] + alpha_lut[ctx], scale_bits)


def _mix_rows(f, g, w: int, b: int, A: int):
    """Two-level mix of a fine row f and a coarse row g (see
    fqsqueezer_tpu.ops.models.model_cdf_mix): the coarse row contributes
    (w * b) // (t_fine + b) pseudo-counts, spread by its own shape."""
    f = f.to(torch.int64)
    g = g.to(torch.int64)
    tf = f.sum(dim=-1, keepdim=True)
    tg = g.sum(dim=-1, keepdim=True)
    w_eff = (w * b) // (tf + b)
    return f + (g * w_eff) // (tg + A) + ALPHA


def model_cdf_mix(freqs: torch.Tensor, ctx: torch.Tensor, cctx: torch.Tensor,
                  scale_bits: int, w: int, b: int,
                  local: torch.Tensor | None = None) -> torch.Tensor:
    """Two-level context mix over one array holding both families (fine
    rows first, coarse rows behind them; cctx arrives pre-offset). local:
    in-batch deltas of the fine rows, clamped to local_cap(..., extra=w)
    and added to the fine row before the mix."""
    f = freqs[ctx]
    if local is not None:
        cap = local_cap(freqs.shape[1], scale_bits, extra=w)
        f = f + torch.clamp(local[ctx], max=cap)
    return _rows_to_cdf(_mix_rows(f, freqs[cctx], w, b, freqs.shape[1]),
                        scale_bits)


def local_cap(n_sym: int, scale_bits: int, extra: int = 0) -> int:
    """Per-symbol cap on in-batch local deltas: every smoothed row total
    stays <= 2^scale_bits, so quantized frequencies stay >= 1 (global rows
    are held below 2^RAW_CAP_BITS). extra: headroom kept for the mix's
    coarse budget."""
    return max(1, ((1 << scale_bits) - (1 << RAW_CAP_BITS) - 2 * n_sym
                   - extra) // n_sym)


def model_cdf_local(freqs: torch.Tensor, local: torch.Tensor,
                    ctx: torch.Tensor, scale_bits: int) -> torch.Tensor:
    """model_cdf with in-batch local deltas folded in, clamped at query
    time to local_cap."""
    cap = local_cap(freqs.shape[1], scale_bits)
    return _rows_to_cdf(freqs[ctx] + torch.clamp(local[ctx], max=cap)
                        + ALPHA, scale_bits)


def local_model_update(local: torch.Tensor, ctx, sym, valid,
                       inc: int = 8) -> torch.Tensor:
    """Add inc at every valid (ctx, sym) of the in-batch deltas local, in
    place (a batch owns its deltas); no rescale: they are clamped at query
    time. Returns local."""
    n_sym = local.shape[1]
    valid = valid.reshape(-1)
    idx = torch.where(valid, ctx.reshape(-1).to(torch.int64) * n_sym
                      + sym.reshape(-1).to(torch.int64), 0)
    local.view(-1).index_add_(
        0, idx, torch.where(valid, inc, 0).to(local.dtype))
    return local


# ---------------------------------------------------------------------------
# packed u16 find mirror
# ---------------------------------------------------------------------------
# Model cells never exceed 2^RAW_CAP_BITS, so they fit u16: the mirror packs
# two cells per u32 word (held in int64). A pure storage layout — the cdf
# values are identical to the unpacked reads.

def pack_freqs(freqs: torch.Tensor) -> torch.Tensor:
    """[n, A] int32 (cells < 2^16) -> [n, ceil(A/2)] u32 words, 2 cells per
    word."""
    n, A = freqs.shape
    f = freqs.to(torch.int64)
    if A % 2:
        f = torch.cat([f, f.new_zeros((n, 1))], dim=1)
    return f[:, 0::2] | (f[:, 1::2] << 16)


def _unpack_row(w: torch.Tensor, A: int) -> torch.Tensor:
    """[..., ceil(A/2)] u32 -> [..., A] int64."""
    lo = w & 0xFFFF
    hi = w >> 16
    return torch.stack([lo, hi], dim=-1).reshape(
        w.shape[:-1] + (2 * w.shape[-1],))[..., :A]


def model_cdf_packed(mp: torch.Tensor, A: int, ctx: torch.Tensor,
                     scale_bits: int) -> torch.Tensor:
    """model_cdf reading from a packed mirror — identical cdf values."""
    return _rows_to_cdf(_unpack_row(mp[ctx], A) + ALPHA, scale_bits)


def model_cdf_mix_packed(mp: torch.Tensor, A: int, coarse: torch.Tensor,
                         ctx: torch.Tensor, cctx: torch.Tensor,
                         scale_bits: int, w: int, b: int) -> torch.Tensor:
    """model_cdf_mix with the fine family read from the packed mirror and
    the coarse family from its own array; cctx is an index into `coarse`."""
    return _rows_to_cdf(_mix_rows(_unpack_row(mp[ctx], A), coarse[cctx],
                                  w, b, A), scale_bits)


def cdf_encode_lookup(cdf: torch.Tensor, sym: torch.Tensor):
    """(freq, cum) of known symbols. cdf: [..., A+1], sym: [...]."""
    s = sym.to(torch.int64)[..., None]
    lo = torch.gather(cdf, -1, s)[..., 0]
    hi = torch.gather(cdf, -1, s + 1)[..., 0]
    return hi - lo, lo


def model_update(freqs: torch.Tensor, ctx: torch.Tensor, sym: torch.Tensor,
                 valid: torch.Tensor, inc: int = 8) -> torch.Tensor:
    """Add `inc` per valid (ctx, sym) occurrence, then halve every row whose
    smoothed total exceeds 2^RAW_CAP_BITS by the smallest shift that brings
    it under. Invalid events add 0 at cell 0 (the explicit mask of the
    reference's dropped scatter). Returns a new array."""
    n_ctx, n_sym = freqs.shape
    valid = valid.reshape(-1)
    idx = torch.where(valid, ctx.reshape(-1).to(torch.int64) * n_sym
                      + sym.reshape(-1).to(torch.int64), 0)
    add = torch.where(valid, inc, 0).to(freqs.dtype)
    freqs = freqs.reshape(-1).clone().index_add_(0, idx, add).reshape(
        n_ctx, n_sym)
    total = freqs.sum(dim=1, dtype=torch.int64) + n_sym * ALPHA
    # floor(log2(total)), exact: total < 2^53 is exact in float64 and frexp
    # returns its binary exponent without rounding
    expo = torch.frexp(total.to(torch.float64)).exponent.to(torch.int64) - 1
    nshift = torch.clamp(expo - RAW_CAP_BITS, min=0)
    nshift = nshift + ((total >> nshift) > (1 << RAW_CAP_BITS)).to(
        torch.int64)
    # in the cells' own type: every shift is below 32, since a row of at
    # most 256 int32 cells sums below 2^39
    return freqs >> nshift[:, None].to(freqs.dtype)
