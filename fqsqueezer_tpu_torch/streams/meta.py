"""META stream: read lengths as two byte symbols (lo, hi) under two adaptive
contexts, and in sorted mode a third byte symbol a read, its LCP (the
prefix it shares with the previous read of its lane, capped at 255) under
a third context. Port of fqsqueezer_tpu/streams/meta.py. Decode is a scan
of W * r_pl steps (4 to 12 a batch at the bench geometries), so plain
torch ops do."""
from __future__ import annotations

import dataclasses

import torch

from ..ops import models, rans
from . import common

N_SYM = 256
N_CTX = 3  # 0: len lo byte, 1: len hi byte, 2: lcp byte
LCP_CAP = 255


@dataclasses.dataclass(frozen=True)
class MetaConfig:
    scale_bits: int = 14
    n_lanes: int = 1024
    with_lcp: bool = False
    lcp_stride: int = 1

    @property
    def n_per_read(self) -> int:
        return 3 if self.with_lcp else 2


def meta_state_create(device=None) -> torch.Tensor:
    return models.model_create(N_CTX, N_SYM, device)


def compute_lcp(codes: torch.Tensor, lengths: torch.Tensor, n_lanes: int,
                stride: int = 1) -> torch.Tensor:
    """[R] int64 shared-prefix length of each read against the read
    `stride` back in the same lane (lane-major reads, common.to_read_grid),
    capped at 255; 0 for each lane's first `stride` reads. Stride 2 is
    paired-end's: read1 against the previous read1 of the lane, and mate2
    rows get 0. Exact byte compare (N distinct from T), so copying the
    prefix is lossless."""
    R, L = codes.shape
    lengths = lengths.to(torch.int64)
    pos = torch.arange(L, dtype=torch.int64, device=codes.device)[None, :]
    prev = torch.roll(codes, stride, dims=0)
    prev_len = torch.roll(lengths, stride)
    idx = torch.arange(R, device=codes.device) % (R // n_lanes)
    first = idx < stride
    if stride == 2:
        first = first | (idx % 2 == 1)          # mate2 rows
    eq = (codes == prev) & (pos < lengths[:, None]) & (pos < prev_len[:, None])
    lcp = torch.cumprod(eq.to(torch.int64), dim=1).sum(dim=1)
    return torch.clamp(torch.where(first, 0, lcp), max=LCP_CAP)


def _syms_ctx(cfg: MetaConfig, lengths: torch.Tensor, lcp=None):
    lengths = lengths.to(torch.int64)
    cols = [lengths & 0xFF, (lengths >> 8) & 0xFF]
    if cfg.with_lcp:
        cols.append(lcp.to(torch.int64))
    syms = torch.stack(cols, dim=-1)
    ctx = torch.arange(cfg.n_per_read, dtype=torch.int64,
                       device=lengths.device)[None, :].expand_as(syms)
    return syms, ctx


def meta_modeling(cfg: MetaConfig, model: torch.Tensor, lengths: torch.Tensor,
                  lcp=None):
    """Returns (ctx, syms, freq, cum), each [R, n_per_read]. lcp: [R] (with
    cfg.with_lcp)."""
    syms, ctx = _syms_ctx(cfg, lengths, lcp)
    cdf = models.model_cdf(model, ctx, cfg.scale_bits)
    f, c = models.cdf_encode_lookup(cdf, syms)
    return ctx, syms, f, c


def meta_encode_batch(cfg: MetaConfig, model: torch.Tensor,
                      lengths: torch.Tensor, lcp=None):
    """One batch coded from fresh lanes (the reference's single-step
    encode). Returns (words, n_words, decoder initial states, new
    model)."""
    ctx, syms, f, c = meta_modeling(cfg, model, lengths, lcp)
    words, n_words, states = rans.rans_encode(
        common.lane_grid(f, cfg.n_lanes), common.lane_grid(c, cfg.n_lanes),
        cfg.scale_bits)
    new_model = models.model_update(
        model, ctx.reshape(-1), syms.reshape(-1),
        torch.ones(ctx.numel(), dtype=torch.bool, device=ctx.device))
    return words, n_words, states, new_model


def meta_decode_batch(cfg: MetaConfig, model: torch.Tensor, R: int,
                      words: torch.Tensor, init_states: torch.Tensor):
    """Decode the (length[, lcp]) tuples of R reads. Returns (lengths [R]
    int64, lcp [R] int64 (zeros without cfg.with_lcp), new_model,
    final_states, n_words_consumed), as the reference's
    meta_decode_batch."""
    N = cfg.n_lanes
    W = cfg.n_per_read
    sb = cfg.scale_bits
    dev = init_states.device
    cdfs = [models.model_cdf(model, torch.full((N,), k, dtype=torch.int64,
                                               device=dev), sb)
            for k in range(W)]
    x = init_states
    ptr = torch.zeros((), dtype=torch.int64, device=dev)
    ys = []
    for t in range(W * (R // N)):
        sym, f, c = rans.cdf_lookup(cdfs[t % W],
                                    rans.rans_decode_slots(x, sb))
        x, ptr = rans.rans_decode_advance(x, ptr, words, f, c, sb)
        ys.append(sym)
    syms = common.from_grid(torch.stack(ys), N, W)             # [R, W]
    lengths = syms[:, 0] | (syms[:, 1] << 8)
    lcp = syms[:, 2] if cfg.with_lcp else torch.zeros_like(lengths)
    ctx = torch.arange(W, dtype=torch.int64, device=dev)[None, :].expand_as(
        syms)
    new_model = models.model_update(
        model, ctx.reshape(-1), syms.reshape(-1),
        torch.ones(ctx.numel(), dtype=torch.bool, device=dev))
    return lengths, lcp, new_model, x, ptr
