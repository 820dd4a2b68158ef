"""META stream: read lengths as two byte symbols (lo, hi) under two adaptive
contexts. Port of fqsqueezer_tpu/streams/meta.py without the sorted-mode LCP
byte (that comes with sorted order). Decode is a scan of W * r_pl steps
(4 a batch at the bench geometry), so plain torch ops do."""
from __future__ import annotations

import dataclasses

import torch

from ..ops import models, rans
from . import common

N_SYM = 256
N_CTX = 3  # 0: len lo byte, 1: len hi byte, 2: lcp byte


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


def _syms_ctx(cfg: MetaConfig, lengths: torch.Tensor):
    if cfg.with_lcp:
        raise NotImplementedError("sorted-mode LCP meta is not ported yet")
    lengths = lengths.to(torch.int64)
    syms = torch.stack([lengths & 0xFF, (lengths >> 8) & 0xFF], dim=-1)
    ctx = torch.arange(cfg.n_per_read, dtype=torch.int64,
                       device=lengths.device)[None, :].expand_as(syms)
    return syms, ctx


def meta_modeling(cfg: MetaConfig, model: torch.Tensor, lengths: torch.Tensor):
    """Returns (ctx, syms, freq, cum), each [R, 2]."""
    syms, ctx = _syms_ctx(cfg, lengths)
    cdf = models.model_cdf(model, ctx, cfg.scale_bits)
    f, c = models.cdf_encode_lookup(cdf, syms)
    return ctx, syms, f, c


def meta_decode_batch(cfg: MetaConfig, model: torch.Tensor, R: int,
                      words: torch.Tensor, init_states: torch.Tensor):
    """Decode the read lengths of R reads. Returns (lengths [R] int64,
    new_model, final_states, n_words_consumed) — the reference's
    meta_decode_batch without its LCP output."""
    if cfg.with_lcp:
        raise NotImplementedError("sorted-mode LCP meta is not ported yet")
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
    ctx = torch.arange(W, dtype=torch.int64, device=dev)[None, :].expand_as(
        syms)
    new_model = models.model_update(
        model, ctx.reshape(-1), syms.reshape(-1),
        torch.ones(ctx.numel(), dtype=torch.bool, device=dev))
    return lengths, new_model, x, ptr
