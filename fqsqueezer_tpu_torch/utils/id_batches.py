"""Encoded batches for checking and timing the slot decode scans: the id
scan (K4) and the meta scan (K5).

Made with numpy from a seed and encoded by the package's own modeling and
rANS walk, so a batch's words decode to known planes; the same input then
reaches a kernel and its plain version. Used by chip_smoke.py, the K4
timing script and the tests.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import rans
from ..streams import common, ids, meta


def _coded(f, c, N, sb, cap, short, device):
    """The words of one walk of the (f, c) planes from fresh lanes, as an
    int32 [cap] plane with zeros after them (cut to half with `short`: the
    reads past the end clamp), and the decoder's initial states."""
    words, n, init = rans.rans_encode(common.lane_grid(f, N),
                                      common.lane_grid(c, N), sb)
    n = int(n) // 2 if short else int(n)
    w = torch.zeros(max(cap, 1), dtype=torch.int32, device=device)
    w[:n] = words[:n].to(torch.int32)
    return w, init


def id_scan_inputs(seed: int, N: int, r_pl: int, F: int, M: int,
                   codec_v: int = 2, n_pad: int = 0, device="cpu",
                   short: bool = False):
    """(IdConfig, cdfs int32 [N_CTX, 257], R, words int32, init int64 [N],
    n_valid) of one encoded id batch of R = N * r_pl reads: random planes
    (the first quarter and a third of the rest escape with a raw length
    from 0 to M, 0 and M among them; the others code delta symbols 0-8
    with their magnitude bytes), the last n_pad reads padding, under a
    random model whose rows count
    only the symbols their context codes — the masked ones stay zero, as in
    a real stream, so a v2 flag or delta row is mostly zero-width steps —
    and a quarter of whose rows are all zero. With `short` the words are
    cut to half."""
    rng = np.random.default_rng(seed)
    cfg = ids.IdConfig(max_id_len=M, n_fields=F, n_lanes=N, codec_v=codec_v)
    R = N * r_pl
    model = rng.integers(0, (1 << 13) // ids.N_SYM, (ids.N_CTX, ids.N_SYM))
    model *= ids._alpha_lut_np()
    model[rng.random(ids.N_CTX) < 0.25] = 0
    flag = (rng.random(R) < 0.3).astype(np.uint8)
    dsym = np.where(rng.random((R, F)) < 0.4, 0,
                    rng.integers(0, 9, (R, F))).astype(np.uint8)
    dmag = rng.integers(0, 256, (R, F, ids.MAGS)).astype(np.uint8)
    elens = rng.integers(0, M + 1, R)
    # the first quarter escapes, lengths 0 and M among them
    flag[:R // 4] = 1
    elens[:R // 4] = np.resize(np.array([0, M]), R // 4)
    emat = rng.integers(0, 256, (R, M)).astype(np.uint8)
    n_valid = R - n_pad
    model_t = torch.from_numpy(model.astype(np.int32)).to(device)
    planes = [torch.from_numpy(a).to(device)
              for a in (flag, dsym, dmag, emat, elens.astype(np.int32))]
    _, _, f, c, _ = ids.id_modeling(cfg, model_t, *planes, n_valid=n_valid)
    words, init = _coded(f, c, N, cfg.scale_bits, R * cfg.w_all + 4 * N,
                         short, device)
    cdfs = ids._ctx_cdfs(cfg, model_t).to(torch.int32).contiguous()
    return cfg, cdfs, R, words, init, n_valid


def meta_scan_inputs(seed: int, N: int, r_pl: int, with_lcp: bool,
                     device="cpu", short: bool = False):
    """(MetaConfig, cdfs int32 [W, 257], R, words int32, init int64 [N]) of
    one encoded meta batch of R = N * r_pl reads: random lengths below
    2^16 (0 and 1 among them) and, with the LCP, random LCPs up to 255,
    under a random model with a zero row."""
    rng = np.random.default_rng(seed)
    cfg = meta.MetaConfig(n_lanes=N, with_lcp=with_lcp)
    R = N * r_pl
    model = rng.integers(0, (1 << 13) // meta.N_SYM, (meta.N_CTX,
                                                      meta.N_SYM))
    model[rng.integers(0, meta.N_CTX)] = 0
    lengths = np.where(rng.random(R) < 0.5, rng.integers(0, 300, R),
                       rng.integers(0, 1 << 16, R))
    lengths[:R // 8] = np.resize(np.array([0, 1]), R // 8)
    lcp = rng.integers(0, meta.LCP_CAP + 1, R)
    model_t = torch.from_numpy(model.astype(np.int32)).to(device)
    _, _, f, c = meta.meta_modeling(
        cfg, model_t, torch.from_numpy(lengths).to(device),
        torch.from_numpy(lcp).to(device) if with_lcp else None)
    words, init = _coded(f, c, N, cfg.scale_bits, cfg.n_per_read * R,
                         short, device)
    return cfg, meta.meta_cdfs(cfg, model_t), R, words, init
