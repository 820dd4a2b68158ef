"""Inputs for checking and timing the rANS kernels: (freq, cum) grids for
the encode walk (K1) and quality decode batches for the decode scan (K3).

Made with numpy from a seed, so the same input reaches the kernel, its plain
version and the reference package. Used by chip_smoke.py, the K1 timing
script and the tests.
"""
from __future__ import annotations

import numpy as np

_CHUNK_ROWS = 1024   # rows made at a time, to bound the host memory


def random_grid(seed: int, T: int, N: int, scale_bits: int = 14):
    """(freq, cum) int32 [T, N]: every slot a symbol of a random 5-symbol
    cdf, about 15% of the slots the masked no-op (freq 2^SB, cum 0)."""
    rng = np.random.default_rng(seed)
    fs = [np.zeros((0, N), np.int32)]
    cs = [np.zeros((0, N), np.int32)]
    for t0 in range(0, T, _CHUNK_ROWS):
        t = min(_CHUNK_ROWS, T - t0)
        raw = rng.integers(1, 50, size=(t, N, 5)).astype(np.int64)
        cdf = np.concatenate([np.zeros((t, N, 1), np.int64),
                              np.cumsum(raw, axis=-1)], axis=-1)
        cdf = (cdf << scale_bits) // cdf[..., -1:]
        s = rng.integers(0, 5, size=(t, N, 1))
        lo = np.take_along_axis(cdf, s, axis=-1)[..., 0]
        hi = np.take_along_axis(cdf, s + 1, axis=-1)[..., 0]
        mask = rng.random((t, N)) < 0.85
        fs.append(np.where(mask, hi - lo, 1 << scale_bits).astype(np.int32))
        cs.append(np.where(mask, lo, 0).astype(np.int32))
    return np.concatenate(fs), np.concatenate(cs)


def adversarial_grid(seed: int, T: int, N: int, scale_bits: int = 14):
    """(freq, cum int32 [T, N], init states int64 [N]) at the edges of K1's
    arithmetic: most freqs from {1, 2, 3, 2^SB - 1, 2^SB}, the rest random,
    each with a random legal cum; the starting states cycle through 2^16,
    2^32 - 1, the first step's emit threshold f << (32 - SB) and its two
    neighbours, and random states."""
    rng = np.random.default_rng(seed)
    top = 1 << scale_bits
    special = np.array([1, 2, 3, top - 1, top])
    f = np.where(rng.random((T, N)) < 0.6,
                 special[rng.integers(0, special.size, (T, N))],
                 rng.integers(1, top + 1, (T, N)))
    c = rng.integers(0, top, (T, N)) % (top - f + 1)   # cum + freq <= 2^SB
    lo, hi = 1 << 16, (1 << 32) - 1
    thr = f[T - 1].astype(np.int64) << (32 - scale_bits)
    kind = np.arange(N) % 8
    init = np.select(
        [kind == 0, kind == 1, kind == 2, kind == 3, kind == 4],
        [np.full(N, lo), np.full(N, hi), np.clip(thr - 1, lo, hi),
         np.clip(thr, lo, hi), np.clip(thr + 1, lo, hi)],
        rng.integers(lo, hi + 1, N))
    return f.astype(np.int32), c.astype(np.int32), init.astype(np.int64)


def quality_batch(seed: int, n_lanes: int, r_pl: int, L: int, n_ctx: int,
                  n_sym: int, n_words: int):
    """(model int32 [n_ctx, n_sym], lengths int32 [n_lanes * r_pl], words
    int32 [n_words], init states int64 [n_lanes]) for the quality decode
    scan. The model's rows are random counts that model_update could have
    left (smoothed totals at most 2^13), a quarter of them all zero; the
    lengths cycle through 0, 1 and L and are random otherwise; words and
    states are random, so a short word array runs out and the reads past
    its end clamp."""
    rng = np.random.default_rng(seed)
    model = rng.integers(0, (1 << 13) // n_sym, (n_ctx, n_sym))
    model[rng.random(n_ctx) < 0.25] = 0
    R = n_lanes * r_pl
    lengths = rng.integers(0, L + 1, R)
    lengths[:3 * (R // 4)] = np.resize(np.array([0, 1, L]), 3 * (R // 4))
    rng.shuffle(lengths)
    words = rng.integers(0, 1 << 16, n_words)
    init = rng.integers(1 << 16, 1 << 32, n_lanes)
    return (model.astype(np.int32), lengths.astype(np.int32),
            words.astype(np.int32), init.astype(np.int64))
