"""Interleaved vectorized rANS entropy coder.

Port of fqsqueezer_tpu/ops/rans.py (see its docstring for the format: N lanes
share one word stream, u32 states in [2^16, 2^32), u16 words, masked slots
coded as the exact no-op (freq = 2^SB, cum = 0)).

Each encode entry point has two parts:
  * the walk — the reverse per-lane recurrence over the [T, N] grid. On
    CUDA tensors it is kernel K1 (csrc/rans_encode.cu), which walks every
    grid of a list in one launch; on CPU tensors it is
    rans_encode_walk_plain, the same recurrence as a reverse torch loop;
  * the compaction — the emitted words selected in row-major (t, lane)
    order, and per-batch word counts from the emit plane's row sums. These
    stay torch ops.
The decode side (rans_decode_slots, rans_decode_advance, cdf_lookup) is
torch ops, one step for all lanes; the decode scans that run these steps
(streams/quality.py's K3 and streams/dna.py's scan) call them or repeat them.
The walk's planes are narrow: words as int16 bit patterns of the u16 values
(torch indexes no uint16 on CUDA; words_to_i32 gives the values), emit flags
as uint8. u32 states are carried in int64 (see _u32.py).
"""
from __future__ import annotations

import ctypes

import torch

from .._u32 import MASK32

RANS_L = 1 << 16  # lower bound of the normalized state interval
WORD_BITS = 16
WORD_MASK = (1 << 16) - 1

GROUP_PAD_ROWS = 512   # group grid rows are padded to this granularity
GROUP_MAX_BATCHES = 64   # batches a single-device group holds at most

# Launches of K1 (the CUDA walk) in this process; the plain walk never counts.
K1_LAUNCHES = 0
K1_MAX_STREAMS = 8     # grids one launch takes (kMaxStreams in the source)


def rans_initial_states(n_lanes: int, device=None) -> torch.Tensor:
    return torch.full((n_lanes,), RANS_L, dtype=torch.int64, device=device)


def words_to_i32(w: torch.Tensor) -> torch.Tensor:
    """The u16 values of a word tensor held as int16 bit patterns."""
    return w.to(torch.int32) & WORD_MASK


# --- K1's divide, as plain torch ------------------------------------------
# The kernel replaces x / f on its chain by a multiply with a reciprocal
# made ahead of use. These functions are the same arithmetic on int64
# tensors holding u32 values; the tests hold them against //.

def umulhi32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """High 32 bits of the 64-bit product of two u32 values (in int64
    without overflow: a is split into 16-bit halves)."""
    return ((a >> 16) * b + (((a & WORD_MASK) * b) >> 16)) >> 16


def reciprocal_u32(f: torch.Tensor) -> torch.Tensor:
    """m = floor((2^32 - 1) / f): fits 32 bits for every f >= 1 (f = 1
    included, where 2^32 / f does not) and lies in [2^32/f - 1, 2^32/f]."""
    return MASK32 // f


def div_by_reciprocal(x: torch.Tensor, f: torch.Tensor,
                      m: torch.Tensor | None = None) -> torch.Tensor:
    """x // f for u32 x and 1 <= f <= 2^16, as K1 computes it: umulhi(x, m)
    is the quotient or one less, and one compare makes it exact."""
    q = umulhi32(x, reciprocal_u32(f) if m is None else m)
    return q + ((x - q * f) >= f).to(torch.int64)


# --- the walk ---------------------------------------------------------------

def rans_encode_walk_plain(freq: torch.Tensor, cum: torch.Tensor,
                           scale_bits: int, init_states: torch.Tensor):
    """K1's plain torch version, on any device: (wplane [T, N] int16 bit
    patterns of the u16 words, eplane [T, N] uint8, final states [N] int64)
    of the reverse walk."""
    T, N = freq.shape
    shift = 32 - scale_bits
    f = freq.to(torch.int64)
    c = cum.to(torch.int64)
    x = init_states.to(torch.int64) & MASK32
    w = torch.empty((T, N), dtype=torch.int16, device=freq.device)
    e = torch.empty((T, N), dtype=torch.uint8, device=freq.device)
    for t in range(T - 1, -1, -1):
        ft = f[t]
        emit = (x >> shift) >= ft
        word = x & WORD_MASK
        w[t] = (word ^ 0x8000) - 0x8000    # the same 16 bits, as int16
        e[t] = emit
        x = torch.where(emit, x >> WORD_BITS, x)
        q = x // ft
        x = ((q << scale_bits) + c[t] + (x - q * ft)) & MASK32
    return w, e, x


def _check_grid(i, freq, cum, init, scale_bits):
    if freq.dim() != 2 or cum.shape != freq.shape:
        raise ValueError(f"K1: grid {i}: freq/cum must be one [T, N] shape, "
                         f"got {tuple(freq.shape)} and {tuple(cum.shape)}")
    T, N = freq.shape
    if N < 1:
        raise ValueError(f"K1: grid {i}: no lanes")
    dev = freq.device
    for name, t in (("freq", freq), ("cum", cum)):
        if t.dtype != torch.int32 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"K1: grid {i}: {name} must be a contiguous "
                             f"int32 tensor on {dev}, got {t.dtype} on "
                             f"{t.device}")
    if (init.shape != (N,) or init.dtype != torch.int64
            or init.device != dev or not init.is_contiguous()):
        raise ValueError(f"K1: grid {i}: init_states must be a contiguous "
                         f"int64 [{N}] tensor on {dev}")
    if T * N >= 1 << 31:
        raise ValueError(f"K1: grid {i}: {T} x {N} slots do not fit the "
                         f"kernel's 32-bit offsets")
    if not 1 <= scale_bits <= 16:
        raise ValueError(f"K1: scale_bits {scale_bits} outside [1, 16]")


def _rans_encode_walks_cuda(grids, scale_bits, inits):
    """One K1 launch for at most K1_MAX_STREAMS grids. Checks everything
    before it builds or launches."""
    global K1_LAUNCHES
    if len(grids) > K1_MAX_STREAMS:
        raise ValueError(f"K1: {len(grids)} grids, one launch takes at most "
                         f"{K1_MAX_STREAMS}")
    dev = grids[0][0].device
    for i, ((f, c), init) in enumerate(zip(grids, inits)):
        _check_grid(i, f, c, init, scale_bits)
        if f.device != dev:
            raise ValueError(f"K1: grid {i} is on {f.device}, grid 0 on "
                             f"{dev}")
    from . import _build

    out = []
    for (f, c), init in zip(grids, inits):
        T, N = f.shape
        out.append((torch.empty((T, N), dtype=torch.int16, device=dev),
                    torch.empty((T, N), dtype=torch.uint8, device=dev),
                    torch.empty((N,), dtype=torch.int64, device=dev)))
    rows = [(f, c, init, *o) for (f, c), init, o in zip(grids, inits, out)]
    n = len(rows)
    ptrs = [(ctypes.c_void_p * n)(*(row[k].data_ptr() for row in rows))
            for k in range(6)]
    with torch.cuda.device(dev):
        rc = _build.kernels().fqtz_rans_encode_walk(
            n, *ptrs, (ctypes.c_int * n)(*(f.shape[0] for f, _ in grids)),
            (ctypes.c_int * n)(*(f.shape[1] for f, _ in grids)), scale_bits,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    K1_LAUNCHES += 1
    return out


def rans_encode_walks(grids, scale_bits: int, init_states=None):
    """The reverse encode walks of a list of (freq, cum) grids — the streams
    of one group flush; their [T, N] may differ. CUDA grids (int32,
    contiguous) go through kernel K1 in one launch; CPU grids run the plain
    torch loop one after another. init_states: one int64 [N] tensor per
    grid (default: fresh lanes). Returns per grid (wplane [T, N] int16 word
    bits, eplane [T, N] uint8, final states [N] int64)."""
    grids = list(grids)
    if not grids:
        return []
    if init_states is None:
        init_states = [rans_initial_states(f.shape[1], f.device)
                       for f, _ in grids]
    kind = grids[0][0].device.type
    if any(f.device.type != kind for f, _ in grids):
        raise ValueError("rans_encode_walks: grids on different devices")
    if kind == "cuda":
        return _rans_encode_walks_cuda(grids, scale_bits, list(init_states))
    if kind == "cpu":
        return [rans_encode_walk_plain(f, c, scale_bits, init)
                for (f, c), init in zip(grids, init_states)]
    raise ValueError(f"rans_encode_walks: no walk for device "
                     f"{grids[0][0].device}")


def rans_encode_walk(freq: torch.Tensor, cum: torch.Tensor, scale_bits: int,
                     init_states: torch.Tensor):
    """One grid's walk (see rans_encode_walks)."""
    return rans_encode_walks([(freq, cum)], scale_bits, [init_states])[0]


# --- compaction and the entry points ----------------------------------------

def _compact(wplane: torch.Tensor, eplane: torch.Tensor) -> torch.Tensor:
    """Emitted words (int32 values) in row-major (t, lane) order — the
    decoder's consumption order. The selection sizes its result, so it
    waits for the walk."""
    picked = wplane.reshape(-1)[eplane.reshape(-1).view(torch.bool)]
    return words_to_i32(picked)


def rans_encode(freq: torch.Tensor, cum: torch.Tensor, scale_bits: int,
                init_states: torch.Tensor | None = None):
    """Encode a [T, N] grid of symbols given their (freq, cum) in decode
    order. Returns (words [n_words] int32 holding u16 words in decode order,
    n_words, final states [N] = the decoder's initial states)."""
    if init_states is None:
        init_states = rans_initial_states(freq.shape[1], freq.device)
    wplane, eplane, x = rans_encode_walk(freq, cum, scale_bits, init_states)
    words = _compact(wplane, eplane)
    return words, words.numel(), x


def rans_encode_shards(grids, scale_bits: int, row_bounds, n_shards: int):
    """Encode the concatenated [T, S * N] grids of one group flush, one per
    stream, whose lane columns are S shards of N lanes each: shard s owns
    columns [s * N, (s + 1) * N) and codes its own word stream. Each grid
    is one chained walk from fresh lanes (a walk over the group's batches
    in reverse: lanes never interact, so the shards' walks are one walk)
    — all of them in one K1 launch on a CUDA device. row_bounds: per grid,
    the cumulative row offsets of its K batches ([K + 1], any K; entries
    past T count as T). Returns per grid (words [n] int32 in (shard, t,
    lane) order, n_per [S, K] int64, states [S * N]): shard s's words are
    a contiguous run, shard after shard, and within it batch k's words the
    run of n_per[s, k] after those of its batches before k."""
    out = []
    for (wplane, eplane, x), rb in zip(
            rans_encode_walks(grids, scale_bits), row_bounds):
        T = wplane.shape[0]
        w = wplane.reshape(T, n_shards, -1).transpose(0, 1)
        e = eplane.reshape(T, n_shards, -1).transpose(0, 1)
        row_sums = e.sum(dim=2)
        crow = torch.cat([row_sums.new_zeros((n_shards, 1)),
                          torch.cumsum(row_sums, 1)], dim=1)
        at = crow[:, torch.clamp(rb.to(torch.int64), max=T)]
        out.append((_compact(w, e), at[:, 1:] - at[:, :-1], x))
    return out


def rans_encode_groups(grids, scale_bits: int, row_bounds):
    """Encode the concatenated [T, N] grids of one group flush, one per
    stream, each as one chained walk from fresh lanes — all of them in one
    K1 launch on a CUDA device (rans_encode_shards with one shard).
    row_bounds: per grid, the cumulative row offsets of its batches.
    Returns per grid (words [n] int32, n_per [K] int64, states [N]):
    batch k's words are the contiguous slice [sum(n_per[:k]),
    sum(n_per[:k+1]))."""
    return [(w, n[0], x) for w, n, x in
            rans_encode_shards(grids, scale_bits, row_bounds, 1)]


def rans_encode_fresh(grids, scale_bits: int, n_shards: int = 1):
    """The single-step encode of a batch's grids, one per stream, each
    [T, S * N] of S shards: every shard of every grid coded from fresh
    lanes, all in one K1 launch on a CUDA device (rans_encode_shards with
    one batch). Returns per grid (words [n] int32 shard-major, n_words
    [S] int64, states [S * N])."""
    bounds = [torch.tensor([0, f.shape[0]], device=f.device)
              for f, _ in grids]
    return [(w, n[:, 0], x) for w, n, x in
            rans_encode_shards(grids, scale_bits, bounds, n_shards)]


def rans_encode_group(freq: torch.Tensor, cum: torch.Tensor, scale_bits: int,
                      row_bounds: torch.Tensor):
    """One stream's group encode (see rans_encode_groups)."""
    return rans_encode_groups([(freq, cum)], scale_bits, [row_bounds])[0]


# --- decode steps -------------------------------------------------------------

def rans_decode_slots(states: torch.Tensor, scale_bits: int) -> torch.Tensor:
    """Current slot (low SB bits) of each lane's state: the value the symbol
    lookup inverts through the cdf."""
    return states & ((1 << scale_bits) - 1)


def rans_decode_advance(states: torch.Tensor, ptr: torch.Tensor,
                        words: torch.Tensor, freq: torch.Tensor,
                        cum: torch.Tensor, scale_bits: int):
    """Advance all lanes one symbol after the caller resolved (freq, cum)
    (freq = 2^SB, cum = 0 for masked lanes).

    states: [N] int64 holding u32; ptr: 0-d int64 read cursor into words;
    words: [W] integer tensor of u16 values in decode order. The lanes that
    renormalize take consecutive words in lane order (an exclusive cumsum
    over all N lanes), so every step couples every lane. A read past the
    end clamps to the last word, as the reference's gather does. Returns
    (new_states, new_ptr)."""
    slot = states & ((1 << scale_bits) - 1)
    x = (freq.to(torch.int64) * (states >> scale_bits) + slot
         - cum.to(torch.int64)) & MASK32
    consume = x < RANS_L
    ci = consume.to(torch.int64)
    off = torch.cumsum(ci, 0) - ci
    idx = torch.clamp(ptr + off, max=words.numel() - 1)
    w = words[idx].to(torch.int64)
    x = torch.where(consume, ((x << WORD_BITS) | w) & MASK32, x)
    return x, ptr + ci.sum()


def cdf_lookup(cdf: torch.Tensor, slots: torch.Tensor):
    """Map rANS slots to symbols through per-lane cdf rows [N, A+1]
    (cdf[:, 0] = 0, cdf[:, A] = 2^SB). Returns (sym, freq, cum), each [N]
    int64. The reference's masked reductions, kept as they are: sym counts
    the boundaries <= slot, cum is the largest of them (0 if none), and
    freq runs to the smallest boundary above the slot — so a zero-width
    step resolves exactly as there, whatever its position."""
    bnd = cdf[:, 1:]
    le = bnd <= slots[:, None]
    sym = le.sum(dim=1)
    cum = torch.where(le, bnd, 0).amax(dim=1)
    nxt = torch.where(le, cdf.shape[1] << 16, bnd).amin(dim=1)
    return sym, nxt - cum, cum
