"""QUALITY stream codec.

Port of fqsqueezer_tpu/streams/quality.py: per-mode quantization maps and a
dense [n_ctx, n_sym] model indexed by a packed (history, position-bucket)
context. With in-batch local model deltas (QualConfig.with_local: the
first local-statistics writer's header) a read row's probabilities add
the deltas of the batch's earlier rows, clamped (models.model_cdf_local),
and each row adds its own at its end.

Decode is a scan over the positions of each read row, all lanes in step:
each step builds the context from the lane's last n_hist symbols, looks the
slot up in the frozen model's cdf row and advances the rANS state. On CUDA
tensors the scan is kernel K3 (csrc/qual_decode.cu), one launch a batch, the
deltas' row-end updates included; on CPU tensors it is
qual_decode_scan_plain, the same scan as torch ops.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..ops import models, rans
from . import common

POS_BITS = 4

# mode -> (n_sym, bits_per_hist_sym, n_hist_syms)
_MODE_GEOM = {
    "lossless": (96, 7, 2),
    "illumina_8": (8, 3, 5),
    "illumina_4": (4, 2, 7),
    "binary": (2, 1, 10),
}


def qual_maps(mode: str, qt: int):
    """(fwd [96] -> symbol, rev [n_sym] -> quality value) numpy LUTs."""
    fwd = np.zeros(96, np.int32)
    if mode == "lossless":
        fwd = np.arange(96, dtype=np.int32)
        rev = np.arange(96, dtype=np.int32)
    elif mode == "illumina_8":
        bounds = [(0, 2, 0), (2, 10, 6), (10, 20, 15), (20, 25, 22),
                  (25, 30, 27), (30, 35, 33), (35, 40, 37), (40, 96, 40)]
        rev = np.zeros(8, np.int32)
        for s, (a, b, r) in enumerate(bounds):
            fwd[a:b] = s
            rev[s] = r
    elif mode == "illumina_4":
        bounds = [(0, 2, 0), (2, 15, 12), (15, 31, 23), (31, 96, 37)]
        rev = np.zeros(4, np.int32)
        for s, (a, b, r) in enumerate(bounds):
            fwd[a:b] = s
            rev[s] = r
    elif mode == "binary":
        fwd[:qt] = 0
        fwd[qt:] = 1
        rev = np.array([0, qt], np.int32)
    else:
        raise ValueError(mode)
    return fwd, rev


@dataclasses.dataclass(frozen=True)
class QualConfig:
    mode: str = "illumina_8"
    qt: int = 20
    scale_bits: int = 14
    n_lanes: int = 1024
    with_local: bool = False
    local_inc: int = 8

    @property
    def n_sym(self) -> int:
        return _MODE_GEOM[self.mode][0]

    @property
    def hist_bits(self) -> int:
        return _MODE_GEOM[self.mode][1]

    @property
    def n_hist(self) -> int:
        return _MODE_GEOM[self.mode][2]

    @property
    def hist_mask(self) -> int:
        return (1 << (self.hist_bits * self.n_hist)) - 1

    @property
    def n_ctx(self) -> int:
        return 1 << (self.hist_bits * self.n_hist + POS_BITS)


def qual_state_create(cfg: QualConfig, device=None) -> torch.Tensor:
    return models.model_create(cfg.n_ctx, cfg.n_sym, device)


def _pos_bucket(i):
    """4-bit quality position bucket: fine early, coarse later."""
    return torch.clamp(torch.where(i < 8, i, 8 + (i - 8) // 24), max=15)


def qual_ctx_plane(cfg: QualConfig, qsyms: torch.Tensor) -> torch.Tensor:
    """Packed (history, position-bucket) context of every position."""
    L = qsyms.shape[1]
    pos = torch.arange(L, dtype=torch.int64, device=qsyms.device)[None, :]
    b = cfg.hist_bits
    h = torch.zeros_like(qsyms)
    for d in range(cfg.n_hist, 0, -1):
        prev = torch.roll(qsyms, d, dims=1)
        prev = torch.where(pos - d >= 0, prev, (1 << b) - 1)
        h = (h << b) | prev
    hist = h & cfg.hist_mask
    return (hist | (_pos_bucket(pos) << (b * cfg.n_hist))).expand_as(qsyms)


def qual_modeling(cfg: QualConfig, model: torch.Tensor, qsyms: torch.Tensor,
                  lengths: torch.Tensor):
    """qsyms: [R, L] quantized symbols. Returns (ctx, f, c, active).

    With cfg.with_local, a loop over the read rows: row rd's cdf adds the
    deltas of rows < rd, then its own (ctx, sym) events add local_inc —
    the order the decoder replays."""
    R, L = qsyms.shape
    pos = torch.arange(L, dtype=torch.int64, device=qsyms.device)[None, :]
    active = pos < lengths[:, None]
    ctx = qual_ctx_plane(cfg, qsyms)
    sb = cfg.scale_bits

    def code(cdf, sym, act):
        f, c = models.cdf_encode_lookup(cdf, sym)
        return torch.where(act, f, 1 << sb), torch.where(act, c, 0)

    if not cfg.with_local:
        return (ctx,) + code(models.model_cdf(model, ctx, sb), qsyms,
                             active) + (active,)
    rb = lambda x: common.to_row_blocks(x, cfg.n_lanes)
    lm = local_state_create(cfg, qsyms.device)
    fc = []
    for ctx_r, sym_r, act_r in zip(rb(ctx), rb(qsyms), rb(active)):
        fc.append(code(models.model_cdf_local(model, lm, ctx_r, sb), sym_r,
                       act_r))
        lm = models.local_model_update(lm, ctx_r, sym_r, act_r,
                                       inc=cfg.local_inc)
    f, c = (common.from_row_blocks(torch.stack(t)) for t in zip(*fc))
    return ctx, f, c, active


def local_state_create(cfg: QualConfig, device=None) -> torch.Tensor:
    """A batch's zeroed in-batch deltas, int32 [n_ctx, n_sym]."""
    return torch.zeros((cfg.n_ctx, cfg.n_sym), dtype=torch.int32,
                       device=device)


def qual_encode_batch(cfg: QualConfig, model: torch.Tensor,
                      qsyms: torch.Tensor, lengths: torch.Tensor):
    """One batch coded from fresh lanes (the reference's single-step
    encode). Returns (words, n_words, decoder initial states, new
    model)."""
    ctx, f, c, active = qual_modeling(cfg, model, qsyms, lengths)
    words, n_words, states = rans.rans_encode(
        common.lane_grid(f, cfg.n_lanes), common.lane_grid(c, cfg.n_lanes),
        cfg.scale_bits)
    new_model = models.model_update(
        model, ctx.reshape(-1), qsyms.reshape(-1), active.reshape(-1))
    return words, n_words, states, new_model


# ---------------------------------------------------------------------------
# decode scan: kernel K3 and its plain version
# ---------------------------------------------------------------------------

# Launches of K3 (the CUDA quality decode scan) in this process; the plain
# scan never counts.
K3_LAUNCHES = 0
K3_MAX_LANES = 2048   # one cluster holds every lane (kMaxLanes in the source)
# symbols a model row K3 takes: binary, Illumina-4, Illumina-8, lossless (one
# instantiation each in the source, and one more each with in-batch deltas)
K3_SYM = (2, 4, 8, 96)


def qual_decode_scan_plain(cfg: QualConfig, model: torch.Tensor,
                           lengths: torch.Tensor, words: torch.Tensor,
                           init_states: torch.Tensor, L: int,
                           with_ctx: bool = False):
    """K3's plain torch version, on any device: the reference's
    qual_decode_batch scan. With cfg.with_local the cdf adds the batch's
    in-batch deltas, clamped, frozen during a read row; each row's (ctx,
    sym) events add local_inc at its end. Returns (syms [R, L] uint8,
    final states [N] int64, words consumed 0-d int64), and with with_ctx
    the [R, L] int64 contexts the scan read as well."""
    N = cfg.n_lanes
    r_pl = lengths.shape[0] // N
    len_grid = common.to_read_grid(lengths.to(torch.int64), N)   # [N, r_pl]
    sb, b = cfg.scale_bits, cfg.hist_bits
    dev = init_states.device
    pos_ctx = [v << (b * cfg.n_hist)
               for v in _pos_bucket(torch.arange(L)).tolist()]
    x = init_states
    ptr = torch.zeros((), dtype=torch.int64, device=dev)
    lm = local_state_create(cfg, dev) if cfg.with_local else None
    sym_rows, ctx_rows = [], []
    for rd in range(r_pl):
        length = len_grid[:, rd]
        hist = torch.full((N,), cfg.hist_mask, dtype=torch.int64, device=dev)
        syms, ctxs = [], []
        for i in range(L):
            active = i < length
            ctx = hist | pos_ctx[i]
            cdf = (models.model_cdf(model, ctx, sb) if lm is None
                   else models.model_cdf_local(model, lm, ctx, sb))
            sym, f, c = rans.cdf_lookup(cdf, rans.rans_decode_slots(x, sb))
            f = torch.where(active, f, 1 << sb)
            c = torch.where(active, c, 0)
            x, ptr = rans.rans_decode_advance(x, ptr, words, f, c, sb)
            sym = torch.where(active, sym, 0)
            hist = ((hist << b) | sym) & cfg.hist_mask
            syms.append(sym)
            ctxs.append(ctx)
        sym_rows.append(torch.stack(syms, dim=1))
        ctx_rows.append(torch.stack(ctxs, dim=1))
        if lm is not None:
            pos = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
            lm = models.local_model_update(
                lm, ctx_rows[-1], sym_rows[-1], pos < length[:, None],
                inc=cfg.local_inc)
    qsyms = common.from_row_blocks(torch.stack(sym_rows)).to(torch.uint8)
    if with_ctx:
        return qsyms, x, ptr, common.from_row_blocks(torch.stack(ctx_rows))
    return qsyms, x, ptr


def _check_k3(cfg, model, lengths, words, init_states, L):
    N = cfg.n_lanes
    dev = model.device
    if not 1 <= N <= K3_MAX_LANES:
        raise ValueError(f"K3: {N} lanes, one cluster takes "
                         f"1..{K3_MAX_LANES}")
    if cfg.n_sym not in K3_SYM:
        raise ValueError(f"K3: {cfg.n_sym}-symbol models are not taken (it "
                         f"takes {', '.join(map(str, K3_SYM))})")
    want = (("model", model, torch.int32, (cfg.n_ctx, cfg.n_sym)),
            ("lengths", lengths, torch.int32, None),
            ("words", words, torch.int32, None),
            ("init_states", init_states, torch.int64, (N,)))
    common.check_kernel_tensors("K3", want, dev)
    if model.data_ptr() % 16:
        raise ValueError("K3: the model's rows must be 16-byte aligned")
    R = lengths.shape[0]
    if R % N or words.numel() < 1 or L < 0 or R * max(L, 1) >= 1 << 31:
        raise ValueError(f"K3: {R} reads over {N} lanes, {words.numel()} "
                         f"words, L = {L}")
    if not 1 <= cfg.scale_bits <= 16 or not 0 <= cfg.local_inc <= 1 << 16:
        raise ValueError(f"K3: scale_bits {cfg.scale_bits} outside [1, 16] "
                         f"or local_inc {cfg.local_inc} outside [0, 2^16]")


def _qual_decode_scan_cuda(cfg, model, lengths, words, init_states, L):
    """One K3 launch for the whole batch. Checks everything before it
    builds or launches."""
    global K3_LAUNCHES
    _check_k3(cfg, model, lengths, words, init_states, L)
    from ..ops import _build

    dev = model.device
    N = cfg.n_lanes
    R = lengths.shape[0]
    syms = torch.empty((R, L), dtype=torch.uint8, device=dev)
    fin = torch.empty((N,), dtype=torch.int64, device=dev)
    ptr = torch.empty((1,), dtype=torch.int64, device=dev)
    # the batch's delta plane, zeroed here; K3 adds each row's events
    lm = local_state_create(cfg, dev) if cfg.with_local else None
    with torch.cuda.device(dev):
        rc = _build.kernels().fqtz_qual_decode(
            model.data_ptr(), cfg.n_sym, cfg.hist_bits, cfg.n_hist,
            lengths.data_ptr(), R // N, L, words.data_ptr(), words.numel(),
            init_states.data_ptr(), N, cfg.scale_bits, syms.data_ptr(),
            fin.data_ptr(), ptr.data_ptr(),
            None if lm is None else lm.data_ptr(),
            models.local_cap(cfg.n_sym, cfg.scale_bits), cfg.local_inc,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {rc}")
    K3_LAUNCHES += 1
    return syms, fin, ptr[0]


def qual_decode_scan(cfg: QualConfig, model: torch.Tensor,
                     lengths: torch.Tensor, words: torch.Tensor,
                     init_states: torch.Tensor, L: int):
    """The quality decode scan of one batch: on a CUDA model kernel K3 (a
    failed build or launch raises; nothing falls back to the plain scan),
    on a CPU model the plain scan. model: int32 [n_ctx, n_sym]; lengths:
    int32 [R]; words: int32 [W] u16 values; init_states: int64 [N]. Returns
    (syms [R, L] uint8, final states [N] int64, words consumed 0-d int64).
    With cfg.with_local the scan adds in-batch deltas (K3 in its delta
    instantiation, or the plain scan's)."""
    kind = model.device.type
    if kind == "cuda":
        return _qual_decode_scan_cuda(cfg, model, lengths, words,
                                      init_states, L)
    if kind == "cpu":
        return qual_decode_scan_plain(cfg, model, lengths, words,
                                      init_states, L)
    raise ValueError(f"qual_decode_scan: no scan for device {model.device}")


def qual_decode_batch(cfg: QualConfig, model: torch.Tensor,
                      lengths: torch.Tensor, words: torch.Tensor,
                      init_states: torch.Tensor, L: int):
    """Returns (qsyms [R, L] int64, new_model, final_states, n_words) — the
    reference's qual_decode_batch. The model update reads the contexts from
    qual_ctx_plane of the decoded symbols: the scan's history is that plane
    (masked positions decode as 0 on both sides; the tests hold the two
    equal)."""
    syms, x, ptr = qual_decode_scan(
        cfg, model, lengths.to(torch.int32).contiguous(),
        words.to(torch.int32).contiguous(), init_states, L)
    qsyms = syms.to(torch.int64)
    pos = torch.arange(L, dtype=torch.int64, device=qsyms.device)[None, :]
    active = pos < lengths[:, None]
    new_model = models.model_update(
        model, qual_ctx_plane(cfg, qsyms).reshape(-1), qsyms.reshape(-1),
        active.reshape(-1))
    return qsyms, new_model, x, ptr
