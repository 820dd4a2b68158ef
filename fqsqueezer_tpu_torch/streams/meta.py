"""META stream: read lengths as two byte symbols (lo, hi) under two adaptive
contexts, and in sorted mode a third byte symbol a read, its LCP (the
prefix it shares with the previous read of its lane, capped at 255) under
a third context. Port of fqsqueezer_tpu/streams/meta.py. Decode is a scan
of W * r_pl steps (4 to 12 a batch at the bench geometries): on CUDA
tensors kernel K5 (csrc/slot_decode.cu), one launch a batch; on CPU
tensors meta_decode_scan_plain, the same scan as torch ops."""
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


# ---------------------------------------------------------------------------
# decode scan: kernel K5 and its plain version
# ---------------------------------------------------------------------------

# Launches of K5 (the CUDA meta decode scan) in this process; the plain scan
# never counts.
K5_LAUNCHES = 0
K5_MAX_LANES = 2048   # one cluster holds every lane (kMaxLanes in the source)


def meta_cdfs(cfg: MetaConfig, model: torch.Tensor) -> torch.Tensor:
    """int32 [W, 257]: the cdf row of each slot's context (slot k reads
    context k) of the frozen model, built once a batch."""
    ctx = torch.arange(cfg.n_per_read, dtype=torch.int64,
                       device=model.device)
    return models.model_cdf(model, ctx, cfg.scale_bits).to(
        torch.int32).contiguous()


def meta_decode_scan_plain(cfg: MetaConfig, cdfs: torch.Tensor, R: int,
                           words: torch.Tensor, init_states: torch.Tensor):
    """K5's plain torch version, on any device: the reference's
    meta_decode_batch scan, W * (R / N) steps, step t decoding slot t % W
    of every lane's read row through row t % W of cdfs. Returns (syms [R,
    W] uint8, final states [N] int64, words consumed 0-d int64)."""
    N = cfg.n_lanes
    W = cfg.n_per_read
    sb = cfg.scale_bits
    x = init_states
    ptr = torch.zeros((), dtype=torch.int64, device=init_states.device)
    ys = []
    for t in range(W * (R // N)):
        sym, f, c = rans.cdf_lookup(cdfs[t % W].expand(N, -1),
                                    rans.rans_decode_slots(x, sb))
        x, ptr = rans.rans_decode_advance(x, ptr, words, f, c, sb)
        ys.append(sym)
    return common.from_grid(torch.stack(ys), N, W).to(torch.uint8), x, ptr


def _check_k5(cfg, cdfs, R, words, init_states):
    N, W = cfg.n_lanes, cfg.n_per_read
    dev = cdfs.device
    if not 1 <= N <= K5_MAX_LANES:
        raise ValueError(f"K5: {N} lanes, one cluster takes "
                         f"1..{K5_MAX_LANES}")
    want = (("cdfs", cdfs, torch.int32, (W, N_SYM + 1)),
            ("words", words, torch.int32, None),
            ("init_states", init_states, torch.int64, (N,)))
    common.check_kernel_tensors("K5", want, dev)
    if R < 0 or R % N or words.numel() < 1 or R * W >= 1 << 31:
        raise ValueError(f"K5: {R} reads over {N} lanes, {words.numel()} "
                         f"words")
    if not 1 <= cfg.scale_bits <= 16:
        raise ValueError(f"K5: scale_bits {cfg.scale_bits} outside [1, 16]")


def _meta_decode_scan_cuda(cfg, cdfs, R, words, init_states):
    """One K5 launch for the whole batch. Checks everything before it
    builds or launches."""
    global K5_LAUNCHES
    _check_k5(cfg, cdfs, R, words, init_states)
    from ..ops import _build

    dev = cdfs.device
    N, W = cfg.n_lanes, cfg.n_per_read
    syms = torch.empty((R, W), dtype=torch.uint8, device=dev)
    fin = torch.empty((N,), dtype=torch.int64, device=dev)
    ptr = torch.empty((1,), dtype=torch.int64, device=dev)
    lib = _build.kernels()
    with torch.cuda.device(dev):
        rc = lib.fqtz_meta_decode(
            cdfs.data_ptr(), W, R // N, words.data_ptr(), words.numel(),
            init_states.data_ptr(), N, cfg.scale_bits, syms.data_ptr(),
            fin.data_ptr(), ptr.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"K5 launch failed: cudaError {rc}")
    K5_LAUNCHES += 1
    return syms, fin, ptr[0]


def meta_decode_scan(cfg: MetaConfig, cdfs: torch.Tensor, R: int,
                     words: torch.Tensor, init_states: torch.Tensor):
    """The meta decode scan of one batch: on a CUDA table kernel K5 (a
    failed build or launch raises; nothing falls back to the plain scan),
    on a CPU table the plain scan. cdfs: int32 [W, 257] (meta_cdfs);
    words: int32 [n] u16 values; init_states: int64 [N]. Returns (syms [R,
    W] uint8, final states [N] int64, words consumed 0-d int64)."""
    kind = cdfs.device.type
    if kind == "cuda":
        return _meta_decode_scan_cuda(cfg, cdfs, R, words, init_states)
    if kind == "cpu":
        return meta_decode_scan_plain(cfg, cdfs, R, words, init_states)
    raise ValueError(f"meta_decode_scan: no scan for device {cdfs.device}")


def meta_decode_batch(cfg: MetaConfig, model: torch.Tensor, R: int,
                      words: torch.Tensor, init_states: torch.Tensor):
    """Decode the (length[, lcp]) tuples of R reads. Returns (lengths [R]
    int64, lcp [R] int64 (zeros without cfg.with_lcp), new_model,
    final_states, n_words_consumed), as the reference's
    meta_decode_batch. The scan is meta_decode_scan (K5 on the card)."""
    W = cfg.n_per_read
    syms, x, ptr = meta_decode_scan(
        cfg, meta_cdfs(cfg, model), R, words.to(torch.int32).contiguous(),
        init_states)
    syms = syms.to(torch.int64)                                # [R, W]
    lengths = syms[:, 0] | (syms[:, 1] << 8)
    lcp = syms[:, 2] if cfg.with_lcp else torch.zeros_like(lengths)
    ctx = torch.arange(W, dtype=torch.int64, device=syms.device)[
        None, :].expand_as(syms)
    new_model = models.model_update(
        model, ctx.reshape(-1), syms.reshape(-1),
        torch.ones(ctx.numel(), dtype=torch.bool, device=syms.device))
    return lengths, lcp, new_model, x, ptr
