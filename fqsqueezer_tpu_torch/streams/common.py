"""Lane-grid plumbing shared by all stream codecs.

Port of fqsqueezer_tpu/streams/common.py: a batch of R reads (R a multiple of
n_lanes N) runs on N interleaved rANS lanes; lane l owns the contiguous read
range [l*R/N, (l+1)*R/N) and steps through it read-major, position-minor.
"""
from __future__ import annotations

import torch


def to_grid(x: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """[R, L] per-read values -> [T, N] lane grid with T = (R/N)*L,
    t = read_in_lane * L + position."""
    R, L = x.shape
    r_pl = R // n_lanes
    return x.reshape(n_lanes, r_pl, L).permute(1, 2, 0).reshape(
        r_pl * L, n_lanes)


def lane_grid(x: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """to_grid as the contiguous int32 grid the rANS walk (K1) takes."""
    return to_grid(x, n_lanes).to(torch.int32).contiguous()


def from_grid(y: torch.Tensor, n_lanes: int, L: int) -> torch.Tensor:
    """[T, N] -> [R, L]."""
    T, N = y.shape
    r_pl = T // L
    return y.reshape(r_pl, L, N).permute(2, 0, 1).reshape(N * r_pl, L)


def to_read_grid(x: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """[R] per-read values -> [N, r_pl] (lane-major)."""
    return x.reshape(n_lanes, -1)


def to_row_blocks(x: torch.Tensor, n_lanes: int) -> torch.Tensor:
    """[R, L, ...] -> [r_pl, N, L, ...]: row rd holds read rd of every lane
    (read r = lane * r_pl + rd)."""
    R, L = x.shape[:2]
    r_pl = R // n_lanes
    return x.reshape((n_lanes, r_pl, L) + tuple(x.shape[2:])).transpose(0, 1)


def from_row_blocks(y: torch.Tensor) -> torch.Tensor:
    """[r_pl, N, L, ...] -> [R, L, ...]."""
    r_pl, N, L = y.shape[:3]
    return y.transpose(0, 1).reshape((N * r_pl, L) + tuple(y.shape[3:]))


def pad_reads(n: int, n_lanes: int) -> int:
    """Smallest multiple of n_lanes >= n."""
    return -(-n // n_lanes) * n_lanes


def check_kernel_tensors(kernel: str, want, dev) -> None:
    """Raise ValueError unless every (name, tensor, dtype, shape) of `want`
    is a contiguous tensor of that dtype on `dev` and of that shape (shape
    None: any 1-d length): the checks a decode kernel's wrapper makes
    before it builds or launches."""
    for name, t, dt, shape in want:
        if (t.dtype != dt or t.device != dev or not t.is_contiguous()
                or t.dim() != (1 if shape is None else len(shape))
                or (shape is not None and tuple(t.shape) != shape)):
            raise ValueError(f"{kernel}: {name} must be a contiguous {dt} "
                             f"tensor on {dev}" + ("" if shape is None else
                                                   f" of shape {shape}")
                             + f", got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
