"""Checkpoint and resume: codec-state snapshots at group boundaries.

The archive is group-framed and the whole codec state is a handful of dense
integer arrays, so a snapshot taken after a group's table growth is all a
decoder needs to start at the next group: to resume an interrupted decode,
or to decode one group of a large archive without the groups before it.

A snapshot is a plain .npz of the reference package's arrays
(fqsqueezer_tpu/checkpoint.py): the same keys, dtypes and shapes — uint32
for the SIV, the K2 s/b tables and the pair-table planes, int32 for the
models — so each package resumes from the other's snapshot. This package
carries those u32 values in int64 tensors (see _u32.py): state.py masks
them to 32 bits on the way out and zero-extends them on the way in.
"""
from __future__ import annotations

import os

import numpy as np

from .pipeline import CodecState, resolve_device
from .state import state_from_numpy, state_to_numpy

# state.py's keys -> the snapshot's; the pe tuple is dna_pe_0 .. dna_pe_4
_KEYS = {"siv": "dna_siv", "s_tc": "dna_s_tc", "b_tc": "dna_b_tc",
         "model": "dna_model", "meta": "meta", "qual": "qual", "id": "id"}
_U32 = ("dna_siv", "dna_s_tc", "dna_b_tc", "dna_pe_0", "dna_pe_1",
        "dna_pe_2", "dna_pe_3")


def state_to_arrays(state: CodecState) -> dict:
    """The snapshot's arrays: numpy, in the reference's keys and dtypes."""
    d = state_to_numpy(state)
    out = {_KEYS[k]: v for k, v in d.items() if k in _KEYS and v is not None}
    for i, a in enumerate(d["pe"] or ()):
        out[f"dna_pe_{i}"] = a
    return out


def arrays_to_state(d: dict, device=None) -> CodecState:
    """CodecState from a snapshot's arrays, on `device` (default: the first
    CUDA card, see pipeline.resolve_device). The u32 arrays must be uint32:
    read through int32 they would sign-extend."""
    for k in _U32:
        if k in d and np.asarray(d[k]).dtype != np.uint32:
            raise ValueError(f"snapshot array {k}: {np.asarray(d[k]).dtype}, "
                             f"want uint32")
    arrays = {k: d.get(v) for k, v in _KEYS.items()}
    if "dna_pe_0" in d:
        arrays["pe"] = tuple(d[f"dna_pe_{i}"] for i in range(5))
    return state_from_numpy(arrays, resolve_device(device))


def save_state(state: CodecState, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **state_to_arrays(state))


def load_state(path: str, device=None) -> CodecState:
    with np.load(path) as z:
        return arrays_to_state(dict(z.items()), device)


def snapshot_path(prefix: str, group_idx: int) -> str:
    return f"{prefix}.g{group_idx:05d}.npz"
