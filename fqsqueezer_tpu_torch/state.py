"""Codec state to and from numpy, in the reference package's layout.

The numpy form is a dict of the arrays of fqsqueezer_tpu.pipeline.CodecState
after jax.device_get, with the reference's dtypes: "siv", "s_tc", "b_tc"
(uint32, from CodecState.dna), "model" (int32, CodecState.dna.model), "meta",
"qual" and "id" (int32; "qual" and "id" may be None or absent), and "pe"
(CodecState.dna.pe: None or absent, or the pair table's four uint32
planes and the pe model, int32, as a tuple). It lets both
packages start from the same mid-stream state, and checkpoint.py writes
group snapshots through it. The u32 arrays are carried in int64 tensors:
masked to 32 bits on the way out, zero-extended on the way in.
"""
from __future__ import annotations

import numpy as np
import torch

from ._u32 import MASK32
from .pipeline import CodecState
from .streams.dna import DnaState

_U32 = ("siv", "s_tc", "b_tc")
_I32 = ("model", "meta", "qual", "id")


def state_from_numpy(d: dict, device=None) -> CodecState:
    """CodecState on `device` from a dict of numpy arrays (see module
    docstring). u32 arrays are carried in int64."""
    def t(k):
        if d.get(k) is None:
            return None
        a = np.asarray(d[k])
        dt = torch.int64 if k in _U32 else torch.int32
        return torch.from_numpy(a.astype(np.int64 if k in _U32
                                         else np.int32)).to(device, dt)

    pe = None
    if d.get("pe") is not None:
        pe = tuple(torch.from_numpy(np.asarray(a).astype(np.int64)).to(device)
                   for a in d["pe"][:4]) + (
            torch.from_numpy(np.asarray(d["pe"][4]).astype(np.int32)).to(
                device),)
    return CodecState(
        dna=DnaState(siv=t("siv"), s_tc=t("s_tc"), b_tc=t("b_tc"),
                     model=t("model"), pe=pe),
        meta=t("meta"), qual=t("qual"), id=t("id"))


def state_to_numpy(state: CodecState) -> dict:
    """dict of numpy arrays in the reference package's dtypes."""
    src = {"siv": state.dna.siv, "s_tc": state.dna.s_tc,
           "b_tc": state.dna.b_tc, "model": state.dna.model,
           "meta": state.meta, "qual": state.qual, "id": state.id}
    out = {k: None if v is None else _u32(v) if k in _U32 else
           v.cpu().numpy().astype(np.int32) for k, v in src.items()}
    pe = state.dna.pe
    out["pe"] = None if pe is None else tuple(_u32(a) for a in pe[:4]) + (
        pe[4].cpu().numpy().astype(np.int32),)
    return out


def _u32(t: torch.Tensor) -> np.ndarray:
    return (t & MASK32).cpu().numpy().astype(np.uint32)
