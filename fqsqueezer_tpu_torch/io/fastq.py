"""Host-side FASTQ parsing and reconstruction — fully vectorized numpy.

The port's own copy of fqsqueezer_tpu/io/fastq.py's in-RAM reader and
writers: the whole input is scanned once with vectorized newline finding
and gathered into padded [R, L] integer matrices the device consumes
directly, or block-streamed in chunks (stream_fastq) for inputs above
the CLI's streaming threshold. The native scanner (io/native.py) and the
pure-numpy path give the same arrays. sort_order and the external bin
sort (external_sort_stream) give sorted mode's read order.

Symbols: A,C,G,T,N -> 0..4; any other sequence byte maps to N. Qualities
are stored as (byte - 33), clipped to [0, 95].
"""
from __future__ import annotations

import dataclasses

import numpy as np

# base byte -> code (A=0 C=1 G=2 T=3, everything else = N = 4)
BASE_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    BASE_LUT[_b] = _i
    BASE_LUT[ord(chr(_b).lower())] = _i
CODE_TO_BASE = np.frombuffer(b"ACGTN", dtype=np.uint8).copy()


@dataclasses.dataclass
class FastqData:
    """A parsed FASTQ file as padded matrices.

    codes: [R, L] uint8 base codes (0..4), zero beyond lengths.
    quals: [R, L] uint8 quality values (phred, 0..95), zero beyond lengths.
    lengths: [R] int32.
    ids: raw header bytes (without '@' or newline), list of bytes objects.
    """

    codes: np.ndarray
    quals: np.ndarray
    lengths: np.ndarray
    ids: list

    @property
    def n_reads(self) -> int:
        return int(self.lengths.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.codes.shape[1])


def parse_fastq_bytes(data: np.ndarray) -> FastqData:
    """Parse a uint8 array of FASTQ bytes (4 lines per record)."""
    if data.size and data[-1] != 10:
        data = np.concatenate([data, np.array([10], np.uint8)])
    nl = np.flatnonzero(data == 10)
    n_lines = nl.size - (nl.size % 4)
    if n_lines == 0:
        return FastqData(np.zeros((0, 0), np.uint8), np.zeros((0, 0), np.uint8),
                         np.zeros((0,), np.int32), [])
    nl = nl[:n_lines]
    starts = np.empty(n_lines, np.int64)
    starts[0] = 0
    starts[1:] = nl[:-1] + 1
    ends = nl.copy()
    # tolerate \r\n
    crlf = ends > starts
    crlf[crlf] = data[ends[crlf] - 1] == 13
    ends[crlf] -= 1

    R = n_lines // 4
    seq_s, seq_e = starts[1::4], ends[1::4]
    qual_s, qual_e = starts[3::4], ends[3::4]
    hdr_s, hdr_e = starts[0::4], ends[0::4]
    lengths = (seq_e - seq_s).astype(np.int32)
    L = int(lengths.max()) if R else 0

    pos = np.arange(L, dtype=np.int64)[None, :]
    valid = pos < lengths[:, None]
    seq_idx = np.minimum(seq_s[:, None] + pos, data.size - 1)
    codes = np.where(valid, BASE_LUT[data[seq_idx]], 0).astype(np.uint8)
    # clamp to the quality line's own extent: on malformed records with a
    # short quality line, degrade to phred 0 like the native parser's qlen
    # zero-fill (fqtz_fill_records) instead of reading adjacent lines
    qlen = (qual_e - qual_s)[:, None]
    qual_idx = np.minimum(qual_s[:, None] + pos, data.size - 1)
    quals = np.where(valid & (pos < qlen), data[qual_idx], 33).astype(np.int16) - 33
    quals = np.clip(quals, 0, 95).astype(np.uint8)

    dview = data.tobytes()
    ids = [dview[int(s) + 1:int(e)] if e > s else b"" for s, e in zip(hdr_s, hdr_e)]
    return FastqData(codes=codes, quals=quals, lengths=lengths, ids=ids)


def concat_fastq(parts: list) -> "FastqData":
    """Concatenate parsed files: every input of an @file_list goes into one
    archive."""
    parts = [d for d in parts if d.n_reads]
    if not parts:
        return FastqData(np.zeros((0, 0), np.uint8), np.zeros((0, 0), np.uint8),
                         np.zeros((0,), np.int32), [])
    L = max(d.max_len for d in parts)
    padL = lambda a: np.pad(a, ((0, 0), (0, L - a.shape[1])))
    codes = np.concatenate([padL(d.codes) for d in parts])
    quals = np.concatenate([padL(d.quals) for d in parts])
    lengths = np.concatenate([d.lengths for d in parts])
    ids = [i for d in parts for i in d.ids]
    return FastqData(codes=codes, quals=quals, lengths=lengths, ids=ids)


def read_fastq(path: str, use_native: bool = True) -> FastqData:
    data = np.fromfile(path, dtype=np.uint8)
    if use_native:
        from . import native

        out = native.parse_fastq_bytes_native(data)
        if out is not None:
            return out
    return parse_fastq_bytes(data)


def stream_fastq(paths, chunk_bytes: int = 64 << 20, use_native: bool = True):
    """Yield FastqData chunks of ~chunk_bytes from one or more FASTQ files —
    the block-streamed input path (reference 16 MiB read blocks,
    reads_block.h:35-76, io.h:31-120): host memory stays O(chunk) no matter
    the file size. Records never straddle a chunk: each block is cut at the
    last complete 4-line record and the tail is carried into the next."""
    if isinstance(paths, (str, bytes)):
        paths = [paths]
    from . import native

    def parse(buf: bytes) -> FastqData:
        data = np.frombuffer(buf, np.uint8)
        if use_native:
            out = native.parse_fastq_bytes_native(data)
            if out is not None:
                return out
        return parse_fastq_bytes(data)

    for path in paths:
        with open(path, "rb") as f:
            tail = b""
            while True:
                blob = f.read(chunk_bytes)
                if not blob:
                    if tail:
                        yield parse(tail)
                    break
                buf = tail + blob
                nl = np.flatnonzero(np.frombuffer(buf, np.uint8) == 10)
                cut_nl = nl.size - (nl.size % 4)
                if cut_nl == 0:       # no complete record yet: keep reading
                    tail = buf
                    continue
                cut = int(nl[cut_nl - 1]) + 1
                tail = buf[cut:]
                yield parse(buf[:cut])


def _sort_bin_ids(codes: np.ndarray, lengths: np.ndarray,
                  prefix: int = 4) -> np.ndarray:
    """Bin index = the leading `prefix` bytes of the sort key (collated
    base + 1, 0 past the read end) as a base-5 integer. The bin id is the
    major key of sort_order, so processing bins in id order, each sorted
    in RAM, is a full external sort (reference 256-bin split,
    application.cpp:349-506, bin_name :1595-1609)."""
    R, L = codes.shape
    collated = np.where(codes == 4, 3, codes).astype(np.int32) + 1
    out = np.zeros(R, np.int32)
    for i in range(prefix):
        byte = np.where(i < lengths, collated[:, i] if i < L else 0, 0)
        out = out * 5 + byte
    return out


def external_sort_stream(paths, chunk_bytes: int = 64 << 20,
                         tmpdir: str | None = None, prefix: int = 4):
    """Sorted-mode input at WGS scale: stream chunks, scatter records into
    5^prefix on-disk bins by sort-key prefix, then yield each bin (sorted in
    RAM) in key order. Host memory stays O(chunk + largest bin). Ties keep
    file order at every step, so the concatenated output equals the in-RAM
    sort_order permutation exactly. ids are NOT preserved (callers restrict
    to id-mode NONE)."""
    import os
    import tempfile

    td = tempfile.mkdtemp(prefix="fqtz_bins_", dir=tmpdir)
    n_bins = 5 ** prefix
    handles: dict = {}
    try:
        for chunk in stream_fastq(paths, chunk_bytes):
            if chunk.n_reads == 0:
                continue
            bins = _sort_bin_ids(chunk.codes, chunk.lengths, prefix)
            order = np.argsort(bins, kind="stable")
            bs = bins[order]
            uniq, starts = np.unique(bs, return_index=True)
            bounds = list(starts[1:]) + [len(bs)]
            for b, s, e in zip(uniq, starts, bounds):
                rows = order[s:e]
                buf = render_fastq(chunk.codes[rows], chunk.quals[rows],
                                   chunk.lengths[rows],
                                   np.zeros(0, np.uint8),
                                   np.zeros(len(rows), np.int64))
                f = handles.get(int(b))
                if f is None:
                    f = open(os.path.join(td, f"{int(b):05d}.bin"), "wb")
                    handles[int(b)] = f
                f.write(buf.tobytes())
        for f in handles.values():
            f.close()
        for b in sorted(handles):
            path = os.path.join(td, f"{b:05d}.bin")
            d = read_fastq(path)
            os.remove(path)
            order = sort_order(d.codes, d.lengths)
            yield FastqData(d.codes[order], d.quals[order],
                            d.lengths[order], [d.ids[i] for i in order])
    finally:
        for f in handles.values():
            if not f.closed:
                f.close()
        for name in os.listdir(td):
            os.remove(os.path.join(td, name))
        os.rmdir(td)


def render_fastq(codes: np.ndarray, quals: np.ndarray, lengths: np.ndarray,
                 id_src: np.ndarray, id_lens: np.ndarray) -> np.ndarray:
    """Render records to a flat uint8 byte buffer (vectorized).
    id_src: flat uint8 id bytes (concatenated), id_lens: [R] int64."""
    R, L = codes.shape
    id_lens = id_lens.astype(np.int64)
    lens64 = lengths.astype(np.int64)
    # per-record size: '@'+id+'\n' + seq+'\n' + '+\n' + qual+'\n'
    rec = 1 + id_lens + 1 + lens64 + 1 + 2 + lens64 + 1
    offs = np.zeros(R + 1, np.int64)
    np.cumsum(rec, out=offs[1:])
    out = np.empty(int(offs[-1]), np.uint8)

    pos = np.arange(L, dtype=np.int64)[None, :]
    valid = pos < lens64[:, None]

    out[offs[:-1]] = ord("@")
    id_dst = offs[:-1] + 1
    if id_src.size:
        id_off = np.zeros(R + 1, np.int64)
        np.cumsum(id_lens, out=id_off[1:])
        max_il = int(id_lens.max())
        ipos = np.arange(max_il, dtype=np.int64)[None, :]
        ivalid = ipos < id_lens[:, None]
        dst = (id_dst[:, None] + ipos)[ivalid]
        src = (id_off[:-1][:, None] + ipos)[ivalid]
        out[dst] = id_src[src]
    out[id_dst + id_lens] = 10

    seq_dst = id_dst + id_lens + 1
    dst = (seq_dst[:, None] + pos)[valid]
    out[dst] = CODE_TO_BASE[codes[valid]]
    out[seq_dst + lens64] = 10
    plus = seq_dst + lens64 + 1
    out[plus] = ord("+")
    out[plus + 1] = 10
    qual_dst = plus + 2
    dst = (qual_dst[:, None] + pos)[valid]
    out[dst] = quals[valid].astype(np.uint8) + 33
    out[qual_dst + lens64] = 10
    return out


def _flat_ids(ids: list | None, R: int):
    if ids is None:
        return np.zeros(0, np.uint8), np.zeros(R, np.int64)
    id_lens = (np.fromiter((len(s) for s in ids), np.int64, count=R)
               if R else np.zeros(0, np.int64))
    flat = b"".join(ids)
    return np.frombuffer(flat, np.uint8) if flat else np.zeros(0, np.uint8), \
        id_lens


def write_fastq(path: str, codes: np.ndarray, quals: np.ndarray,
                lengths: np.ndarray, ids: list | None,
                use_native: bool = True) -> None:
    """Reconstruct a FASTQ file. ids=None emits bare '@' lines (the id-none
    reconstruction)."""
    if use_native:
        from . import native

        if native.write_fastq_native(path, codes, quals, lengths, ids):
            return
    id_src, id_lens = _flat_ids(ids, codes.shape[0])
    render_fastq(codes, quals, lengths, id_src, id_lens).tofile(path)


class FastqWriter:
    """Streamed FASTQ reconstruction: one vectorized render + append per
    decoded batch, so decompression's host memory stays O(batch) instead of
    O(file). id bytes may arrive as a padded matrix straight from the
    device."""

    def __init__(self, path: str):
        self.f = open(path, "wb")
        self.n_reads = 0

    def write_batch(self, codes, quals, lengths, ids=None,
                    id_mat=None, id_lens=None) -> None:
        R = codes.shape[0]
        if id_mat is not None:
            mask = np.arange(id_mat.shape[1])[None, :] < id_lens[:, None]
            id_src = np.ascontiguousarray(id_mat[mask])
            il = id_lens.astype(np.int64)
        else:
            id_src, il = _flat_ids(ids, R)
        buf = render_fastq(codes, quals, lengths, id_src, il)
        self.f.write(buf.tobytes())
        self.n_reads += R

    def close(self) -> None:
        self.f.close()


def sort_order(codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Lexicographic read ordering for sorted mode: sequence bytes with N
    collated as T, then length, then exact bytes (reference CSortedFASTQFile
    sort, io.h:499-528). Returns the permutation."""
    R, L = codes.shape
    if R == 0:
        return np.zeros(0, np.int64)
    collated = np.where(codes == 4, 3, codes).astype(np.uint8)
    pos = np.arange(L)[None, :]
    valid = pos < lengths[:, None]
    # pad with 0 (< any real code + 1) so a read that is a strict prefix of
    # another sorts first, matching std::lexicographical_compare semantics
    key = np.where(valid, collated + 1, 0).astype(np.uint8)
    exact = np.where(valid, codes, 0).astype(np.uint8)
    # ONE memcmp-based argsort over fixed-width byte strings [key | exact]
    # instead of np.lexsort's 2L stable counting passes (minutes at 1M x 150).
    # numpy 'S' compare strips trailing NULs — order-preserving here, since 0
    # is the padding byte and the minimum value.
    comp = np.empty((R, 2 * L), np.uint8)
    comp[:, :L] = key
    comp[:, L:] = exact
    as_str = np.frombuffer(comp.tobytes(), dtype=f"S{2 * L}")
    return np.argsort(as_str, kind="stable")
