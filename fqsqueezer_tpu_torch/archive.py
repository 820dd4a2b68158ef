"""Archive container: self-describing header + varint-framed group sections.

The port's own copy of fqsqueezer_tpu/archive.py, writer and reader: a JSON
params header, then one section per group holding, per logical stream, the
final lane states the decoder starts from and each batch's rANS word
payload. The bytes are the reference package's, so either package reads the
other's archives.
"""
from __future__ import annotations

import io
from typing import BinaryIO, List, Tuple

import numpy as np

MAGIC = b"FQTZ04"  # 04: file-order id chains (03: tokenized id stream)


def write_uvarint(f: BinaryIO, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            f.write(bytes([b | 0x80]))
        else:
            f.write(bytes([b]))
            return


def read_uvarint(f: BinaryIO) -> int:
    v = 0
    shift = 0
    while True:
        b = f.read(1)
        if not b:
            raise EOFError("truncated varint")
        v |= (b[0] & 0x7F) << shift
        if not (b[0] & 0x80):
            return v
        shift += 7


class ArchiveWriter:
    """Groups chain rANS lane states across batches: the encoder encodes a
    group's batches in reverse, so the decoder's state at the end of batch k
    equals its start state for batch k+1, and only ONE state block per stream
    per group is stored (vs per batch) — see pipeline.py."""

    def __init__(self, path: str, header_blob: bytes):
        self.f = open(path, "wb")
        self.f.write(MAGIC)
        write_uvarint(self.f, len(header_blob))
        self.f.write(header_blob)

    def write_group(self, states: List[np.ndarray],
                    batches: List[Tuple[int, int, List[Tuple[np.ndarray, int]]]],
                    payload_crc: int = 0) -> None:
        """states: per-stream uint32[n_lanes] decoder start states.
        batches: list of (n_reads, max_len, [(words, n_words) per stream]).
        payload_crc: crc32 of the group's plaintext payload — the decoder
        recomputes it from decoded data and fails loudly on divergence."""
        f = self.f
        write_uvarint(f, payload_crc)
        write_uvarint(f, len(states))
        for st in states:
            f.write(np.asarray(st, dtype="<u4").tobytes())
        write_uvarint(f, len(batches))
        for n_reads, max_len, streams in batches:
            write_uvarint(f, n_reads)
            write_uvarint(f, max_len)
            for words, n_words in streams:
                n_words = int(n_words)
                write_uvarint(f, n_words)
                f.write(np.asarray(words[:n_words], dtype="<u4")
                        .astype("<u2").tobytes())

    def write_blob(self, blob: bytes) -> None:
        """Raw auxiliary section (e.g. host-coded id metadata)."""
        write_uvarint(self.f, len(blob))
        self.f.write(blob)

    def close(self) -> None:
        self.f.close()


class ArchiveReader:
    def __init__(self, path: str):
        self.f = open(path, "rb")
        if self.f.read(len(MAGIC)) != MAGIC:
            raise ValueError("not an fqsqueezer_tpu archive")
        hlen = read_uvarint(self.f)
        self.header_blob = self.f.read(hlen)

    def read_group(self, n_lanes: int):
        """Returns (states per stream, [(n_reads, max_len, [(words, n_words)
        per stream])]) or None at EOF."""
        f = self.f
        try:
            payload_crc = read_uvarint(f)
        except EOFError:
            return None
        n_streams = read_uvarint(f)
        states = [np.frombuffer(f.read(4 * n_lanes), dtype="<u4")
                  for _ in range(n_streams)]
        n_batches = read_uvarint(f)
        batches = []
        for _ in range(n_batches):
            n_reads = read_uvarint(f)
            max_len = read_uvarint(f)
            streams = []
            for _ in range(n_streams):
                n_words = read_uvarint(f)
                words = np.frombuffer(f.read(2 * n_words),
                                      dtype="<u2").astype(np.uint32)
                streams.append((words, n_words))
            batches.append((n_reads, max_len, streams))
        return states, batches, payload_crc

    def read_blob(self) -> bytes:
        return self.f.read(read_uvarint(self.f))

    def close(self) -> None:
        self.f.close()
