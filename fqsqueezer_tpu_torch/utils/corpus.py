"""Deterministic synthetic FASTQ corpora for tests and benchmarks.

The port's own copy of the single-end generator of
fqsqueezer_tpu/utils/corpus.py: reads sampled from a random genome with
sequencing errors, occasional N's, and Illumina-like quality profiles. The
same seed gives the same file bytes as the reference package's generator.
The paired-end and structured-genome generators are copied when the slices
that need them come.
"""
from __future__ import annotations

import numpy as np


def make_genome(n_bases: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=n_bases, dtype=np.int8)


def sample_reads(genome: np.ndarray, n_reads: int, read_len: int,
                 seed: int = 1, err_rate: float = 0.005,
                 n_rate: float = 0.001):
    """Returns (codes [R, L] int8 with N=4, quals [R, L] uint8 phred)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(genome) - read_len, size=n_reads)
    idx = starts[:, None] + np.arange(read_len)[None, :]
    codes = genome[idx].astype(np.int8)
    # strand: half the reads are reverse-complemented
    rc = rng.random(n_reads) < 0.5
    codes[rc] = (3 - codes[rc])[:, ::-1]
    # substitution errors
    err = rng.random(codes.shape) < err_rate
    codes = np.where(err, (codes + rng.integers(1, 4, codes.shape)) % 4,
                     codes).astype(np.int8)
    # N's
    codes = np.where(rng.random(codes.shape) < n_rate, 4, codes).astype(np.int8)
    # Illumina-like quality: high plateau with noisy 3' droop
    pos = np.arange(read_len)[None, :]
    mean_q = 37.0 - np.maximum(0, pos - read_len * 0.6) * 0.15
    quals = np.clip(rng.normal(mean_q, 3.0, codes.shape), 2, 41)
    quals = np.where(codes == 4, 2, quals).astype(np.uint8)
    return codes, quals


def write_fastq_corpus(path: str, n_reads: int, read_len: int,
                       genome_bases: int, seed: int = 0) -> None:
    from ..io.fastq import write_fastq

    genome = make_genome(genome_bases, seed)
    codes, quals = sample_reads(genome, n_reads, read_len, seed + 1)
    lengths = np.full(n_reads, read_len, np.int32)
    ids = [f"@SIM.{i} {i} length={read_len}".encode()[1:] for i in range(n_reads)]
    write_fastq(path, codes.astype(np.uint8), quals, lengths, ids)
