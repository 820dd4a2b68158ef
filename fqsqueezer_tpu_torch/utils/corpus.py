"""Deterministic synthetic FASTQ corpora for tests and benchmarks.

The port's own copy of the single-end generators of
fqsqueezer_tpu/utils/corpus.py: reads sampled from a random genome, or from
one with real-genome-like structure (the bench's se_real row), with
sequencing errors, occasional N's, and Illumina-like quality profiles. The
same seed gives the same file bytes as the reference package's generators.
The paired-end generator is copied when the slice that needs it comes.
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


def make_genome_realistic(n_bases: int, seed: int = 0) -> np.ndarray:
    """Genome with real-genome-like structure the uniform-random generator
    lacks: order-2 Markov composition, interspersed repeat families (mutated
    copies), tandem/homopolymer runs — the workloads that reward deeper
    context modeling and repeat-aware k-mer statistics."""
    rng = np.random.default_rng(seed)
    # compositional heterogeneity: isochore-like blocks, each with its own
    # skewed base mixture (vectorized stand-in for a Markov backbone)
    block = 1000
    n_blocks = -(-n_bases // block)
    mixes = rng.dirichlet(np.full(4, 0.8), size=n_blocks)  # [n_blocks, 4]
    cum = np.cumsum(mixes, axis=1)
    u = rng.random(n_bases)
    blk = np.arange(n_bases) // block
    g = (u[:, None] > cum[blk, :3]).sum(axis=1).astype(np.int8)
    # repeat families: ~8% of the genome as mutated copies of short elements
    n_fam = max(1, n_bases // 500_000)
    for f in range(n_fam):
        elem_len = int(rng.integers(300, 3000))
        elem = rng.integers(0, 4, elem_len).astype(np.int8)
        n_copies = max(2, int(0.08 * n_bases / n_fam / elem_len))
        for _ in range(n_copies):
            copy = elem.copy()
            mut = rng.random(elem_len) < 0.03
            copy[mut] = (copy[mut] + rng.integers(1, 4, mut.sum())) % 4
            if rng.random() < 0.5:
                copy = (3 - copy)[::-1]
            at = int(rng.integers(0, n_bases - elem_len))
            g[at:at + elem_len] = copy
    # homopolymer / tandem runs
    n_runs = n_bases // 20_000
    for _ in range(n_runs):
        run = int(rng.integers(8, 40))
        at = int(rng.integers(0, n_bases - run))
        g[at:at + run] = rng.integers(0, 4)
    return g


def write_fastq_corpus_realistic(path: str, n_reads: int, read_len: int,
                                 genome_bases: int, seed: int = 0) -> None:
    from ..io.fastq import write_fastq

    genome = make_genome_realistic(genome_bases, seed)
    codes, quals = sample_reads(genome, n_reads, read_len, seed + 1)
    lengths = np.full(n_reads, read_len, np.int32)
    ids = [f"SIM.{i} {i} length={read_len}".encode() for i in range(n_reads)]
    write_fastq(path, codes.astype(np.uint8), quals, lengths, ids)
