"""Deterministic synthetic FASTQ corpora for tests and benchmarks.

The port's own copy of the generators of fqsqueezer_tpu/utils/corpus.py:
reads sampled from a random genome, or from one with real-genome-like
structure (the bench's se_real row), and mate pairs from both ends of
fragments (write_pe_corpus, the bench's PE row), with sequencing errors,
occasional N's, and Illumina-like quality profiles. The same seed gives
the same file bytes as the reference package's generators. One more is
the port's own: a low-complexity corpus (write_repeat_corpus).
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


def _apply_errors(rng, codes, err_rate=0.005, n_rate=0.001):
    err = rng.random(codes.shape) < err_rate
    codes = np.where(err, (codes + rng.integers(1, 4, codes.shape)) % 4,
                     codes).astype(np.int8)
    return np.where(rng.random(codes.shape) < n_rate, 4, codes).astype(np.int8)


def write_pe_corpus(path1: str, path2: str, n_pairs: int, read_len: int,
                    genome_bases: int, seed: int = 0,
                    frag_mean: int = 250, frag_sd: int = 30) -> None:
    """Paired-end corpus: mates from opposite ends of variable-length
    fragments (mate2 on the reverse strand), Illumina-like qualities."""
    from ..io.fastq import write_fastq

    genome = make_genome(genome_bases, seed)
    rng = np.random.default_rng(seed + 1)
    frag_len = np.maximum(rng.normal(frag_mean, frag_sd, n_pairs).astype(int),
                          read_len + 10)
    starts = rng.integers(0, genome_bases - frag_len.max() - 1, n_pairs)
    idx1 = starts[:, None] + np.arange(read_len)[None, :]
    r1 = genome[idx1].astype(np.int8)
    ends = starts + frag_len
    idx2 = ends[:, None] - 1 - np.arange(read_len)[None, :]
    r2 = (3 - genome[idx2]).astype(np.int8)      # reverse strand
    # strand flip: half the pairs swap mate roles
    flip = rng.random(n_pairs) < 0.5
    r1[flip], r2[flip] = r2[flip].copy(), r1[flip].copy()
    r1 = _apply_errors(rng, r1)
    r2 = _apply_errors(rng, r2)
    pos = np.arange(read_len)[None, :]
    mean_q = 37.0 - np.maximum(0, pos - read_len * 0.6) * 0.15
    q1 = np.clip(rng.normal(mean_q, 3.0, r1.shape), 2, 41)
    q2 = np.clip(rng.normal(mean_q, 3.0, r2.shape), 2, 41)
    q1 = np.where(r1 == 4, 2, q1).astype(np.uint8)
    q2 = np.where(r2 == 4, 2, q2).astype(np.uint8)
    lengths = np.full(n_pairs, read_len, np.int32)
    ids1 = [f"SIM.{i} {i}/1".encode() for i in range(n_pairs)]
    ids2 = [f"SIM.{i} {i}/2".encode() for i in range(n_pairs)]
    write_fastq(path1, r1.astype(np.uint8), q1, lengths, ids1)
    write_fastq(path2, r2.astype(np.uint8), q2, lengths, ids2)


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


def write_repeat_corpus(path: str, n_reads: int, read_len: int,
                        seed: int = 0, odd=()) -> None:
    """A low-complexity corpus: every read one base repeated (poly-A),
    except the reads at the indices `odd`, which are windows of one
    random sequence of twice read_len bases drawn from `seed` (so their
    k-mers recur). Poly-A k-mers all fall in one table bucket, so a batch
    of such reads loads one bucket range with most of its s/b events (the
    owner-routed exchange's worst case)."""
    from ..io.fastq import write_fastq

    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 2 * read_len, dtype=np.int8)
    odd = list(odd)
    starts = rng.integers(0, read_len + 1, len(odd))
    codes = np.zeros((n_reads, read_len), np.uint8)
    for r, s0 in zip(odd, starts):
        codes[r] = genome[s0:s0 + read_len]
    quals = rng.integers(20, 41, (n_reads, read_len)).astype(np.uint8)
    lengths = np.full(n_reads, read_len, np.int32)
    ids = [f"SIM.{i} {i}".encode() for i in range(n_reads)]
    write_fastq(path, codes, quals, lengths, ids)
