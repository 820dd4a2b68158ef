"""End to end: the port's archives against the reference package's.

On a tiny multi-group geometry (several groups, table growth and an SIV
prune), fqsqueezer_tpu_torch.pipeline.compress_file must write the same
bytes as fqsqueezer_tpu.pipeline.compress_file, and the reference decoder
must give the reads back. Each package gets its own Params, built the same
way from its own params module. Also: the port's compress path imports no
JAX and nothing of the reference package, and the CLI refuses every mode it
does not have with one line. Everything here asks for the CPU
(`device="cpu"`, `--device cpu`).
"""
import contextlib
import hashlib
import importlib.util
import io
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from fqsqueezer_tpu import params as jparams
from fqsqueezer_tpu import pipeline as jp
from fqsqueezer_tpu.io import fastq
from fqsqueezer_tpu.streams.quality import qual_maps
from fqsqueezer_tpu.utils.corpus import write_fastq_corpus
from fqsqueezer_tpu_torch import cli
from fqsqueezer_tpu_torch import params as tparams
from fqsqueezer_tpu_torch import pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_MEM = 30_000   # a few tiny batches per group


def tiny_params(mod):
    """Tiny geometry with undersized s/b tables (2^8 buckets) and SIV (cap
    7), so the tables grow and the SIV gets pruned. mod: the params module
    of the package the Params are for."""
    p = mod.Params()
    p.genome_size = 1
    p.adjust_kmer_sizes()
    p.n_lanes = 8
    p.max_batch_reads = 64
    p.smer_log2_buckets = 8
    p.bmer_log2_buckets = 8
    p.dna_siv_cap = 7
    p.dna_mode = mod.DnaMode.SE_ORIGINAL
    p.quality_mode = mod.QualityMode.ILLUMINA_8
    p.id_mode = mod.IdMode.NONE
    p.verbosity = 1
    return p


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pipeline")
    src = str(d / "in.fastq")
    write_fastq_corpus(src, 600, 40, 60_000, seed=5)
    jarc, tarc = str(d / "jax.fqst"), str(d / "torch.fqst")
    jstats = jp.compress_file(tiny_params(jparams), src, jarc,
                              group_mem_bytes=GROUP_MEM)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        tstats = pipeline.compress_file(tiny_params(tparams), src, tarc,
                                        group_mem_bytes=GROUP_MEM,
                                        device="cpu")
    return src, jarc, tarc, jstats, tstats, log.getvalue(), d


def test_archive_byte_identical(archives):
    _, jarc, tarc, jstats, tstats, log, _ = archives
    with open(jarc, "rb") as f:
        want = f.read()
    with open(tarc, "rb") as f:
        got = f.read()
    assert got == want
    assert tstats["out_bytes"] == jstats["out_bytes"]
    assert tstats["stream_bytes"] == jstats["stream_bytes"]
    # the run crossed the group-boundary maintenance paths
    assert "table grown" in log and "siv pruned" in log


def test_multiple_groups(archives):
    from fqsqueezer_tpu.archive import ArchiveReader

    rd = ArchiveReader(archives[2])
    n_groups = 0
    while rd.read_group(8) is not None:
        n_groups += 1
    rd.close()
    assert n_groups >= 3


def test_reference_decodes_port_archive(tmp_path):
    """The reference decoder gives back the reads of a port archive. A run
    with one batch shape and no table growth keeps the decoder's compiles
    few (each new table size or batch shape compiles its decode scan)."""
    src, arc, out = (str(tmp_path / n) for n in ("in.fq", "a.fqst", "o.fq"))
    write_fastq_corpus(src, 160, 40, 60_000, seed=6)
    p = tiny_params(tparams)
    p.max_batch_reads = 8
    p.smer_log2_buckets = p.bmer_log2_buckets = 14
    pipeline.compress_file(p, src, arc, group_mem_bytes=GROUP_MEM,
                           device="cpu")
    jp.decompress_file(jparams.Params(), arc, out)
    a, b = fastq.read_fastq(src), fastq.read_fastq(out)
    np.testing.assert_array_equal(b.lengths, a.lengths)
    np.testing.assert_array_equal(b.codes, a.codes)
    fwd, rev = qual_maps("illumina_8", 20)
    mask = np.arange(a.codes.shape[1])[None, :] < a.lengths[:, None]
    np.testing.assert_array_equal(np.where(mask, b.quals, 0),
                                  np.where(mask, rev[fwd[a.quals]], 0))


def test_compress_path_imports_no_jax(tmp_path):
    src = str(tmp_path / "in.fastq")
    write_fastq_corpus(src, 80, 30, 5_000, seed=1)
    code = textwrap.dedent(f"""
        import sys
        import fqsqueezer_tpu_torch.cli
        from fqsqueezer_tpu_torch.params import Params, DnaMode, IdMode
        from fqsqueezer_tpu_torch import pipeline
        p = Params()
        p.genome_size = 1
        p.adjust_kmer_sizes()
        p.n_lanes, p.max_batch_reads, p.dna_siv_cap = 8, 64, 7
        p.smer_log2_buckets = p.bmer_log2_buckets = 8
        p.dna_mode, p.id_mode = DnaMode.SE_ORIGINAL, IdMode.NONE
        st = pipeline.compress_file(p, {src!r}, {str(tmp_path / "o.fqst")!r},
                                    device="cpu")
        assert st["n_reads"] == 80
        bad = sorted(m for m in sys.modules if m.split(".")[0] in (
            "jax", "jaxlib", "fqsqueezer_tpu"))
        assert not bad, bad
        print("no jax")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("no jax")


_SE = ["-s", "-om", "o", "-qm", "8", "-im", "n"]


@pytest.mark.parametrize("argv,what", [
    (["d", "x.fqst"], "decompression"),
    (["e", "-p", "-om", "o", "-qm", "8", "-im", "n", "a.fq", "b.fq"],
     "paired-end"),
    (["e", "-s", "-om", "s", "-qm", "8", "-im", "n", "a.fq"], "sorted"),
    (["e", "-s", "-om", "o", "-qm", "o", "-im", "n", "a.fq"], "quality"),
    (["e", "-s", "-om", "o", "-qm", "4", "-im", "n", "a.fq"], "quality"),
    (["e", "-s", "-om", "o", "-qm", "2", "-im", "n", "a.fq"], "quality"),
    (["e", "-s", "-om", "o", "-qm", "n", "-im", "n", "a.fq"], "quality"),
    (["e", "-s", "-om", "o", "-qm", "8", "-im", "o", "a.fq"], "id mode"),
    (["e", "-s", "-om", "o", "-qm", "8", "a.fq"], "id mode"),
    (["e", *_SE, "-dp", "2", "a.fq"], "mesh"),
])
def test_cli_unported_modes_exit_with_one_line(argv, what):
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    msg = e.value.code
    assert isinstance(msg, str) and "\n" not in msg
    assert msg.startswith("error: ") and what in msg
    assert msg.endswith("not yet ported to fqsqueezer_tpu_torch")


def test_cli_refuses_streamed_input(tmp_path):
    big = tmp_path / "big.fastq"
    with open(big, "wb") as f:
        f.truncate((256 << 20) + 1)        # sparse: no data written
    res = subprocess.run(
        [sys.executable, "-m", "fqsqueezer_tpu_torch.cli", "e", *_SE,
         "--device", "cpu", "-out", str(tmp_path / "o.fqst"), str(big)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1
    lines = res.stderr.strip().splitlines()
    assert len(lines) == 1 and "streamed input" in lines[0], res.stderr


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_bench_row_stores_bench_params():
    """chip_smoke.py compresses through the CLI with BENCH_ROW and holds the
    archive to a digest made at bench_params(): both must write one header."""
    cs = _chip_smoke()
    p = cli.parse_args(["e", *cs.BENCH_ROW])
    assert p.n_lanes == 2048
    assert p.store_params() == cs.bench_params().store_params()


@pytest.mark.slow
def test_bench_geometry_reference_digest(tmp_path):
    """The sha256 chip_smoke.py holds the port's 20k-read archive to is the
    reference writer's, at the bench primary row's geometry."""
    cs = _chip_smoke()
    src, arc = str(tmp_path / "in.fastq"), str(tmp_path / "o.fqst")
    write_fastq_corpus(src, cs.DIGEST_READS, 100, 4_600_000, seed=42)
    p = jparams.Params.load_params(cs.bench_params().store_params())
    p.verbosity = 0
    jp.compress_file(p, src, arc)
    with open(arc, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == cs.DIGEST_20K
