"""End to end: the port's archives against the reference package's.

On a tiny multi-group geometry (several groups, table growth and an SIV
prune), fqsqueezer_tpu_torch.pipeline.compress_file must write the same
bytes as fqsqueezer_tpu.pipeline.compress_file, and the reference decoder
must give the reads back; the port's decompress_file (and its CLI's `d`)
must give the same FASTQ bytes as the reference decoder, from either
package's archive. Each package gets its own Params, built the same way
from its own params module. Also: the port's compress and decompress paths
import no JAX and nothing of the reference package, and the CLI refuses
every mode it does not have, and every file it cannot read, with one line.
Everything here asks for the CPU (`device="cpu"`, `--device cpu`).
"""
import contextlib
import hashlib
import importlib.util
import io
import json
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
# sha256 of fqsqueezer_tpu.pipeline.decompress_file's FASTQ output for the
# `archives` fixture's archive (test_reference_decoder_digest recomputes it)
DECODED_SHA256 = "8053a71995a73807cd906c68f215f644dd6790442a011f5a1b751c5649a055b1"


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


@pytest.fixture(scope="module")
def no_jax_run(tmp_path_factory):
    """One fresh process that compresses a small corpus through the port and
    decodes the archive back, listing after each step the modules of JAX and
    of the reference package it has imported."""
    d = tmp_path_factory.mktemp("no_jax")
    src, arc, out = (str(d / n) for n in ("in.fq", "a.fqst", "o.fq"))
    write_fastq_corpus(src, 40, 30, 5_000, seed=2)
    code = textwrap.dedent(f"""
        import json
        import sys
        import fqsqueezer_tpu_torch.cli
        from fqsqueezer_tpu_torch.params import Params, DnaMode, IdMode
        from fqsqueezer_tpu_torch import pipeline

        def bad():
            return sorted(m for m in sys.modules if m.split(".")[0] in (
                "jax", "jaxlib", "fqsqueezer_tpu"))

        p = Params()
        p.genome_size = 1
        p.adjust_kmer_sizes()
        p.n_lanes, p.max_batch_reads, p.dna_siv_cap = 8, 64, 7
        p.smer_log2_buckets = p.bmer_log2_buckets = 8
        p.dna_mode, p.id_mode = DnaMode.SE_ORIGINAL, IdMode.NONE
        p.verbosity = 0
        c = pipeline.compress_file(p, {src!r}, {arc!r}, device="cpu")
        after_c = bad()
        q = Params()
        q.verbosity = 0
        dd = pipeline.decompress_file(q, {arc!r}, {out!r}, device="cpu")
        print(json.dumps({{"compress": [c["n_reads"], after_c],
                          "decompress": [dd["n_reads"], bad()]}}))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return src, out, json.loads(res.stdout.strip().splitlines()[-1])


def test_compress_path_imports_no_jax(no_jax_run):
    n_reads, bad = no_jax_run[2]["compress"]
    assert n_reads == 40
    assert not bad, bad


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _same_reads(src, out):
    """The decoded reads are the source's: bases and lengths exactly,
    qualities through the Illumina-8 bins."""
    a, b = fastq.read_fastq(src), fastq.read_fastq(out)
    np.testing.assert_array_equal(b.lengths, a.lengths)
    np.testing.assert_array_equal(b.codes, a.codes)
    fwd, rev = qual_maps("illumina_8", 20)
    mask = np.arange(a.codes.shape[1])[None, :] < a.lengths[:, None]
    np.testing.assert_array_equal(np.where(mask, b.quals, 0),
                                  np.where(mask, rev[fwd[a.quals]], 0))


@pytest.fixture(scope="module")
def port_decode(archives):
    """The port's CLI `d --device cpu` (pipeline.decompress_file behind it)
    on the reference writer's archive, decoded once for the tests below:
    the output path and the printed log."""
    _, jarc, _, _, _, _, d = archives
    out = str(d / "port_of_jax.fastq")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        assert cli.main(["d", "--device", "cpu", "-out", out, jarc]) == 0
    return out, log.getvalue()


def test_port_decodes_reference_archive(archives, port_decode):
    """The reference writer's archive decodes to the reference decoder's
    bytes, through every group's growth, prune and checksum."""
    out, log = port_decode
    assert _sha256(out) == DECODED_SHA256
    _same_reads(archives[0], out)
    assert "reads: 600" in log
    assert "table grown" in log and "siv pruned" in log


def test_cli_decodes_port_archive(archives, port_decode):
    """The port's own archive is byte for byte the reference writer's
    (test_archive_byte_identical), so the CLI's decode of it is the one
    above: the reference decoder's bytes."""
    _, jarc, tarc, _, _, _, _ = archives
    with open(jarc, "rb") as f, open(tarc, "rb") as g:
        assert f.read() == g.read()
    assert _sha256(port_decode[0]) == DECODED_SHA256


@pytest.mark.slow
def test_reference_decoder_digest(archives):
    """DECODED_SHA256 is the reference decoder's output for the fixture."""
    _, jarc, _, _, _, _, d = archives
    out = str(d / "jax_of_jax.fastq")
    with contextlib.redirect_stdout(io.StringIO()):
        jp.decompress_file(jparams.Params(), jarc, out)
    assert _sha256(out) == DECODED_SHA256


def test_decompress_path_imports_no_jax(no_jax_run):
    src, out, res = no_jax_run
    n_reads, bad = res["decompress"]
    assert n_reads == 40
    assert not bad, bad
    a, b = fastq.read_fastq(src), fastq.read_fastq(out)
    np.testing.assert_array_equal(b.codes, a.codes)


def _header_only_archive(path, **fields):
    """An archive the reference package's writer starts with the given
    Params fields and closes without a group."""
    from fqsqueezer_tpu.archive import ArchiveWriter

    p = jparams.Params()
    p.dna_mode = jparams.DnaMode.SE_ORIGINAL
    p.quality_mode = jparams.QualityMode.ILLUMINA_8
    p.id_mode = jparams.IdMode.NONE
    for k, v in fields.items():
        setattr(p, k, v)
    ArchiveWriter(str(path), p.store_params()).close()
    return str(path)


def _decodes_to_empty_fastq(arc, out):
    """A header-only archive of a ported mode decodes, through the CLI and
    through pipeline.decompress_file (a mesh one through
    mesh_pipeline.decompress_file_mesh), to an empty FASTQ (a paired-end
    archive to two, the second at -out2)."""
    p = tparams.Params.load_params(_header_blob(arc))
    pe = p.dna_mode in (tparams.DnaMode.PE_ORIGINAL,
                        tparams.DnaMode.PE_SORTED)
    out2 = out + ".2"
    from fqsqueezer_tpu_torch.parallel import mesh_pipeline

    decompress = (mesh_pipeline.decompress_file_mesh
                  if p.mesh_dp * p.mesh_tp > 1 else pipeline.decompress_file)
    for decode in (lambda: cli.main(["d", "--device", "cpu", "-out", out,
                                     "-out2", out2, arc]),
                   lambda: decompress(
                       tparams.Params(), arc, out, out2, device="cpu")):
        assert decode() in (0, {"n_reads": 0})
        assert os.path.getsize(out) == 0
        assert os.path.exists(out2) == pe
        if pe:
            assert os.path.getsize(out2) == 0
            os.remove(out2)
        os.remove(out)


def _header_blob(arc):
    from fqsqueezer_tpu_torch.archive import ArchiveReader

    rd = ArchiveReader(arc)
    try:
        return rd.header_blob
    finally:
        rd.close()


# `what` None: a mode this package decodes; "routed": a mesh header, which
# the CLI's d routes to parallel.mesh_pipeline — today's writer's, and
# those of the older writers (H0, H5, H1, once refused on a mesh); the
# cases keep their ids
_D_CASES = [
    ({"quality_mode": jparams.QualityMode.LOSSLESS}, None),
    ({"dna_mode": jparams.DnaMode.SE_SORTED}, None),
    ({"dna_mode": jparams.DnaMode.PE_ORIGINAL}, None),
    ({"id_mode": jparams.IdMode.INSTRUMENT}, None),
    ({"mesh_dp": 2}, "routed"),
    ({"dna_row_global": 0}, None),
    ({"id_mode": jparams.IdMode.LOSSLESS, "id_codec_v": 1}, None),
    ({**tparams.HEADER_GENERATIONS["H0"], "mesh_dp": 2,
      "id_mode": jparams.IdMode.LOSSLESS}, "routed"),
    ({**tparams.HEADER_GENERATIONS["H5"], "mesh_dp": 2,
      "id_mode": jparams.IdMode.LOSSLESS}, "routed"),
    ({**tparams.HEADER_GENERATIONS["H1"], "mesh_dp": 2,
      "id_mode": jparams.IdMode.LOSSLESS}, "routed"),
]


@pytest.mark.parametrize(
    "fields,what", _D_CASES,
    ids=["fields0-quality mode", "fields1-sorted", "fields2-paired-end",
         "fields3-id mode", "fields4-mesh", "fields5-row-global",
         "fields6-id codec v1", "fields7-mesh H0", "fields8-mesh H5",
         "fields9-mesh H1"])
def test_cli_d_refuses_unported_archives(tmp_path, fields, what):
    """Every header a JAX writer stores decodes, once refused or not: the
    quality and id modes (id codec v1 too) and the in-batch local tables
    (dna_row_global 0 with the default local_log2_cells) decode (an
    archive with no group: an empty FASTQ), and so does a mesh header
    through the CLI, which routes it to the mesh decode, while
    pipeline.decompress_file raises the reference's error for it: today's
    writer's, and an older writer's (H0, H5, H1), which the mesh decode
    once refused."""
    arc = _header_only_archive(tmp_path / "a.fqst", **fields)
    if what is None:
        _decodes_to_empty_fastq(arc, str(tmp_path / "o.fq"))
        return
    out = str(tmp_path / "o.fq")
    assert cli.main(["d", "--device", "cpu", "-v", "0", "-out", out,
                     arc]) == 0
    assert os.path.getsize(out) == 0
    with pytest.raises(ValueError) as e:
        pipeline.decompress_file(tparams.Params(), arc, out, device="cpu")
    with pytest.raises(ValueError) as f:
        jp.decompress_file(jparams.Params(), arc, out)
    assert str(e.value) == str(f.value)
    assert str(e.value) == ("archive was written on a 2x1 mesh — use "
                            "parallel.mesh_pipeline.decompress_file_mesh")


def test_cli_d_error_paths_exit_with_one_line(tmp_path):
    """No visible card and no --device (in a fresh process, which shows
    the exit code and that no traceback is printed); a file that is not
    an archive; an archive of a 2 x 3 mesh, whose tp does not divide the
    tables (the reference's mesh decode raises on it too); a
    missing file. Each is exit 1 with one line, and writes no output
    file. And a mesh archive (the reference's dp=2 writer, a committed
    fixture) whose first group's payload crc is broken: exit 1 with one
    line, after that group's reads."""
    arc = _header_only_archive(tmp_path / "ok.fqst")
    out = str(tmp_path / "o.fq")
    res = subprocess.run(
        [sys.executable, "-m", "fqsqueezer_tpu_torch.cli", "d", "-out", out,
         arc], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    lines = res.stderr.strip().splitlines()
    assert res.returncode == 1 and len(lines) == 1, res.stderr
    assert "no CUDA device" in lines[0]
    bad = tmp_path / "bad.fqst"
    bad.write_bytes(b"@r1\nACGT\n+\nIIII\n")
    tp3_arc = _header_only_archive(tmp_path / "tp3.fqst", mesh_dp=2,
                                   mesh_tp=3)
    for path, what in ((str(bad), "not an fqsqueezer_tpu archive"),
                       (tp3_arc, "-dp 2 -tp 3"),
                       (str(tmp_path / "none.fqst"), "none.fqst")):
        with pytest.raises(SystemExit) as e:
            cli.main(["d", "--device", "cpu", "-out", out, path])
        msg = e.value.code
        assert isinstance(msg, str) and "\n" not in msg and what in msg
    assert not os.path.exists(out)
    mesh_arc = _mesh_archive_with_bad_crc(tmp_path / "mesh.fqst")
    with pytest.raises(SystemExit) as e:
        cli.main(["d", "--device", "cpu", "-v", "0", "-out", out, mesh_arc])
    msg = e.value.code
    assert isinstance(msg, str) and "\n" not in msg
    assert msg == "error: payload checksum mismatch (seq mesh decode)"


def _mesh_archive_with_bad_crc(path):
    """The committed mesh fixture snap_dp2tp1 (fqsqueezer_tpu_torch/
    testdata/mesh) with its first group's payload crc changed by one."""
    from fqsqueezer_tpu_torch.archive import ArchiveReader

    src = os.path.join(REPO, "fqsqueezer_tpu_torch", "testdata", "mesh",
                       "snap_dp2tp1.fqst")
    rd = ArchiveReader(src)
    at = rd.f.tell()            # the first group's crc, a uvarint
    rd.close()
    with open(src, "rb") as f:
        blob = bytearray(f.read())
    blob[at] ^= 1
    path.write_bytes(bytes(blob))
    return str(path)


_SE = ["-s", "-om", "o", "-qm", "8", "-im", "n"]


# `what` None: a mode this package has (the cases keep their ids)
_E_CASES = [
    (["e", "-p", "-om", "o", "-qm", "8", "-im", "n", "a.fq", "b.fq"], None),
    (["e", "-s", "-om", "s", "-qm", "8", "-im", "n", "a.fq"], None),
    (["e", "-s", "-om", "o", "-qm", "o", "-im", "n", "a.fq"], None),
    (["e", "-s", "-om", "o", "-qm", "4", "-im", "n", "a.fq"], None),
    (["e", "-s", "-om", "o", "-qm", "2", "-im", "n", "a.fq"], None),
    (["e", "-s", "-om", "o", "-qm", "n", "-im", "n", "a.fq"], None),
    (["e", "-s", "-om", "o", "-qm", "8", "-im", "o", "a.fq"], None),
    (["e", "-s", "-om", "o", "-qm", "8", "a.fq"], None),
    (["e", *_SE, "-dp", "2", "a.fq"], None),
]


@pytest.mark.parametrize(
    "argv,what", _E_CASES,
    ids=["argv0-paired-end", "argv1-sorted", "argv2-quality",
         "argv3-quality", "argv4-quality", "argv5-quality", "argv6-id mode",
         "argv7-id mode", "argv8-mesh"])
def test_cli_unported_modes_exit_with_one_line(tmp_path, argv, what):
    """Every mode of the CLI is ported: the paired-end, sorted, quality
    and id modes, and a dp x tp mesh; a header-only archive of their
    Params decodes to an empty FASTQ."""
    from fqsqueezer_tpu_torch.archive import ArchiveWriter

    assert what is None
    p = cli.parse_args(argv)
    # the default -gs 3100 sizes its tables at 2^26 buckets (the pair
    # table at 2^24): keep the decoder's state small, its modes as they
    # are
    p.smer_log2_buckets = p.bmer_log2_buckets = p.pe_log2_buckets = 8
    arc = str(tmp_path / "a.fqst")
    ArchiveWriter(arc, p.store_params()).close()
    _decodes_to_empty_fastq(arc, str(tmp_path / "o.fq"))


def test_cli_refuses_streamed_input(tmp_path, monkeypatch):
    """Of the inputs above the streaming threshold, eligible single-end
    (tests/test_torch_sorted.py) and paired-end original-order ones
    stream, paired-end sorted order loads its mates, as in the reference
    CLI; a mesh (-dp) passes the mode check and its compress does not
    stream: the CLI hands the whole file to the mesh writer, SE and PE."""
    big = []
    for name in ("big_1.fastq", "big_2.fastq"):
        with open(tmp_path / name, "wb") as f:
            f.truncate((256 << 20) + 1)    # sparse: no data written
        big.append(str(tmp_path / name))
    from fqsqueezer_tpu_torch.parallel import mesh_pipeline

    calls = []

    def record(name):
        def writer(p, *args, dp, tp, device):
            calls.append((name, args, dp, tp, device.type))
            return {"n_reads": 0, "in_bytes": 1, "out_bytes": 1,
                    "bits_per_base": 0.0}
        return writer

    for name in ("compress_file_mesh", "compress_pe_mesh"):
        monkeypatch.setattr(mesh_pipeline, name, record(name))
    out = str(tmp_path / "o.fqst")
    for argv in ([*_SE, "-dp", "2", big[0]],
                 ["-p", "-om", "o", "-dp", "2", "-tp", "1", *big]):
        p = cli.parse_args(["e", *argv])
        assert cli.stream_chunk_bytes(p) == 0
        assert cli.main(["e", *argv, "--device", "cpu", "-v", "0", "-out",
                         out]) == 0
    assert calls == [("compress_file_mesh", (big[0], out), 2, 1, "cpu"),
                     ("compress_pe_mesh", (*big, out), 2, 1, "cpu")]
    assert cli.stream_chunk_bytes(cli.parse_args(["e", *_SE, big[0]])) \
        == cli.STREAM_CHUNK_BYTES
    assert cli.stream_chunk_bytes(cli.parse_args(
        ["e", "-p", "-om", "o", *big])) == cli.STREAM_CHUNK_BYTES
    assert cli.stream_chunk_bytes(cli.parse_args(
        ["e", "-p", "-om", "s", "-im", "n", *big])) == 0
    assert not os.path.exists(out)


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
