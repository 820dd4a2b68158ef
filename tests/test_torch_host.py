"""The port's own host layer against the reference package's, exact.

fqsqueezer_tpu_torch keeps its own copies of params, archive, io.fastq (with
the native scanner), utils.corpus and the CLI's argument parser. For the
same inputs each copy must give what the reference module gives: header
bytes, archive bytes, parsed arrays, corpus file bytes, error texts. No
tolerance anywhere. Also here: the port imports nothing of the reference
package or of JAX (static walk over its sources), and its entry points take
the card by default and fail with one line without one.
"""
import ast
import dataclasses
import enum
import glob
import os

import numpy as np
import pytest
import torch

from fqsqueezer_tpu import archive as jarchive
from fqsqueezer_tpu import cli as jcli
from fqsqueezer_tpu import params as jparams
from fqsqueezer_tpu.io import fastq as jfastq
from fqsqueezer_tpu.io import native as jnative
from fqsqueezer_tpu.utils import corpus as jcorpus
from fqsqueezer_tpu_torch import archive as tarchive
from fqsqueezer_tpu_torch import cli as tcli
from fqsqueezer_tpu_torch import params as tparams
from fqsqueezer_tpu_torch import pipeline
from fqsqueezer_tpu_torch.io import fastq as tfastq
from fqsqueezer_tpu_torch.io import native as tnative
from fqsqueezer_tpu_torch.utils import corpus as tcorpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plain(p):
    """A Params as a dict of plain values (enums by value)."""
    return {k: v.value if isinstance(v, enum.Enum) else v
            for k, v in dataclasses.asdict(p).items()}


# --- params -----------------------------------------------------------------

_ARGVS = [
    ["e", "-s", "-om", "o", "-qm", "8", "-im", "n", "-gs", "5", "a.fq"],
    *[["e", "-s", "-om", "o", "-gs", gs, "a.fq"]
      for gs in ("1", "5", "60", "3100")],
    *[["e", "-s", "-om", "o", "-qm", qm, "a.fq"]
      for qm in ("o", "8", "4", "2", "n")],
    *[["e", "-s", "-om", om, "a.fq"] for om in ("o", "s")],
    *[["e", "-s", "-im", im, "a.fq"] for im in ("o", "i", "n")],
    ["e", "-p", "-om", "o", "-qt", "17", "-t", "99", "-dp", "2", "-tp", "2",
     "-out", "x", "-out2", "y", "-tmp", "z", "-v", "2", "a.fq", "b.fq"],
    ["d", "-out", "o.fq", "x.fqst"],
]


@pytest.mark.parametrize("argv", _ARGVS, ids=[" ".join(a) for a in _ARGVS])
def test_parse_args_gives_the_reference_params_and_header(argv):
    jp_, tp_ = jcli.parse_args(argv), tcli.parse_args(argv)
    assert _plain(tp_) == _plain(jp_)
    assert tp_.store_params() == jp_.store_params()
    assert tp_.siv_len == jp_.siv_len


def test_params_fields_and_defaults_are_the_reference():
    jf = [(f.name, f.type) for f in dataclasses.fields(jparams.Params)]
    tf = [(f.name, f.type) for f in dataclasses.fields(tparams.Params)]
    assert tf == jf
    assert _plain(tparams.Params()) == _plain(jparams.Params())
    assert tparams.Params._HDR_KEYS == jparams.Params._HDR_KEYS
    assert tparams.Params._HDR_LEGACY == jparams.Params._HDR_LEGACY
    assert tparams._KMER_TUNING == jparams._KMER_TUNING
    for name in ("WorkMode", "DnaMode", "IdMode", "QualityMode"):
        je, te = getattr(jparams, name), getattr(tparams, name)
        assert te is not je
        assert [(m.name, m.value) for m in te] == [(m.name, m.value)
                                                  for m in je]


@pytest.mark.parametrize("gs", [0, 1, 2, 4, 5, 16, 17, 64, 300, 3100, 20000,
                                70000])
@pytest.mark.parametrize("canon", [0, 1])
def test_adjust_kmer_sizes_and_auto_tune_lanes(gs, canon):
    out = []
    for mod in (jparams, tparams):
        p = mod.Params()
        p.genome_size, p.dna_canon = gs, canon
        p.adjust_kmer_sizes()
        p.dna_mode = mod.DnaMode.SE_ORIGINAL
        p.auto_tune_lanes()
        q = mod.Params()
        q.dna_mode = mod.DnaMode.SE_ORIGINAL
        q.quality_mode = mod.QualityMode.NONE
        q.auto_tune_lanes()
        out.append((_plain(p), q.n_lanes))
    assert out[0] == out[1]
    assert out[1][0]["n_lanes"] == 2048 and out[1][1] == 1024


def test_each_package_loads_the_others_header():
    """Current headers both ways, and a legacy header with keys missing."""
    jp_ = jcli.parse_args(_ARGVS[0])
    tp_ = tparams.Params.load_params(jp_.store_params())
    assert _plain(tp_) == {**_plain(jp_), "file_names": [],
                           "genome_size": 3100}
    assert isinstance(tp_.dna_mode, tparams.DnaMode)
    back = jparams.Params.load_params(tp_.store_params())
    assert back.store_params() == jp_.store_params()
    legacy = b'{"dna_mode": "se_sorted", "n_lanes": 512, "pmer_len": 12}'
    base = tparams.Params(verbosity=0, out_path="q")
    got = tparams.Params.load_params(legacy, base=base)
    want = jparams.Params.load_params(
        legacy, base=jparams.Params(verbosity=0, out_path="q"))
    assert _plain(got) == _plain(want) and got.dna_siv_cap == 13
    assert base.n_lanes == 1024


@pytest.mark.parametrize("argv", [
    [], ["e"], ["x", "a.fq"], ["e", "-qm", "z", "a.fq"],
    ["e", "-im", "q", "a.fq"],
], ids=["empty", "one_arg", "bad_mode", "bad_qm", "bad_im"])
def test_parse_args_errors_are_the_reference_text(argv):
    codes = []
    for parse in (jcli.parse_args, tcli.parse_args):
        with pytest.raises(SystemExit) as e:
            parse(argv)
        codes.append(e.value.code)
    assert codes[1] == codes[0] and isinstance(codes[1], str)


def test_main_without_input_is_the_reference_one_line():
    codes = []
    for main, argv in ((jcli.main, ["e", "-s"]),
                       (tcli.main, ["--device", "cpu", "e", "-s"])):
        with pytest.raises(SystemExit) as e:
            main(argv)
        codes.append(e.value.code)
    assert codes == ["no input files", "no input files"]


# --- archive ----------------------------------------------------------------

def _write_two_groups(mod, path):
    rng = np.random.default_rng(3)
    w = mod.ArchiveWriter(path, b'{"n_lanes": 8}')
    for g in range(2):
        states = [rng.integers(1 << 16, 1 << 32, 8, dtype=np.uint64)
                  .astype(np.uint32) for _ in range(3)]
        batches = []
        for b in range(2 + g):
            streams = []
            for _ in range(3):
                n = int(rng.integers(0, 300))
                words = rng.integers(0, 1 << 16, n + 5).astype(np.uint32)
                streams.append((words, n))
            batches.append((64 - b, 48, streams))
        w.write_group(states, batches, payload_crc=0xDEADBEEF + g)
    w.write_blob(b"tail blob")
    w.close()


def _read_all(mod, path):
    rd = mod.ArchiveReader(path)
    groups = []
    try:
        while len(groups) < 2:
            groups.append(rd.read_group(8))
        blob = rd.read_blob()
        end = rd.read_group(8)
    finally:
        rd.close()
    return rd.header_blob, groups, blob, end


def _same_tree(a, b):
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_tree(x, y)
                                        for x, y in zip(a, b))
    return a == b


def test_archive_writer_bytes_and_cross_reading(tmp_path):
    jpath, tpath = str(tmp_path / "j.fqst"), str(tmp_path / "t.fqst")
    _write_two_groups(jarchive, jpath)
    _write_two_groups(tarchive, tpath)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert g.read() == f.read()
    own = _read_all(tarchive, tpath)
    assert own[0] == b'{"n_lanes": 8}' and own[2] == b"tail blob"
    assert own[3] is None and len(own[1][1][1]) == 3
    assert own[1][0][2] == 0xDEADBEEF
    assert _same_tree(_read_all(tarchive, jpath), own)
    assert _same_tree(_read_all(jarchive, tpath), own)
    bad = tmp_path / "bad.fqst"
    bad.write_bytes(b"not an archive at all")
    for mod in (jarchive, tarchive):
        with pytest.raises(ValueError, match="not an fqsqueezer_tpu archive"):
            mod.ArchiveReader(str(bad))


# --- FASTQ I/O --------------------------------------------------------------

def _ragged_fastq(path):
    """Ragged lengths, N's, lowercase and odd bases, a CRLF record, an empty
    id, an empty read, a short quality line and no trailing newline."""
    rng = np.random.default_rng(9)
    recs = []
    for i in range(40):
        n = int(rng.integers(1, 60))
        seq = "".join(rng.choice(list("ACGTNacgtRY"), n))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(0, 94, n))
        recs.append(f"@r{i} x/{i % 2}\n{seq}\n+\n{qual}\n")
    recs.append("@crlf\r\nACGT\r\n+\r\nIIII\r\n")
    recs.append("@\nAC\n+\nII\n")
    recs.append("@empty\n\n+\n\n")
    recs.append("@shortq\nACGTAC\n+\nII")
    with open(path, "w", newline="") as f:
        f.write("".join(recs))


def _same_data(a, b):
    return (np.array_equal(a.codes, b.codes) and a.codes.dtype == b.codes.dtype
            and np.array_equal(a.quals, b.quals)
            and np.array_equal(a.lengths, b.lengths)
            and a.lengths.dtype == b.lengths.dtype and a.ids == b.ids)


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "numpy"])
def test_read_fastq_equals_reference(tmp_path, use_native):
    src = str(tmp_path / "ragged.fastq")
    _ragged_fastq(src)
    assert (tnative.get_lib() is None) == (jnative.get_lib() is None)
    want = jfastq.read_fastq(src, use_native=use_native)
    got = tfastq.read_fastq(src, use_native=use_native)
    assert got.n_reads == 44 and got.max_len == want.max_len
    assert _same_data(got, want)
    both = tfastq.concat_fastq([got, tfastq.parse_fastq_bytes(
        np.frombuffer(b"@z\nACGTACGTAC\n+\nIIIIIIIIII\n", np.uint8))])
    ref = jfastq.concat_fastq([want, jfastq.parse_fastq_bytes(
        np.frombuffer(b"@z\nACGTACGTAC\n+\nIIIIIIIIII\n", np.uint8))])
    assert _same_data(both, ref)


def test_native_scanner_is_built_from_the_ports_own_source():
    """Where there is a toolchain, the library comes from csrc/fqtz_io.cpp
    into build/native/, not from the reference package's native/."""
    if tnative.get_lib() is None:
        pytest.skip("no g++ toolchain here: the numpy path is the only one")
    so = os.path.realpath(tnative._build())
    assert so.startswith(os.path.join(REPO, "build", "native") + os.sep)
    with open(os.path.join(REPO, "native", "fqtz_io.cpp")) as f:
        ref = f.read()
    with open(tnative._SRC) as f:
        own = f.read()
    assert own[own.index("#include"):] == ref[ref.index("#include"):]


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "numpy"])
def test_write_fastq_equals_reference(tmp_path, use_native):
    src = str(tmp_path / "ragged.fastq")
    _ragged_fastq(src)
    d = tfastq.read_fastq(src)
    outs = []
    for mod, name in ((jfastq, "j"), (tfastq, "t")):
        for ids in (d.ids, None):
            path = str(tmp_path / f"{name}{ids is None}.fastq")
            mod.write_fastq(path, d.codes, d.quals, d.lengths, ids,
                            use_native=use_native)
            with open(path, "rb") as f:
                outs.append(f.read())
    assert outs[2] == outs[0] and outs[3] == outs[1] and outs[0] != outs[1]
    # the streamed writer renders the same bytes, ids as a matrix included
    path = str(tmp_path / "w.fastq")
    wr = tfastq.FastqWriter(path)
    wr.write_batch(d.codes[:20], d.quals[:20], d.lengths[:20], d.ids[:20])
    il = np.array([len(s) for s in d.ids[20:]], np.int64)
    mat = np.zeros((len(il), int(il.max())), np.uint8)
    for i, s in enumerate(d.ids[20:]):
        mat[i, :len(s)] = np.frombuffer(s, np.uint8)
    wr.write_batch(d.codes[20:], d.quals[20:], d.lengths[20:], id_mat=mat,
                   id_lens=il)
    wr.close()
    with open(path, "rb") as f:
        assert f.read() == outs[0] and wr.n_reads == d.n_reads


def _tied_fastq(path, empty=True):
    """Reads for the sorted-order helpers: exact duplicates (ties keep file
    order), reads that are strict prefixes of others, N against T (N sorts
    as T, then the exact bytes decide), ragged lengths, an empty read
    (unless not `empty`), distinct qualities and ids to tell tied reads
    apart."""
    rng = np.random.default_rng(12)
    base = ["ACGTACGTAC", "ACGT", "ACGN", "ACGT", "ACGTACGTAC", "ACG", "",
            "TTTT", "TTTN", "ACGTACGTAA", "ACGT"][:None if empty else 6] + [
        "TTTT", "TTTN", "ACGTACGTAA", "ACGT"][:0 if empty else 4]
    seqs = base + ["".join(rng.choice(list("ACGTN"), int(n)))
                   for n in rng.integers(1, 30, 60)]
    seqs += [seqs[i] for i in rng.integers(0, len(seqs), 30)]
    with open(path, "w") as f:
        for i, seq in enumerate(seqs):
            qual = "".join(chr(34 + (i + k) % 40) for k in range(len(seq)))
            f.write(f"@t{i}\n{seq}\n+\n{qual}\n")
    return len(seqs)


@pytest.mark.parametrize("chunk", [50, 1000, 1 << 20])
def test_stream_fastq_and_external_sort_equal_reference(tmp_path, chunk):
    """stream_fastq's chunks and the external bin sort's sorted chunks are
    the reference's, chunk by chunk (ragged records, CRLF and a last
    record without its newline included); the concatenated sorted chunks
    equal the in-RAM sort_order permutation. An empty read makes a bin of
    width 0, on which both packages raise alike (ROADMAP.md, F5)."""
    a, b = str(tmp_path / "a.fastq"), str(tmp_path / "b.fastq")
    _ragged_fastq(a)
    _tied_fastq(b)
    errors = []
    for mod in (tfastq, jfastq):
        with pytest.raises(ValueError) as e:
            list(mod.external_sort_stream(b, chunk, tmpdir=str(tmp_path)))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    n_b = _tied_fastq(b, empty=False)
    for paths in ([a], [b, a]):
        got = list(tfastq.stream_fastq(paths, chunk))
        want = list(jfastq.stream_fastq(paths, chunk))
        assert len(got) == len(want) and all(
            _same_data(g, w) for g, w in zip(got, want))
    got = list(tfastq.external_sort_stream(b, chunk, tmpdir=str(tmp_path),
                                           prefix=2))
    want = list(jfastq.external_sort_stream(b, chunk, tmpdir=str(tmp_path),
                                            prefix=2))
    assert len(got) == len(want) > 1 and all(
        _same_data(g, w) for g, w in zip(got, want))
    whole = tfastq.read_fastq(b)
    order = tfastq.sort_order(whole.codes, whole.lengths)
    cat = tfastq.concat_fastq(got)
    assert cat.n_reads == n_b
    assert np.array_equal(cat.lengths, whole.lengths[order])
    assert np.array_equal(cat.codes[:, :whole.max_len],
                          whole.codes[order][:, :cat.max_len])
    assert np.array_equal(cat.quals[:, :whole.max_len],
                          whole.quals[order][:, :cat.max_len])
    assert sorted(os.listdir(tmp_path)) == ["a.fastq", "b.fastq"]


def test_sort_order_and_bins_equal_reference(tmp_path):
    """The in-RAM order (ties in file order, a strict prefix first, N as T
    and then after T) and the bin ids of every prefix width."""
    src = str(tmp_path / "t.fastq")
    _tied_fastq(src)
    d = tfastq.read_fastq(src)
    got = tfastq.sort_order(d.codes, d.lengths)
    want = jfastq.sort_order(d.codes, d.lengths)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    seqs = [bytes(tfastq.CODE_TO_BASE[d.codes[i, :d.lengths[i]]])
            for i in got]
    assert seqs[0] == b""
    for seq in set(seqs):                           # ties in file order
        at = [int(i) for i, t in zip(got, seqs) if t == seq]
        assert at == sorted(at)
    assert seqs.count(b"ACGT") > 2
    assert seqs.index(b"ACG") < seqs.index(b"ACGT") < seqs.index(b"ACGN")
    assert seqs.index(b"TTTT") < seqs.index(b"TTTN")
    for prefix in (1, 2, 4, 40):
        g = tfastq._sort_bin_ids(d.codes, d.lengths, prefix)
        w = jfastq._sort_bin_ids(d.codes, d.lengths, prefix)
        assert g.dtype == w.dtype and np.array_equal(g, w)
    empty = np.zeros((0, 5), np.uint8)
    assert tfastq.sort_order(empty, np.zeros(0, np.int32)).shape == (0,)


def test_write_fastq_corpus_equals_reference(tmp_path):
    jpath, tpath = str(tmp_path / "j.fastq"), str(tmp_path / "t.fastq")
    jcorpus.write_fastq_corpus(jpath, 300, 50, 20_000, seed=42)
    tcorpus.write_fastq_corpus(tpath, 300, 50, 20_000, seed=42)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert g.read() == f.read()
    g1, g2 = jcorpus.make_genome(500, 3), tcorpus.make_genome(500, 3)
    assert np.array_equal(g1, g2)
    for a, b in zip(jcorpus.sample_reads(g1, 20, 30, 4),
                    tcorpus.sample_reads(g2, 20, 30, 4)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_write_fastq_corpus_realistic_equals_reference(tmp_path):
    """The structured-genome generator (bench_gpu's se_real corpus): repeat
    families, homopolymer runs and composition blocks all present at 1.2
    Mbp."""
    g1 = jcorpus.make_genome_realistic(1_200_000, 7)
    g2 = tcorpus.make_genome_realistic(1_200_000, 7)
    assert g2.dtype == g1.dtype and np.array_equal(g1, g2)
    jpath, tpath = str(tmp_path / "j.fastq"), str(tmp_path / "t.fastq")
    jcorpus.write_fastq_corpus_realistic(jpath, 200, 60, 1_200_000, seed=7)
    tcorpus.write_fastq_corpus_realistic(tpath, 200, 60, 1_200_000, seed=7)
    with open(jpath, "rb") as f, open(tpath, "rb") as g:
        assert g.read() == f.read()


def test_write_pe_corpus_equals_reference(tmp_path):
    """The bench's PE generator: both mate files byte for byte."""
    paths = {}
    for tag, mod in (("j", jcorpus), ("t", tcorpus)):
        paths[tag] = [str(tmp_path / f"{tag}{k}.fastq") for k in (1, 2)]
        mod.write_pe_corpus(*paths[tag], 200, 60, 30_000, seed=42)
    for j, t in zip(paths["j"], paths["t"]):
        with open(j, "rb") as f, open(t, "rb") as g:
            assert g.read() == f.read()


def _pe_mates(tmp_path):
    """Two ragged mate files (the second's reads longer)."""
    m1, m2 = str(tmp_path / "m1.fastq"), str(tmp_path / "m2.fastq")
    for path, n, seed in ((m1, 40, 1), (m2, 90, 2)):
        rng = np.random.default_rng(seed)
        with open(path, "w") as f:
            for i in range(37):
                k = int(rng.integers(1, n))
                f.write(f"@p{i} {seed}\n{''.join(rng.choice(list('ACGTN'), k))}"
                        f"\n+\n{'I' * k}\n")
    return m1, m2


def test_interleave_pe_equals_reference(tmp_path):
    m1, m2 = _pe_mates(tmp_path)
    got = pipeline.interleave_pe(tfastq.read_fastq(m1),
                                 tfastq.read_fastq(m2))
    want = jpipeline().interleave_pe(jfastq.read_fastq(m1),
                                     jfastq.read_fastq(m2))
    assert got.n_reads == 74 and _same_data(got, want)
    # mates of 37 and 74 reads: the reference's error, word for word
    with pytest.raises(ValueError) as e:
        pipeline.interleave_pe(tfastq.read_fastq(m1), tfastq.concat_fastq(
            [tfastq.read_fastq(m2)] * 2))
    with pytest.raises(ValueError) as f:
        jpipeline().interleave_pe(jfastq.read_fastq(m1), jfastq.concat_fastq(
            [jfastq.read_fastq(m2)] * 2))
    assert str(e.value) == str(f.value) == "PE mate counts differ: 37 vs 74"


@pytest.mark.parametrize("chunk", [300, 4096, 1 << 20])
def test_stream_interleaved_pe_equals_reference(tmp_path, chunk):
    """The port reads each mate in chunks of half the size the reference
    reads them in: its chunks at 2 * chunk are the reference's at chunk,
    and at any size its stream holds the reference's pairs."""
    m1, m2 = _pe_mates(tmp_path)
    want = list(jpipeline()._stream_interleaved_pe((m1, m2), chunk))
    got = list(pipeline._stream_interleaved_pe((m1, m2), 2 * chunk))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _same_data(g, w)
    same = list(pipeline._stream_interleaved_pe((m1, m2), chunk))
    assert _same_data(tfastq.concat_fastq(same),
                      jfastq.concat_fastq(want))


@pytest.mark.parametrize("chunk", [300, 4096])
def test_stream_interleaved_pe_mate_count_error_is_the_references(tmp_path,
                                                                   chunk):
    """Mate files of 37 and 148 reads: the 111 unpaired reads span more
    than one chunk, and the port's streamed reader (at 2 * chunk, the
    reference's chunks) raises the reference's error word for word, whose
    count is the unpaired reads buffered when the shorter file ended."""
    m1, m2 = _pe_mates(tmp_path)
    long2 = str(tmp_path / "long2.fastq")
    with open(m2) as f, open(long2, "w") as g:
        g.write(f.read() * 4)
    msgs = []
    for gen in (lambda: jpipeline()._stream_interleaved_pe((m1, long2),
                                                           chunk),
                lambda: pipeline._stream_interleaved_pe((m1, long2),
                                                        2 * chunk)):
        with pytest.raises(ValueError, match="mate counts differ") as e:
            list(gen())
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    n = int(msgs[0].split(" ended with ")[1].split()[0])
    assert 0 < n < 111


def jpipeline():
    from fqsqueezer_tpu import pipeline as jp

    return jp


def test_bench_pairs_summary_counts_medians_quartiles_and_wins():
    """bench_pairs' summary line: each side's median and quartiles of
    compress and decode reads/s, and the pairs the change won; a tie wins
    for neither side."""
    from fqsqueezer_tpu_torch.tools import bench_pairs

    def row(c, d):
        return {"value": c, "decode_reads_per_s": d}

    pairs = [(row(10, 5), row(12, 5)), (row(11, 6), row(9, 7)),
             (row(13, 4), row(14, 3)), (row(12, 8), row(12, 9))]
    s = bench_pairs.summarize(pairs)
    assert s["value"]["parent"] == {"median": 11.5, "q1": 10.25,
                                    "q3": 12.75, "runs": [10, 11, 13, 12]}
    assert s["value"]["change"]["median"] == 12
    assert s["value"]["change_wins"] == 2
    assert s["decode_reads_per_s"]["change_wins"] == 2
    assert s["decode_reads_per_s"]["pairs"] == 4


# --- imports ----------------------------------------------------------------

_FORBIDDEN = ("jax", "jaxlib", "fqsqueezer_tpu")


def _port_sources():
    files = glob.glob(os.path.join(REPO, "fqsqueezer_tpu_torch", "**", "*.py"),
                      recursive=True)
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py"),
                            os.path.join(REPO, "tests", "test_torch_cuda.py")]


def test_port_sources_import_nothing_of_jax_or_the_reference_package():
    files = _port_sources()
    assert len(files) > 20
    rel = {os.path.relpath(f, REPO) for f in files}
    assert {"fqsqueezer_tpu_torch/checkpoint.py",
            "fqsqueezer_tpu_torch/parallel/mesh_pipeline.py",
            "fqsqueezer_tpu_torch/parallel/comm.py"} <= rel
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "id", getattr(node.func, "attr", ""))
                  in ("import_module", "__import__") and node.args
                  and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            bad += [(os.path.relpath(path, REPO), n) for n in names
                    if n.split(".")[0] in _FORBIDDEN]
    assert not bad, bad


# --- the card by default ----------------------------------------------------

def test_take_device_splits_the_port_only_option():
    assert tcli.take_device(["e", "-s", "a.fq"]) == ("cuda",
                                                     ["e", "-s", "a.fq"])
    assert tcli.take_device(["e", "--device", "cpu", "a.fq"]) == (
        "cpu", ["e", "a.fq"])
    assert tcli.take_device(["--device", "cuda:1", "e", "a.fq"]) == (
        "cuda:1", ["e", "a.fq"])
    for argv in (["e", "a.fq", "--device"], ["e", "--device", "tpu", "a.fq"],
                 ["e", "--device", "cuda:x", "a.fq"]):
        with pytest.raises(SystemExit) as e:
            tcli.take_device(argv)
        assert isinstance(e.value.code, str) and "\n" not in e.value.code
        assert "--device" in e.value.code


def test_without_a_card_the_entry_points_fail_with_one_line(tmp_path,
                                                            monkeypatch):
    """compress_file(device=None) and the CLI without --device mean the
    card: where none is visible they raise / exit 1 with one line and write
    nothing — no fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, arc = str(tmp_path / "in.fastq"), str(tmp_path / "o.fqst")
    tcorpus.write_fastq_corpus(src, 16, 30, 2_000, seed=1)
    assert pipeline.resolve_device("cpu") == torch.device("cpu")
    p = tcli.parse_args(["e", "-s", "-om", "o", "-im", "n", "-gs", "1", src])
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError) as e:
            pipeline.compress_file(p, src, arc, device=device)
        msg = str(e.value)
        assert "\n" not in msg and "no CUDA device is visible" in msg
        assert 'device="cpu"' in msg and "--device cpu" in msg
    with pytest.raises(SystemExit) as e:
        tcli.main(["e", "-s", "-om", "o", "-im", "n", "-gs", "1", "-v", "0",
                   "-out", arc, src])
    code = e.value.code
    assert isinstance(code, str) and "\n" not in code
    assert code.startswith("error: no CUDA device is visible")
    assert not os.path.exists(arc)
