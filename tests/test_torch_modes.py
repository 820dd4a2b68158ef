"""Every SE original-order quality and id mode of the port against the
reference package.

Function level, for the quality modes other than Illumina-8 (lossless,
Illumina-4 and binary): qual_modeling, and the decode scan (the plain scan
and qual_decode_batch) on encoded batches with lengths 0, 1 and L — the
symbols, final states, words consumed and updated model exactly equal to
the reference's. Archive level, on a tiny multi-group geometry: the port's
archive for `-qm o -im o`, `-qm n -im o`, `-qm 4 -im i` and `-qm 2 -im n`
has the reference writer's sha256 (ARCHIVE_SHA256; the slow
test_reference_writer_digest compresses with the reference package and
holds its bytes to the port's), and the port decodes it to the input's
bytes where both streams are lossless, otherwise to the input quantized
through the reference's qual_maps (and its instrument_prefix). Every CLI
combination of -qm and -im passes the port's mode check. Everything here
asks for the CPU.
"""
import contextlib
import hashlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fqsqueezer_tpu import params as jparams
from fqsqueezer_tpu import pipeline as jp
from fqsqueezer_tpu.io import fastq as jfastq
from fqsqueezer_tpu.streams import ids as jids
from fqsqueezer_tpu.streams import quality as jq
from fqsqueezer_tpu.utils.corpus import write_fastq_corpus
from fqsqueezer_tpu_torch import cli
from fqsqueezer_tpu_torch import params as tparams
from fqsqueezer_tpu_torch import pipeline
from fqsqueezer_tpu_torch.archive import ArchiveReader
from fqsqueezer_tpu_torch.streams import quality

SB = 14
N, R_PL, L = 8, 2, 16
MODES = ["lossless", "illumina_4", "binary"]


# --- function level: the quality modes ------------------------------------

def _qual_inputs(mode, seed):
    """(cfg pair, model, qsyms [R, L], lengths [R]) as numpy: a model of
    counts model_update could have left (smoothed row totals at most
    2^13 + n_sym), a quarter of its rows empty; lengths 0, 1 and L among
    random ones."""
    jcfg = jq.QualConfig(mode=mode, qt=20, scale_bits=SB, n_lanes=N)
    tcfg = quality.QualConfig(mode=mode, qt=20, scale_bits=SB, n_lanes=N)
    rng = np.random.default_rng(seed)
    A = jcfg.n_sym
    model = rng.integers(0, (1 << 13) // A, (jcfg.n_ctx, A)).astype(np.int32)
    model[rng.random(jcfg.n_ctx) < 0.25] = 0
    R = N * R_PL
    lengths = rng.integers(2, L, R).astype(np.int32)
    lengths[:3] = (0, 1, L)
    rng.shuffle(lengths)
    fwd = jq.qual_maps(mode, 20)[0]
    quals = rng.integers(2, 42, (R, L))
    qsyms = np.where(np.arange(L)[None, :] < lengths[:, None],
                     fwd[quals], 0).astype(np.int32)
    return (jcfg, tcfg), model, qsyms, lengths


@pytest.fixture(scope="module", params=MODES)
def qual_case(request):
    """One mode's batch through both packages: the reference's modeling,
    encode and decode, and the port's modeling, plain scan and
    qual_decode_batch on the reference's words."""
    (jcfg, tcfg), model, qsyms, lengths = _qual_inputs(
        request.param, MODES.index(request.param) + 3)
    jm, jsyms, jlen = jnp.asarray(model), jnp.asarray(qsyms), jnp.asarray(
        lengths)
    out = {"mode": request.param, "qsyms": qsyms}
    out["jmodeling"] = jax.device_get(jq.qual_modeling(jcfg, jm, jsyms,
                                                       jlen))
    words, n_words, states, enc_model = jq.qual_encode_batch(
        jcfg, jm, jsyms, jlen)
    n = int(n_words)
    out["n_words"] = n
    out["enc_model"] = np.asarray(enc_model)
    w = np.zeros(N * R_PL * L, np.int64)
    w[:n] = np.asarray(words)[:n]
    st = np.asarray(states).astype(np.int64)
    out["jdecode"] = jax.device_get(jq.qual_decode_batch(
        jcfg, jm, jlen, jnp.asarray(w, jnp.uint32), jnp.asarray(
            st, jnp.uint32), L))
    tm = torch.from_numpy(model)
    tlen = torch.from_numpy(lengths)
    out["tmodeling"] = quality.qual_modeling(
        tcfg, tm, torch.from_numpy(qsyms).to(torch.int64),
        tlen.to(torch.int64))
    tw, tst = torch.from_numpy(w), torch.from_numpy(st)
    out["tplain"] = quality.qual_decode_scan_plain(
        tcfg, tm, tlen, tw.to(torch.int32), tst, L)
    out["tdecode"] = quality.qual_decode_batch(tcfg, tm, tlen, tw, tst, L)
    return out


def test_qual_modeling_every_mode(qual_case):
    for name, g, w in zip(("ctx", "f", "c", "active"),
                          qual_case["tmodeling"], qual_case["jmodeling"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


def test_qual_decode_every_mode(qual_case):
    """The plain scan and qual_decode_batch give the reference's symbols,
    final states, words consumed and updated model, and the symbols are the
    encoded ones."""
    jsyms, jmodel, jx, jptr = qual_case["jdecode"]
    np.testing.assert_array_equal(np.asarray(jsyms), qual_case["qsyms"])
    psyms, px, pptr = qual_case["tplain"]
    tsyms, tmodel, tx, tptr = qual_case["tdecode"]
    for syms in (psyms, tsyms):
        np.testing.assert_array_equal(syms.numpy(), qual_case["qsyms"])
    for x in (px, tx):
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx).astype(
            np.int64))
    assert int(pptr) == int(tptr) == int(jptr) == qual_case["n_words"]
    np.testing.assert_array_equal(tmodel.numpy(), np.asarray(jmodel))
    np.testing.assert_array_equal(tmodel.numpy(), qual_case["enc_model"])


def test_k3_takes_every_quality_mode():
    """K3's symbol counts are those of the four quality modes."""
    assert sorted(quality.K3_SYM) == sorted(
        quality.QualConfig(mode=m).n_sym for m in MODES + ["illumina_8"])


# --- the CLI takes every mode ---------------------------------------------

_QM = ["o", "8", "4", "2", "n"]
_IM = ["o", "i", "n", None]


@pytest.mark.parametrize("qm", _QM)
@pytest.mark.parametrize("im", _IM)
def test_cli_modes_pass_the_port_mode_check(tmp_path, qm, im):
    """Each -qm/-im pair of the CLI: a header-only archive of its Params
    (the tables cut to 2^8 buckets) round-trips through the port's
    decoder to an empty FASTQ."""
    from fqsqueezer_tpu_torch.archive import ArchiveWriter

    argv = ["e", "-s", "-om", "o", "-qm", qm] + (
        ["-im", im] if im else []) + ["a.fq"]
    p = cli.parse_args(argv)
    p.smer_log2_buckets = p.bmer_log2_buckets = 8
    arc, out = str(tmp_path / "a.fqst"), str(tmp_path / "o.fq")
    ArchiveWriter(arc, p.store_params()).close()
    assert pipeline.decompress_file(tparams.Params(), arc, out,
                                    device="cpu") == {"n_reads": 0}
    assert os.path.getsize(out) == 0


# --- archive level, a tiny multi-group geometry -----------------------------

N_READS = 36         # batches of 8, 16 and 12 (padded to 16) reads
GROUP_MEM = 6_000    # the first two batches make one group, the third one
ARCHIVE_PAIRS = [("o", "o"), ("n", "o"), ("4", "i"), ("2", "n")]
# sha256 of fqsqueezer_tpu.pipeline.compress_file's archive of the corpus
# below at each pair's tiny_params (test_reference_writer_digest)
ARCHIVE_SHA256 = {
    ("o", "o"): "0df07193d7c327be7189be1492aaab04af16210ed95a011e534c37f04a84fdf3",
    ("n", "o"): "f93cc75c9b65d44d55d5c5d5e7634248361dd30505e3926bb1476eae6f180aee",
    ("4", "i"): "c76384b328723d162e82c47c3d1de33d20bebdf1e5b16fabb0a1cd2a3a6f9284",
    ("2", "n"): "430121ccc86c259b7af697eca01297d8dd493a993cfb006bda1eaecbfbded8fc",
}


def tiny_params(mod, qm, im):
    """The tiny geometry of tests/test_torch_pipeline.py (8 lanes, 2^8-
    bucket tables, SIV cap 7), batches of at most 16 reads, in one quality
    and id mode. mod: the params module of the package."""
    p = mod.Params()
    p.genome_size = 1
    p.adjust_kmer_sizes()
    p.n_lanes = 8
    p.max_batch_reads = 16
    p.smer_log2_buckets = p.bmer_log2_buckets = 8
    p.dna_siv_cap = 7
    p.dna_mode = mod.DnaMode.SE_ORIGINAL
    p.quality_mode = {"o": mod.QualityMode.LOSSLESS,
                      "8": mod.QualityMode.ILLUMINA_8,
                      "4": mod.QualityMode.ILLUMINA_4,
                      "2": mod.QualityMode.BINARY,
                      "n": mod.QualityMode.NONE}[qm]
    p.id_mode = {"o": mod.IdMode.LOSSLESS, "i": mod.IdMode.INSTRUMENT,
                 "n": mod.IdMode.NONE}[im]
    p.verbosity = 0
    return p


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_modes")
    src = str(d / "in.fastq")
    write_fastq_corpus(src, N_READS, 40, 60_000, seed=8)
    return src, d


@pytest.fixture(scope="module", params=ARCHIVE_PAIRS,
                ids=[f"qm{q}-im{i}" for q, i in ARCHIVE_PAIRS])
def port_archive(request, corpus):
    """The port's archive of the corpus in one mode pair, and its decode
    (pipeline.decompress_file on the CPU)."""
    qm, im = request.param
    src, d = corpus
    arc = str(d / f"port_{qm}{im}.fqst")
    out = str(d / f"port_{qm}{im}.fastq")
    stats = pipeline.compress_file(tiny_params(tparams, qm, im), src, arc,
                                   group_mem_bytes=GROUP_MEM, device="cpu")
    dstats = pipeline.decompress_file(tparams.Params(), arc, out,
                                      device="cpu")
    return (qm, im), src, arc, out, stats, dstats


def test_port_archive_is_the_reference_writers(port_archive):
    pair, _, arc, _, stats, _ = port_archive
    assert _sha256(arc) == ARCHIVE_SHA256[pair]
    assert stats["n_reads"] == N_READS
    # two groups: the id chain restarts at the second
    rd = ArchiveReader(arc)
    try:
        p = tparams.Params.load_params(rd.header_blob)
        groups = 0
        while rd.read_group(p.n_lanes) is not None:
            groups += 1
    finally:
        rd.close()
    assert groups == 2


def _expected_fastq(src, path, qm, im):
    """The input as the mode pair keeps it, written by the reference's
    FASTQ writer: qualities through the reference's qual_maps (all
    quality_thr without a quality stream), ids whole, cut to the instrument
    prefix, or none."""
    a = jfastq.read_fastq(src)
    mode = {"o": "lossless", "4": "illumina_4", "2": "binary"}.get(qm)
    if mode is None:
        quals = np.full(a.quals.shape, jparams.Params().quality_thr, np.uint8)
    else:
        fwd, rev = jq.qual_maps(mode, 20)
        quals = rev[fwd[np.minimum(a.quals, 95)]].astype(np.uint8)
    id_list = {"o": a.ids, "i": jids.instrument_prefix(a.ids),
               "n": None}[im]
    jfastq.write_fastq(path, a.codes, quals, a.lengths, id_list)
    return path


def test_port_decodes_its_archive(port_archive, corpus):
    """Byte for byte the input for `-qm o -im o`; otherwise the input with
    its qualities and ids as the modes keep them."""
    (qm, im), src, _, out, _, dstats = port_archive
    assert dstats["n_reads"] == N_READS
    want = src if (qm, im) == ("o", "o") else _expected_fastq(
        src, str(corpus[1] / f"want_{qm}{im}.fastq"), qm, im)
    with open(out, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.slow
def test_reference_writer_digest(port_archive):
    """ARCHIVE_SHA256 is the reference writer's archive: its bytes are the
    port's."""
    (qm, im), src, arc, _, stats, _ = port_archive
    jarc = arc + ".jax"
    with contextlib.redirect_stdout(io.StringIO()):
        jstats = jp.compress_file(tiny_params(jparams, qm, im), src, jarc,
                                  group_mem_bytes=GROUP_MEM)
    with open(jarc, "rb") as f, open(arc, "rb") as g:
        assert f.read() == g.read()
    assert _sha256(jarc) == ARCHIVE_SHA256[(qm, im)]
    assert jstats["stream_bytes"] == stats["stream_bytes"]


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke_rows():
    cs = _chip_smoke()
    rows = [(tag, flags, 20_000, 100, 4_600_000, 42, arc, dec)
            for tag, flags, arc, dec in cs.MODES_20K]
    rows += [(tag, flags, 100_000, 100, 4_600_000, 42, arc, dec)
             for tag, flags, arc, dec in cs.MODES_100K]
    rows.append(("verify", cs.VERIFY[0], 3000, 80, 100_000, 9, cs.VERIFY[1],
                 None))
    return rows


@pytest.mark.slow
@pytest.mark.parametrize("row", _smoke_rows(), ids=lambda r: r[0])
def test_chip_smoke_mode_digests(tmp_path, row):
    """The digests chip_smoke.py holds its mode rows to are the reference
    package's: its writer's archive at the Params the reference CLI makes
    of the row's flags, and its decoder's FASTQ (the input itself where
    qualities and ids are lossless)."""
    from fqsqueezer_tpu import cli as jcli

    tag, flags, n, length, genome, seed, want, want_dec = row
    src, arc = str(tmp_path / "in.fastq"), str(tmp_path / "a.fqst")
    out = str(tmp_path / "o.fastq")
    write_fastq_corpus(src, n, length, genome, seed=seed)
    p = jcli.parse_args(["e", *flags, src])
    p.verbosity = 0
    jp.compress_file(p, src, arc)
    assert _sha256(arc) == want
    if want_dec is None:
        return
    with contextlib.redirect_stdout(io.StringIO()):
        jp.decompress_file(jparams.Params(), arc, out)
    assert _sha256(out) == want_dec
