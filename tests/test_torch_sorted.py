"""Sorted read order (-om s) and block-streamed input in the port, against
the reference package, exact.

Function level: meta.compute_lcp, the meta stream with its LCP byte, the
DNA encoder's row pass with LCP and the DNA decode (the plain K2 row step,
which copies each read's shared prefix from the previous read row) take
the same inputs, made from a seed with numpy, as the reference's
functions, and must give the same integers. Archive level: a tiny sorted
corpus at the CLI's defaults (-om s -qm 8 -im i) and at -om s -qm o -im n
is compressed by both packages to the same bytes, and the port decodes
the reference's archive to the reference decoder's bytes. Streamed: the
port's archive of a block-streamed input equals its in-RAM archive and
the reference's; the id prescan reads header lines only and gives the
reference's values; the CLI streams what the reference CLI streams.
Tolerance 0 everywhere: the codec is integer-only. Everything of the port
runs on the CPU (the plain versions of its kernels).
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fqsqueezer_tpu import params as jparams
from fqsqueezer_tpu import pipeline as jp
from fqsqueezer_tpu.io import fastq as jfastq
from fqsqueezer_tpu.streams import dna as jdna
from fqsqueezer_tpu.streams import meta as jmeta
from fqsqueezer_tpu.utils.corpus import make_genome, sample_reads
from fqsqueezer_tpu_torch import cli
from fqsqueezer_tpu_torch import params as tparams
from fqsqueezer_tpu_torch import pipeline
from fqsqueezer_tpu_torch.ops import rans
from fqsqueezer_tpu_torch.state import state_from_numpy, state_to_numpy
from fqsqueezer_tpu_torch.streams import common, dna, meta
from fqsqueezer_tpu_torch.utils.dna_batches import bench_dna_config

SB = 14
N = 8             # lanes of the tiny geometry


def _prefix_reads(seed, R, L, dup_lane=None):
    """codes [R, L] uint8 (N = 4, zero past the length) and lengths [R]
    int32 of reads from a small genome, lane-major over N lanes (read r is
    read r % (R // N) of lane r // (R // N)): unequal lengths with N bases,
    and most reads sharing a prefix of random length with the read before
    them in the file — the previous read of the lane, or for a lane's first
    read the previous lane's last read, whose prefix compute_lcp does not
    count. dup_lane: a lane whose reads are all one read."""
    genome = make_genome(max(400, R * L // 6), seed)
    codes, _ = sample_reads(genome, R, L, seed + 1, err_rate=0.01,
                            n_rate=0.02)
    rng = np.random.default_rng(seed + 2)
    lengths = np.where(rng.random(R) < 0.5, L,
                       rng.integers(0, L + 1, R)).astype(np.int32)
    for r in range(1, R):
        if rng.random() < 0.8:
            k = int(rng.integers(0, lengths[r] + 1))
            codes[r, :k] = codes[r - 1, :k]
    if dup_lane is not None:
        r_pl = R // N
        lane = slice(dup_lane * r_pl, (dup_lane + 1) * r_pl)
        codes[lane] = codes[dup_lane * r_pl]
        lengths[lane] = L
    tail = np.arange(L)[None, :] >= lengths[:, None]
    return np.where(tail, 0, codes).astype(np.uint8), lengths


def test_compute_lcp_matches_reference():
    """300 columns, so the 255 cap binds; lane-first reads count 0."""
    codes, lengths = _prefix_reads(1, 6 * N, 300, dup_lane=3)
    got = meta.compute_lcp(torch.from_numpy(codes.astype(np.int64)),
                           torch.from_numpy(lengths), N)
    want = jmeta.compute_lcp(jnp.asarray(codes, jnp.int32),
                             jnp.asarray(lengths), N, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.max()) == 255
    assert (got.numpy()[::6] == 0).all()
    # paired-end's stride: read1 against the previous read1, mates 2 get 0
    got2 = meta.compute_lcp(torch.from_numpy(codes.astype(np.int64)),
                            torch.from_numpy(lengths), N, stride=2)
    want2 = jmeta.compute_lcp(jnp.asarray(codes, jnp.int32),
                              jnp.asarray(lengths), N, 2)
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))
    assert (got2.numpy()[1::2] == 0).all() and int(got2.max()) == 255


def test_meta_modeling_and_decode_with_lcp():
    """The meta stream with its third (LCP) symbol, from a mid-stream
    model: (freq, cum) of the encoder, then its decode of those words."""
    codes, lengths = _prefix_reads(2, 4 * N, 40)
    lcp = meta.compute_lcp(torch.from_numpy(codes.astype(np.int64)),
                           torch.from_numpy(lengths), N)
    rng = np.random.default_rng(3)
    model = rng.integers(0, 40, (meta.N_CTX, meta.N_SYM)).astype(np.int32)
    cfg = meta.MetaConfig(n_lanes=N, with_lcp=True)
    jcfg = jmeta.MetaConfig(n_lanes=N, with_lcp=True)
    got = meta.meta_modeling(cfg, torch.from_numpy(model),
                             torch.from_numpy(lengths), lcp)
    want = jmeta.meta_modeling(jcfg, jnp.asarray(model), jnp.asarray(lengths),
                               jnp.asarray(lcp.numpy(), jnp.int32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    f, c = (common.to_grid(a, N).to(torch.int32) for a in got[2:])
    words, n, x = rans.rans_encode(f, c, SB)
    w = np.zeros(3 * 4 * N, np.int64)
    w[:int(n)] = words.numpy()
    tout = meta.meta_decode_batch(cfg, torch.from_numpy(model), 4 * N,
                                  torch.from_numpy(w), x)
    jout = jax.device_get(jmeta.meta_decode_batch(
        jcfg, jnp.asarray(model), 4 * N, jnp.asarray(w, jnp.uint32),
        jnp.asarray(x.numpy(), jnp.uint32)))
    for g, wnt in zip(tout, jout):
        np.testing.assert_array_equal(np.asarray(g.numpy()), wnt)
    np.testing.assert_array_equal(tout[0].numpy(), lengths)
    np.testing.assert_array_equal(tout[1].numpy(), lcp.numpy())


# --- the DNA stream with LCP: the encoder's row pass and the decode ----------

L_DNA = 40        # the DNA batch's columns
R_PL = 2          # read rows of the DNA batch


def _dna_cfgs():
    """Both packages' configs (dna, quality, meta, ids) of a tiny sorted
    geometry: 8 lanes, 2^10-bucket tables, SIV cap 7 (no prefix ramp)."""
    p = jparams.Params()
    p.genome_size = 1
    p.adjust_kmer_sizes()
    p.n_lanes = N
    p.smer_log2_buckets = p.bmer_log2_buckets = 10
    p.dna_siv_cap = 7
    p.dna_mode = jparams.DnaMode.SE_SORTED
    tp = tparams.Params.load_params(p.store_params())
    return jp.make_configs(p), pipeline.make_configs(tp)


@pytest.fixture(scope="module")
def dna_batch():
    """A mid-stream DNA state (two warm-up batches through the port's
    encoder) and one batch with LCP: a duplicate lane (lcp == length in
    its second row), chained prefixes, and a first row whose reads repeat
    the reads before them in the file but are coded in full. Both
    packages encode it; the port's grids are rANS-coded into the words
    both decode."""
    (jd, *_), (td, *_) = _dna_cfgs()
    state = dna.dna_state_create(td)
    for k in range(2):
        codes, lengths = _prefix_reads(10 + k, 4 * N, L_DNA)
        c = torch.from_numpy(codes.astype(np.int64))
        n = torch.from_numpy(lengths.astype(np.int64))
        eff, ctx, sym, _, _, act, s_tc, b_tc = dna.dna_process_batch_rg(
            td, state, c, torch.where(c >= 4, 0, c), n,
            lcp=meta.compute_lcp(c, n, N))
        state = dna.dna_collect_updates(
            td, state._replace(s_tc=s_tc, b_tc=b_tc), c, eff, n, ctx, sym,
            act, skip_sb=True)
    codes, lengths = _prefix_reads(20, R_PL * N, L_DNA, dup_lane=5)
    c = torch.from_numpy(codes.astype(np.int64))
    n = torch.from_numpy(lengths.astype(np.int64))
    lcp = meta.compute_lcp(c, n, N)
    start = state_to_numpy(pipeline.CodecState(dna=state, meta=None,
                                               qual=None))
    got = dna.dna_process_batch_rg(td, state, c, torch.where(c >= 4, 0, c),
                                   n, lcp=lcp)
    jstate = jdna.DnaState(*(jnp.asarray(start[k]) for k in
                             ("siv", "s_tc", "b_tc", "model")))
    jc = jnp.asarray(codes, jnp.int32)
    want = jax.device_get(jdna.dna_process_batch_rg(
        jd, jstate, jc, jnp.where(jc >= 4, 0, jc), jnp.asarray(lengths),
        lcp=jnp.asarray(lcp.numpy(), jnp.int32)))
    f, cum = (common.to_grid(a, N).to(torch.int32) for a in got[3:5])
    words, nw, x = rans.rans_encode(f, cum, SB)
    w = np.zeros(R_PL * N * L_DNA, np.int64)
    w[:int(nw)] = words.numpy()
    return {"cfgs": (jd, td), "start": start, "jstate": jstate,
            "codes": codes, "lengths": lengths, "lcp": lcp, "got": got,
            "want": want, "words": w, "x": x.numpy(), "n_words": int(nw)}


def test_batch_has_what_the_decode_must_survive(dna_batch):
    lcp, lengths = dna_batch["lcp"].numpy(), dna_batch["lengths"]
    assert (lcp[0::R_PL] == 0).all()                 # the first row
    row1 = slice(1, None, R_PL)
    assert ((lcp[row1] > 0) & (lcp[row1] < lengths[row1])).any()
    assert lcp[5 * R_PL + 1] == lengths[5 * R_PL + 1] == L_DNA
    first = dna_batch["codes"][0::R_PL][1:]          # lane-first reads ...
    before = dna_batch["codes"][R_PL - 1::R_PL][:-1]  # ... and their
    assert (first[:, :4] == before[:, :4]).all(axis=1).any()  # predecessors


@pytest.mark.parametrize("k,name", list(enumerate(
    ["eff", "ctx_all", "sym_enc", "f", "c", "code_active", "s_tc", "b_tc"])))
def test_dna_process_batch_rg_with_lcp(dna_batch, k, name):
    """Every output and both updated tables equal the reference's; coded
    positions are exactly the in-length ones at or past the LCP."""
    np.testing.assert_array_equal(dna_batch["got"][k].numpy(),
                                  dna_batch["want"][k], err_msg=name)
    if name == "code_active":
        pos = np.arange(L_DNA)[None, :]
        np.testing.assert_array_equal(
            dna_batch["got"][k].numpy(),
            (pos < dna_batch["lengths"][:, None])
            & (pos >= dna_batch["lcp"].numpy()[:, None]))


@pytest.fixture(scope="module")
def dna_decoded(dna_batch):
    """The batch's words decoded by both packages' dna_decode_batch with
    LCP (the port's rows through the plain K2 step)."""
    # the reference's decode scan unrolls DECODE_UNROLL steps a loop trip,
    # a speed knob with no effect on values; one step compiles fastest
    unroll, jdna.DECODE_UNROLL = jdna.DECODE_UNROLL, 1
    try:
        jd, td = dna_batch["cfgs"]
        lengths, lcp = dna_batch["lengths"], dna_batch["lcp"]
        jcodes, jst, jx, jptr, jextras = jdna.dna_decode_batch(
            jd, dna_batch["jstate"], jnp.asarray(lengths),
            jnp.asarray(dna_batch["words"], jnp.uint32),
            jnp.asarray(dna_batch["x"], jnp.uint32), L_DNA,
            lcp=jnp.asarray(lcp.numpy(), jnp.int32), lcp_stride=1)
        want = jax.device_get((jcodes, jx, jptr, jextras, jst))
    finally:
        jdna.DECODE_UNROLL = unroll
    got = dna.dna_decode_batch(
        td, state_from_numpy(dna_batch["start"]).dna,
        torch.from_numpy(lengths.astype(np.int64)),
        torch.from_numpy(dna_batch["words"]), torch.from_numpy(
            dna_batch["x"]), L_DNA, lcp=lcp, lcp_stride=1)
    return got, want


def test_dna_decode_batch_with_lcp(dna_batch, dna_decoded):
    """Codes, the eff, ctx and sym planes at every position (copied prefix
    positions included), the final states, the words consumed and the
    coded mask equal the reference decoder's; the codes are the batch's
    reads and every word is consumed."""
    (tcodes, _, tx, tptr, textras), (jcodes, jx, jptr, jextras, _) = \
        dna_decoded
    np.testing.assert_array_equal(tcodes.numpy(), jcodes)
    np.testing.assert_array_equal(tcodes.numpy(), dna_batch["codes"])
    for g, w, name in zip(textras, jextras, ("eff", "ctx", "sym", "coded")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_array_equal(tx.numpy(), jx)
    assert int(tptr) == int(jptr) == dna_batch["n_words"]


@pytest.mark.parametrize("key", ["siv", "s_tc", "b_tc", "model"])
def test_dna_decode_state_with_lcp(dna_batch, dna_decoded, key):
    """The decoded batch's state equals the reference decoder's and the
    port encoder's (the prefix positions feed the tables and the SIV, not
    the model)."""
    got = state_to_numpy(pipeline.CodecState(
        dna=dna_decoded[0][1], meta=None, qual=None))[key]
    np.testing.assert_array_equal(got, getattr(dna_decoded[1][4], key))
    if key in ("s_tc", "b_tc"):
        np.testing.assert_array_equal(
            got, dna_batch["got"][6 if key == "s_tc" else 7].numpy()
            .astype(np.uint32))


def test_dna_decode_refuses_paired_end_lcp_stride():
    """Strides 1 (single-end) and 2 (paired-end) are decoded
    (tests/test_torch_pe.py); any other is refused."""
    with pytest.raises(NotImplementedError, match="stride 3"):
        dna.dna_decode_batch(bench_dna_config(N), None, torch.zeros(N),
                             None, None, 8, lcp=torch.zeros(N),
                             lcp_stride=3)


# --- archives --------------------------------------------------------------

GROUP_MEM = 2_000    # a group or two a corpus


def tiny_params(mod, flags):
    """The Params each package's CLI makes of `flags` (sorted order, -qm 8,
    -im i unless they say otherwise), on a tiny geometry: 8 lanes,
    32-read batches (so batches of 1, 4 and 4 read rows), 2^12-bucket
    tables, SIV cap 7."""
    cli_mod = cli if mod is tparams else jp_cli()
    p = cli_mod.parse_args(["e", "-gs", "1", *flags, "x.fq"])
    p.n_lanes = N
    p.max_batch_reads = 32
    p.smer_log2_buckets = p.bmer_log2_buckets = 12
    p.dna_siv_cap = 7
    p.verbosity = 0
    return p


def jp_cli():
    from fqsqueezer_tpu import cli as jcli

    return jcli


def write_sorted_corpus(path, n=48, L=40, seed=5):
    """Reads of ragged lengths from a genome of 3 L bases (so that sorting
    brings shared prefixes and duplicates together), with N bases and
    Illumina-like ids."""
    genome = make_genome(3 * L, seed)
    codes, quals = sample_reads(genome, n, L, seed + 1, err_rate=0.01,
                                n_rate=0.01)
    rng = np.random.default_rng(seed + 2)
    lengths = np.where(rng.random(n) < 0.7, L,
                       rng.integers(1, L, n)).astype(np.int32)
    tail = np.arange(L)[None, :] >= lengths[:, None]
    ids = [f"SIM{seed}:{i % 3}:FC{i % 2}:{i}:{7 * i} 1:N:0".encode()
           for i in range(n)]
    jfastq.write_fastq(path, np.where(tail, 0, codes).astype(np.uint8),
                       np.where(tail, 0, quals).astype(np.uint8), lengths,
                       ids)


# (tag, flags): the CLI's defaults (-om s -qm 8 -im i), sorted order with
# lossless qualities and no ids, and original order with ids (streamed
# only); with the sha256 of the reference writer's archive of each
# (test_reference_writer_digests_sorted recomputes them) and of the
# reference decoder's FASTQ of it (test_reference_decoder_digests_sorted)
MODES = (("cli_defaults", ()), ("qmo_imn", ("-qm", "o", "-im", "n")))
STREAMED = (("qmo_imn", ("-qm", "o", "-im", "n")),
            ("original_imo", ("-om", "o", "-qm", "n", "-im", "o")))
ARCHIVE_SHA256 = {
    "cli_defaults":
        "9a1b8f4600b8cef79dc51b9250226d8b57de1c7dbde28e383aa934914959e50d",
    "qmo_imn":
        "51efabb140f105389b29d338e2e9c86d2f3008c630011c74ba1d97a592b981eb",
    "original_imo":
        "fe39f53411efce41bc07ce0f940ee31bee447e9f3e476e8115a47900780544cf",
}
DECODED_SHA256 = {
    "cli_defaults":
        "63162ed911ee5be51e892156c93682cd5e31cf1ac7acfc5c7825856d3ee495b4",
    "qmo_imn":
        "fda932370ef57f2dffc5c64fcff4ffd26200ae8a5ac025ac33909b216e5bd243",
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sorted")
    src = str(d / "in.fastq")
    write_sorted_corpus(src)
    return src, d


@pytest.fixture(scope="module")
def archives(corpus):
    """Per sorted mode: (the port's archive, its decode of it)."""
    src, d = corpus
    out = {}
    for tag, flags in MODES:
        arc, dec = str(d / f"{tag}.fqst"), str(d / f"{tag}.fastq")
        pipeline.compress_file(tiny_params(tparams, flags), src, arc,
                               group_mem_bytes=GROUP_MEM, device="cpu")
        pipeline.decompress_file(tparams.Params(), arc, dec, device="cpu")
        out[tag] = (arc, dec)
    return out


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.mark.parametrize("tag", [t for t, _ in MODES])
def test_sorted_archive_is_the_reference_writers(archives, tag):
    """The port's archive has the reference writer's sha256, over more than
    one group and batch."""
    arc = archives[tag][0]
    assert _sha256(arc) == ARCHIVE_SHA256[tag]
    from fqsqueezer_tpu_torch.archive import ArchiveReader

    rd = ArchiveReader(arc)
    groups = []
    while (g := rd.read_group(N)) is not None:
        groups.append(len(g[1]))
    rd.close()
    assert len(groups) >= 2 and sum(groups) == 3


@pytest.mark.parametrize("tag", [t for t, _ in MODES])
def test_port_decodes_reference_sorted_archive(archives, corpus, tag):
    """The port decodes the reference writer's archive (the port's own is
    the same bytes) to the reference decoder's FASTQ; its reads are the
    input's, sorted."""
    dec = archives[tag][1]
    assert _sha256(dec) == DECODED_SHA256[tag]
    a, b = jfastq.read_fastq(corpus[0]), jfastq.read_fastq(dec)
    order = jfastq.sort_order(a.codes, a.lengths)
    np.testing.assert_array_equal(b.lengths, a.lengths[order])
    np.testing.assert_array_equal(b.codes, a.codes[order])
    if tag == "qmo_imn":
        np.testing.assert_array_equal(b.quals, a.quals[order])


@pytest.mark.slow
@pytest.mark.parametrize("tag,flags", MODES + STREAMED[1:])
def test_reference_writer_digests_sorted(corpus, tag, flags):
    """ARCHIVE_SHA256 is the reference writer's archive of each mode."""
    src, d = corpus
    arc = str(d / f"{tag}.ref.fqst")
    jp.compress_file(tiny_params(jparams, flags), src, arc,
                     group_mem_bytes=GROUP_MEM)
    assert _sha256(arc) == ARCHIVE_SHA256[tag]


@pytest.mark.slow
@pytest.mark.parametrize("tag", [t for t, _ in MODES])
def test_reference_decoder_digests_sorted(archives, corpus, tag):
    """DECODED_SHA256 is the reference decoder's output for the port's
    archive of each mode."""
    out = str(corpus[1] / f"{tag}.ref.fastq")
    jp.decompress_file(jparams.Params(), archives[tag][0], out)
    assert _sha256(out) == DECODED_SHA256[tag]


@pytest.mark.slow
@pytest.mark.parametrize("n_reads,row", [(20_000, "SORTED_CLI"),
                                         (100_000, "SORTED_100K")])
def test_chip_smoke_sorted_digests(tmp_path, n_reads, row):
    """The digests chip_smoke.py holds its sorted phase to are the
    reference package's: its writer's archive of the bench corpus at the
    Params the reference CLI makes of the row's flags, and its decoder's
    FASTQ of it."""
    import importlib.util
    import os

    from fqsqueezer_tpu.utils.corpus import write_fastq_corpus

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    flags, want, want_dec = getattr(cs, row)
    src, arc = str(tmp_path / "in.fastq"), str(tmp_path / "a.fqst")
    out = str(tmp_path / "o.fastq")
    write_fastq_corpus(src, n_reads, 100, 4_600_000, seed=42)
    p = jp_cli().parse_args(["e", *flags, src])
    p.verbosity = 0
    jp.compress_file(p, src, arc)
    assert _sha256(arc) == want
    jp.decompress_file(jparams.Params(), arc, out)
    assert _sha256(out) == want_dec


# --- block-streamed input ------------------------------------------------------

@pytest.mark.parametrize("tag,flags", STREAMED)
def test_streamed_archive_equals_in_ram_and_reference(archives, corpus, tag,
                                                      flags):
    """stream_chunk_bytes=512 cuts the input into chunks of a few reads
    (sorted order through the external bin sort); the archive is the
    in-RAM one's and the reference writer's, byte for byte."""
    src, d = corpus
    arcs = [archives[tag][0]] if tag in archives else []
    for chunk in ((512,) if arcs else (0, 512)):
        arcs.append(str(d / f"{tag}.{chunk}.fqst"))
        pipeline.compress_file(tiny_params(tparams, flags), src, arcs[-1],
                               group_mem_bytes=GROUP_MEM, device="cpu",
                               stream_chunk_bytes=chunk)
    assert [_sha256(a) for a in arcs] == [ARCHIVE_SHA256[tag]] * 2


def test_streamed_sorted_with_ids_raises_the_reference_error(corpus):
    src = corpus[0]
    with pytest.raises(ValueError) as want:
        jp.compress_file(tiny_params(jparams, ()), src, "unused.fqst",
                         stream_chunk_bytes=4096)
    with pytest.raises(ValueError) as got:
        pipeline.compress_file(tiny_params(tparams, ()), src, "unused.fqst",
                               device="cpu", stream_chunk_bytes=4096)
    assert str(got.value) == str(want.value)
    assert "requires -im n" in str(got.value)


def _ragged_id_files(d):
    """Two FASTQ files that test the header-only prescan: ids of many
    lengths and field counts, CRLF line ends, an empty header, a last
    record without its final newline (it counts) in one file, an
    unfinished record (it does not) in the other."""
    rng = np.random.default_rng(4)
    recs = []
    for i in range(120):
        n_f = int(rng.integers(0, 9))
        hid = ":".join(str(int(v)) for v in rng.integers(0, 10 ** 6, n_f))
        hid = f"M{i % 5}.x{hid} {i}" if i % 7 else ""
        seq = "".join(rng.choice(list("ACGTN"), int(rng.integers(1, 30))))
        eol = "\r\n" if i % 11 == 0 else "\n"
        recs.append(f"@{hid}{eol}{seq}{eol}+{eol}{'I' * len(seq)}{eol}")
    a, b = str(d / "ids_a.fastq"), str(d / "ids_b.fastq")
    with open(a, "w", newline="") as f:
        f.write("".join(recs[:70]).rstrip("\n"))
    with open(b, "w", newline="") as f:
        f.write("".join(recs[70:]) + "@unfinished:1:2:3:4:5:6:7:8:9\nAC\n")
    return [a, b]


@pytest.mark.parametrize("im", ["o", "i"])
@pytest.mark.parametrize("chunk", [64, 333, 1 << 20])
def test_prescan_reads_headers_and_equals_reference(tmp_path, im, chunk):
    paths = _ragged_id_files(tmp_path)
    jparm = jp_cli().parse_args(["e", "-om", "o", "-im", im, *paths])
    tparm = cli.parse_args(["e", "-om", "o", "-im", im, *paths])
    want = jp._prescan_ids_stream(paths, jparm, chunk)
    assert pipeline._prescan_ids_stream(paths, tparm, chunk) == want
    ids = [i for c in pipeline._stream_ids(paths, chunk) for i in c]
    assert ids == [i for c in jfastq.stream_fastq(paths, chunk)
                   for i in c.ids]


_STREAMS = 256 << 20


@pytest.mark.parametrize("flags,chunk", [
    (("-om", "o", "-im", "o"), _STREAMS),
    (("-om", "o", "-im", "i"), _STREAMS),
    (("-om", "s", "-im", "n"), _STREAMS),
    (("-im", "n"), _STREAMS),            # the default order: sorted
    (("-om", "s", "-im", "i"), 0),       # sorted with ids loads the file
    ((), 0)])                            # the defaults: likewise
def test_cli_streams_what_the_reference_cli_streams(tmp_path, monkeypatch,
                                                    flags, chunk):
    """Above the threshold (lowered here to 1 KiB) the CLI's `e` streams
    in 256 MiB chunks where the reference CLI does; below it, it loads."""
    src = str(tmp_path / "in.fastq")
    write_sorted_corpus(src)
    seen = []
    monkeypatch.setattr(pipeline, "compress_file",
                        lambda *a, **k: seen.append(k["stream_chunk_bytes"])
                        or {"n_reads": 0})
    monkeypatch.setattr(cli, "STREAM_THRESHOLD", 1 << 10)
    argv = ["e", "--device", "cpu", "-v", "0", *flags, "-out",
            str(tmp_path / "o"), src]
    assert cli.main(argv) == 0
    monkeypatch.setattr(cli, "STREAM_THRESHOLD", 1 << 20)
    assert cli.main(argv) == 0
    assert seen == [chunk, 0]
