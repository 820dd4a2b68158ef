"""Group snapshots and resume: the port's checkpoint against the reference's.

fqsqueezer_tpu_torch.checkpoint writes the reference package's snapshot
arrays (keys, dtypes, shapes, values: u32 planes with bit 31 set survive
the port's int64), compress_file and compress_pe save one after every
group, and decompress_file(start_group, init_state) resumes from one,
leaving the caller's state as it was (on a CUDA card K2 updates the s/b
tables it decodes against in place). The reference's writer is too slow
for the fast tests (about a minute on one CPU core for these tiny inputs,
its resumed decode some five minutes), so its archives and group-1
snapshots are committed fixtures (fqsqueezer_tpu_torch/testdata/checkpoint/,
see the README there). No tolerance: every array and every byte is equal.

Under `slow`: the fixtures regenerated by the reference's writer, the
reference's decoder resumed from the port's snapshots, and the snapshot
digests of chip_smoke.py's [resume] phase at -gs 5.
"""
import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from fqsqueezer_tpu import checkpoint as jck
from fqsqueezer_tpu import params as jparams
from fqsqueezer_tpu_torch import checkpoint as tck
from fqsqueezer_tpu_torch import params as tparams
from fqsqueezer_tpu_torch import pipeline
from fqsqueezer_tpu_torch.io import fastq as tfastq
from fqsqueezer_tpu_torch.utils import corpus as tcorpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "fqsqueezer_tpu_torch", "testdata",
                        "checkpoint")
# group budgets: SE groups {8, 32} and {32} reads, PE a group a batch
GROUP_MEM = {"se": 8_000, "pe": 3_000}
KINDS = ("se", "pe")


def ck_params(mod, kind):
    """The Params of a fixture, from either package's params module. se:
    -s -om o -qm 8 -im o on 8 lanes, 32-read batches, 2^5-bucket s/b tables
    (they grow at the first group boundary) and SIV cap 7; pe: the PE
    tests' tiny geometry (tests.test_torch_pe.tiny_pe_params) at -om o -qm
    8 -im o."""
    if kind == "pe":
        from tests.test_torch_pe import tiny_pe_params

        return tiny_pe_params(mod, ("-om", "o", "-qm", "8"))
    p = mod.Params()
    p.genome_size = 1
    p.adjust_kmer_sizes()
    p.dna_mode = mod.DnaMode.SE_ORIGINAL
    p.quality_mode = mod.QualityMode.ILLUMINA_8
    p.id_mode = mod.IdMode.LOSSLESS
    p.n_lanes = 8
    p.max_batch_reads = 32
    p.smer_log2_buckets = p.bmer_log2_buckets = 5
    p.dna_siv_cap = 7
    p.verbosity = 0
    return p


def write_input(kind, d):
    """The fixture's input: [path] (56 reads of 40 bases, utils.corpus:
    batches of 8, 16 and 32 reads) or [mate 1, mate 2]
    (tests.test_torch_pe.write_pe_pairs: 24 pairs, batches of 8 and 16)."""
    import pathlib

    if kind == "pe":
        from tests.test_torch_pe import write_pe_pairs

        return write_pe_pairs(pathlib.Path(d))
    path = os.path.join(d, "se.fastq")
    tcorpus.write_fastq_corpus(path, 56, 40, 60_000, seed=5)
    return [path]


def compress(mod, kind, paths, arc, snapshot_prefix=None, **kw):
    """Either package's compress of the fixture's input."""
    p = ck_params(tparams if mod is pipeline else jparams, kind)
    if kind == "pe":
        return mod.compress_pe(p, *paths, arc, group_mem_bytes=GROUP_MEM[kind],
                               snapshot_prefix=snapshot_prefix, **kw)
    return mod.compress_file(p, paths[0], arc,
                             group_mem_bytes=GROUP_MEM[kind],
                             snapshot_prefix=snapshot_prefix, **kw)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _sha(path):
    return hashlib.sha256(_read(path)).hexdigest()


def _arrays(path):
    with np.load(path) as z:
        return dict(z.items())


def assert_same_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- state_to_arrays / arrays_to_state -------------------------------------

def _random_arrays(kind, seed):
    """A snapshot's arrays in the reference's dtypes, random, every u32
    plane with words that have bit 31 set."""
    rng = np.random.default_rng(seed)

    def u32(*shape):
        a = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(
            np.uint32)
        a.reshape(-1)[::3] |= np.uint32(0x80000000)
        return a

    def i32(*shape):
        return rng.integers(0, 1 << 16, shape).astype(np.int32)

    d = {"dna_siv": u32(4096), "dna_s_tc": u32(64, 4), "dna_b_tc": u32(128, 4),
         "dna_model": i32(300, 5), "meta": i32(3, 256), "qual": i32(64, 8),
         "id": i32(79, 256)}
    if kind == "pe":
        d.update({f"dna_pe_{i}": u32(32, 8) for i in range(4)})
        d["dna_pe_4"] = i32(3, 256)
        del d["qual"]
    return d


@pytest.mark.parametrize("kind", KINDS)
def test_state_to_arrays_equals_reference(kind):
    """Both packages give the same snapshot arrays of the same state: keys,
    dtypes, shapes, values; the port's u32 tensors are zero-extended into
    int64 (a sign-extending path would break every K2 tag compare)."""
    d = _random_arrays(kind, 3 + len(kind))
    want = jck.state_to_arrays(jck.arrays_to_state(d))
    state = tck.arrays_to_state(d, "cpu")
    assert_same_arrays(tck.state_to_arrays(state), want)
    assert_same_arrays(want, d)
    for t in (state.dna.siv, state.dna.s_tc, state.dna.b_tc) + (
            state.dna.pe[:4] if kind == "pe" else ()):
        assert t.dtype == torch.int64
        assert int(t.min()) >= 0 and int(t.max()) >= 1 << 31
    assert (state.qual is None) == (kind == "pe")
    # int64 values past 32 bits are masked on the way out, as u32 math is
    s = state.dna.s_tc.clone()
    s[0, 0] = (1 << 40) | 0x80000001
    arrays = tck.state_to_arrays(state._replace(dna=state.dna._replace(
        s_tc=s)))
    assert arrays["dna_s_tc"][0, 0] == 0x80000001


# --- the port's writer and decoder against the reference's fixtures --------

# sha256 of the last records of the reference decoder's full decode of
# each fixture archive, those of groups 1 and on (mate 1's and mate 2's
# files for PE): test_reference_decoder_tails recomputes them
TAIL_SHA256 = {
    "se": ["2b2ae165bc4adcba7b5f99f3e7425bad2e19d94b72d496f6dec070cc91afd0dd"],
    "pe": ["af7ee18bcaffa7059620fe222c279a5444d34c1ba7fec15ebef56ba7424631f3",
           "c104a08512db4820c8a13222ffac937b75127813d9b9c34faabdf05f9428ff2e"]}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Per kind: the input, and the port's archive and group snapshots of
    it (the reference's group sizes)."""
    out = {}
    for kind in KINDS:
        d = str(tmp_path_factory.mktemp(f"ck_{kind}"))
        paths = write_input(kind, d)
        arc = os.path.join(d, "port.fqst")
        compress(pipeline, kind, paths, arc, os.path.join(d, "snap"),
                 device="cpu")
        out[kind] = (paths, arc, os.path.join(d, "snap"), d)
    return out


def fixture(kind, what):
    return os.path.join(FIXTURES, f"{kind}.{what}")


@pytest.mark.parametrize("kind", KINDS)
def test_port_writes_the_references_archive_and_snapshot(port_runs, kind):
    """compress_file / compress_pe with snapshot_prefix: the archive is the
    reference writer's (snapshots change no byte), and the group-1
    snapshot holds the reference's arrays, K2 cells with bit 31 among
    them; the s/b tables of the SE one have grown past their 2^5 rows."""
    _, arc, snap, _ = port_runs[kind]
    assert _read(arc) == _read(fixture(kind, "fqst"))
    got = _arrays(tck.snapshot_path(snap, 1))
    assert_same_arrays(got, _arrays(fixture(kind, "g00001.npz")))
    assert (got["dna_s_tc"] >> 31).any() and (got["dna_b_tc"] >> 31).any()
    if kind == "se":
        assert got["dna_s_tc"].shape[0] > 1 << 5
    else:
        assert "dna_pe_0" in got and "qual" in got and "id" in got


@pytest.mark.parametrize("kind", KINDS)
def test_resume_from_reference_snapshot_twice(port_runs, kind):
    """One load_state of the reference's group-1 snapshot, two decodes from
    group 1: each tail is the full decode's tail, byte for byte (SE, and PE
    with the pair table and pe model in the snapshot): the reference
    decoder's (TAIL_SHA256), whose reads are the input's last ones; the
    loaded state's tensors are unchanged afterwards."""
    paths, _, _, d = port_runs[kind]
    state = tck.load_state(fixture(kind, "g00001.npz"), device="cpu")
    before = [t.clone() for t in _tensors(state)]
    for rep in range(2):
        tail = [os.path.join(d, f"tail{rep}_{k}.fastq")
                for k in range(len(paths))]
        st = pipeline.decompress_file(tparams.Params(), fixture(kind, "fqst"),
                                      *tail, start_group=1, init_state=state,
                                      device="cpu")
        assert [_sha(t) for t in tail] == TAIL_SHA256[kind]
        for t, src in zip(tail, paths):
            got = _reads(t)
            assert 0 < len(got) < len(_reads(src))
            assert _reads(src)[-len(got):] == got
        assert st["n_reads"] == sum(len(_reads(t)) for t in tail)
    after = _tensors(state)
    assert len(after) == len(before)
    assert all(torch.equal(a, b) for a, b in zip(after, before))


def _reads(path):
    """(bases, id) of each record (-qm 8 bins the qualities)."""
    fq = tfastq.read_fastq(path)
    return [(bytes(fq.codes[i, :fq.lengths[i]]), fq.ids[i])
            for i in range(fq.n_reads)]


def _tensors(state):
    d = state.dna
    return [t for t in (d.siv, d.s_tc, d.b_tc, d.model, *(d.pe or ()),
                        state.meta, state.qual, state.id) if t is not None]


def _dna_words_at(path):
    """Byte offset of the middle of the first batch's DNA words (the
    second stream) in the archive's first group."""
    from fqsqueezer_tpu_torch import archive

    rd = archive.ArchiveReader(path)
    try:
        n_lanes = tparams.Params.load_params(rd.header_blob).n_lanes
        f = rd.f
        archive.read_uvarint(f)                       # payload crc
        n_streams = archive.read_uvarint(f)
        f.seek(4 * n_lanes * n_streams, 1)            # the lane states
        archive.read_uvarint(f)                       # batches
        archive.read_uvarint(f)                       # reads
        archive.read_uvarint(f)                       # width
        f.seek(2 * archive.read_uvarint(f), 1)        # meta words
        n_words = archive.read_uvarint(f)
        return f.tell() + n_words
    finally:
        rd.close()


def test_flipped_payload_byte_raises_checksum_mismatch(tmp_path):
    """The payload crc of each group catches a flipped byte of the
    entropy-coded DNA words."""
    path = fixture("se", "fqst")
    blob = bytearray(_read(path))
    blob[_dna_words_at(path)] ^= 0xFF
    bad = tmp_path / "bad.fqst"
    bad.write_bytes(bytes(blob))
    with pytest.raises(ValueError, match="checksum mismatch"):
        pipeline.decompress_file(tparams.Params(), str(bad),
                                 str(tmp_path / "o.fastq"), device="cpu")


# --- slow: the reference's side ---------------------------------------------

def write_reference_fixture(kind, d):
    """The reference writer's archive and group-1 snapshot of a fixture, in
    directory d: (archive path, snapshot path)."""
    from fqsqueezer_tpu import pipeline as jp

    paths = write_input(kind, d)
    arc = os.path.join(d, f"{kind}.fqst")
    compress(jp, kind, paths, arc, os.path.join(d, kind))
    return arc, jck.snapshot_path(os.path.join(d, kind), 1)


@pytest.mark.slow
@pytest.mark.parametrize("kind", KINDS)
def test_reference_writer_regenerates_the_fixtures(tmp_path, kind):
    arc, snap = write_reference_fixture(kind, str(tmp_path))
    assert _read(arc) == _read(fixture(kind, "fqst"))
    assert_same_arrays(_arrays(snap), _arrays(fixture(kind, "g00001.npz")))


@pytest.mark.slow
@pytest.mark.parametrize("kind", KINDS)
def test_reference_resumes_from_port_snapshot(port_runs, kind):
    """The reference's decoder, resumed from the port's group-1 snapshot,
    gives the full decode's tail."""
    from fqsqueezer_tpu import pipeline as jp

    paths, arc, snap, d = port_runs[kind]
    tail = [os.path.join(d, f"jtail_{k}.fastq") for k in range(len(paths))]
    jp.decompress_file(jparams.Params(), arc, *tail, start_group=1,
                       init_state=jck.load_state(tck.snapshot_path(snap, 1)))
    assert [_sha(t) for t in tail] == TAIL_SHA256[kind]


@pytest.mark.slow
@pytest.mark.parametrize("kind", KINDS)
def test_reference_decoder_tails(tmp_path, kind):
    """TAIL_SHA256: the reference decoder's decode of each fixture from its
    group-1 snapshot, which is the tail of its full decode."""
    from fqsqueezer_tpu import pipeline as jp

    n = 1 + (kind == "pe")
    full = [str(tmp_path / f"full_{k}.fastq") for k in range(n)]
    tail = [str(tmp_path / f"tail_{k}.fastq") for k in range(n)]
    jp.decompress_file(jparams.Params(), fixture(kind, "fqst"), *full)
    jp.decompress_file(jparams.Params(), fixture(kind, "fqst"), *tail,
                       start_group=1, init_state=jck.load_state(
                           fixture(kind, "g00001.npz")))
    for t, f in zip(tail, full):
        got = _read(t)
        assert got and _read(f).endswith(got)
    assert [_sha(t) for t in tail] == TAIL_SHA256[kind]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
def test_chip_smoke_resume_digests(tmp_path):
    """chip_smoke.py's [resume] constants: the reference writer's archive
    of each row (the 20k bench corpus, and 10k bench pairs) at its flags and
    group budget, its group count, and the sha256 of each array of its
    group-1 snapshot in the reference's dtype."""
    from fqsqueezer_tpu import cli as jcli
    from fqsqueezer_tpu import pipeline as jp
    from fqsqueezer_tpu.utils import corpus as jcorpus

    cs = _chip_smoke()
    for row in (cs.RESUME_SE, cs.RESUME_PE):
        n, flags, group_mem, want_arc, want_groups, want_arrays = row
        pe = "-p" in flags
        paths = [str(tmp_path / f"in_{k}.fastq") for k in (1, 2)]
        if pe:
            jcorpus.write_pe_corpus(*paths, n, 100, 4_600_000, seed=42)
        else:
            paths = paths[:1]
            jcorpus.write_fastq_corpus(paths[0], n, 100, 4_600_000, seed=42)
        p = jcli.parse_args(["e", *flags, *paths])
        p.verbosity = 0
        arc = str(tmp_path / "r.fqst")
        prefix = str(tmp_path / "snap")
        if pe:
            jp.compress_pe(p, *paths, arc, group_mem_bytes=group_mem,
                           snapshot_prefix=prefix)
        else:
            jp.compress_file(p, paths[0], arc, group_mem_bytes=group_mem,
                             snapshot_prefix=prefix)
        snaps = [f for f in os.listdir(tmp_path) if f.startswith("snap.g")]
        got = {k: hashlib.sha256(v.tobytes()).hexdigest()
               for k, v in _arrays(jck.snapshot_path(prefix, 1)).items()}
        assert (_sha(arc), len(snaps), got) == (want_arc, want_groups,
                                                want_arrays)
        for f in snaps:
            os.remove(tmp_path / f)
