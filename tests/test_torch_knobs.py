"""The last single-card header knobs: the port against the reference.

Three knobs of params.Params, stored in the archive header and replayed
by the decoder, that no CLI flag sets: dna_sorted_ctx (sorted order: a
position past the prefix a read shares with the previous read of its
lane takes its distance from that prefix as its position bucket,
dna._pos_bucket_sorted), dna_pe_pos_ctx (paired-end with the anchors:
rowA and rowB take read2's coordinates, dna._pe_pos_map) and dna_canon 0
with dna_row_global 1 (the context-keyed table_* cells updated at each
read row's end, tables.table_update with either claim protocol).

The position functions are held to the reference's on numpy inputs from
a seed, every integer equal. The reference's writer and decoder compile
for a minute and more on one CPU core, so the archives are committed
fixtures it wrote (fqsqueezer_tpu_torch/testdata/knobs, see its README),
with the sha256 of its decoder's output of each (SHA256SUMS): the port's
writer must give the same bytes and its decoder the same output. The
plain decode (K2's plain version, dna_decode_row_plain a row) of a
fixture's second batch under each position map is held to the digest of
the reference's dna_decode_batch on the same inputs (DECODE_BATCH_SHA256).
Under `slow` the reference recomputes those digests, and with
ROTATE_KNOB_FIXTURES=1 it rewrites the fixtures, each checked for its
own round trip first.
"""
import hashlib
import os

import numpy as np
import pytest
import torch

from fqsqueezer_tpu_torch import cli, pipeline
from fqsqueezer_tpu_torch import params as tparams
from fqsqueezer_tpu_torch.archive import ArchiveReader
from fqsqueezer_tpu_torch.io import fastq
from fqsqueezer_tpu_torch.parallel import mesh_pipeline
from fqsqueezer_tpu_torch.streams import dna
from fqsqueezer_tpu_torch.utils.corpus import (write_fastq_corpus,
                                               write_pe_corpus)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "fqsqueezer_tpu_torch", "testdata", "knobs")

SORTED_CTX = {"dna_sorted_ctx": 1}
PE_POS = {"dna_pe_pos_ctx": 1}
CANON0_RG = {"dna_canon": 0, "dna_row_global": 1, "dna_claim_rounds": 0}
# name -> (flags, knobs, corpus: reads or pairs, read length, seed, genome
# bases, mesh dp x tp or None). Two batches each (knob_params): the
# second reads the tables and the model the first left, and in PE finds
# anchors in the pair table, so the PE corpora come from a 400-base
# genome.
SPECS = {
    "sorted_ctx": (("-s", "-om", "s", "-qm", "8", "-im", "n"), SORTED_CTX,
                   (24, 48, 61, 20_000), None),
    "pe_pos": (("-p", "-om", "o", "-qm", "n", "-im", "n"), PE_POS,
               (24, 48, 63, 400), None),
    "pe_pos_sorted": (("-p", "-om", "s", "-qm", "n", "-im", "n"),
                      {**PE_POS, **SORTED_CTX}, (24, 48, 65, 400), None),
    "canon0_rg": (("-s", "-om", "o", "-qm", "8", "-im", "n"), CANON0_RG,
                  (24, 48, 67, 20_000), None),
    "canon0_rg_r2": (("-s", "-om", "o", "-qm", "8", "-im", "n"),
                     {**CANON0_RG, "dna_claim_rounds": 2},
                     (24, 48, 69, 20_000), None),
    "canon0_rg_sorted": (("-s", "-om", "s", "-qm", "8", "-im", "n"),
                         CANON0_RG, (24, 48, 71, 20_000), None),
    "canon0_rg_dp2tp2": (("-s", "-om", "o", "-qm", "8", "-im", "n"),
                         CANON0_RG, (48, 48, 73, 20_000), (2, 2)),
}
# the fixtures whose second batch's decode is held to the reference's
# dna_decode_batch: the position maps and the row-global table cells
MAPPED = ("sorted_ctx", "pe_pos", "pe_pos_sorted", "canon0_rg_sorted")
# sha256 (_decode_digest) of the reference's dna_decode_batch on each
# MAPPED fixture's second batch (_batch_inputs): the decoded reads, final
# lane states, words consumed, extras and the new DNA state
DECODE_BATCH_SHA256 = {
    "sorted_ctx":
        "528521f6f73f81e71cbf75a086ab1f844e021236e538c94a454e52a58980caf2",
    "pe_pos":
        "3ea6c1995a08131c34d662616e92fd51a2ed429d6927ed3d218889c0902e93b2",
    "pe_pos_sorted":
        "b0d4200e2566c9a31e3d106065fe384a0ee3b313ef1027e68a6a6d0cd26740bc",
    "canon0_rg_sorted":
        "b110b30ca2d67c27f9d9c3d4d89d7bb8c35d34be4603ab1ba1551df1fa1ed1a9",
}


def knob_params(mod, name, files):
    """The Params a fixture was written with, from the CLI of either
    package (mod: a params module): `e FLAGS -gs 1` with the knobs set
    and ctx v1 (dna_ctx_v 1, so no rough rescue: a model of 2^20 + 2^19
    rows, whose update a batch costs a sixth of today's 2^23 + 2^19 on a
    CPU core), 8 lanes, 2^10-bucket s/b tables (they grow), SIV cap 7,
    batches of at
    most 16 reads (SE: 8, then 16) or 32 (PE: 8 pairs, then 16); the mesh
    fixture 16 lanes, 64-read batches (32, then 64) and 2^12-bucket
    tables (tp shards them), as the mesh fixtures of
    testdata/mesh_legacy."""
    flags, knobs, _, mesh = SPECS[name]
    if mod is tparams:
        parse = cli.parse_args
    else:
        from fqsqueezer_tpu.cli import parse_args as parse
    p = parse(["e", *flags, "-gs", "1", *files])
    for k, v in {**knobs, "dna_ctx_v": 1}.items():
        setattr(p, k, v)
    p.adjust_kmer_sizes()
    p.n_lanes, p.max_batch_reads, log2b = (
        (16, 64, 12) if mesh else (8, 32, 10) if "-p" in flags
        else (8, 16, 10))
    p.smer_log2_buckets = p.bmer_log2_buckets = log2b
    p.dna_siv_cap = 7
    p.verbosity = 0
    return p


def write_inputs(name, d):
    """The fixture's input FASTQ file(s) in directory d: utils.corpus's
    generators."""
    flags, _, (n, L, seed, genome), _ = SPECS[name]
    if "-p" in flags:
        paths = [os.path.join(d, f"{name}_{k}.fastq") for k in (1, 2)]
        write_pe_corpus(*paths, n, L, genome, seed=seed)
        return paths
    path = os.path.join(d, f"{name}.fastq")
    write_fastq_corpus(path, n, L, genome, seed=seed)
    return [path]


def write_archive(pipe, mesh_pipe, params_mod, name, files, arc, **kw):
    """The fixture's archive through either package's writer (pipe: its
    pipeline module, mesh_pipe: its parallel.mesh_pipeline)."""
    p = knob_params(params_mod, name, files)
    mesh = SPECS[name][3]
    if mesh is not None:
        return mesh_pipe.compress_file_mesh(p, files[0], arc, dp=mesh[0],
                                            tp=mesh[1], **kw)
    if len(files) == 2:
        return pipe.compress_pe(p, *files, arc, **kw)
    return pipe.compress_file(p, files[0], arc, **kw)


def fixture(name):
    return os.path.join(FIXTURES, f"{name}.fqst")


def out_names(name):
    if "-p" in SPECS[name][0]:
        return [f"{name}_1.fastq", f"{name}_2.fastq"]
    return [f"{name}.fastq"]


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _sums():
    """SHA256SUMS: output file name -> sha256 of the reference decoder's
    output."""
    out = {}
    with open(os.path.join(FIXTURES, "SHA256SUMS")) as f:
        for line in f:
            sha, name = line.split()
            out[name] = sha
    return out


def _reads(path):
    """A FASTQ file's bases, a read."""
    d = fastq.read_fastq(path)
    return [bytes(d.codes[i, :d.lengths[i]]) for i in range(d.n_reads)]


def _same_reads(flags, outs, srcs):
    """The decode's reads are the input's: in order, or as pairs sorted by
    mate 1 in sorted order (flags: -om s; the qualities are quantized or
    dropped, the ids dropped)."""
    got = list(zip(*(_reads(o) for o in outs)))
    want = list(zip(*(_reads(s) for s in srcs)))
    if flags[flags.index("-om") + 1] == "s":
        got, want = sorted(got), sorted(want)
    assert got == want


# --- the position functions --------------------------------------------------

def _i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_position_functions_match_the_reference():
    """_pos_bucket_sorted, _pe_pos_map and _pos_buckets (with and without
    dna_sorted_ctx, the map and the LCPs) on [12, 64] batches from two
    seeds against the reference's, every bucket equal: lengths from 0 to
    64, LCPs from 0 to the length, anchors at read2's start and end and
    none."""
    for seed in (0, 1):
        _check_positions(seed)


def _check_positions(seed):
    import dataclasses

    import jax.numpy as jnp

    from fqsqueezer_tpu.streams import dna as jdna

    rng = np.random.default_rng(seed)
    R, L, B = 12, 64, 21
    lengths = rng.integers(0, L + 1, R)
    lengths[:2] = (0, L)
    lcp = np.minimum(rng.integers(0, L, R), lengths)
    lcp[2] = lengths[2]
    pos = np.arange(L)[None, :]
    a = rng.integers(0, L - B + 1, R // 2)
    a[:2] = (0, L - B)
    has = rng.random(R // 2) < 0.7
    L2 = lengths[1::2]
    lenB = np.where(has, np.minimum(a + B, L2), 0)
    pb = rng.integers(0, 16, (R, L))
    got = dna._pos_bucket_sorted(_i64(pb), _i64(pos), _i64(lengths)[:, None],
                                 _i64(lcp)[:, None])
    want = jdna._pos_bucket_sorted(jnp.asarray(pb), jnp.asarray(pos),
                                   jnp.asarray(lengths)[:, None],
                                   jnp.asarray(lcp)[:, None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_map = dna._pe_pos_map(_i64(lengths), _i64(a), torch.from_numpy(has),
                              _i64(lenB))
    want_map = jdna._pe_pos_map(jnp.asarray(lengths), jnp.asarray(a),
                                jnp.asarray(has), jnp.asarray(lenB), B)
    for g, w in zip(got_map, want_map):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    lens3 = np.resize(lengths, 3 * (R // 2))
    lcp3 = np.zeros_like(lens3)
    lcp3[0::3] = np.minimum(lcp[0::2], lens3[0::3])
    base = dna.DnaConfig()
    for sorted_ctx in (False, True):
        cfg = dataclasses.replace(base, sorted_ctx=sorted_ctx)
        jcfg = jdna.DnaConfig(**dataclasses.asdict(cfg))
        for lens, lcp_r, pmap in ((lengths, None, None), (lengths, lcp, None),
                                  (lens3, lcp3, got_map)):
            got = dna._pos_buckets(
                cfg, _i64(pos), _i64(lens)[:, None],
                None if lcp_r is None else _i64(lcp_r), pmap)
            want = jdna._pos_buckets(
                jcfg, jnp.asarray(pos), jnp.asarray(lens)[:, None],
                None if lcp_r is None else jnp.asarray(lcp_r),
                None if pmap is None else tuple(
                    jnp.asarray(t.numpy()) for t in pmap))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the fixtures ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SPECS))
def test_port_writes_and_decodes_the_reference_archive(tmp_path, monkeypatch,
                                                       name):
    """Each fixture: the port's CPU writer gives the reference writer's
    archive byte for byte (the mesh one through its mesh writer), and the
    port's decoder gives the reference decoder's output (SHA256SUMS),
    whose reads are the input's. The PE fixtures' decodes arm anchors
    and the sorted ones' rows share prefixes (LCP > 0), counted and
    printed; the rows take the knobs' position maps. The plain decode
    (K2's plain version, dna_decode_row_plain a row) of each MAPPED
    fixture's second batch equals the reference's dna_decode_batch on
    the same inputs (DECODE_BATCH_SHA256)."""
    files = write_inputs(name, str(tmp_path))
    arc = str(tmp_path / f"{name}.fqst")
    write_archive(pipeline, mesh_pipeline, tparams, name, files, arc,
                  device="cpu")
    with open(arc, "rb") as f, open(fixture(name), "rb") as g:
        assert f.read() == g.read()
    anchored, shared, maps, batches = [], [], set(), []

    def row_end(*a, fn=dna._pe_row_end):
        out = fn(*a)
        anchored.append(int(out[5].sum()))
        return out

    def decode_row(*a, fn=dna.dna_decode_row, pos=None, **k):
        maps.add(None if pos is None else pos.kind)
        return fn(*a, pos=pos, **k)

    def decode_batch(*a, fn=dna.dna_decode_batch, **k):
        if k.get("lcp") is not None:
            shared.append(int((k["lcp"] > 0).sum()))
        batches.append(fn(*a, **k))
        return batches[-1]

    monkeypatch.setattr(dna, "_pe_row_end", row_end)
    monkeypatch.setattr(dna, "dna_decode_row", decode_row)
    monkeypatch.setattr(dna, "dna_decode_batch", decode_batch)
    outs = [str(tmp_path / n) for n in out_names(name)]
    decode = (pipeline.decompress_file if SPECS[name][3] is None
              else mesh_pipeline.decompress_file_mesh)
    decode(tparams.Params(), fixture(name), *outs, device="cpu")
    sums = _sums()
    assert [_sha(o) for o in outs] == [sums[n] for n in out_names(name)]
    _same_reads(SPECS[name][0], outs, files)
    print(f"{name}: {sum(anchored)} anchored lane-rows, {sum(shared)} "
          f"reads with LCP > 0")
    knobs = SPECS[name][1]
    assert (sum(anchored) > 0) == ("-p" in SPECS[name][0])
    assert (sum(shared) > 0) == (SPECS[name][0][2] == "s")
    assert (1 in maps) == bool(knobs.get("dna_sorted_ctx"))
    assert (2 in maps) == bool(knobs.get("dna_pe_pos_ctx"))
    if name in MAPPED:
        # the second batch's plain decode (dna_decode_row_plain a row)
        # against the reference's dna_decode_batch on the same inputs
        assert _decode_digest(batches[1]) == DECODE_BATCH_SHA256[name]


def _batch_inputs(name):
    """The DNA decode inputs of a fixture's second batch, with the DNA
    state its first batch left (k2_compare.real_dna_batch on the CPU)."""
    from fqsqueezer_tpu_torch.tools import k2_compare

    return k2_compare.real_dna_batch(fixture(name), device="cpu")


@pytest.mark.parametrize("name, in_k2", (("canon0_rg", False),
                                         ("sorted_ctx", True)))
def test_k2_plain_version_and_bound_count_only_k2s_update(monkeypatch,
                                                          name, in_k2):
    """K2's plain version and bound on a fixture's second batch
    (k2_compare.plain_row, k2_bound_ms): where K2 applies the row's table
    update itself (canonical row-global tables) both count it; where the
    update runs after K2 as torch ops (context-keyed row-global tables)
    neither does, and the plain version's planes, lane states, words
    consumed and registers are still the whole row step's."""
    from fqsqueezer_tpu_torch.ops import tables
    from fqsqueezer_tpu_torch.tools import k2_compare

    cfg, state, lengths, words, init, L, lcp, pe = _batch_inputs(name)
    assert cfg.row_global and k2_compare.k2_updates(cfg) == in_k2
    rows = []

    def record(cfg, state, length, words, x, ptr, regs, L, lcp=None,
               src=None, be=tables.LOCAL, loc=None, pos=None):
        a = (cfg, state, length, words, x, ptr, regs, L, lcp, src, loc, pos)
        rows.append((a, dna.dna_decode_row_plain(*a[:10], be=be, loc=loc,
                                                 pos=pos)))
        return rows[-1][1]

    monkeypatch.setattr(dna, "dna_decode_row", record)
    dna.dna_decode_batch(cfg, state, lengths, words, init, L, lcp=lcp,
                         **(pe or {}))
    assert rows
    frozen = []
    for a, want in rows:
        got = k2_compare.plain_row(a)
        for g, w in zip(_flat_row(got)[:7], _flat_row(want)[:7]):
            assert torch.equal(g, w)
        changed = not (torch.equal(want[4], a[1].s_tc)
                       and torch.equal(want[5], a[1].b_tc))
        assert changed
        if in_k2:
            assert torch.equal(got[4], want[4])
            assert torch.equal(got[5], want[5])
        else:
            assert got[4] is a[1].s_tc and got[5] is a[1].b_tc
        frozen.append((a, (*want[:4], a[1].s_tc, a[1].b_tc)))
    bound, by = k2_compare.k2_bound_ms(rows)
    assert by == "bytes"
    assert (bound > k2_compare.k2_bound_ms(frozen)[0]) == in_k2


def _flat_row(out):
    planes, *rest = out
    return (*planes, *rest)


def _digest(*arrays):
    """sha256 of arrays' int64 values, in order (a tuple counts as its
    items)."""
    h = hashlib.sha256()
    for a in arrays:
        for x in (a if isinstance(a, tuple) else (a,)):
            x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            h.update(np.ascontiguousarray(x, np.int64).tobytes())
    return h.hexdigest()


def _decode_digest(out):
    codes, st, x, ptr, extras = out
    return _digest(codes, x, ptr, *extras, st.siv, st.s_tc, st.b_tc,
                   st.model, *(() if st.pe is None else st.pe))


@pytest.mark.slow
@pytest.mark.parametrize("name", MAPPED)
def test_reference_decodes_the_mapped_batch(name):
    """DECODE_BATCH_SHA256 is the reference's: its dna_decode_batch on
    _batch_inputs, every output equal to the port's plain decode."""
    import jax
    import jax.numpy as jnp

    from fqsqueezer_tpu import params as jparams
    from fqsqueezer_tpu import pipeline as jp
    from fqsqueezer_tpu.streams import dna as jdna

    cfg, state, lengths, words, init, L, lcp, pe = _batch_inputs(name)
    got = dna.dna_decode_batch(cfg, state, lengths, words, init, L,
                               lcp=lcp, **(pe or {}))
    u32 = lambda t: jnp.asarray(t.numpy().astype(np.uint32))
    i32 = lambda t: jnp.asarray(t.numpy().astype(np.int32))
    rd = ArchiveReader(fixture(name))
    jcfg = jp.make_configs(jparams.Params.load_params(rd.header_blob))[0]
    rd.close()
    jstate = jdna.DnaState(
        siv=u32(state.siv), s_tc=u32(state.s_tc), b_tc=u32(state.b_tc),
        model=i32(state.model),
        pe=None if state.pe is None else tuple(
            u32(t) if k < 4 else i32(t) for k, t in enumerate(state.pe)))
    kw = {}
    if pe is not None:
        kw["lcp_stride"] = pe["lcp_stride"]
        if "pe_words" in pe:
            kw.update(pe_words=u32(pe["pe_words"]),
                      pe_states=u32(pe["pe_states"]))
    want = jax.device_get(jdna.dna_decode_batch(
        jcfg, jstate, i32(lengths), u32(words), u32(init), L,
        lcp=None if lcp is None else i32(lcp), **kw))
    assert _decode_digest(got) == _decode_digest(want)
    print(name, _decode_digest(want))
    assert _decode_digest(want) == DECODE_BATCH_SHA256[name]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SPECS))
def test_reference_writes_and_decodes_the_fixture(tmp_path, name):
    """The reference's writer gives the committed fixture and its decoder
    the committed digest, and that decode's reads are the input's (the
    reference's own round trip). With ROTATE_KNOB_FIXTURES=1 it rewrites
    both, after the round trip holds."""
    from fqsqueezer_tpu import params as jparams
    from fqsqueezer_tpu import pipeline as jp
    from fqsqueezer_tpu.parallel import mesh_pipeline as jmesh

    files = write_inputs(name, str(tmp_path))
    arc = str(tmp_path / f"{name}.fqst")
    write_archive(jp, jmesh, jparams, name, files, arc)
    outs = [str(tmp_path / n) for n in out_names(name)]
    if SPECS[name][3] is None:
        jp.decompress_file(jparams.Params(), arc, *outs)
    else:
        jmesh.decompress_file_mesh_seq(jparams.Params(), arc, *outs)
    _same_reads(SPECS[name][0], outs, files)
    if os.environ.get("ROTATE_KNOB_FIXTURES") == "1":
        os.makedirs(FIXTURES, exist_ok=True)
        with open(arc, "rb") as f, open(fixture(name), "wb") as g:
            g.write(f.read())
        sums = _sums() if os.path.exists(
            os.path.join(FIXTURES, "SHA256SUMS")) else {}
        sums.update({n: _sha(o) for n, o in zip(out_names(name), outs)})
        order = [n for s in sorted(SPECS) for n in out_names(s) if n in sums]
        with open(os.path.join(FIXTURES, "SHA256SUMS"), "w") as f:
            f.writelines(f"{sums[n]}  {n}\n" for n in order)
    with open(arc, "rb") as f, open(fixture(name), "rb") as g:
        assert f.read() == g.read()
    sums = _sums()
    assert [_sha(o) for o in outs] == [sums[n] for n in out_names(name)]


# --- chip_smoke.py's [knobs] ---------------------------------------------------

def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_knob_fixtures_are_the_specs():
    """chip_smoke.py writes the fixtures on the card from its own copy of
    SPECS (the card has no JAX to import this file's): the same inputs,
    knobs, geometry and mesh."""
    cs = _chip_smoke()
    assert {name: (flags, knobs, corpus, mesh) for name, flags, knobs,
            corpus, mesh in cs.KNOB_FIXTURES} == SPECS
    assert cs.KNOBS_DIR == FIXTURES


@pytest.mark.slow
@pytest.mark.parametrize("row", range(7))
def test_chip_smoke_knob_digests(tmp_path, row):
    """chip_smoke.py's KNOBS_FULL digests are the reference's: its
    writer's archive of the bench corpus (or bench pairs) at the row's
    flags and knobs, and its decoder's output files."""
    from fqsqueezer_tpu import cli as jcli
    from fqsqueezer_tpu import params as jparams
    from fqsqueezer_tpu import pipeline as jp

    _, knobs, n, flags, want, want_dec = _chip_smoke().KNOBS_FULL[row]
    if "-p" in flags:
        files = [str(tmp_path / f"in_{k}.fastq") for k in (1, 2)]
        write_pe_corpus(*files, n, 100, 4_600_000, seed=42)
    else:
        files = [str(tmp_path / "in.fastq")]
        write_fastq_corpus(files[0], n, 100, 4_600_000, seed=42)
    p = jcli.parse_args(["e", *flags, *files])
    for k, v in knobs.items():
        setattr(p, k, v)
    p.verbosity = 0
    arc = str(tmp_path / "a.fqst")
    if len(files) == 2:
        jp.compress_pe(p, *files, arc)
    else:
        jp.compress_file(p, files[0], arc)
    outs = [str(tmp_path / f"o_{k}.fastq") for k in range(len(files))]
    jp.decompress_file(jparams.Params(), arc, *outs)
    print(row, _sha(arc), tuple(_sha(o) for o in outs))
    _same_reads(flags, outs, files)
    assert _sha(arc) == want
    assert tuple(_sha(o) for o in outs) == want_dec
