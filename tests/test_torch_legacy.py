"""Archives of the JAX package's older writers: the port against the
reference.

An archive's header names the knobs its writer set, and a key the writer
did not know loads its legacy value (params.Params._HDR_LEGACY), so every
archive of an earlier writer still decodes. params.HEADER_GENERATIONS
names the ones the port takes besides today's: H0, the first writer
(batch-frozen context-keyed table_* tables, ctx v1, no mix or ramp, three
repairs, id codec v1), H1-H4 (H0's tables with in-batch local
statistics, tests/test_torch_local.py; H4 over canonical tables), H5,
the first row-global writer (canonical ktable_* tables with u16
counters, ctx v1) and H6 (H5 with ctx v2 and the rough rescue).

The table families' functions are held to the reference's on the same
inputs, every integer equal: duplicate events in one call, full buckets,
a u16 counter at 0xFFFF (its carry into the neighbouring counter, and out
of the word), grow steps. So are the batch-frozen encoder's modeling
(dna_effective_kcodes, dna_modeling, the batch-level table update) and id
codec v1's modeling, and each header knob's branch
(tests/test_torch_decode.py). The reference's writer and decoder compile
for a minute on one CPU core, so the archives are committed fixtures it
wrote (fqsqueezer_tpu_torch/testdata/legacy, see its README): the port's
writer must give the same bytes, so the reference decodes the port's
archives as it decodes its own, and the port's decode of each must be
its input (lossless modes) or the reference decoder's output (sha256).
Under `slow` the reference rewrites every fixture, and chip_smoke.py's
[legacy] digests are recomputed.
"""
import contextlib
import dataclasses
import hashlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fqsqueezer_tpu import cli as jcli
from fqsqueezer_tpu import params as jparams
from fqsqueezer_tpu import pipeline as jpipeline
from fqsqueezer_tpu.ops import tables as jtables
from fqsqueezer_tpu.streams import dna as jdna
from fqsqueezer_tpu.streams import ids as jids
from fqsqueezer_tpu_torch import cli, pipeline
from fqsqueezer_tpu_torch import params as tparams
from fqsqueezer_tpu_torch.ops import tables
from fqsqueezer_tpu_torch.streams import dna, ids
from fqsqueezer_tpu_torch.utils import dna_batches
from fqsqueezer_tpu_torch.utils.corpus import (write_fastq_corpus,
                                               write_pe_corpus)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "fqsqueezer_tpu_torch", "testdata", "legacy")
GENOME = 20_000

# name -> (generation, flags, corpus: reads or pairs, read length, seed)
SPECS = {
    "h0_se": ("H0", ("-s", "-om", "o", "-qm", "o", "-im", "o"), (64, 48, 5)),
    "h0_sorted": ("H0", ("-s", "-om", "s", "-qm", "o", "-im", "n"),
                  (64, 48, 7)),
    "h0_pe": ("H0", ("-p", "-om", "o", "-qm", "o", "-im", "o"), (32, 48, 9)),
    "h5_se": ("H5", ("-s", "-om", "o", "-qm", "o", "-im", "o"), (64, 48, 11)),
    "h6_se": ("H6", ("-s", "-om", "o", "-qm", "o", "-im", "o"), (24, 48, 13)),
    # the in-batch local statistics' writers (tests/test_torch_local.py)
    "h1_se": ("H1", ("-s", "-om", "o", "-qm", "o", "-im", "o"), (64, 48, 15)),
    "h1_sorted": ("H1", ("-s", "-om", "s", "-qm", "8", "-im", "n"),
                  (64, 48, 17)),
    "h2_se": ("H2", ("-s", "-om", "o", "-qm", "o", "-im", "o"), (64, 48, 19)),
    "h3_se": ("H3", ("-s", "-om", "o", "-qm", "o", "-im", "o"), (64, 48, 21)),
    "h4_se": ("H4", ("-s", "-om", "o", "-qm", "o", "-im", "o"), (64, 48, 23)),
    "h4_pe": ("H4", ("-p", "-om", "o", "-qm", "o", "-im", "o"), (32, 48, 25)),
}
# the local tables' cells of the H1-H4 fixtures (the header stores it)
LOCAL_LOG2_CELLS = 10
# the reference decoder's output, where the decode is not the input (the
# sorted order without ids)
DECODE_SHA256 = {
    "h0_sorted":
        "f000a52e3236d5c17350464721ca299fab537468688d97bcef41938c3a7cb26f",
    "h1_sorted":
        "4092e90d77f29db4ed390698c02962708d27175cd8e051e2dbda94d32699ed20"}


def _i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq(got, want, what=""):
    want = np.asarray(want).astype(np.int64)
    got = got.numpy()
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


def _sha256(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


# --- the table families ----------------------------------------------------

def _events(rng, n, n_keys):
    """lo, hi, base, valid [n] of context events drawn from 3 n_keys keys,
    so that keys recur within a call and across calls."""
    lo = rng.integers(0, n_keys, n).astype(np.uint32)
    hi = rng.integers(0, 3, n).astype(np.uint32)
    base = rng.integers(0, 4, n).astype(np.int32)
    return lo, hi, base, rng.random(n) < 0.9


@pytest.mark.parametrize("rounds", [0, 1, 2])
def test_table_update_find_grow_match_the_reference(rounds):
    """table_* against the reference: four update calls of events with
    duplicates, 600 keys into a 2^6-bucket table of 512 cells (buckets
    fill: new keys are dropped), the finds, a grow step and the finds
    through it, the fill statistics; claim-round (rounds 1, 2) and fused
    (0) protocols."""
    rng = np.random.default_rng(rounds)
    jt, tt = jtables.table_create(6), tables.table_create(6)
    for _ in range(4):
        lo, hi, base, valid = _events(rng, 800, 200)
        jt = jtables.table_update(jt, jnp.asarray(lo), jnp.asarray(hi),
                                  jnp.asarray(base), jnp.asarray(valid),
                                  rounds=rounds)
        tt = tables.table_update(tt, _i64(lo), _i64(hi), _i64(base),
                                 torch.from_numpy(valid), rounds=rounds)
        _eq(tt, jt, "update")
    assert int(tables.table_fill_stats(tt)[0]) == int(
        jtables.table_fill_stats(jt)[0])
    assert int(tables.table_fill_stats(tt)[0]) > 0.8 * 64 * tables.BUCKET
    for log2_base, (j, t) in ((-1, (jt, tt)),
                              (6, (jtables.table_grow(jt, 6),
                                   tables.table_grow(tt, 6)))):
        _eq(t, j, "grow")
        jc, jf = jtables.table_find(j, jnp.asarray(lo), jnp.asarray(hi),
                                    log2_base)
        tc, tf = tables.table_find(t, _i64(lo), _i64(hi), log2_base)
        _eq(tc, jc, "find counts")
        _eq(tf, jf, "found")


def _k_events(rng, n, n_buckets):
    """bkt, tag, valid [n] of canonical events drawn from a pool of 6
    n_buckets keys (so that keys recur within a call and across calls,
    and buckets fill)."""
    pool = np.random.default_rng(99)
    keys_b = pool.integers(0, n_buckets, 6 * n_buckets).astype(np.int32)
    keys_t = (pool.integers(0, 1 << 31, 6 * n_buckets)
              | (1 << 31)).astype(np.uint32)
    pick = rng.integers(0, 6 * n_buckets, n)
    return keys_b[pick], keys_t[pick], rng.random(n) < 0.9


def _kt_update(jt, tt, bkt, tag, valid, log2_base=-1):
    return (jtables.ktable_update(jt, jnp.asarray(bkt), jnp.asarray(tag),
                                  jnp.asarray(valid), log2_base),
            tables.ktable_update(tt, _i64(bkt), _i64(tag),
                                 torch.from_numpy(valid), log2_base))


def test_ktable_update_find_grow_clamp_match_the_reference():
    """ktable_* (u16-counter cells) against the reference: update calls
    with duplicates and full buckets, the finds (counters clipped at 255),
    a grow step and updates and finds through it, the clamp, the fills."""
    rng = np.random.default_rng(3)
    jt, tt = jtables.ktable_create(5), tables.ktable_create(5)
    for _ in range(5):
        bkt, tag, valid = _k_events(rng, 300, 32)
        jt, tt = _kt_update(jt, tt, bkt, tag, valid)
        _eq(tt, jt, "update")
    # one key hit 300 times in a call: its counter passes the 255 clip
    hot = np.full(300, tag[-1], np.uint32)
    jt, tt = _kt_update(jt, tt, np.full(300, bkt[-1], np.int32), hot,
                        np.ones(300, bool))
    tags4 = np.stack([tag, tag ^ 1, tag ^ 2, hot[:300]], axis=1)
    jc, jf = jtables.ktable_find(jt, jnp.asarray(bkt), jnp.asarray(tags4))
    tc, tf = tables.ktable_find(tt, _i64(bkt), _i64(tags4))
    _eq(tc, jc, "find counts")
    _eq(tf, jf, "found")
    assert int(tc.max()) == 255
    jg, tg = jtables.ktable_grow(jt, 5), tables.ktable_grow(tt, 5)
    _eq(tg, jg, "grow")
    jg, tg = _kt_update(jg, tg, bkt, tag, valid, 5)
    _eq(tg, jg, "update of the grown table")
    jc, jf = jtables.ktable_find(jg, jnp.asarray(bkt), jnp.asarray(tags4), 5)
    tc, tf = tables.ktable_find(tg, _i64(bkt), _i64(tags4), 5)
    _eq(tc, jc, "find in the grown table")
    _eq(tables.ktable_clamp(tg), jtables.ktable_clamp(jg), "clamp")
    assert int(tables.ktable_fill_stats(tg)[0]) == int(
        jtables.ktable_fill_stats(jg)[0])


def test_ktable_u16_counter_carries_as_the_reference():
    """A u16 counter at 0xFFFF: the next add carries into its neighbour
    (the low counter) or out of the u32 word (the high one), as the
    reference's u32 add does; the clamp then holds both at 0x8000."""
    rng = np.random.default_rng(4)
    jt, tt = jtables.ktable_create(4), tables.ktable_create(4)
    bkt, tag, valid = _k_events(rng, 120, 16)
    jt, tt = _kt_update(jt, tt, bkt, tag, valid)
    jt = jt.at[:, tables.KBUCKET:].set(jnp.uint32(0xFFFFFFFF))
    tt = tt.clone()
    tt[:, tables.KBUCKET:] = 0xFFFFFFFF
    jt, tt = _kt_update(jt, tt, bkt, tag, valid)
    _eq(tt, jt, "carry")
    assert int((tt[:, tables.KBUCKET:] != 0xFFFFFFFF).sum()) > 0
    assert int(tt.max()) <= 0xFFFFFFFF
    _eq(tables.ktable_clamp(tt), jtables.ktable_clamp(jt), "clamp")


@pytest.mark.parametrize("family", ["table", "ktable", "k2"])
def test_group_end_steps_dispatch_on_the_row_width(family):
    """tables.sb_grow, sb_clamp and sb_fill_stats, the group end's steps on
    an s/b table of any family, against the reference's function for the
    family that the row width names (table_*, ktable_* with u16 counters
    past the clamp's 0x8000, or K2 cells through ktable_*), on the same
    table of live cells."""
    rng = np.random.default_rng(7)
    if family == "table":
        lo, hi, base, valid = _events(rng, 800, 200)
        jt = jtables.table_update(
            jtables.table_create(6), jnp.asarray(lo), jnp.asarray(hi),
            jnp.asarray(base), jnp.asarray(valid))
        jgrow, jclamp = jtables.table_grow, (lambda t: t)
        jfill = jtables.table_fill_stats
    else:
        create = (jtables.ktable_create if family == "ktable"
                  else jtables.k2_create)
        bkt, tag, valid = _k_events(rng, 300, 64)
        jt = jtables.ktable_update(create(6), jnp.asarray(bkt),
                                   jnp.asarray(tag), jnp.asarray(valid))
        if family == "ktable":
            jt = jt.at[::3, tables.KBUCKET:].set(jnp.uint32(0x9000A000))
        jgrow, jclamp = jtables.ktable_grow, jtables.ktable_clamp
        jfill = jtables.ktable_fill_stats
    tt = _i64(jt)
    _eq(tables.sb_grow(tt, 6), jgrow(jt, 6), "grow")
    _eq(tables.sb_clamp(tt), jclamp(jt), "clamp")
    used, cap = tables.sb_fill_stats(tt)
    jused, jcap = jfill(jt)
    assert (int(used), cap) == (int(jused), int(jcap))
    assert int(used) > 0
    assert cap == tt.shape[0] * tables.sb_cells(tt)


# --- the header generations ------------------------------------------------

def test_load_params_without_knob_keys_is_h0():
    """A header with no knob key (the first writer's) loads the H0 Params
    in both packages, and header_generation's H0 equals it."""
    p = cli.parse_args(["e", "-s", "-om", "o", "-qm", "o", "-im", "o",
                        "-gs", "5", "a.fq"])
    blob = json.loads(p.store_params())
    for k in tparams.Params._HDR_LEGACY:
        del blob[k]
    blob = json.dumps(blob, sort_keys=True).encode()
    tp = tparams.Params.load_params(blob)
    jp = jparams.Params.load_params(blob)
    h0 = tparams.header_generation(
        cli.parse_args(["e", "-s", "-om", "o", "-qm", "o", "-im", "o",
                        "-gs", "5", "a.fq"]), "H0")
    assert tp.store_params() == jp.store_params()
    for k, v in jparams.Params._HDR_LEGACY.items():
        assert getattr(tp, k) == getattr(jp, k) == getattr(h0, k) == v
    assert (h0.smer_log2_buckets, h0.bmer_log2_buckets) == (21, 21)
    assert jparams.Params._HDR_LEGACY == tparams.Params._HDR_LEGACY


@pytest.mark.parametrize("gen,family,width", [
    ("H0", "table", 16), ("H5", "ktable", 6), ("H6", "ktable", 6),
    ("H1", "table", 16), ("H2", "table", 16), ("H3", "table", 16),
    ("H4", "ktable", 6)])
def test_header_generations_map_onto_their_table_family(gen, family, width):
    """Each generation's DnaConfig in both packages: the same config, its
    table family, and the tables at -gs 5 (H0
    2^21 buckets x 16 words, H5/H6 2^22 x 6)."""
    p = tparams.header_generation(
        cli.parse_args(["e", "-s", "-om", "o", "-qm", "o", "-im", "o",
                        "-gs", "5", "a.fq"]), gen)
    jp = jparams.Params.load_params(p.store_params())
    tcfg = pipeline.make_configs(p)[0]
    jcfg = jpipeline.make_configs(jp)[0]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dna.table_family(tcfg)[0::2] == (family, width)
    log2b = 21 if family == "table" else 22
    assert tcfg.smer_log2_buckets == tcfg.bmer_log2_buckets == log2b
    assert (tcfg.row_global, tcfg.ctx_v, tcfg.rough) == {
        "H0": (False, 1, 0), "H5": (True, 1, 0), "H6": (True, 2, 1)}.get(
            gen, (False, 1, 0))
    # H1-H4 keep in-batch local tables (2^22 cells) beside them
    assert tcfg.local_log2_cells == (22 if gen in ("H1", "H2", "H3", "H4")
                                     else 0)


def _frozen_batch():
    """(cfg, port state, codes, lengths, the reference's cfg and state) of
    H0's encoder batch: 32 reads of 48 over 8 lanes, SIV 8, 2^7-bucket
    table_* tables warmed by two batches (they fill)."""
    cfg = dataclasses.replace(dna_batches.legacy_dna_config("H0", 8),
                              smer_log2_buckets=7, bmer_log2_buckets=7,
                              siv_len=8)
    rng = np.random.default_rng(6)
    genome, state, _ = dna_batches._warm(cfg, rng, 6, 32, 48, "cpu")
    codes, lengths = dna_batches._reads(rng, genome, 32, 48, 9)
    jstate = jdna.DnaState(*(jnp.asarray(t.numpy().astype(
        np.int32 if t.dtype == torch.int32 else np.uint32))
        for t in state[:4]))
    return (cfg, state, torch.from_numpy(codes), torch.from_numpy(lengths),
            jdna.DnaConfig(**dataclasses.asdict(cfg)), jstate)


def _digest(arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a).astype(np.int64)))
    return h.hexdigest()


# sha256 of the reference's outputs on _frozen_batch (the repaired kcodes,
# the modeling's five planes, the updated state's four arrays), recomputed
# by test_batch_frozen_encoder_digest_matches_the_reference: its repair and
# modeling take some 15 s on one core
FROZEN_SHA256 = (
    "c7c700c899ccddbc9c633b89aba033575b1587788e8cf20daad8e5fe2fc89b23")


def _port_frozen(cfg, state, c, n):
    eff = dna.dna_effective_kcodes(cfg, state, c, torch.where(c >= 4, 0, c),
                                   n)
    got = dna.dna_modeling(cfg, state, c, eff, n)
    new = dna.dna_collect_updates(cfg, state, c, eff, n, *got[0:2], got[4])
    return (eff,) + tuple(got) + tuple(new[:4])


def test_batch_frozen_encoder_matches_the_reference():
    """H0's encoder on one batch against the reference (FROZEN_SHA256 of
    its outputs): the repaired kcodes (three repairs), the modeling
    against the batch-frozen tables (ctx v1, fine rows, no ramp) and the
    batch-level state update (both strands' events into the table_*
    tables, claim rounds); the tables fill, so claims are dropped.
    dna_apply_batch, the same pass on the decoder's side, evolves the
    state alike."""
    cfg, state, c, n, _, _ = _frozen_batch()
    outs = _port_frozen(cfg, state, c, n)
    assert _digest(outs) == FROZEN_SHA256
    assert int(tables.table_fill_stats(outs[-3])[0]) > 0.6 * (1 << 7) * 8
    # the decoder-side pass over the batch: the same state
    applied = dna.dna_apply_batch(cfg, state, c, torch.where(c >= 4, 0, c),
                                  n)
    for g, w in zip(applied[:4], outs[-4:]):
        assert torch.equal(g, w)


@pytest.mark.slow
def test_batch_frozen_encoder_digest_matches_the_reference():
    cfg, state, c, n, jcfg, jstate = _frozen_batch()
    jc = jnp.asarray(c.numpy().astype(np.int32))
    jn = jnp.asarray(n.numpy().astype(np.int32))
    jeff = jdna.dna_effective_kcodes(jcfg, jstate, jc,
                                     jnp.where(jc >= 4, 0, jc), jn)
    want = jdna.dna_modeling(jcfg, jstate, jc, jeff, jn)
    jnew = jdna.dna_collect_updates(jcfg, jstate, jc, jeff, jn, want[0],
                                    want[1], want[4])
    want = (jeff,) + tuple(want) + tuple(jnew[:4])
    for g, w, name in zip(_port_frozen(cfg, state, c, n), want,
                          ("eff", "ctx", "sym", "f", "c", "active")
                          + jdna.DnaState._fields):
        _eq(g, w, name)
    print(_digest(want))
    assert _digest(want) == FROZEN_SHA256


def test_id_codec_v1_modeling_matches_the_reference():
    """id codec v1's modeling against the reference: ALPHA smoothing over
    all 256 symbols of every context, and padding reads coded like real
    ones (n_valid ignored)."""
    idl = [f"SRR1.{k} HWI:1:{k % 7}:{k * 3}:{k * 5} len=60".encode()
           for k in range(24)] + [b"weird id"] + [b""] * 7
    cfg = ids.IdConfig(max_id_len=40, n_fields=4, n_lanes=8, codec_v=1)
    jcfg = jids.IdConfig(max_id_len=40, n_fields=4, n_lanes=8, codec_v=1)
    assert ids.host_n_valid(cfg, 25) is None
    planes = ids.encode_ids_host(idl, ids.read_lanes(32, 8), 4, 40, [None],
                                 n_valid=None)
    model = np.random.default_rng(2).integers(0, 300, (ids.N_CTX, 256))
    got = ids.id_modeling(cfg, torch.from_numpy(model.astype(np.int32)),
                          *(torch.from_numpy(a) for a in planes),
                          n_valid=25)
    want = jids.id_modeling(jcfg, jnp.asarray(model.astype(np.int32)),
                            *(jnp.asarray(a) for a in planes), n_valid=25)
    for g, w, name in zip(got, want, ("ctx", "syms", "f", "c", "active")):
        _eq(g, w, name)
    assert bool(got[4][25:].any())          # the padding is coded


# --- archives --------------------------------------------------------------

def legacy_params(mod, name, files):
    """The Params a fixture was written with, from the CLI of either
    package: `e FLAGS -gs 1` under the generation's knobs (re-tuned), on a
    tiny geometry: 8 lanes, 64-read batches, 2^10-bucket s/b tables (they
    grow), SIV cap 7, and local tables (H1-H4) of 2^LOCAL_LOG2_CELLS
    cells."""
    gen, flags, _ = SPECS[name]
    parse = cli.parse_args if mod is tparams else jcli.parse_args
    p = parse(["e", *flags, "-gs", "1", *files])
    for k, v in tparams.HEADER_GENERATIONS[gen].items():
        setattr(p, k, v)
    p.adjust_kmer_sizes()
    p.n_lanes = 8
    p.max_batch_reads = 64
    p.smer_log2_buckets = p.bmer_log2_buckets = 10
    p.dna_siv_cap = 7
    if gen in ("H1", "H2", "H3", "H4"):
        p.local_log2_cells = LOCAL_LOG2_CELLS
    p.verbosity = 0
    return p


def write_inputs(name, d):
    """The fixture's input FASTQ file(s) in directory d."""
    _, flags, (n, L, seed) = SPECS[name]
    if "-p" in flags:
        paths = [os.path.join(d, f"{name}_{k}.fastq") for k in (1, 2)]
        write_pe_corpus(*paths, n, L, GENOME, seed=seed)
        return paths
    path = os.path.join(d, f"{name}.fastq")
    write_fastq_corpus(path, n, L, GENOME, seed=seed)
    return [path]


def _write(mod_pipeline, p, files, arc):
    if len(files) == 2:
        return mod_pipeline.compress_pe(p, *files, arc, **(
            {"device": "cpu"} if mod_pipeline is pipeline else {}))
    return mod_pipeline.compress_file(p, files[0], arc, **(
        {"device": "cpu"} if mod_pipeline is pipeline else {}))


def fixture(name):
    return os.path.join(FIXTURES, f"{name}.fqst")


def _check_decode(name, files, outs):
    if name in DECODE_SHA256:
        assert _sha256(outs[0]) == DECODE_SHA256[name]
        return
    for o, f in zip(outs, files):
        with open(o, "rb") as a, open(f, "rb") as b:
            assert a.read() == b.read(), o


@pytest.mark.parametrize("name", sorted(SPECS))
def test_port_writes_and_decodes_the_reference_archive(tmp_path, name):
    """The port's writer gives the reference writer's archive (the
    committed fixture), byte for byte: SE original and sorted order and
    PE under H0 (id codec v1 with -im o), SE under H5 and H6. Its decode of
    the fixture is the input, or the reference decoder's output."""
    files = write_inputs(name, str(tmp_path))
    arc = str(tmp_path / "t.fqst")
    _write(pipeline, legacy_params(tparams, name, files), files, arc)
    with open(arc, "rb") as a, open(fixture(name), "rb") as b:
        assert a.read() == b.read()
    outs = [str(tmp_path / f"o{k}.fastq") for k in range(len(files))]
    pipeline.decompress_file(tparams.Params(), fixture(name), *outs,
                             device="cpu")
    _check_decode(name, files, outs)


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SPECS))
def test_reference_writes_and_decodes_the_fixture(tmp_path, name):
    """The reference's writer gives the committed fixture, and its decoder
    the input (or DECODE_SHA256): what the fast test holds the port to.
    With ROTATE_LEGACY_FIXTURES=1 in the environment it rewrites them."""
    files = write_inputs(name, str(tmp_path))
    arc = str(tmp_path / "j.fqst")
    with contextlib.redirect_stdout(io.StringIO()):
        _write(jpipeline, legacy_params(jparams, name, files), files, arc)
    if os.environ.get("ROTATE_LEGACY_FIXTURES") == "1":
        os.makedirs(FIXTURES, exist_ok=True)
        with open(arc, "rb") as a, open(fixture(name), "wb") as b:
            b.write(a.read())
    with open(arc, "rb") as a, open(fixture(name), "rb") as b:
        assert a.read() == b.read()
    outs = [str(tmp_path / f"o{k}.fastq") for k in range(len(files))]
    with contextlib.redirect_stdout(io.StringIO()):
        jpipeline.decompress_file(jparams.Params(), arc, *outs)
    if name in DECODE_SHA256:
        print(name, _sha256(outs[0]))
    _check_decode(name, files, outs)


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
@pytest.mark.parametrize("row", range(15))
def test_chip_smoke_legacy_digests(tmp_path, row):
    """chip_smoke.py's [legacy] digests are the reference's: its writer's
    archive of the bench corpus under the row's generation and flags, and
    for the sorted row its decoder's FASTQ."""
    cs = _chip_smoke()
    rows = [r[:4] + (r[4],) for r in cs.LEGACY] + [
        r + (None,) for r in cs.LEGACY_FULL]
    gen, n, flags, want, want_dec = rows[row]
    if "-p" in flags:
        files = [str(tmp_path / f"in_{k}.fastq") for k in (1, 2)]
        write_pe_corpus(*files, n, 100, 4_600_000, seed=42)
    else:
        files = [str(tmp_path / "in.fastq")]
        write_fastq_corpus(files[0], n, 100, 4_600_000, seed=42)
    p = jcli.parse_args(["e", *flags, *files])
    for k, v in tparams.HEADER_GENERATIONS[gen].items():
        setattr(p, k, v)
    p.adjust_kmer_sizes()
    p.verbosity = 0
    arc = str(tmp_path / "a.fqst")
    _write(jpipeline, p, files, arc)
    assert _sha256(arc) == want
    if want_dec is not None:
        out = str(tmp_path / "o.fastq")
        with contextlib.redirect_stdout(io.StringIO()):
            jpipeline.decompress_file(jparams.Params(), arc, out)
        assert _sha256(out) == want_dec
