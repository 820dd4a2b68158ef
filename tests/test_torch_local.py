"""The in-batch local statistics of the writers H1-H4 against the reference.

Headers without row-global updates keep, beside their batch-frozen s/b
tables, local tables of the k-mers of the batch's earlier read rows
(tables.local_* over context-keyed tables, klocal_* over canonical ones)
and, under H1, deltas of the DNA and quality models. Both sides freeze
them during a read row and apply the row's events at its end.

Every function is held to the reference's on the same inputs, made with
numpy from a seed, every integer equal (tolerance 0: the codec is
integer-only): the two table families (hash collisions, a claim raced
within one row, read rows past 31, both insert protocols, klocal's u16
carry), the model functions, local_row_update for each canon x rc x lite,
and the header generations' Params in both packages. The reference's
batch-level modeling compiles its row scan for some seconds on one core,
so one batch of each generation, and the quality deltas, are held to the
sha256 of its outputs (recomputed under `slow`), and the port's plain
decode of its own encode of that batch to the batch. The archives of
these writers are fixtures of tests/test_torch_legacy.py.
"""
import dataclasses
import hashlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fqsqueezer_tpu import params as jparams
from fqsqueezer_tpu.ops import models as jm
from fqsqueezer_tpu.ops import tables as jt
from fqsqueezer_tpu.streams import dna as jdna
from fqsqueezer_tpu.streams import quality as jq
from fqsqueezer_tpu_torch import cli
from fqsqueezer_tpu_torch import params as tparams
from fqsqueezer_tpu_torch import pipeline
from fqsqueezer_tpu_torch.ops import models, rans, tables
from fqsqueezer_tpu_torch.streams import common, dna, quality
from fqsqueezer_tpu_torch.utils import dna_batches
from fqsqueezer_tpu_torch.utils.corpus import make_genome


def _i64(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq(got, want, what=""):
    want = np.asarray(want).astype(np.int64)
    assert tuple(got.shape) == want.shape, what
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want,
                                  err_msg=what)


def _digest(arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a).astype(np.int64)))
    return h.hexdigest()


# --- the table families ----------------------------------------------------

def _local_events(rng, n, n_keys):
    """(lo, hi, base, valid) of n context events drawn from n_keys keys, so
    that keys recur within a call and collide on a small table's cells."""
    lo = rng.integers(0, n_keys, n).astype(np.uint32)
    hi = rng.integers(0, 2, n).astype(np.uint32)
    return lo, hi, rng.integers(0, 4, n), rng.random(n) < 0.9


@pytest.mark.parametrize("lite", [False, True])
@pytest.mark.parametrize("canon", [False, True])
def test_local_tables_match_the_reference(canon, lite):
    """local_* (canon 0) and klocal_* (canon 1) inserts and queries
    against the reference's: 300 keys onto 2^6 cells (most cells are
    claimed by several keys), four calls at read rows 0, 0, 31 and 70 (a
    row past 31 stamps like 31), the claims of one call racing
    within its row; the tables and the queries of every key after each
    call, owned and lost cells, both protocols (lite: a lost key adds to
    the cell all the same)."""
    rng = np.random.default_rng(10 + 2 * canon + lite)
    log2 = 6
    mk_t, mk_j = ((tables.klocal_create, jt.klocal_create) if canon
                  else (tables.local_create, jt.local_create))
    tt, jtt = mk_t(log2), mk_j(log2)
    qlo, qhi, _, _ = _local_events(rng, 300, 150)
    qcell, qtag = jt.local_keys(jnp.asarray(qlo), jnp.asarray(qhi), log2)
    slots4 = rng.integers(0, 16, (300, 4))
    qvalid = rng.random(300) < 0.95
    for row in (0, 0, 31, 70):
        lo, hi, base, valid = _local_events(rng, 400, 150)
        cell, tag = tables.local_keys(_i64(lo), _i64(hi), log2)
        jcell, jtag = jt.local_keys(jnp.asarray(lo), jnp.asarray(hi), log2)
        _eq(cell, jcell, "cell")
        _eq(tag, jtag, "tag")
        if canon:
            slot = rng.integers(0, 16, 400)
            tt = tables.klocal_insert(tt, cell, tag, _i64(slot),
                                      torch.from_numpy(valid), row=row,
                                      lite=lite)
            jtt = jt.klocal_insert(jtt, jcell, jtag, jnp.asarray(slot),
                                   jnp.asarray(valid), row=row, lite=lite)
            got = tables.klocal_query(tt, _i64(qcell), _i64(qtag),
                                      _i64(slots4), torch.from_numpy(qvalid))
            want = jt.klocal_query(jtt, qcell, qtag, jnp.asarray(slots4),
                                   jnp.asarray(qvalid))
        else:
            tt = tables.local_insert(tt, cell, tag, _i64(base),
                                     torch.from_numpy(valid), row=row,
                                     lite=lite)
            jtt = jt.local_insert(jtt, jcell, jtag, jnp.asarray(base),
                                  jnp.asarray(valid), row=row, lite=lite)
            got = tables.local_query(tt, _i64(qcell), _i64(qtag),
                                     torch.from_numpy(qvalid))
            want = jt.local_query(jtt, qcell, qtag, jnp.asarray(qvalid))
        _eq(tt, jtt, f"table after row {row}")
        _eq(got, want, f"queries after row {row}")
    # every cell is claimed, by the earliest row's largest tag
    assert int((tt[:, 0] == 0).sum()) == 0
    assert int(got.sum()) > 0


def test_klocal_u16_counter_carries_as_the_reference():
    """A klocal counter at 0xFFFF: the next add carries into its neighbour
    (the low half) or out of the u32 word (the high half), as the
    reference's u32 add does."""
    rng = np.random.default_rng(4)
    lo, hi, _, valid = _local_events(rng, 200, 40)
    slot = rng.integers(0, 16, 200)
    cell, tag = jt.local_keys(jnp.asarray(lo), jnp.asarray(hi), 4)
    jtt = jt.klocal_insert(jt.klocal_create(4), cell, tag,
                           jnp.asarray(slot), jnp.asarray(valid))
    jtt = jtt.at[:, 1:].set(jnp.uint32(0xFFFFFFFF))
    tt = _i64(jtt)
    jtt = jt.klocal_insert(jtt, cell, tag, jnp.asarray(slot),
                           jnp.asarray(valid), row=1)
    tt = tables.klocal_insert(tt, _i64(cell), _i64(tag), _i64(slot),
                              torch.from_numpy(valid), row=1)
    _eq(tt, jtt, "carry")
    assert int((tt[:, 1:] != 0xFFFFFFFF).sum()) > 0
    assert int(tt.max()) <= 0xFFFFFFFF


# --- the model functions ---------------------------------------------------

@pytest.mark.parametrize("n_sym,w", [(5, 0), (5, 2048), (8, 0), (96, 0)])
def test_local_model_functions_match_the_reference(n_sym, w):
    """local_cap, local_model_update (invalid events dropped, repeated
    cells), model_cdf_local and model_cdf_mix(local=) — deltas past the
    cap clamp — against the reference's."""
    rng = np.random.default_rng(n_sym + w)
    n_ctx = 64
    assert models.local_cap(n_sym, 14, extra=w) == jm.local_cap(n_sym, 14,
                                                                extra=w)
    freqs = rng.integers(0, 1 << 13, (2 * n_ctx, n_sym)) // n_sym
    lm = np.zeros((n_ctx, n_sym), np.int32)
    ctx = rng.integers(0, n_ctx, 500)
    sym = rng.integers(0, n_sym, 500)
    valid = rng.random(500) < 0.8
    tl = torch.from_numpy(lm.copy())
    jl = jnp.asarray(lm)
    for inc in (8, 300):
        tl = models.local_model_update(tl, _i64(ctx), _i64(sym),
                                       torch.from_numpy(valid), inc=inc)
        jl = jm.local_model_update(jl, jnp.asarray(ctx), jnp.asarray(sym),
                                   jnp.asarray(valid), inc=inc)
        _eq(tl, jl, "deltas")
    assert int(tl.max()) > models.local_cap(n_sym, 14, extra=w)
    q = rng.integers(0, n_ctx, (7, 9))
    tf = torch.from_numpy(freqs.astype(np.int32))
    jf = jnp.asarray(freqs.astype(np.int32))
    if w:
        cq = n_ctx + rng.integers(0, n_ctx, (7, 9))
        got = models.model_cdf_mix(tf, _i64(q), _i64(cq), 14, w, 4096, tl)
        want = jm.model_cdf_mix(jf, jnp.asarray(q), jnp.asarray(cq), 14, w,
                                4096, jl)
    else:
        got = models.model_cdf_local(tf, tl, _i64(q), 14)
        want = jm.model_cdf_local(jf, jl, jnp.asarray(q), 14)
    _eq(got, want, "cdf")
    assert bool((got[..., 1:] > got[..., :-1]).all())   # every freq >= 1


# --- the row machinery -----------------------------------------------------

def _row(rng, N, L, n_model):
    """A read row block: eff [N, L] bases (a repeat across lanes, so that
    k-mers recur), ctx, sym, lengths and the coded positions."""
    eff = rng.integers(0, 4, (N, L))
    eff[1::2, :20] = eff[0, :20]
    lengths = rng.integers(0, L + 1, N)
    lengths[:2] = L
    pos = np.arange(L)[None, :]
    act = (pos < lengths[:, None]) & (rng.random((N, L)) < 0.8)
    return (eff, rng.integers(0, n_model, (N, L)),
            rng.integers(0, 5, (N, L)), act, lengths)


def _row_update_case(canon, rc, lite):
    """(cfg, rows) of a local_row_update case: three rows of 8 lanes x 40
    positions, model deltas in one case (they do not depend on the tables'
    knobs)."""
    deltas = not canon and rc and not lite
    cfg = dataclasses.replace(
        dna_batches.legacy_dna_config("H1", 8), smer_len=11, bmer_len=17,
        local_log2_cells=7, local_model_inc=8 if deltas else 0, canon=canon,
        local_rc=rc, local_lite=lite)
    rng = np.random.default_rng(canon * 4 + rc * 2 + lite)
    return cfg, [_row(rng, 8, 40, dna._n_model_ctx(cfg)) for _ in range(3)]


def _port_row_updates(cfg, rows):
    """The port's local state after each of the rows (indices 0, 1 and 33),
    then its row queries (_local_counts) of the first row's bases."""
    ls, lb, lm = dna._local_state_create(cfg)
    outs = []
    for row, (eff, ctx, sym, act, lengths) in zip((0, 1, 33), rows):
        ls, lb, lm = dna.local_row_update(
            cfg, ls, lb, lm, _i64(eff), _i64(ctx), _i64(sym),
            torch.from_numpy(act), _i64(lengths), row=row)
        outs += [t.clone() for t in (ls, lb, lm)]
    eff, _, _, _, lengths = rows[0]
    return outs + list(dna._local_counts(cfg, ls, lb, _i64(eff),
                                         _i64(lengths)))


def _reference_row_updates(cfg, rows):
    jcfg = jdna.DnaConfig(**dataclasses.asdict(cfg))
    jls, jlb, jlm = jdna._local_state_create(jcfg)
    outs = []
    for row, (eff, ctx, sym, act, lengths) in zip((0, 1, 33), rows):
        jls, jlb, jlm = jdna.local_row_update(
            jcfg, jls, jlb, jlm, jnp.asarray(eff, jnp.int32),
            jnp.asarray(ctx, jnp.int32), jnp.asarray(sym, jnp.int32),
            jnp.asarray(act), jnp.asarray(lengths, jnp.int32), row=row)
        outs += [jls, jlb, jlm]
    eff, _, _, _, lengths = rows[0]
    je, jn = jnp.asarray(eff, jnp.int32), jnp.asarray(lengths, jnp.int32)
    for tbl, k in ((jls, cfg.smer_len), (jlb, cfg.bmer_len)):
        if cfg.canon:
            outs.append(jt.klocal_query(
                tbl, *jdna._row_canon_query(jcfg, je, jn, k)))
        else:
            outs.append(jt.local_query(
                tbl, *jdna._row_query_keys(jcfg, je, jn, k)))
    return outs


# sha256 of the reference's outputs of each local_row_update case
# (canon, rc, lite), recomputed by
# test_local_row_update_digests_match_the_reference: the reference's eager
# row update takes 5-8 s a case on one core
ROW_SHA256 = {
    (False, False, False):
        "e94e267ba62f7915d9dab6e12ea3fd802ff41b35c7a301abfbe341fb455d791c",
    (False, False, True):
        "e9d4b737cde23a03910c8134edcb7d403a6c9af611b73c4ed6e23bf261f5b294",
    (False, True, False):
        "e0188e5f51f34de3ce780ec262b9449965487e65d2a5b7619a6560a260ed3452",
    (False, True, True):
        "c1d4cbf6daadaa50ff6a229cd706de2292f43049f4b83d343d60b69f543b13d4",
    (True, False, False):
        "457bfe9b23788de4781886b83d15ab05da76dae45250cee7410091c93cf4ebe0",
    (True, False, True):
        "b60f6c3c5854229b9b8145b9225a7cfd63f8b0959139aefc9258a24d266d2d7b",
    (True, True, False):
        "8bd3b44badfcac32bb3183e8d476bdb377f842e5d75dd468cd4b0b59c2448d9c",
    (True, True, True):
        "f4e25928c634918c76ddd4129e57619e5f982e2696ce01fc6f44b8bebb1b775e",
}


_CASES = [(c, r, l) for c in (False, True) for r in (False, True)
          for l in (False, True)]


@pytest.mark.parametrize("canon,rc,lite", _CASES)
def test_local_row_update_matches_the_reference(canon, rc, lite):
    """local_row_update, the one function of the encoder's row loop and the
    decoder's row end, against the reference's (ROW_SHA256) over three rows
    (indices 0, 1 and 33) of 8 lanes x 40 positions: the local tables, the
    model deltas (one case), and the encoder's row queries of the first
    row's bases afterwards, which find counts."""
    outs = _port_row_updates(*_row_update_case(canon, rc, lite))
    assert _digest(outs) == ROW_SHA256[(canon, rc, lite)]
    assert int(outs[-1].sum()) > 0 and int(outs[-2].sum()) > 0


@pytest.mark.slow
@pytest.mark.parametrize("canon,rc,lite", _CASES)
def test_local_row_update_digests_match_the_reference(canon, rc, lite):
    cfg, rows = _row_update_case(canon, rc, lite)
    want = _reference_row_updates(cfg, rows)
    for k, (g, w) in enumerate(zip(_port_row_updates(cfg, rows), want)):
        _eq(g, w, f"output {k}")
    print((canon, rc, lite), _digest(want))
    assert _digest(want) == ROW_SHA256[(canon, rc, lite)]


# --- one batch of each generation ------------------------------------------

def _gen_batch(gen):
    """(cfg, the warmed state, codes, lengths) of a generation's batch: 32
    reads of 40 over 8 lanes (4 read rows), SIV 8 with ramp columns 5-6,
    2^9-bucket s/b tables warmed by two batches and 2^8-cell local tables;
    the batch's reads come from another, 300-base genome, so that the
    global tables miss where the earlier rows' local tables find."""
    cfg = dataclasses.replace(
        dna_batches.legacy_dna_config(gen, 8), siv_len=8, prefix_len=5,
        smer_log2_buckets=9, bmer_log2_buckets=9, local_log2_cells=8)
    rng = np.random.default_rng(int(gen[1]))
    _, state, _ = dna_batches._warm(cfg, rng, 3, 32, 40, "cpu")
    codes, lengths = dna_batches._reads(rng, make_genome(300, int(gen[1])),
                                        32, 40, 7)
    return cfg, state, torch.from_numpy(codes), torch.from_numpy(lengths)


# sha256 of the reference's outputs on each generation's batch (the
# repaired kcodes, then dna_modeling's five planes), recomputed by
# test_generation_batch_digests_match_the_reference
GEN_SHA256 = {
    "H1":
        "3c761131a514db86e15aaaa134cdad5f0233075af0cbe6d7d6d259b3814c3133",
    "H2":
        "7913d02834db179970050c9d825ca4df7ca1cf10b336fed2c9bb2d9a312169d2",
    "H3":
        "ee27e82c2cbe6a1894246b3cfcb517da77c245ca36033131b47d39e7d6dceae8",
    "H4":
        "dd33280b28e5134f3d01439e438154b128638fc456818bff93065031b48d394f",
}


@pytest.mark.parametrize("gen", ["H1", "H2", "H3", "H4"])
def test_generation_batch_matches_the_reference(gen):
    """One batch of each generation (_gen_batch) against the reference
    (GEN_SHA256): repair against the batch-frozen tables, then the row
    loop over the local tables and, under H1, the model deltas. The
    port's plain decode (dna_decode_batch, K2's plain version) of its own
    encode of the batch returns the batch, its repaired kcodes and its
    contexts and symbols at every coded position."""
    cfg, state, c, n = _gen_batch(gen)
    got = dna.dna_process_batch(cfg, state, c, torch.where(c >= 4, 0, c), n)
    assert _digest(got[:6]) == GEN_SHA256[gen]
    words, _, init = rans.rans_encode(common.lane_grid(got[3], 8),
                                      common.lane_grid(got[4], 8), 14)
    dec, _, _, _, extras = dna.dna_decode_batch(cfg, state, n, words, init,
                                                40)
    assert torch.equal(dec, c) and torch.equal(extras[0], got[0])
    for g, w in zip(extras[1:3], got[1:3]):
        assert torch.equal(torch.where(got[5], g, 0),
                           torch.where(got[5], w, 0))


@pytest.mark.slow
@pytest.mark.parametrize("gen", ["H1", "H2", "H3", "H4"])
def test_generation_batch_digests_match_the_reference(gen):
    cfg, state, c, n = _gen_batch(gen)
    jcfg = jdna.DnaConfig(**dataclasses.asdict(cfg))
    jstate = jdna.DnaState(*(jnp.asarray(t.numpy().astype(
        np.int32 if t.dtype == torch.int32 else np.uint32))
        for t in state[:4]))
    jc = jnp.asarray(c.numpy().astype(np.int32))
    jn = jnp.asarray(n.numpy().astype(np.int32))
    jeff = jdna.dna_effective_kcodes(jcfg, jstate, jc,
                                     jnp.where(jc >= 4, 0, jc), jn)
    want = (jeff,) + tuple(jdna.dna_modeling(jcfg, jstate, jc, jeff, jn))
    got = dna.dna_process_batch(cfg, state, c, torch.where(c >= 4, 0, c), n)
    for g, w, name in zip(got, want, ("eff", "ctx", "sym", "f", "c",
                                      "active")):
        _eq(g, w, name)
    print(gen, _digest(want))
    assert _digest(want) == GEN_SHA256[gen]


# --- quality deltas --------------------------------------------------------

def _qual_batch(mode):
    """(cfg, model, qsyms, lengths) of a quality batch with deltas: 32 reads
    of 40 over 8 lanes (4 read rows), geometric symbols, a random model."""
    cfg = quality.QualConfig(mode=mode, n_lanes=8, with_local=True)
    rng = np.random.default_rng(cfg.n_sym)
    model = rng.integers(0, 200, (cfg.n_ctx, cfg.n_sym)).astype(np.int32)
    lengths = rng.integers(0, 41, 32)
    lengths[:3] = (0, 1, 40)
    q = np.minimum(rng.geometric(0.3, (32, 40)) - 1, cfg.n_sym - 1)
    q = np.where(np.arange(40)[None, :] < lengths[:, None], q, 0)
    return cfg, torch.from_numpy(model), _i64(q), _i64(lengths)


# sha256 of the reference's qual_modeling outputs with deltas (ctx, f, c),
# recomputed by test_quality_delta_digests_match_the_reference
QUAL_SHA256 = {
    "illumina_8":
        "56b6b0cafaade929ba62320d38bd280dec54febb8c107061ace785388cff253c",
    "lossless":
        "568dbb0588b4214d14f9c09b6976c3b6d548daa2af040cca3dca81528fb437fe"}


@pytest.mark.parametrize("mode", ["illumina_8", "lossless"])
def test_quality_deltas_match_the_reference(mode):
    """qual_modeling with in-batch deltas (the row loop, model_cdf_local,
    the row-end local_model_update) against the reference's (QUAL_SHA256),
    and the plain scan (K3's plain version) decodes its words to the
    batch, reading the same contexts."""
    cfg, model, q, n = _qual_batch(mode)
    ctx, f, c, act = quality.qual_modeling(cfg, model, q, n)
    assert _digest((ctx, f, c)) == QUAL_SHA256[mode]
    plain = quality.qual_modeling(dataclasses.replace(cfg, with_local=False),
                                  model, q, n)
    assert not torch.equal(plain[1], f)       # the deltas move the cdf
    words, _, init = rans.rans_encode(common.lane_grid(f, 8),
                                      common.lane_grid(c, 8), 14)
    syms, _, _, dctx = quality.qual_decode_scan_plain(
        cfg, model, n, words, init, 40, with_ctx=True)
    assert torch.equal(syms.to(torch.int64), q)
    assert torch.equal(torch.where(act, dctx, 0), torch.where(act, ctx, 0))


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["illumina_8", "lossless"])
def test_quality_delta_digests_match_the_reference(mode):
    """QUAL_SHA256 is the reference's qual_modeling, and the reference's
    qual_decode_batch decodes the port's words to the batch."""
    cfg, model, q, n = _qual_batch(mode)
    jcfg = jq.QualConfig(mode=mode, n_lanes=8, with_local=True)
    jm_, jqs = jnp.asarray(model.numpy()), jnp.asarray(q.numpy(), jnp.int32)
    jn = jnp.asarray(n.numpy(), jnp.int32)
    want = jq.qual_modeling(jcfg, jm_, jqs, jn)
    got = quality.qual_modeling(cfg, model, q, n)
    for g, w, name in zip(got, want, ("ctx", "f", "c", "active")):
        _eq(g, w, name)
    print(mode, _digest(want[:3]))
    assert _digest(want[:3]) == QUAL_SHA256[mode]
    words, _, init = rans.rans_encode(common.lane_grid(got[1], 8),
                                      common.lane_grid(got[2], 8), 14)
    jsyms = jq.qual_decode_batch(jcfg, jm_, jn,
                                 jnp.asarray(words.numpy(), jnp.uint32),
                                 jnp.asarray(init.numpy(), jnp.uint32), 40)[0]
    _eq(q, jsyms, "the reference's decode")


# --- the header generations ------------------------------------------------

# the knob keys each writer's header lacked (git show <its commit>:
# fqsqueezer_tpu/params.py), which load_params gives their legacy values
_LATER = ("dna_local_lite", "dna_canon", "dna_row_global", "dna_pe_pos_ctx",
          "dna_ctx_v", "dna_pe_mesh", "dna_rough", "dna_sb_proto",
          "mesh_route_sb", "dna_let_pb2")
HEADER_MISSING = {
    "H1": tuple(k for k in tparams.Params._HDR_LEGACY
                if k != "local_log2_cells"),
    "H2": _LATER,
    "H3": _LATER[1:],
    "H4": _LATER[2:],
}


@pytest.mark.parametrize("gen", ["H1", "H2", "H3", "H4"])
def test_load_params_of_each_generation_header(gen):
    """A header as the generation's writer stored it (its knob values, the
    keys it did not know left out) loads the same Params in both packages,
    equal to header_generation's; its DnaConfig and QualConfig are the
    same in both, with local tables (and, under H1 only, model deltas)."""
    flags = ["e", "-s", "-om", "o", "-qm", "o", "-im", "o", "-gs", "5",
             "a.fq"]
    want = tparams.header_generation(cli.parse_args(flags), gen)
    blob = json.loads(want.store_params())
    for k in HEADER_MISSING[gen]:
        del blob[k]
    blob = json.dumps(blob, sort_keys=True).encode()
    tp = tparams.Params.load_params(blob)
    jp = jparams.Params.load_params(blob)
    assert tp.store_params() == jp.store_params() == want.store_params()
    dcfg, qcfg = pipeline.make_configs(tp)[:2]
    assert dcfg.local_log2_cells == 22 and not dcfg.row_global
    assert dcfg.canon == (gen == "H4")
    assert (dcfg.local_model_inc > 0) == qcfg.with_local == (gen == "H1")
    assert dna.k2_local(dcfg) == {"H1": 2, "H2": 1, "H3": 1, "H4": 3}[gen]


def test_k2_refuses_a_local_table_of_the_wrong_width():
    """K2's checks (run before it builds or launches) refuse, with one
    line, local tables whose row width is not the family's (klocal_*
    rows beside context-keyed tables) and a missing local state."""
    cfg, state, c, n = _gen_batch("H2")
    N = cfg.n_lanes
    args = (cfg, state, n[:N].contiguous(), torch.zeros(4, dtype=torch.int32),
            torch.full((N,), 1 << 16, dtype=torch.int64),
            torch.zeros((), dtype=torch.int64),
            torch.zeros((dna.K2_NREGS, N), dtype=torch.int64), 40, None,
            None, tables.LOCAL)
    loc = dna._local_state_create(cfg)
    dna._check_k2(*args, loc)
    wide = (tables.klocal_create(cfg.local_log2_cells),) * 2 + loc[2:]
    for bad in (wide, None):
        with pytest.raises(ValueError) as e:
            dna._check_k2(*args, bad)
        assert "\n" not in str(e.value) and str(e.value).startswith("K2: ")

