"""Paired-end reads (-p) in the port, against the reference package, exact.

Function level: every function of streams/pe.py and the pair table
(ops/tables.py pair_*) take the same inputs, made from a seed with numpy,
as the reference's and must give the same integers: the pair table's
planes after duplicate events, a bucket filled past its last cell and two
batches that accumulate; the candidates, matches, anchors and the 3-row
recoding. Batch level: one small PE batch (64 lanes, 2^10-bucket tables,
from a mid-stream state the reference reached) through the port's
_model_batch and the reference's (dna_pe_encode, the anchored row pass,
the pair table and pe model update: every grid and the whole new state),
and its DNA decode (the plain K2 row on the CPU, the row-end PE step
between rows) against the reference's scan: codes, final DNA and pe lane
states, words consumed, the new state. Archive level: a small PE corpus
whose fragments recur (so the pair table finds anchors), at -qm o -im o,
in original and sorted order, anchors on and pe_log2_buckets = 0: each
archive's sha256 is the reference writer's (the slow tests recompute the
constants), the port decodes it to the input's bytes (original order) or
to the reference decoder's (sorted), and the reference decodes the port's
archive (slow). Then the streamed archive, the mate-count errors, the
CLI's `e -p` and `d -out2`, and the dna_pe_pos_ctx refusal. Tolerance 0
everywhere: the codec is integer-only. Everything of the port runs on the
CPU (the plain versions of its kernels).
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
from fqsqueezer_tpu.ops import tables as jtables
from fqsqueezer_tpu.streams import dna as jdna
from fqsqueezer_tpu.streams import pe as jpe
from fqsqueezer_tpu_torch import cli
from fqsqueezer_tpu_torch import params as tparams
from fqsqueezer_tpu_torch import pipeline
from fqsqueezer_tpu_torch.ops import rans, tables
from fqsqueezer_tpu_torch.state import state_from_numpy, state_to_numpy
from fqsqueezer_tpu_torch.streams import dna, pe

SB = 14

# the reference's functions jitted, as its pipeline runs them: one XLA
# program a call instead of a compile for each op (static B and segments)
_jpe = {
    "segment_minimizers": jax.jit(jpe.segment_minimizers,
                                  static_argnums=(3, 4)),
    "find_candidates": jax.jit(jpe.find_candidates, static_argnums=3),
    "match_in_read2": jax.jit(jpe.match_in_read2, static_argnums=6),
    "find_anchors": jax.jit(jpe.find_anchors, static_argnums=4),
    "pair_events": jax.jit(jpe.pair_events, static_argnums=3),
    "pair_update": jax.jit(jtables.pair_update),
}


def _u32(a):
    return jnp.asarray(np.asarray(a, np.int64).astype(np.uint32))


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _eq(got, want, what=""):
    np.testing.assert_array_equal(
        np.asarray(got.numpy() if isinstance(got, torch.Tensor) else got,
                   np.int64),
        np.asarray(want).astype(np.int64), err_msg=what)


def _codes(seed, R, L, n_rate=0.03):
    """codes [R, L] (N = 4), kcodes, lengths [R]: ragged lengths from 0
    to L, N bases."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (R, L))
    codes = np.where(rng.random((R, L)) < n_rate, 4, codes)
    lengths = rng.integers(0, L + 1, R)
    lengths[:R // 2] = L
    codes = np.where(np.arange(L)[None, :] < lengths[:, None], codes, 0)
    return codes, np.where(codes >= 4, 0, codes), lengths


# --- streams/pe.py and the pair table ---------------------------------------

def test_segment_minimizers():
    """Both widths of a packed value (2B <= 32 and > 32: B 14, 19, 26),
    reads shorter than B, Ns, 3 and 4 segments."""
    for B in (14, 19, 26):
        codes, kc, lengths = _codes(B, 16, 64)
        lengths[3] = B - 2
        for n_seg in (3, 4):
            got = pe.segment_minimizers(_t(codes), _t(kc), _t(lengths), B,
                                        n_seg)
            want = _jpe["segment_minimizers"](jnp.asarray(codes, jnp.int32),
                                          jnp.asarray(kc, jnp.int32),
                                          jnp.asarray(lengths, jnp.int32),
                                          B, n_seg)
            for g, w in zip(got, want):
                _eq(g, w, f"B {B}, n_seg {n_seg}")


def _pair_events(seed, n, n_keys, n_vals, B=20):
    """Flat (klo, khi, vlo, vhi, w, valid) numpy events: few keys and
    values, so that events repeat and buckets fill."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << (2 * B), n_keys, dtype=np.int64)
    vals = rng.integers(0, 1 << (2 * B), n_vals, dtype=np.int64)
    k = keys[rng.integers(0, n_keys, n)]
    v = vals[rng.integers(0, n_vals, n)]
    return (k & 0xFFFFFFFF, k >> 32, v & 0xFFFFFFFF, v >> 32,
            rng.integers(1, 5, n), rng.random(n) < 0.9)


def _padded(ev, n=400):
    """Events padded with invalid ones to n: every call has one shape, so
    the reference compiles its update once."""
    k = n - len(ev[0])
    return tuple(np.concatenate([np.asarray(a), np.zeros(k, np.asarray(
        a).dtype)]) for a in ev)


def _pair_cases():
    """(name, [event batches]) of the pair-table checks, 2^4 buckets."""
    dup = ((np.array([11, 11, 11, 22, 22, 11]), np.zeros(6, np.int64),
            np.array([100, 100, 101, 200, 201, 100]), np.zeros(6, np.int64),
            np.array([2, 3, 4, 1, 5, 7]), np.array([1, 1, 1, 1, 1, 0], bool)),)
    # one key with 11 values, three batches: the bucket fills to its last
    # cell (8), then the other values find it full
    full = ((np.full(11, 9), np.zeros(11, np.int64), np.arange(300, 311),
             np.zeros(11, np.int64), np.arange(1, 12), np.ones(11, bool)),
            ) * 3
    two = (_pair_events(1, 200, 40, 30), _pair_events(2, 200, 40, 30))
    return [("duplicates", dup), ("full bucket", full),
            ("two batches", two), ("clamp", (_pair_events(3, 400, 4, 3),) * 3)]


def test_pair_update():
    """Every plane after each batch, and pair_find of every key, for each
    of _pair_cases: duplicate events, a full bucket, two batches, counts
    at the clamp."""
    for case in _pair_cases():
        _check_pair_update(*case)


def _check_pair_update(name, batches):
    got = tables.pair_create(4)
    want = jtables.pair_create(4)
    for ev in map(_padded, batches):
        if name == "clamp":
            ev = ev[:4] + (np.full(ev[4].shape, 1 << 19),) + ev[5:]
        got = tables.pair_update(got, *(_t(a) for a in ev[:5]),
                                 torch.from_numpy(np.asarray(ev[5], bool)))
        want = _jpe["pair_update"](want, *(_u32(a) for a in ev[:5]),
                                   jnp.asarray(ev[5], bool))
        for g, w, plane in zip(got, want, ("tags", "vlo", "vhi", "cnt")):
            _eq(g, w, f"{name}: {plane}")
    keys = np.unique(np.concatenate([ev[0] for ev in batches]))
    for g, w in zip(tables.pair_find(got, _t(keys), torch.zeros(
            len(keys), dtype=torch.int64)),
            jtables.pair_find(want, _u32(keys), _u32(np.zeros(len(keys))))):
        _eq(g, w)
    cnt = got[3].numpy()
    if name == "full bucket":
        assert (cnt > 0).sum() == tables.BUCKET
    if name == "clamp":
        assert cnt.max() == 1 << 20


def _filled_pair_table(seed, B, codes, kc, lengths):
    """Both packages' pair tables after the events of a batch and of a
    random batch."""
    got, want = tables.pair_create(8), jtables.pair_create(8)
    ev = _jpe["pair_events"](jnp.asarray(codes, jnp.int32),
                         jnp.asarray(kc, jnp.int32),
                         jnp.asarray(lengths, jnp.int32), B)
    tev = pe.pair_events(_t(codes), _t(kc), _t(lengths), B)
    for g, w in zip(tev, ev):
        _eq(g, w)
    rnd = _pair_events(seed, len(ev[0]), 60, 80, B)
    want = _jpe["pair_update"](want, *ev)
    want = _jpe["pair_update"](want, *(_u32(a) for a in rnd[:5]),
                               jnp.asarray(rnd[5]))
    got = tables.pair_update(got, *tev)
    got = tables.pair_update(got, *(_t(a) for a in rnd[:5]),
                             torch.from_numpy(rnd[5]))
    return got, want


def _pe_batch_codes(seed, P, L, B):
    """Interleaved pairs whose mate 2 is mostly a copy of an earlier pair's,
    so that candidates match: codes, kcodes, lengths."""
    codes, kc, lengths = _codes(seed, 2 * P, L, n_rate=0.01)
    codes[3::4] = codes[1::4]
    lengths[3::4] = lengths[1::4]
    lengths[0::2] = np.maximum(lengths[0::2], B + 4)
    kc = np.where(codes >= 4, 0, codes)
    return codes, kc, lengths


def test_candidates_match_and_anchors():
    """pair_events, find_candidates (sentinel queries included),
    match_in_read2, find_anchors and anchor_base against the reference,
    at the bench's B (bmer_len at -gs 5)."""
    B = 21
    codes, kc, lengths = _pe_batch_codes(B, 24, 64, B)
    got_t, want_t = _filled_pair_table(B, B, codes, kc, lengths)
    q_lo, q_hi = _jpe["segment_minimizers"](
        jnp.asarray(codes[0::2], jnp.int32), jnp.asarray(kc[0::2], jnp.int32),
        jnp.asarray(lengths[0::2], jnp.int32), B, 4)
    want_c = _jpe["find_candidates"](want_t, q_lo, q_hi, B)
    got_c = pe.find_candidates(got_t, _t(q_lo), _t(q_hi), B)
    for g, w in zip(got_c, want_c):
        _eq(g, w, "candidates")
    assert (np.asarray(want_c[2]) > 0).any()
    j2 = (jnp.asarray(codes[1::2], jnp.int32), jnp.asarray(kc[1::2], jnp.int32),
          jnp.asarray(lengths[1::2], jnp.int32))
    want_m = _jpe["match_in_read2"](*want_c, *j2, B)
    got_m = pe.match_in_read2(*got_c, _t(codes[1::2]), _t(kc[1::2]),
                              _t(lengths[1::2]), B)
    for g, w in zip(got_m, want_m):
        _eq(g, w, "match")
    assert (np.asarray(want_m[0]) < jpe.N_CAND).any()
    want_a = _jpe["find_anchors"](want_t, jnp.asarray(codes, jnp.int32),
                              jnp.asarray(kc, jnp.int32),
                              jnp.asarray(lengths, jnp.int32), B)
    got_a = pe.find_anchors(got_t, _t(codes), _t(kc), _t(lengths), B)
    for g, w in zip(got_a, want_a):
        _eq(g, w, "anchors")
    j = np.arange(-1, B + 2)
    a_lo, a_hi = np.asarray(want_m[2])[:, None], np.asarray(want_m[3])[:, None]
    _eq(pe.anchor_base(_t(a_lo), _t(a_hi), _t(j[None, :]), B),
        jpe.anchor_base(_u32(a_lo), _u32(a_hi), jnp.asarray(j[None, :]), B))


def test_find_candidates_orders_by_count():
    """The reference test's case: counts merged by value, (count desc,
    value asc)."""
    pt = tables.pair_create(6)
    pt = tables.pair_update(pt, _t([9, 9, 9]), _t([0, 0, 0]),
                            _t([300, 100, 200]), _t([0, 0, 0]),
                            _t([1, 9, 9]), torch.ones(3, dtype=torch.bool))
    c_lo, _, c_cnt = pe.find_candidates(pt, _t([[9, 9, 9, 9]]),
                                        _t([[0, 0, 0, 0]]), 20)
    live = [(int(v), int(c)) for v, c in zip(c_lo[0], c_cnt[0]) if c > 0]
    assert live == [(100, 36), (200, 36), (300, 4)]


def test_expand_and_collapse_pe_rows():
    """The 3-row recoding (anchors at read2's start, at its end, anywhere,
    none, and read2 shorter than the anchor), its preset mask, the span
    mask, and the collapse back to the true reads."""
    B, L = 19, 48
    codes, _, lengths = _codes(7, 20, L)
    P = 10
    rng = np.random.default_rng(8)
    has = rng.random(P) < 0.7
    a = rng.integers(0, L - B + 1, P)
    a[:3] = (0, L - B, 5)
    lengths[1::2][:3] = L
    lengths[7] = B - 3
    a[3] = 0
    a = np.where(has, np.minimum(a, np.maximum(lengths[1::2] - B, 0)), a)
    codes = np.where(np.arange(L)[None, :] < lengths[:, None], codes, 0)
    got = pe.expand_pe_rows(_t(codes), _t(lengths), _t(a),
                            torch.from_numpy(has), B)
    want = jpe.expand_pe_rows(jnp.asarray(codes, jnp.int32),
                              jnp.asarray(lengths, jnp.int32),
                              jnp.asarray(a, jnp.int32), jnp.asarray(has), B)
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(pe.expand_lengths_mask(3 * P, L, torch.from_numpy(has), B),
        jpe.expand_lengths_mask(3 * P, L, jnp.asarray(has), B))
    _eq(pe.anchor_span_mask(_t(a), torch.from_numpy(has), L, B),
        jpe.anchor_span_mask(jnp.asarray(a, jnp.int32), jnp.asarray(has),
                             L, B))
    back = pe.collapse_pe_rows(got[0], _t(lengths), _t(a),
                               torch.from_numpy(has), B)
    _eq(back, jpe.collapse_pe_rows(want[0], jnp.asarray(lengths, jnp.int32),
                                   jnp.asarray(a, jnp.int32),
                                   jnp.asarray(has), B))
    _eq(back, codes)
    _eq(pe.comp_codes(_t(codes)), jpe.comp_codes(jnp.asarray(codes)))
    assert pe.value_mask(B) == tuple(int(v) for v in jpe.value_mask(B))


# --- one PE batch: the encoder's modeling and the DNA decode ---------------

N_BATCH = 64      # lanes of the batch-level checks
L_BATCH = 40


def _batch_params():
    """The reference's Params of a tiny PE geometry: 64 lanes, 2^10-bucket
    s, b and pair tables, SIV cap 7, -qm n -im n."""
    p = jparams.Params()
    p.genome_size = 1
    p.adjust_kmer_sizes()
    p.dna_mode = jparams.DnaMode.PE_ORIGINAL
    p.quality_mode = jparams.QualityMode.NONE
    p.id_mode = jparams.IdMode.NONE
    p.n_lanes = N_BATCH
    p.smer_log2_buckets = p.bmer_log2_buckets = p.pe_log2_buckets = 10
    p.dna_siv_cap = 7
    return p


def _fragment_pairs(seed, P, L, genome_len, ragged=False):
    """Interleaved pairs (codes [2P, L] uint8, lengths [2P]) from both ends
    of fragments of a short genome, so that pairs recur; 1% errors, 1% N,
    and with ragged some shorter mates 2."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len)
    frag = rng.integers(L + 8, 3 * L, P)
    start = rng.integers(0, genome_len - frag.max(), P)
    r1 = genome[start[:, None] + np.arange(L)[None, :]]
    r2 = 3 - genome[(start + frag)[:, None] - 1 - np.arange(L)[None, :]]
    codes = np.empty((2 * P, L), np.int64)
    codes[0::2], codes[1::2] = r1, r2
    err = rng.random(codes.shape) < 0.01
    codes = np.where(err, (codes + 1) % 4, codes)
    codes = np.where(rng.random(codes.shape) < 0.01, 4, codes)
    lengths = np.full(2 * P, L, np.int64)
    if ragged:
        short = rng.random(P) < 0.25
        lengths[1::2] = np.where(short, rng.integers(1, L, P), L)
    codes = np.where(np.arange(L)[None, :] < lengths[:, None], codes, 0)
    return codes.astype(np.uint8), lengths


def _jax_state(d):
    """The reference's CodecState of a state_to_numpy dict."""
    return jp.CodecState(
        dna=jdna.DnaState(siv=jnp.asarray(d["siv"]),
                          s_tc=jnp.asarray(d["s_tc"]),
                          b_tc=jnp.asarray(d["b_tc"]),
                          model=jnp.asarray(d["model"]),
                          pe=tuple(jnp.asarray(a) for a in d["pe"])),
        meta=jnp.asarray(d["meta"]), qual=None, id=None)


def _jax_np(state):
    d = jax.device_get(state)
    return {"siv": d.dna.siv, "s_tc": d.dna.s_tc, "b_tc": d.dna.b_tc,
            "model": d.dna.model, "meta": d.meta,
            "pe": tuple(d.dna.pe)}


def _digest(*arrays):
    """sha256 of arrays' int64 values, in order (a tuple counts as its
    items)."""
    h = hashlib.sha256()
    for a in arrays:
        for x in (a if isinstance(a, tuple) else (a,)):
            x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            h.update(np.ascontiguousarray(x, np.int64).tobytes())
    return h.hexdigest()


# sha256 (_digest) of the reference's results on the batch of pe_runs:
# its _model_batch's grids and new state (each family), and its
# dna_decode_batch's (codes, final states, words consumed, extras, new
# DNA state); test_model_batch_matches_reference and
# test_dna_decode_matches_reference recompute them
BATCH_SHA256 = {
    "grids":
        "18c38c499e99299fa4fd8e3e5b9437220e393ea59d51700002cf2d3e6d158b65",
    "siv":
        "ace847cc9e228dce3f1e987d78c437effdbcd5ef40f946458e74cfdd38e753cc",
    "s_tc":
        "55f4dbdf727ff1ea76324fa71a88e3122c74e6ebb0cd7592a6ce4d1bf183f3c3",
    "b_tc":
        "214c074058b21cbc43fca8e2d6e40ff86b95cbc432d45377f46de9f46d2bea38",
    "model":
        "59cf5c78d435fe5103d17eb91c6c61a47e405aa40793b29a4fcf9f5a10200a26",
    "meta":
        "51b998fc31096d105ca011db536423b576648db2b0681cd670f371008fc988ce",
    "pe":
        "24721cfa64b011856ec402640eb1ebb35b1fa1f157af764301d878f4f5c4c784",
    "decode":
        "7b1cdd489c23b0f8a3e8593f11ec52c4858f853e991866c7b408ed8c4635449c",
}
_STATE_KEYS = ("siv", "s_tc", "b_tc", "model", "meta", "pe")


def _decode_digest(out):
    codes, st, x, ptr, extras = out
    return _digest(codes, x, ptr, *extras, st.siv, st.s_tc, st.b_tc,
                   st.model, tuple(st.pe))


@pytest.fixture(scope="module")
def pe_runs():
    """Three batches of 64 pairs through the port's _model_batch (the
    first two warm the tables; the pair table is batch-frozen, so the
    third finds anchors), and the third's DNA decode (its dna and pe
    streams encoded with the plain walk) from the state the second left."""
    p = _batch_params()
    tcfgs = pipeline.make_configs(tparams.Params.load_params(
        p.store_params()))
    codes, lengths = _fragment_pairs(3, 3 * N_BATCH, L_BATCH, 600,
                                     ragged=True)
    R = 2 * N_BATCH
    ts = pipeline.state_create(*tcfgs[:2], device="cpu")
    for k in range(2):
        _, ts = pipeline._model_batch(*tcfgs, ts, _t(codes[k * R:(k + 1) * R]),
                                      None, _t(lengths[k * R:(k + 1) * R]))
    start = state_to_numpy(ts)
    c3, l3 = codes[2 * R:], lengths[2 * R:]
    tgrids, ts3 = pipeline._model_batch(*tcfgs, ts, _t(c3), None, _t(l3))
    (df, dc), (pf, pc) = tgrids[1], tgrids[-1]
    words, n_words, x = rans.rans_encode(df, dc, SB)
    pwords, _, px = rans.rans_encode(pf, pc, SB)
    dec = (l3, words, x, pwords, px)
    got = dna.dna_decode_batch(
        tcfgs[0], state_from_numpy(start).dna, _t(l3), words, x, L_BATCH,
        pe_words=pwords, pe_states=px)
    return dict(p=p, start=start, batch=(c3, l3), tgrids=tgrids,
                tstate=state_to_numpy(ts3), dec=dec, got=got,
                n_words=int(n_words))


def test_model_batch_grids(pe_runs):
    """meta, dna and pe (freq, cum) grids: the reference's; the batch has
    anchors."""
    tg = pe_runs["tgrids"]
    assert len(tg) == 3
    assert _digest(*(a for g in tg for a in g)) == BATCH_SHA256["grids"]
    pf = tg[-1][0].numpy()
    # a pe symbol coded at a position column (lo byte): an anchor
    assert (pf[1::3] < 1 << SB).any()


@pytest.mark.parametrize("key", _STATE_KEYS)
def test_model_batch_state(pe_runs, key):
    """Each family of the new state (the pair table and pe model as
    "pe"): the reference's."""
    assert _digest(pe_runs["tstate"][key]) == BATCH_SHA256[key]


def test_dna_decode_batch_pe(pe_runs):
    """The decoded reads (the true interleaved ones), final DNA and pe
    lane states, words consumed, the walked rows' planes, the pe symbols
    and the new DNA state: the reference's."""
    codes_t, _, _, ptr, extras = pe_runs["got"]
    np.testing.assert_array_equal(codes_t.numpy(), pe_runs["batch"][0])
    assert int(ptr) == pe_runs["n_words"]
    assert int((extras[5][:, 0] < pe.N_CAND).sum()) > 0
    assert _decode_digest(pe_runs["got"]) == BATCH_SHA256["decode"]


@pytest.mark.slow
def test_model_batch_matches_reference(pe_runs):
    """The reference's _model_batch from the same state on the same batch:
    every grid and state family equal, element by element, and the
    BATCH_SHA256 digests its results."""
    p = pe_runs["p"]
    jcfgs = jp.make_configs(p)
    c3, l3 = pe_runs["batch"]
    kp, nm, qp, _ = jp._pack_inputs(c3, None, None, None)
    jgrids, js3 = jax.device_get(jp._model_batch(
        *jcfgs, _jax_state(pe_runs["start"]), jnp.asarray(kp),
        jnp.asarray(nm), jnp.asarray(qp), jnp.asarray(l3, jnp.int32),
        tuple(jnp.asarray(a) for a in jp.ids.zero_id_batch(c3.shape[0]))))
    for (jf, jc), (tf, tc) in zip(jgrids, pe_runs["tgrids"]):
        _eq(tf, jf)
        _eq(tc, jc)
    assert _digest(*(a for g in jgrids for a in g)) == BATCH_SHA256["grids"]
    jst = _jax_np(js3)
    for key in _STATE_KEYS:
        for g, w in zip(*((pe_runs["tstate"][key], jst[key]) if key == "pe"
                          else ((pe_runs["tstate"][key],), (jst[key],)))):
            np.testing.assert_array_equal(g, w, err_msg=key)
            assert g.dtype == w.dtype
        assert _digest(jst[key]) == BATCH_SHA256[key]


@pytest.mark.slow
def test_dna_decode_matches_reference(pe_runs):
    """The reference's dna_decode_batch (its XLA scan) on the same words:
    every output equal, element by element, and BATCH_SHA256["decode"]
    digests them."""
    l3, words, x, pwords, px = pe_runs["dec"]
    jcfg = jp.make_configs(pe_runs["p"])[0]
    u32 = lambda t: jnp.asarray(t.numpy().astype(np.uint32))
    want = jax.device_get(jdna.dna_decode_batch(
        jcfg, _jax_state(pe_runs["start"]).dna, jnp.asarray(l3, jnp.int32),
        u32(words), u32(x), L_BATCH, pe_words=u32(pwords),
        pe_states=u32(px)))
    got = pe_runs["got"]
    for g, w, name in zip(got[:1] + got[2:4], want[:1] + want[2:4],
                          ("codes", "final states", "words consumed")):
        _eq(g, w, name)
    for k, name in enumerate(("eff", "ctx", "sym", "code_active", "pe_x",
                              "pe_syms", "pe_act", "rows", "lengths3")):
        _eq(got[4][k], want[4][k], name)
    for key in ("siv", "s_tc", "b_tc", "model"):
        _eq(getattr(got[1], key), getattr(want[1], key), key)
    for g, w in zip(got[1].pe, want[1].pe):
        _eq(g, w, "pe state")
    assert _decode_digest(want) == BATCH_SHA256["decode"]


# --- archives ----------------------------------------------------------------

N_PAIRS = 24       # two batches (8 and 16 pairs): the second finds anchors
L_READ = 40
GROUP_MEM = 3_000    # a group a batch
# (tag, flags, pe_log2_buckets or None for the geometry's): original and
# sorted order, anchors on and off, -qm o -im o; with the sha256 of the
# reference writer's archive of each (test_reference_writer_digests_pe
# recomputes them) and, in sorted order, of the reference decoder's two
# FASTQs (test_reference_decoder_digests_pe)
MODES = (("original", ("-om", "o"), None), ("sorted", ("-om", "s"), None),
         ("original_pe0", ("-om", "o"), 0), ("sorted_pe0", ("-om", "s"), 0))
ARCHIVE_SHA256 = {
    "original":
        "dbb7b2798cfd09c1ac0d70a037471c17d3578d83caa75ad7d495416bd3ad919a",
    "sorted":
        "c8b8e3361219983b5b7da78c748bfb22ed7938080c5a0dd66663dca9f22d39c0",
    "original_pe0":
        "f55d6577eb93178f68e475e90216986f884c36352b4b71c87fafbd15a7139dc3",
    "sorted_pe0":
        "5f788046cda32e3f9a2c15c9a016966d368d17157940a1f386194c08a7d01559",
}
# both sorted archives decode to the same reads (anchors change the
# coding, not the order)
DECODED_SHA256 = dict.fromkeys(("sorted", "sorted_pe0"), (
    "539ad4d4cb5c5ce75ef196b1fa0164cd2cded7379e3f45e350ab860fb9df2290",
    "dea6b7d40d6a45faf9a8d9fd0f6424a172ebebbe5061f7e0da641c9132c5d5f3"))


_PARSE = cli.parse_args


def tiny_pe_params(mod, flags, peb=None):
    """The Params each package's CLI makes of `e -p -gs 1 -qm o -im o
    flags` on a tiny geometry: 8 lanes, 32-read batches (so batches of 2
    and 4 read rows, 3 and 6 walked rows with anchors), 2^12-bucket s/b
    tables, SIV cap 7; the pair table's size is -gs 1's (2^14 buckets)
    unless peb says otherwise."""
    if mod is tparams:
        parse = _PARSE
    else:
        from fqsqueezer_tpu.cli import parse_args as parse
    p = parse(["e", "-p", "-gs", "1", "-qm", "o", "-im", "o",
                            *flags, "a.fq", "b.fq"])
    p.n_lanes = 8
    p.max_batch_reads = 32
    p.smer_log2_buckets = p.bmer_log2_buckets = 12
    p.dna_siv_cap = 7
    p.verbosity = 0
    if peb is not None:
        p.pe_log2_buckets = peb
    return p


def write_pe_pairs(d, n_pairs=N_PAIRS, L=L_READ, ragged=True, seed=5):
    """Two mate files of pairs from a genome of 8 L bases (fragments
    recur, so the pair table finds anchors), with N bases, ragged mates 2
    and Illumina-like ids and qualities. Returns their paths."""
    codes, lengths = _fragment_pairs(seed, n_pairs, L, 8 * L, ragged)
    rng = np.random.default_rng(seed + 1)
    quals = rng.integers(2, 42, codes.shape).astype(np.uint8)
    quals = np.where(np.arange(L)[None, :] < lengths[:, None], quals, 0)
    paths = []
    for k in (0, 1):
        path = str(d / f"r{k + 1}.fastq")
        ids = [f"PE{seed}:{i % 3}:FC:{i}:{5 * i} {k + 1}:N:0".encode()
               for i in range(n_pairs)]
        jfastq.write_fastq(path, codes[k::2], quals[k::2], lengths[k::2],
                           ids)
        paths.append(path)
    return paths


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_pe")
    return write_pe_pairs(d), d


@pytest.fixture(scope="module", params=[m[0] for m in MODES])
def archive(request, corpus):
    """The port's archive of the corpus in one mode, its decode, and the
    anchors the decode armed."""
    tag, flags, peb = next(m for m in MODES if m[0] == request.param)
    (r1, r2), d = corpus
    arc = str(d / f"port_{tag}.fqst")
    outs = [str(d / f"port_{tag}_{k}.fastq") for k in (1, 2)]
    stats = pipeline.compress_pe(tiny_pe_params(tparams, flags, peb), r1,
                                 r2, arc, group_mem_bytes=GROUP_MEM,
                                 device="cpu")
    real, anchors = dna._pe_row_end, []

    def counted(*a):
        out = real(*a)
        anchors.append(int(out[5].sum()))
        return out

    dna._pe_row_end = counted
    try:
        dstats = pipeline.decompress_file(tparams.Params(), arc, *outs,
                                          device="cpu")
    finally:
        dna._pe_row_end = real
    return tag, arc, outs, stats, dstats, sum(anchors)


def test_pe_archive_is_the_reference_writers(archive):
    """The reference writer's bytes; the anchored archives code anchors
    (the decode arms some), the others have no pe stream."""
    tag, arc, _, stats, dstats, anchors = archive
    assert _sha(arc) == ARCHIVE_SHA256[tag]
    assert stats["n_reads"] == dstats["n_reads"] == 2 * N_PAIRS
    pe0 = tag.endswith("_pe0")
    assert (stats["stream_bytes"]["pe"] > 0) == (anchors > 0) == (not pe0)


def test_port_decodes_pe_archive(archive, corpus):
    """Original order: the input's bytes; sorted order: the reference
    decoder's bytes (the pairs sorted by mate 1)."""
    tag, _, outs, *_ = archive
    if tag in DECODED_SHA256:
        assert tuple(_sha(o) for o in outs) == DECODED_SHA256[tag]
    else:
        for o, src in zip(outs, corpus[0]):
            assert _sha(o) == _sha(src)


@pytest.mark.slow
@pytest.mark.parametrize("tag,flags,peb", MODES, ids=[m[0] for m in MODES])
def test_reference_writer_digests_pe(corpus, tag, flags, peb):
    (r1, r2), d = corpus
    arc = str(d / f"ref_{tag}.fqst")
    jp.compress_pe(tiny_pe_params(jparams, flags, peb), r1, r2, arc,
                   group_mem_bytes=GROUP_MEM)
    assert _sha(arc) == ARCHIVE_SHA256[tag]


@pytest.mark.slow
def test_reference_decoder_digests_pe(archive, corpus):
    """The reference decodes the port's archive: the input's bytes, or
    DECODED_SHA256 in sorted order."""
    tag, arc, *_ = archive
    d = corpus[1]
    outs = [str(d / f"ref_{tag}_{k}.fastq") for k in (1, 2)]
    jp.decompress_file(jparams.Params(), arc, *outs)
    if tag in DECODED_SHA256:
        assert tuple(_sha(o) for o in outs) == DECODED_SHA256[tag]
    else:
        for o, src in zip(outs, corpus[0]):
            assert _sha(o) == _sha(src)


def test_streamed_pe_archive_equals_in_ram(tmp_path):
    """Block-streamed mates (chunks of a few records) give the in-RAM
    archive (equal-length reads: a streamed batch is as wide as the
    in-RAM one)."""
    r1, r2 = write_pe_pairs(tmp_path, n_pairs=8, ragged=False)
    shas = []
    for chunk in (0, 300):
        arc = str(tmp_path / f"s{chunk}.fqst")
        pipeline.compress_pe(tiny_pe_params(tparams, ("-om", "o")), r1, r2,
                             arc, group_mem_bytes=GROUP_MEM, device="cpu",
                             stream_chunk_bytes=chunk)
        shas.append(_sha(arc))
    assert shas[0] == shas[1]


def _mismatched(tmp_path):
    r1, r2 = write_pe_pairs(tmp_path, n_pairs=6, ragged=False)
    with open(r2, "a") as f:
        f.write("@extra\nACGT\n+\nIIII\n@extra2\nACGT\n+\nIIII\n")
    return r1, r2


@pytest.mark.parametrize("chunk", [0, 1 << 20])
def test_mate_count_error_is_the_references(tmp_path, chunk):
    """In RAM and streamed: the reference's ValueError and message."""
    r1, r2 = _mismatched(tmp_path)
    msgs = []
    for mod, kw in ((jp, {}), (pipeline, {"device": "cpu"})):
        p = tiny_pe_params(jparams if mod is jp else tparams, ("-om", "o"))
        with pytest.raises(ValueError, match="mate counts differ") as e:
            mod.compress_pe(p, r1, r2, str(tmp_path / "x.fqst"),
                            stream_chunk_bytes=chunk, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_cli_e_p_and_d_out2(tmp_path, monkeypatch):
    """`e -p` and `d -out -out2` through the port's CLI on the CPU (its
    Params cut to tiny_pe_params' geometry: the CLI's own, 1024 lanes
    and a 4^13-word SIV, would take GiBs of host memory): lossless modes
    decode to both mate files' bytes."""
    parse = cli.parse_args

    def tiny(argv):
        p = parse(argv)
        if argv[0] == "e":
            for k in ("n_lanes", "max_batch_reads", "smer_log2_buckets",
                      "bmer_log2_buckets", "dna_siv_cap"):
                setattr(p, k, getattr(tiny_pe_params(tparams, ()), k))
        return p

    monkeypatch.setattr(cli, "parse_args", tiny)
    r1, r2 = write_pe_pairs(tmp_path, n_pairs=8)
    arc = str(tmp_path / "cli.fqst")
    outs = [str(tmp_path / f"cli_{k}.fastq") for k in (1, 2)]
    assert cli.main(["e", "--device", "cpu", "-p", "-om", "o", "-qm", "o",
                     "-im", "o", "-gs", "1", "-v", "0", "-out", arc, r1,
                     r2]) == 0
    assert cli.main(["d", "--device", "cpu", "-v", "0", "-out", outs[0],
                     "-out2", outs[1], arc]) == 0
    for o, src in zip(outs, (r1, r2)):
        assert _sha(o) == _sha(src)
    with pytest.raises(SystemExit, match="two input files"):
        cli.main(["e", "--device", "cpu", "-p", "-out", arc, r1])


def test_dna_pe_pos_ctx_is_refused(pe_runs):
    """The knob no entry point sets (dna_pe_pos_ctx), once refused, now
    passes and decodes: pe_runs' third batch modeled under it from the
    same state gives its anchored rowA and rowB read2's coordinates
    (dna._pe_pos_map), so its dna grid differs from the one without the
    knob, and the plain decode (K2's plain version) of its encode
    returns the batch and consumes every word. The archives under the
    knob are held to the reference writer's in tests/test_torch_knobs.py."""
    tcfgs = pipeline.make_configs(_pos_ctx_params())
    assert tcfgs[0].pe_pos_ctx
    c3, l3 = pe_runs["batch"]
    tgrids, _ = pipeline._model_batch(
        *tcfgs, state_from_numpy(pe_runs["start"]), _t(c3), None, _t(l3))
    assert not torch.equal(tgrids[1][0], pe_runs["tgrids"][1][0])
    (df, dc), (pf, pc) = tgrids[1], tgrids[-1]
    words, n_words, x = rans.rans_encode(df, dc, SB)
    pwords, _, px = rans.rans_encode(pf, pc, SB)
    codes_t, _, _, ptr, _ = dna.dna_decode_batch(
        tcfgs[0], state_from_numpy(pe_runs["start"]).dna, _t(l3), words, x,
        L_BATCH, pe_words=pwords, pe_states=px)
    np.testing.assert_array_equal(codes_t.numpy(), c3)
    assert int(ptr) == int(n_words)


def _pos_ctx_params():
    p = tparams.Params.load_params(_batch_params().store_params())
    p.dna_pe_pos_ctx = 1
    return p
