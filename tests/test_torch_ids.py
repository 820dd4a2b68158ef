"""The port's id stream against the reference package's, exact.

Host half: each function the port copied from fqsqueezer_tpu/streams/ids.py
gives the reference's outputs (planes, chains, bytes) on the fixtures of
tests/test_ids.py — tokenize/detokenize, zero-padded widths, large delta
magnitudes, escapes, instrument prefixes, and the vectorized
encode_ids_host/decode_ids_host with n_valid below R. Device half (torch
ops on the CPU): model_cdf_masked, id_modeling and id_decode_batch on an
encoded batch with padded rows and several read rows a lane; and the id
model through the port's state conversion both ways.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fqsqueezer_tpu.ops import models as jmodels
from fqsqueezer_tpu.streams import ids as jids
from fqsqueezer_tpu_torch import pipeline
from fqsqueezer_tpu_torch.ops import models as tmodels
from fqsqueezer_tpu_torch.params import DnaMode, IdMode, Params
from fqsqueezer_tpu_torch.state import state_from_numpy, state_to_numpy
from fqsqueezer_tpu_torch.streams import ids as tids

from test_ids import SAMPLE, _adversarial_corpus


def _same_planes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


# --- host half ----------------------------------------------------------------

def test_constants_and_config_are_the_reference():
    for k in ("N_SYM", "COL_BUCKETS", "F_CAP", "MAGS", "CTX_LEN0",
              "CTX_LEN1", "CTX_BYTE0", "CTX_FLAG", "CTX_DELTA0", "CTX_MAG0",
              "N_CTX"):
        assert getattr(tids, k) == getattr(jids, k), k
    np.testing.assert_array_equal(tids._NB_LUT, jids._NB_LUT)
    np.testing.assert_array_equal(tids._alpha_lut_np(), jids._alpha_lut_np())
    for kw in ({}, {"max_id_len": 24, "n_fields": 2, "codec_v": 1}):
        j, t = jids.IdConfig(**kw), tids.IdConfig(**kw)
        assert (t.w_sym, t.w_all, t.codec_v) == (j.w_sym, j.w_all, j.codec_v)


@pytest.mark.parametrize("s", SAMPLE + [b"run_0042_x", b"run_42_x",
                                        b"a.0.7", b"wide1234567890123end9"])
def test_tokenize_detokenize(s):
    t = tids.tokenize_id(s)
    assert t == jids.tokenize_id(s)
    assert tids.detokenize(*t) == jids.detokenize(*t) == s


def test_zero_padded_widths():
    t, v = tids.tokenize_id(b"run_0042_x")
    assert v == [42]
    assert tids.detokenize(t, [43]) == jids.detokenize(t, [43]) == \
        b"run_0043_x"
    t2, _ = tids.tokenize_id(b"run_42_x")
    assert tids.detokenize(t2, [123]) == b"run_123_x"


def test_count_fields_instrument_prefix_and_read_lanes():
    rng = np.random.default_rng(3)
    corpus = _adversarial_corpus(rng, 300)
    for idl in (SAMPLE, corpus, [], [b"x.1.2.3.4.5.6.7.8.9.10.11.12.13"]):
        assert tids.count_fields(idl) == jids.count_fields(idl)
    idl = [b"M00123:45:ABC.1 x", b"plain", b"a.b.c", b"sp ace"] + corpus
    assert tids.instrument_prefix(idl) == jids.instrument_prefix(idl)
    np.testing.assert_array_equal(tids.read_lanes(64, 8),
                                  jids.read_lanes(64, 8))
    _same_planes(tids.zero_id_batch(16), jids.zero_id_batch(16))


def test_large_delta_magnitudes():
    cases = [0, 1, -1, 2, -2, 255, 257, -257, 65538, -70000, 1 << 30]
    base = 500_000_000
    idl = [f"x.{base}".encode()]
    for d in cases:
        idl += [f"x.{base + d}".encode(), f"x.{base}".encode()]
    lanes = np.zeros(len(idl), np.int64)
    planes = tids.encode_ids_host(idl, lanes, 1, 16, [None])
    _same_planes(planes, jids.encode_ids_host(idl, lanes, 1, 16, [None]))
    assert tids.decode_ids_host(*planes, lanes, [None]) == idl
    for r in range(len(idl)):
        for f in range(1):
            assert tids._delta_of(int(planes[1][r, f]), planes[2][r, f]) \
                == jids._delta_of(int(planes[1][r, f]), planes[2][r, f])


@pytest.mark.parametrize("kind", ["single", "mesh"])
def test_encode_ids_host_equals_reference(kind):
    """Both encoders of the port (vectorized and scalar) against both of the
    reference's, two consecutive batches with padded rows, chains carried
    across."""
    rng = np.random.default_rng(11)
    F, M = 4, 48
    idl = _adversarial_corpus(rng, 400)
    lanes = (np.zeros(400, np.int64) if kind == "single"
             else np.arange(400) // 100)
    n = 1 if kind == "single" else 4
    chains = [[None] * n for _ in range(4)]
    for lo, hi, nv in ((0, 200, 192), (200, 400, 200)):
        batch, ln = idl[lo:hi], lanes[lo:hi] - lanes[lo]
        want = jids.encode_ids_host(batch, ln, F, M, chains[0], n_valid=nv)
        for fn, ch in ((jids.encode_ids_host_ref, chains[1]),
                       (tids.encode_ids_host, chains[2]),
                       (tids.encode_ids_host_ref, chains[3])):
            _same_planes(fn(batch, ln, F, M, ch, n_valid=nv), want)
        assert chains[1] == chains[2] == chains[3] == chains[0]


def test_decode_ids_host_equals_reference():
    rng = np.random.default_rng(12)
    F, M = 4, 48
    idl = _adversarial_corpus(rng, 300)
    lanes = np.arange(300) // 150
    planes = jids.encode_ids_host(idl, lanes, F, M, [None, None],
                                  n_valid=290)
    chains = [[None, None] for _ in range(4)]
    want = jids.decode_ids_host(*planes, lanes, chains[0], n_valid=290)
    for fn, ch in ((jids.decode_ids_host_ref, chains[1]),
                   (tids.decode_ids_host, chains[2]),
                   (tids.decode_ids_host_ref, chains[3])):
        assert fn(*planes, lanes, ch, n_valid=290) == want
    assert chains[1] == chains[2] == chains[3] == chains[0]
    assert want[:290] == idl[:290]


def test_sample_chain_round_trip():
    R = len(SAMPLE)
    lanes = np.zeros(R, np.int64)
    F = tids.count_fields(SAMPLE)
    M = max(len(s) for s in SAMPLE) + 1
    planes = tids.encode_ids_host(SAMPLE, lanes, F, M, [None])
    _same_planes(planes, jids.encode_ids_host(SAMPLE, lanes, F, M, [None]))
    flag = planes[0]
    assert list(flag[[0, 5, 7]]) == [1, 1, 1]
    assert list(flag[[1, 2, 3, 4, 6]]) == [0] * 5
    assert tids.decode_ids_host(*planes, lanes, [None]) == SAMPLE


# --- device half --------------------------------------------------------------

N, R_PL = 4, 4
R = N * R_PL
N_VALID = 13


def _batch():
    """A batch of R ids over N lanes (R_PL rows a lane) whose last rows are
    padding: counters, an escape, an empty id and a long one."""
    idl = ([f"SIM.{r} {3 * r}".encode() for r in range(N_VALID - 3)]
           + [b"other.7 x", b"", b"SIM.99999999 1 tail-of-bytes"])
    idl += [b""] * (R - N_VALID)
    jcfg = jids.IdConfig(max_id_len=28, n_fields=2, n_lanes=N)
    tcfg = tids.IdConfig(max_id_len=28, n_fields=2, n_lanes=N)
    planes = jids.encode_ids_host(idl, jids.read_lanes(R, N), 2, 28, [None],
                                  n_valid=N_VALID)
    rng = np.random.default_rng(5)
    model = rng.integers(0, 400, (jids.N_CTX, jids.N_SYM)).astype(np.int32)
    model[rng.random(jids.N_CTX) < 0.3] = 0
    return jcfg, tcfg, idl, planes, model


@pytest.fixture(scope="module")
def id_batch():
    jcfg, tcfg, idl, planes, model = _batch()
    jm = jnp.asarray(model)
    jb = tuple(jnp.asarray(a) for a in planes)
    words, n_words, states, enc_model = jids.id_encode_batch(
        jcfg, jm, *jb, n_valid=jnp.int32(N_VALID))
    n = int(n_words)
    cap = R * jcfg.w_all + 4 * N
    w = np.zeros(cap, np.int64)
    w[:n] = np.asarray(words)[:n]
    st = np.asarray(states).astype(np.int64)
    jdec = jax.device_get(jids.id_decode_batch(
        jcfg, jm, R, jnp.asarray(w, jnp.uint32), jnp.asarray(st, jnp.uint32),
        n_valid=jnp.int32(N_VALID)))
    tdec = tids.id_decode_batch(tcfg, torch.from_numpy(model), R,
                                torch.from_numpy(w), torch.from_numpy(st),
                                n_valid=N_VALID)
    return {"jcfg": jcfg, "tcfg": tcfg, "idl": idl, "planes": planes,
            "model": model, "enc_model": np.asarray(enc_model), "n": n,
            "jdec": jdec, "tdec": tdec}


def test_model_cdf_masked(id_batch):
    model = id_batch["model"]
    lut = jids._alpha_lut_np()
    ctx = np.random.default_rng(1).integers(0, jids.N_CTX, (7, 5))
    want = jmodels.model_cdf_masked(jnp.asarray(model), jnp.asarray(lut),
                                    jnp.asarray(ctx), 14)
    got = tmodels.model_cdf_masked(torch.from_numpy(model),
                                   torch.from_numpy(lut),
                                   torch.from_numpy(ctx), 14)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # zero-width steps for the symbols a context cannot code
    flag_row = got[ctx == tids.CTX_FLAG]
    if flag_row.numel():
        assert (flag_row[:, 3:] == flag_row[:, 2:-1]).all()


def test_id_modeling(id_batch):
    jcfg, tcfg, planes = id_batch["jcfg"], id_batch["tcfg"], id_batch["planes"]
    model = id_batch["model"]
    want = jax.device_get(jids.id_modeling(
        jcfg, jnp.asarray(model), *(jnp.asarray(a) for a in planes),
        n_valid=jnp.int32(N_VALID)))
    got = tids.id_modeling(tcfg, torch.from_numpy(model),
                           *(torch.from_numpy(a) for a in planes),
                           n_valid=N_VALID)
    for name, g, w in zip(("ctx", "syms", "f", "c", "active"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # padding rows code nothing
    assert not got[4][N_VALID:].any()


def test_id_decode_batch(id_batch):
    """Planes, updated model, final states and words consumed: the
    reference's, and the encoded planes on the valid rows."""
    jdec, tdec = id_batch["jdec"], id_batch["tdec"]
    names = ("flag", "dsym", "dmag", "emat", "elens", "model", "states",
             "ptr")
    for name, g, w in zip(names, tdec, jdec):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(w).astype(np.int64),
                                      err_msg=name)
    np.testing.assert_array_equal(tdec[5].numpy(), id_batch["enc_model"])
    assert int(tdec[7]) == id_batch["n"]
    for g, w in zip(tdec[:2], id_batch["planes"][:2]):
        np.testing.assert_array_equal(g.numpy()[:N_VALID], w[:N_VALID])
    ids_out = tids.decode_ids_host(*(a.numpy() for a in tdec[:5]),
                                   tids.read_lanes(R, N), [None],
                                   n_valid=N_VALID)
    assert ids_out[:N_VALID] == id_batch["idl"][:N_VALID]


def test_id_codec_v1_is_refused():
    """The legacy id codec (the first writer's, id_codec_v 1), once
    refused, against the reference: make_configs maps it; on the
    device batch of the other tests, with its padding rows tokenized like
    real ones (host_n_valid), the reference's encode (ALPHA over all 256
    symbols of every context, the padding coded) decodes through the
    port's id_decode_batch to the reference decoder's planes, model,
    states and words consumed, the padding included, and those detokenize
    to the batch's ids."""
    p = Params()
    p.dna_mode = DnaMode.SE_ORIGINAL
    p.id_mode = IdMode.LOSSLESS
    p.id_codec_v = 1
    assert pipeline.make_configs(p)[3].codec_v == 1
    _, _, idl, _, model = _batch()
    jcfg = jids.IdConfig(max_id_len=28, n_fields=2, n_lanes=N, codec_v=1)
    tcfg = tids.IdConfig(max_id_len=28, n_fields=2, n_lanes=N, codec_v=1)
    assert tids.host_n_valid(tcfg, N_VALID) is None
    planes = tids.encode_ids_host(idl, tids.read_lanes(R, N), 2, 28, [None],
                                  n_valid=tids.host_n_valid(tcfg, N_VALID))
    _same_planes(planes, jids.encode_ids_host(
        idl, jids.read_lanes(R, N), 2, 28, [None], n_valid=None))
    jm = jnp.asarray(model)
    words, n_words, states, enc_model = jids.id_encode_batch(
        jcfg, jm, *(jnp.asarray(a) for a in planes),
        n_valid=jnp.int32(N_VALID))
    n = int(n_words)
    w = np.zeros(R * jcfg.w_all + 4 * N, np.int64)
    w[:n] = np.asarray(words)[:n]
    st = np.asarray(states).astype(np.int64)
    jdec = jax.device_get(jids.id_decode_batch(
        jcfg, jm, R, jnp.asarray(w, jnp.uint32), jnp.asarray(st, jnp.uint32),
        n_valid=jnp.int32(N_VALID)))
    tdec = tids.id_decode_batch(tcfg, torch.from_numpy(model), R,
                                torch.from_numpy(w), torch.from_numpy(st),
                                n_valid=N_VALID)
    for name, g, want in zip(("flag", "dsym", "dmag", "emat", "elens",
                              "model", "states", "ptr"), tdec, jdec):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(want).astype(np.int64),
                                      err_msg=name)
    np.testing.assert_array_equal(tdec[5].numpy(), np.asarray(enc_model))
    assert int(tdec[7]) == n
    for g, want in zip(tdec[:5], planes):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      want.astype(np.int64))
    assert tids.decode_ids_host(*(a.numpy() for a in tdec[:5]),
                                tids.read_lanes(R, N), [None]) == idl


def test_id_state_crosses_both_ways(id_batch):
    """The id model goes through state_from_numpy and state_to_numpy as the
    reference's int32 array, beside the other families."""
    dcfg, qcfg, mcfg, icfg = pipeline.make_configs(_id_params())
    assert icfg is not None and qcfg is None
    st = state_to_numpy(pipeline.state_create(dcfg, qcfg, icfg))
    assert st["id"].shape == (tids.N_CTX, tids.N_SYM)
    st["id"] = id_batch["enc_model"]
    back = state_to_numpy(state_from_numpy(st))
    assert back["id"].dtype == np.int32
    np.testing.assert_array_equal(back["id"], id_batch["enc_model"])
    assert back["qual"] is None


def _id_params():
    from fqsqueezer_tpu_torch import params as tparams

    p = tparams.Params()
    p.genome_size = 1
    p.adjust_kmer_sizes()
    p.smer_log2_buckets = p.bmer_log2_buckets = 8
    p.dna_siv_cap = 7
    p.n_lanes = N
    p.dna_mode = tparams.DnaMode.SE_ORIGINAL
    p.quality_mode = tparams.QualityMode.NONE
    p.id_mode = tparams.IdMode.LOSSLESS
    return p
