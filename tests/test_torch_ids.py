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
            "w": w, "st": st, "jdec": jdec, "tdec": tdec}


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


@pytest.fixture(scope="module")
def id_batch_v1():
    """The batch of id_batch under the legacy id codec (the first
    writer's, id_codec_v 1): its padding rows tokenized like real ones
    (host_n_valid), the reference's encode (ALPHA over all 256 symbols of
    every context, the padding coded) and the reference decoder's
    outputs, and the port's id_decode_batch of the same words."""
    _, _, idl, _, model = _batch()
    jcfg = jids.IdConfig(max_id_len=28, n_fields=2, n_lanes=N, codec_v=1)
    tcfg = tids.IdConfig(max_id_len=28, n_fields=2, n_lanes=N, codec_v=1)
    planes = tids.encode_ids_host(idl, tids.read_lanes(R, N), 2, 28, [None],
                                  n_valid=tids.host_n_valid(tcfg, N_VALID))
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
    return {"jcfg": jcfg, "tcfg": tcfg, "idl": idl, "planes": planes,
            "model": model, "enc_model": np.asarray(enc_model), "n": n,
            "w": w, "st": st, "jdec": jdec, "tdec": tdec}


def test_id_codec_v1_is_refused(id_batch_v1):
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
    b = id_batch_v1
    idl, planes = b["idl"], b["planes"]
    assert tids.host_n_valid(b["tcfg"], N_VALID) is None
    _same_planes(planes, jids.encode_ids_host(
        idl, jids.read_lanes(R, N), 2, 28, [None], n_valid=None))
    tdec, jdec, n = b["tdec"], b["jdec"], b["n"]
    for name, g, want in zip(("flag", "dsym", "dmag", "emat", "elens",
                              "model", "states", "ptr"), tdec, jdec):
        np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                      np.asarray(want).astype(np.int64),
                                      err_msg=name)
    np.testing.assert_array_equal(tdec[5].numpy(), b["enc_model"])
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


# --- the id decode scan: kernel K4's inputs, rule and wrapper ------------------

def slot_scan_emulated(table, slot_words, W, N, R, words, init, sb, n_valid,
                       M, rule_ids=True):
    """csrc/slot_decode.cu's slot_decode_kernel, lane by lane in Python:
    the slot word's kind and the carries (the flag, 4-bit delta symbols
    clamped to 8, the length), the 8-probe binary search of the staged
    row, the state update and the renormalizing lanes' words in lane
    order (past the end: the last word). Without rule_ids, the meta rule:
    every slot active, row = slot. Returns (out [R, W] uint8, final states
    [N], words consumed)."""
    r_pl = R // N
    mask = (1 << sb) - 1
    x = [int(v) for v in init]
    flag, ln, ds = [0] * N, [0] * N, [0] * N
    out = np.zeros((R, W), np.uint8)
    ptr = 0
    for rd in range(r_pl):
        for i in range(W):
            if rule_ids:
                s = int(slot_words[i])
                ctx, kind, arg = s & 0xFF, (s >> 8) & 0xF, s >> 12
            else:
                ctx, kind, arg = i, tids.SLOT_FLAG, 0
            syms = []
            for n in range(N):
                act = n * r_pl + rd < n_valid
                if kind == tids.SLOT_DELTA:
                    act = act and flag[n] == 0
                elif kind == tids.SLOT_MAG:
                    d = (ds[n] >> (4 * (arg >> 2))) & 0xF
                    act = act and flag[n] == 0 and (
                        0 if d < 3 else 1 << ((d - 3) >> 1)) > (arg & 3)
                elif kind in (tids.SLOT_LEN0, tids.SLOT_LEN1):
                    act = act and flag[n] > 0
                elif kind == tids.SLOT_BYTE:
                    act = act and flag[n] > 0 and ln[n] > arg
                slot = x[n] & mask
                f, c, sym = 1 << sb, 0, 0
                if act:
                    row = table[ctx]
                    k = 0
                    for h in (128, 64, 32, 16, 8, 4, 2, 1):
                        k = k + h if row[k + h] <= slot else k
                    sym, c, f = k, int(row[k]), int(row[k + 1] - row[k])
                x[n] = (f * (x[n] >> sb) + slot - c) & 0xFFFFFFFF
                if kind == tids.SLOT_FLAG:
                    flag[n] = sym
                elif kind == tids.SLOT_DELTA:
                    ds[n] = (ds[n] & ~(0xF << (4 * arg))) | (
                        min(sym, 8) << (4 * arg))
                elif kind == tids.SLOT_LEN0:
                    ln[n] = sym
                elif kind == tids.SLOT_LEN1:
                    ln[n] = min(ln[n] | sym << 8, M)
                syms.append(sym)
            for n in range(N):
                if x[n] < 1 << 16:
                    x[n] = ((x[n] << 16) | int(words[min(ptr,
                                                         len(words) - 1)]))
                    ptr += 1
                out[n * r_pl + rd, i] = syms[n]
    return out, np.array(x, np.int64), ptr


def _k4_staged(b):
    """The batch's K4 inputs: (cdf table [N_CTX, 257] int32, slot words
    [w_all] int32)."""
    cfg = b["tcfg"]
    return (tids._ctx_cdfs(cfg, torch.from_numpy(b["model"])).to(
        torch.int32), tids.k4_slots(cfg))


@pytest.mark.parametrize("codec", ["v2", "v1"])
def test_k4_staged_inputs_equal_the_reference(id_batch, id_batch_v1, codec):
    """K4's table is the reference's cdf of every context (model_cdf_masked
    under v2, model_cdf under v1), its slot words hold the contexts of
    the reference's id_modeling, and their kinds, through the kernel's
    rule, give its active plane on the decoded planes; the plain scan
    (id_decode_scan_plain) gives the reference decoder's grid, states and
    words consumed, and so does the kernel's arithmetic emulated lane by
    lane on the staged inputs."""
    b = id_batch if codec == "v2" else id_batch_v1
    jcfg, cfg, model = b["jcfg"], b["tcfg"], b["model"]
    table, slots = _k4_staged(b)
    ctx = jnp.arange(jids.N_CTX)
    want = (jax.jit(jmodels.model_cdf_masked, static_argnums=3)(
        jnp.asarray(model), jnp.asarray(jids._alpha_lut_np()), ctx,
        cfg.scale_bits) if codec == "v2" else jax.jit(
        jmodels.model_cdf, static_argnums=2)(jnp.asarray(model), ctx,
                                             cfg.scale_bits))
    assert table.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy(), np.asarray(want))
    jdec = b["jdec"]
    # one compiled call (the operations one by one take seconds)
    jctx, _, _, _, jact = jax.device_get(jax.jit(
        jids.id_modeling, static_argnums=0)(
        jcfg, jnp.asarray(model), *(jnp.asarray(a) for a in jdec[:5]),
        jnp.int32(N_VALID)))
    sw = slots.numpy()
    assert sw.shape == (cfg.w_all,)
    np.testing.assert_array_equal(sw & 0xFF, np.asarray(jctx)[0])
    # the planes as one [R, w_all] grid, the length as its two bytes
    el = np.asarray(jdec[4]).astype(np.int64)
    jgrid = np.concatenate(
        [np.asarray(jdec[0])[:, None], np.asarray(jdec[1]),
         np.asarray(jdec[2]).reshape(R, -1), (el & 0xFF)[:, None],
         (el >> 8)[:, None], np.asarray(jdec[3])], axis=1).astype(np.int64)
    nv = N_VALID if codec == "v2" else R
    grid, x, ptr = tids.id_decode_scan_plain(
        cfg, table, R, torch.from_numpy(b["w"]).to(torch.int32),
        torch.from_numpy(b["st"]), n_valid=N_VALID)
    assert grid.dtype == torch.uint8 and tuple(grid.shape) == (R, cfg.w_all)
    np.testing.assert_array_equal(grid.numpy(), jgrid)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jdec[6]))
    assert int(ptr) == int(jdec[7]) == b["n"]
    emu = slot_scan_emulated(table.numpy(), sw, cfg.w_all, N, R, b["w"],
                             b["st"], cfg.scale_bits, nv, cfg.max_id_len)
    np.testing.assert_array_equal(emu[0], jgrid)
    np.testing.assert_array_equal(emu[1], np.asarray(jdec[6]))
    assert emu[2] == b["n"]
    # the kinds through the kernel's rule: the reference's active plane
    act = np.zeros((R, cfg.w_all), bool)
    for r in range(R):
        flag, ds, ln = jgrid[r, 0], jgrid[r, 1:1 + cfg.n_fields], el[r]
        for i, s in enumerate(sw):
            kind, arg = (s >> 8) & 0xF, s >> 12
            act[r, i] = r < nv and (
                kind == tids.SLOT_FLAG
                or (kind == tids.SLOT_DELTA and flag == 0)
                or (kind == tids.SLOT_MAG and flag == 0
                    and tids._NB_LUT[min(ds[arg >> 2], 8)] > (arg & 3))
                or (kind in (tids.SLOT_LEN0, tids.SLOT_LEN1) and flag > 0)
                or (kind == tids.SLOT_BYTE and flag > 0 and ln > arg))
    np.testing.assert_array_equal(act, np.asarray(jact))


@pytest.mark.parametrize("codec_v,n_pad,short", [(2, 5, False),
                                                 (1, 0, False),
                                                 (2, 0, True)])
def test_k4_emulated_equals_plain_scan_on_encoded_batches(codec_v, n_pad,
                                                          short):
    """utils/id_batches' encoded batches (F = 12, escapes up to M = 300,
    whose lengths take both bytes; zero rows and zero-width steps; padding
    rows; words cut short, so reads past the end clamp): the kernel's
    arithmetic emulated on the staged inputs equals the plain scan, which
    decodes the encoded planes where the words suffice."""
    from fqsqueezer_tpu_torch.utils.id_batches import id_scan_inputs

    cfg, table, R_, words, init, nv = id_scan_inputs(
        40 + codec_v + short, 4, 2, 12, 300, codec_v=codec_v, n_pad=n_pad,
        short=short)
    assert cfg.w_all == 1 + 12 * 5 + 2 + 300
    grid, x, ptr = tids.id_decode_scan_plain(cfg, table, R_, words, init,
                                             nv)
    emu = slot_scan_emulated(table.numpy(), tids.k4_slots(cfg).numpy(),
                             cfg.w_all, 4, R_, words.numpy(), init.numpy(),
                             cfg.scale_bits,
                             nv if codec_v >= 2 else R_, cfg.max_id_len)
    np.testing.assert_array_equal(emu[0], grid.numpy())
    np.testing.assert_array_equal(emu[1], x.numpy())
    assert emu[2] == int(ptr)
    g = grid.numpy().astype(np.int64)
    if not short:
        assert (g[:, 0] > 0).any() and (g[:, 0] == 0).any()
        assert ((g[:, 61] | g[:, 62] << 8) > 255).any()   # both bytes
    if n_pad:
        assert not g[R_ - n_pad:].any()


def _refuse_build(monkeypatch):
    from fqsqueezer_tpu_torch.ops import _build

    def refuse():
        raise AssertionError("the kernel build was reached")

    monkeypatch.setattr(_build, "kernels", refuse)


def test_check_k4_refuses_bad_shapes_before_any_build(id_batch,
                                                      monkeypatch):
    """K4's wrapper checks every argument before it builds or launches:
    (on CPU tensors, which reach the wrapper only here) each bad argument
    raises ValueError, and good ones get as far as the build."""
    import dataclasses

    _refuse_build(monkeypatch)
    cfg = id_batch["tcfg"]
    table, _ = _k4_staged(id_batch)
    words = torch.from_numpy(id_batch["w"]).to(torch.int32)
    init = torch.from_numpy(id_batch["st"])
    good = (cfg, table, R, words, init, N_VALID)

    def bad(k, v):
        a = list(good)
        a[k] = v
        return a

    before = tids.K4_LAUNCHES
    for args in (bad(2, R - 1),                            # R % N != 0
                 bad(0, dataclasses.replace(cfg, n_lanes=4096)),
                 bad(0, dataclasses.replace(cfg, scale_bits=17)),
                 bad(0, dataclasses.replace(cfg, n_fields=tids.F_CAP + 1)),
                 bad(2, (1 << 31) // cfg.w_all // N * N + N),  # R * W
                 bad(3, words[:0]),                        # no words
                 bad(3, words.long()),                     # wrong dtype
                 bad(1, table.long()),
                 bad(1, table[:-1]),                       # wrong shape
                 bad(1, table.t().contiguous().t()),       # not contiguous
                 bad(4, init[:-1]),
                 bad(4, init.int())):
        with pytest.raises(ValueError):
            tids._id_decode_scan_cuda(*args)
    with pytest.raises(AssertionError, match="build was reached"):
        tids._id_decode_scan_cuda(*good)
    assert tids.K4_LAUNCHES == before


def test_id_decode_on_the_cpu_never_builds(id_batch, monkeypatch):
    """On CPU tensors id_decode_batch runs the plain scan and never
    reaches the kernel build; a device that is neither the CPU nor CUDA
    is refused."""
    _refuse_build(monkeypatch)
    before = tids.K4_LAUNCHES
    got = tids.id_decode_batch(
        id_batch["tcfg"], torch.from_numpy(id_batch["model"]), R,
        torch.from_numpy(id_batch["w"]), torch.from_numpy(id_batch["st"]),
        n_valid=N_VALID)
    for g, w in zip(got, id_batch["tdec"]):
        assert torch.equal(g, w)
    assert tids.K4_LAUNCHES == before
    table, _ = _k4_staged(id_batch)
    with pytest.raises(ValueError, match="no scan for device meta"):
        tids.id_decode_scan(id_batch["tcfg"], table.to("meta"), R,
                            torch.zeros(4, dtype=torch.int32, device="meta"),
                            torch.zeros(N, dtype=torch.int64, device="meta"))
