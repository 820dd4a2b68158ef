"""The port's decode side against the reference package, exact.

The rANS decode steps (ops/rans.py) on random states, words and cdf rows;
then one batch of the three stream decoders (meta_decode_batch,
qual_decode_batch, dna_decode_batch) against the reference's on the same
words and the same state. The state is the one the reference reaches over
two batches of a tiny corpus, carried across with state_from_numpy; the
words are the port's encode of a third batch (its grids are held to the
reference's in test_torch_streams.py). The geometry is the tiny one of
test_torch_streams.py with SIV cap 12, so the prefix ramp and the rough
rescue are on: 8 lanes, 16 reads (two read rows), ragged lengths with
0, 1 and the full width among them. Tolerance 0: the codec is
integer-only. Everything of the port runs on the CPU (the plain versions
of its kernels). Then each header knob of the older writers on one batch,
and the DNA decode kernel's (K2's) step predicates against the static
segmentation.
"""
import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fqsqueezer_tpu import pipeline as jp
from fqsqueezer_tpu.ops import models as jmodels
from fqsqueezer_tpu.ops import rans as jrans
from fqsqueezer_tpu.params import DnaMode, IdMode, Params, QualityMode
from fqsqueezer_tpu.streams import dna as jdna
from fqsqueezer_tpu.streams import meta as jmeta
from fqsqueezer_tpu.streams import quality as jq
from fqsqueezer_tpu.utils.corpus import make_genome, sample_reads
from fqsqueezer_tpu_torch import params as tparams
from fqsqueezer_tpu_torch import pipeline
from fqsqueezer_tpu_torch.ops import kmers, rans, tables
from fqsqueezer_tpu_torch.state import state_from_numpy, state_to_numpy
from fqsqueezer_tpu_torch.streams import common, dna, meta, quality
from fqsqueezer_tpu_torch.utils.dna_batches import bench_dna_config

SB = 14
L = 44            # read width; the batch's columns are L8 = 48
R_WARM = 64       # reads of each warm-up batch
R_DEC = 16        # reads of the decoded batch: 2 read rows over 8 lanes


# --- rANS decode steps --------------------------------------------------------

def _cdf_rows(rng, n, A):
    """[n, A+1] cdf rows with 0 and 2^SB at the ends and zero-width steps
    (repeated boundaries) inside."""
    inner = np.sort(rng.integers(0, 1 << SB, (n, A - 1)), axis=1)
    dup = rng.random((n, A - 1)) < 0.3
    inner[:, 1:] = np.where(dup[:, 1:], inner[:, :-1], inner[:, 1:])
    inner[:, 0] = np.where(dup[:, 0], 0, inner[:, 0])
    return np.concatenate([np.zeros((n, 1), np.int64), inner,
                           np.full((n, 1), 1 << SB, np.int64)], axis=1)


@pytest.mark.parametrize("A", [2, 5, 8, 256])
def test_cdf_lookup_matches_reference(A):
    rng = np.random.default_rng(A)
    cdf = _cdf_rows(rng, 512, A)
    slots = rng.integers(0, 1 << SB, 512)
    slots[:64] = cdf[:64, rng.integers(1, A, 64)].diagonal()  # on a boundary
    got = rans.cdf_lookup(torch.from_numpy(cdf), torch.from_numpy(slots))
    want = jrans.cdf_lookup(jnp.asarray(cdf, jnp.int32),
                            jnp.asarray(slots, jnp.int32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        rans.rans_decode_slots(torch.from_numpy(slots + (77 << SB)), SB),
        jrans.rans_decode_slots(jnp.asarray(slots + (77 << SB), jnp.uint32),
                                SB))


@pytest.mark.parametrize("n_words", [3, 40, 4000])
def test_decode_advance_matches_reference(n_words):
    """Ten steps of 256 lanes: masked lanes, lanes whose state sits below
    2^16 + a few (they consume even when masked), and a stream that runs
    out (the reads past its end clamp to its last word)."""
    rng = np.random.default_rng(n_words)
    N = 256
    words = rng.integers(0, 1 << 16, n_words)
    x = rng.integers(1 << 16, 1 << 32, N)
    x[:16] = (1 << 16) + rng.integers(0, 4, 16)
    xt, pt = torch.from_numpy(x), torch.zeros((), dtype=torch.int64)
    xj, pj = jnp.asarray(x, jnp.uint32), jnp.int32(0)
    wt, wj = torch.from_numpy(words), jnp.asarray(words, jnp.uint32)
    for step in range(10):
        cdf = _cdf_rows(rng, N, 5)
        sym, f, c = rans.cdf_lookup(torch.from_numpy(cdf),
                                    rans.rans_decode_slots(xt, SB))
        masked = torch.from_numpy(rng.random(N) < 0.2)
        f = torch.where(masked, 1 << SB, f)
        c = torch.where(masked, 0, c)
        xt, pt = rans.rans_decode_advance(xt, pt, wt, f, c, SB)
        xj, pj = jrans.rans_decode_advance(
            xj, pj, wj, jnp.asarray(f.numpy(), jnp.int32),
            jnp.asarray(c.numpy(), jnp.int32), SB)
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        assert int(pt) == int(pj)
    assert int(pt) > n_words or n_words == 4000


def test_encoded_grid_decodes_back():
    """A grid encoded by the port's rans_encode decodes back to its
    symbols through the decode steps."""
    rng = np.random.default_rng(3)
    T, N = 60, 32
    cdf = _cdf_rows(rng, T * N, 6).reshape(T, N, 7)
    width = np.diff(cdf, axis=-1)
    syms = np.argmax(rng.random((T, N, 6)) * (width > 0), axis=-1)
    f = np.take_along_axis(width, syms[..., None], -1)[..., 0]
    c = np.take_along_axis(cdf, syms[..., None], -1)[..., 0]
    words, n, x = rans.rans_encode(torch.from_numpy(f.astype(np.int32)),
                                   torch.from_numpy(c.astype(np.int32)), SB)
    ptr = torch.zeros((), dtype=torch.int64)
    for t in range(T):
        s, ft, ct = rans.cdf_lookup(torch.from_numpy(cdf[t]),
                                    rans.rans_decode_slots(x, SB))
        np.testing.assert_array_equal(s.numpy(), syms[t])
        x, ptr = rans.rans_decode_advance(x, ptr, words, ft, ct, SB)
    assert int(ptr) == int(n)
    assert (x == rans.RANS_L).all()


# --- one batch of each stream decoder ------------------------------------------

def tiny_params():
    p = Params()
    p.genome_size = 1
    p.adjust_kmer_sizes()
    p.n_lanes = 8
    p.max_batch_reads = 64
    p.smer_log2_buckets = 12
    p.bmer_log2_buckets = 12
    p.dna_siv_cap = 12
    p.dna_mode = DnaMode.SE_ORIGINAL
    p.quality_mode = QualityMode.ILLUMINA_8
    p.id_mode = IdMode.NONE
    return p


def _reads(seed, n):
    genome = make_genome(3000, seed)
    codes, quals = sample_reads(genome, n, L, seed + 1, err_rate=0.01,
                                n_rate=0.005)
    rng = np.random.default_rng(seed + 2)
    lengths = np.where(rng.random(n) < 0.3, rng.integers(1, L, n),
                       L).astype(np.int32)
    tail = np.arange(L)[None, :] >= lengths[:, None]
    return (np.where(tail, 0, codes).astype(np.uint8),
            np.where(tail, 0, quals).astype(np.uint8), lengths)


def _planes(codes, quals, lengths, qfwd):
    """[R, L8] codes and quality symbols with the tails zeroed, as the
    pipeline feeds them."""
    tail = np.arange(L)[None, :] >= lengths[:, None]
    pad = ((0, 0), (0, 48 - L))
    codes = np.pad(np.where(tail, 0, codes), pad).astype(np.int64)
    qsyms = np.pad(np.where(tail, 0, qfwd[np.minimum(quals, 95)]), pad)
    return codes, qsyms.astype(np.int64), lengths.astype(np.int64)


def _jax_np(s):
    s = jax.device_get(s)
    return {"siv": s.dna.siv, "s_tc": s.dna.s_tc, "b_tc": s.dna.b_tc,
            "model": s.dna.model, "meta": s.meta, "qual": s.qual}


@pytest.fixture(scope="module")
def decoded():
    # the reference's decode scans unroll DECODE_UNROLL steps a loop trip,
    # a speed knob with no effect on values; one step compiles in half the
    # time
    unroll, jdna.DECODE_UNROLL = jdna.DECODE_UNROLL, 1
    try:
        yield _decode_one_batch()
    finally:
        jdna.DECODE_UNROLL = unroll


def _decode_one_batch():
    p = tiny_params()
    jcfgs = jp.make_configs(p)
    tcfgs = pipeline.make_configs(tparams.Params.load_params(
        p.store_params()))
    dcfg, qcfg, mcfg, _ = jcfgs
    qfwd = jq.qual_maps(qcfg.mode, qcfg.qt)[0]
    js = jp.state_create(dcfg, qcfg)
    codes, quals, lengths = _reads(21, 2 * R_WARM + R_DEC)
    for k in range(2):
        sl = slice(k * R_WARM, (k + 1) * R_WARM)
        kp, nm, qp, _ = jp._pack_inputs(codes[sl], quals[sl], qcfg, qfwd)
        _, js = jp._model_batch(dcfg, qcfg, mcfg, None, js, kp, nm, qp,
                                jnp.asarray(lengths[sl]), ())
    start = _jax_np(js)

    sl = slice(2 * R_WARM, None)
    lens = lengths[sl].copy()
    lens[[0, 5, 11]] = (0, 1, 0)             # empty reads, as padding is
    c8, q8, l8 = _planes(codes[sl], quals[sl], lens, qfwd)
    ts = state_from_numpy(start)
    grids, enc_state = pipeline._model_batch(
        *tcfgs, ts, torch.from_numpy(c8), torch.from_numpy(q8),
        torch.from_numpy(l8))
    streams = []
    for (f, c), cap in zip(grids, (2 * R_DEC, R_DEC * 48, R_DEC * 48)):
        words, n, x = rans.rans_encode(f, c, SB)
        w = np.zeros(cap, np.int64)
        w[:int(n)] = words.numpy()
        streams.append((w, x.numpy()))

    def jw(k):
        return (jnp.asarray(streams[k][0], jnp.uint32),
                jnp.asarray(streams[k][1], jnp.uint32))

    def tw(k):
        return (torch.from_numpy(streams[k][0]),
                torch.from_numpy(streams[k][1]))

    out = {"codes": c8, "qsyms": q8, "lengths": l8,
           "enc_state": state_to_numpy(enc_state), "tcfgs": tcfgs}
    out["jmeta"] = jax.device_get(jmeta.meta_decode_batch(
        mcfg, jnp.asarray(start["meta"]), R_DEC, *jw(0)))
    out["tmeta"] = meta.meta_decode_batch(tcfgs[2], ts.meta, R_DEC, *tw(0))
    out["meta_in"] = (np.array(start["meta"]), *streams[0])
    jlen = jnp.asarray(out["jmeta"][0], jnp.int32)
    tlen = out["tmeta"][0]
    jcodes, jstate, jx, jptr, jextras = jdna.dna_decode_batch(
        dcfg, js.dna, jlen, *jw(1), 48)
    out["jdna"] = jax.device_get((jcodes, jx, jptr, jextras[:3]))
    out["jdna_state"] = jax.device_get(jstate)
    out["tdna"] = dna.dna_decode_batch(tcfgs[0], ts.dna, tlen, *tw(1), 48)
    out["jqual"] = jax.device_get(jq.qual_decode_batch(
        qcfg, js.qual, jlen, *jw(2), 48))
    out["tqual"] = quality.qual_decode_batch(tcfgs[1], ts.qual, tlen,
                                             *tw(2), 48)
    out["tqual_scan"] = quality.qual_decode_scan_plain(
        tcfgs[1], ts.qual, tlen.to(torch.int32), tw(2)[0].to(torch.int32),
        tw(2)[1], 48, with_ctx=True)
    return out


def test_meta_decode_batch(decoded):
    jl, _, jmodel, jx, jptr = decoded["jmeta"]
    tl, tlcp, tmodel, tx, tptr = decoded["tmeta"]
    assert not tlcp.any()                     # original order: no LCP
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tl.numpy(), decoded["lengths"])
    np.testing.assert_array_equal(tmodel.numpy(), jmodel)
    np.testing.assert_array_equal(tmodel.numpy(),
                                  decoded["enc_state"]["meta"])
    np.testing.assert_array_equal(tx.numpy(), jx)
    assert int(tptr) == int(jptr)


def test_k5_staged_inputs_and_plain_scan_equal_the_reference(decoded):
    """K5's table is the reference's cdf of each meta slot's context
    (model_cdf of contexts 0..W-1); the plain scan (meta_decode_scan_plain)
    gives the reference decoder's length bytes, states and words consumed,
    and so does the kernel's arithmetic emulated lane by lane on the staged
    table."""
    from test_torch_ids import slot_scan_emulated

    cfg = decoded["tcfgs"][2]
    model, w, st = decoded["meta_in"]
    table = meta.meta_cdfs(cfg, torch.from_numpy(model))
    want = jax.jit(jmodels.model_cdf, static_argnums=2)(
        jnp.asarray(model), jnp.arange(2), SB)
    assert table.dtype == torch.int32 and cfg.n_per_read == 2
    np.testing.assert_array_equal(table.numpy(), np.asarray(want))
    jl, _, _, jx, jptr = decoded["jmeta"]
    syms, x, ptr = meta.meta_decode_scan_plain(
        cfg, table, R_DEC, torch.from_numpy(w).to(torch.int32),
        torch.from_numpy(st))
    assert syms.dtype == torch.uint8 and tuple(syms.shape) == (R_DEC, 2)
    jl = np.asarray(jl).astype(np.int64)
    np.testing.assert_array_equal(syms.numpy(),
                                  np.stack([jl & 0xFF, jl >> 8], axis=1))
    np.testing.assert_array_equal(x.numpy(), jx)
    assert int(ptr) == int(jptr)
    emu = slot_scan_emulated(table.numpy(), None, 2, cfg.n_lanes, R_DEC, w,
                             st, SB, R_DEC, 0, rule_ids=False)
    np.testing.assert_array_equal(emu[0], syms.numpy())
    np.testing.assert_array_equal(emu[1], jx)
    assert emu[2] == int(jptr)


@pytest.mark.parametrize("with_lcp,short", [(True, False), (False, True)])
def test_k5_emulated_equals_plain_scan_on_encoded_batches(with_lcp, short):
    """utils/id_batches' encoded meta batches, with the LCP's third slot and
    with the words cut short (the reads past the end clamp): the kernel's
    arithmetic emulated on the staged table equals the plain scan, which
    decodes the encoded symbols where the words suffice."""
    from test_torch_ids import slot_scan_emulated

    from fqsqueezer_tpu_torch.utils.id_batches import meta_scan_inputs

    cfg, table, R, words, init = meta_scan_inputs(7 + short, 8, 3, with_lcp,
                                                  short=short)
    W = cfg.n_per_read
    syms, x, ptr = meta.meta_decode_scan_plain(cfg, table, R, words, init)
    emu = slot_scan_emulated(table.numpy(), None, W, 8, R, words.numpy(),
                             init.numpy(), SB, R, 0, rule_ids=False)
    np.testing.assert_array_equal(emu[0], syms.numpy())
    np.testing.assert_array_equal(emu[1], x.numpy())
    assert emu[2] == int(ptr)
    assert syms.shape[1] == (3 if with_lcp else 2)


def test_check_k5_refuses_bad_shapes_before_any_build(decoded, monkeypatch):
    """K5's wrapper checks every argument before it builds or launches
    (on CPU tensors, which reach the wrapper only here); good ones get as
    far as the build. On CPU tensors meta_decode_batch runs the plain scan
    and never reaches the build; a device that is neither the CPU nor
    CUDA is refused."""
    import dataclasses

    from fqsqueezer_tpu_torch.ops import _build

    def refuse():
        raise AssertionError("the kernel build was reached")

    monkeypatch.setattr(_build, "kernels", refuse)
    cfg = decoded["tcfgs"][2]
    model, w, st = decoded["meta_in"]
    table = meta.meta_cdfs(cfg, torch.from_numpy(model))
    words = torch.from_numpy(w).to(torch.int32)
    init = torch.from_numpy(st)
    good = (cfg, table, R_DEC, words, init)

    def bad(k, v):
        a = list(good)
        a[k] = v
        return a

    before = meta.K5_LAUNCHES
    for args in (bad(2, R_DEC - 1),                        # R % N != 0
                 bad(0, dataclasses.replace(cfg, n_lanes=4096)),
                 bad(0, dataclasses.replace(cfg, scale_bits=17)),
                 bad(0, dataclasses.replace(cfg, with_lcp=True)),  # W
                 bad(3, words[:0]),                        # no words
                 bad(3, words.long()),                     # wrong dtype
                 bad(1, table.long()),
                 bad(1, table[:, :-1].contiguous()),       # wrong shape
                 bad(4, init[:-1])):
        with pytest.raises(ValueError):
            meta._meta_decode_scan_cuda(*args)
    with pytest.raises(AssertionError, match="build was reached"):
        meta._meta_decode_scan_cuda(*good)
    got = meta.meta_decode_batch(cfg, torch.from_numpy(model), R_DEC,
                                 torch.from_numpy(w), init)
    for g, want in zip(got, decoded["tmeta"]):
        assert torch.equal(g, want)
    assert meta.K5_LAUNCHES == before
    with pytest.raises(ValueError, match="no scan for device meta"):
        meta.meta_decode_scan(cfg, table.to("meta"), R_DEC,
                              words.to("meta"), init.to("meta"))


def test_dna_decode_symbols(decoded):
    jcodes, jx, jptr, jextras = decoded["jdna"]
    tcodes, _, tx, tptr, textras = decoded["tdna"]
    np.testing.assert_array_equal(tcodes.numpy(), jcodes)
    np.testing.assert_array_equal(tcodes.numpy(), decoded["codes"])
    for g, w in zip(textras[:3], jextras):      # eff, ctx_all, sym
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(tx.numpy(), jx)
    assert int(tptr) == int(jptr)


@pytest.mark.parametrize("key", ["siv", "s_tc", "b_tc", "model"])
def test_dna_decode_state(decoded, key):
    got = state_to_numpy(pipeline.CodecState(
        dna=decoded["tdna"][1], meta=None, qual=None))[key]
    np.testing.assert_array_equal(got,
                                  getattr(decoded["jdna_state"], key))
    np.testing.assert_array_equal(got, decoded["enc_state"][key])


def test_qual_decode_batch(decoded):
    jq_, jmodel, jx, jptr = decoded["jqual"]
    tq, tmodel, tx, tptr = decoded["tqual"]
    np.testing.assert_array_equal(tq.numpy(), jq_)
    active = np.arange(48)[None, :] < decoded["lengths"][:, None]
    np.testing.assert_array_equal(tq.numpy(),
                                  np.where(active, decoded["qsyms"], 0))
    np.testing.assert_array_equal(tmodel.numpy(), jmodel)
    np.testing.assert_array_equal(tmodel.numpy(),
                                  decoded["enc_state"]["qual"])
    np.testing.assert_array_equal(tx.numpy(), jx)
    assert int(tptr) == int(jptr)


def test_qual_ctx_plane_equals_the_scans_contexts(decoded):
    """qual_decode_batch updates the model from qual_ctx_plane of the
    decoded symbols instead of the scan's own contexts (kernel K3 writes
    none): the two agree at every position, masked ones included."""
    syms, x, ptr, ctx = decoded["tqual_scan"]
    cfg = decoded["tcfgs"][1]
    np.testing.assert_array_equal(
        quality.qual_ctx_plane(cfg, syms.to(torch.int64)).numpy(),
        ctx.numpy())
    np.testing.assert_array_equal(syms.numpy(),
                                  decoded["tqual"][0].numpy())


def _one_row(cfg, seed):
    """(cfg's fresh state, codes [8, 40], lengths [8]): one read row of 8
    lanes, reads of a 200-base genome, lengths 30 to 40."""
    from fqsqueezer_tpu_torch.utils import dna_batches

    rng = np.random.default_rng(seed)
    codes, lengths = dna_batches._reads(rng, make_genome(200, seed), 8, 40,
                                        seed)
    lengths = np.minimum(lengths, rng.integers(30, 41, 8))
    codes = np.where(np.arange(40)[None, :] < lengths[:, None], codes, 0)
    return (dna.dna_state_create(cfg), torch.from_numpy(codes),
            torch.from_numpy(lengths).to(torch.int64))


def test_decode_scans_refuse_what_is_not_ported():
    """What the decode scans lack raises NotImplementedError: an LCP
    stride no writer stores. What they once refused decodes: the quality
    scan with deltas (an empty batch); one read row of row-global
    context-keyed tables (dna_canon 0, dna_row_global 1), whose plain
    decode returns the row and leaves the tables the encoder's row loop
    left; and one rowB-like row under the paired-end position map
    (dna_pe_pos_ctx: positions counted back from 37, no end bucket),
    encoded through dna_process_batch_rg's pos_map and decoded through
    the row's PosMap."""
    cfg = quality.QualConfig(with_local=True, n_lanes=8)
    syms, _, ptr = quality.qual_decode_scan(
        cfg, torch.zeros((cfg.n_ctx, 8), dtype=torch.int32),
        torch.zeros(8, dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
        rans.rans_initial_states(8), 8)
    assert tuple(syms.shape) == (8, 8) and int(ptr) == 0
    # no writer stores an LCP stride but 1 (single-end) and 2 (paired-end)
    with pytest.raises(NotImplementedError, match="stride 3"):
        dna.dna_decode_batch(bench_dna_config(8), None, torch.zeros(8),
                             None, None, 8, lcp=torch.zeros(8), lcp_stride=3)
    small = dataclasses.replace(bench_dna_config(8), siv_len=8, prefix_len=5,
                                smer_log2_buckets=9, bmer_log2_buckets=9)
    canon0 = dataclasses.replace(small, canon=False, sb_proto=0, rough=0,
                                 claim_rounds=0)
    pe_pos = dataclasses.replace(small, pe_log2_buckets=10, pe_pos_ctx=True)
    no_end = torch.full((8,), dna._PE_NO_END, dtype=torch.int64)
    for cfg, pos in ((canon0, None),
                     (pe_pos, dna.PosMap(2, torch.full((8,), 37), no_end,
                                         -1))):
        state, c, n = _one_row(cfg, 7)
        pos_map = None if pos is None else (
            pos.off, torch.full((8,), pos.sign), pos.plen)
        (_, _, _, f, cum, _, s_tc, b_tc) = dna.dna_process_batch(
            cfg, state, c, torch.where(c >= 4, 0, c), n, pos_map=pos_map)
        words, n_words, init = rans.rans_encode(
            common.lane_grid(f, 8).to(torch.int32),
            common.lane_grid(cum, 8).to(torch.int32), cfg.scale_bits)
        (base, *_), _, ptr, _, s_got, b_got = dna.dna_decode_row_plain(
            cfg, state, n, words.to(torch.int32), init,
            torch.zeros((), dtype=torch.int64),
            torch.zeros((dna.K2_NREGS, 8), dtype=torch.int64), 40, pos=pos)
        assert torch.equal(base, c) and int(ptr) == int(n_words)
        assert torch.equal(s_got, s_tc) and torch.equal(b_got, b_tc)
        assert not torch.equal(s_tc, state.s_tc)


def _jax_state(state):
    """A port DnaState (SIV, tables, model) as the reference's arrays."""
    return jdna.DnaState(*(jnp.asarray(t.numpy().astype(
        np.int32 if t.dtype == torch.int32 else np.uint32))
        for t in state[:4]))


_KNOBS = [("ctx_v", 1, "dna_ctx_v=1"), ("rough", 0, "dna_rough=0"),
          ("let_pb2", 0, "dna_let_pb2=0"), ("mix_w", 0, "dna_mix_w=0"),
          ("prefix_ramp", False, "dna_prefix_ramp=0"),
          ("pmer_gate", 20, "dna_pmer_gate=20"),
          ("repair_iters", 3, "dna_repair_iters=3"),
          ("local_log2_cells", 9, "local_log2_cells=9"),
          ("local_model_inc", 8, "local_model_inc=8")]
# sha256 of the reference's modeling outputs of each knob's batch
# (_knob_digest; test_header_knob_digests_match_the_reference recomputes
# them): the reference's eager modeling takes 10-15 s a knob on one core
KNOB_SHA256 = {
    "dna_ctx_v=1":
        "0be9d7271d6e74c2cb4ea8b8cc3f243b81dae647e51caa0e6a641441e94f31fe",
    "dna_rough=0":
        "fde88676aa1d05d38f4c025dd13b90c1df84af1479acc0aa39f2b15732760747",
    "dna_let_pb2=0":
        "e30be9d1e200e53a26b49dcad76c605f96e4fdee3af30f0367bf92c3925d3ed5",
    "dna_mix_w=0":
        "93d83e4acf4ed747a7d63ecda3644de7937b342acb9a436a2a315b2fae9a136b",
    "dna_prefix_ramp=0":
        "e55ba6ac5aed2440eaef85f5f869c5ab74db2329b158a6998fd18d6680641864",
    "dna_pmer_gate=20":
        "6247dc4c8d3fc4ed3de8f6ee15124ea65435c61b528c34076efa598ce194c2cf",
    "dna_repair_iters=3":
        "b35e4cec22841220d154d41ff622ec9b09413c65f4249b104146a010cbe2b5ef",
    "local_log2_cells=9":
        "f7e27e1d2ddac2f955669a6bd6f9ba8c69eefb4dc1006dbe3f76e6901e639ae4",
    "local_model_inc=8":
        "3af73d5c5d91f0e46130e5ae1d45b9430bad4526276644a271afee9447277978",
}


def _knob_batch(knob, value, named):
    """(cfg, the warmed state, codes, lengths) of a knob's batch: 16 reads
    of 40 over 8 lanes, SIV 8 with ramp columns 5-6, 2^9-bucket tables
    warmed by two batches; the bench header with the knob set, against
    batch-frozen tables (the batch-frozen pass compiles no scan in the
    reference) except for the rough knob, the row-global pass's. The
    local knobs: 2^9-cell klocal_* tables beside the K2 cells (and with
    local_model_inc the DNA model's deltas too), on fresh tables and
    reads of a 160-base genome, so that the second read row finds the
    first's k-mers in them."""
    from fqsqueezer_tpu_torch.utils import dna_batches

    base = dataclasses.replace(
        bench_dna_config(8), siv_len=8, prefix_len=5, smer_log2_buckets=9,
        bmer_log2_buckets=9)
    if knob != "rough":
        base = dataclasses.replace(base, row_global=False, rough=0,
                                   local_log2_cells=0)
    cfg = dataclasses.replace(base, **{knob: value})
    if knob == "local_model_inc":
        cfg = dataclasses.replace(cfg, local_log2_cells=9)
    if knob == "ctx_v":
        cfg = dataclasses.replace(cfg, rough=0)
    rng = np.random.default_rng(len(named))
    genome, state, _ = dna_batches._warm(cfg, rng, 3, 16, 40, "cpu")
    if knob.startswith("local"):
        genome = make_genome(160, len(named))
        state = dna.dna_state_create(cfg)
    codes, lengths = dna_batches._reads(rng, genome, 16, 40, 7)
    return cfg, state, torch.from_numpy(codes), torch.from_numpy(lengths)


def _knob_digest(outs):
    h = hashlib.sha256()
    for a in outs:
        h.update(np.ascontiguousarray(np.asarray(a).astype(np.int64)))
    return h.hexdigest()


@pytest.mark.parametrize("knob,value,named", _KNOBS)
def test_check_supported_refuses_untested_header_knobs(knob, value, named):
    """Each header knob that the older writers set (once refused, now
    ported) holds its branch against the reference on one batch
    (_knob_batch): the batch's modeling —
    repair, the cascade, the contexts, the cdf (f, c), the tables the
    row-global pass carried — equals the reference's (dna_modeling against
    batch-frozen tables; for the rough knob dna_process_batch_rg), by the
    sha256 of its outputs (KNOB_SHA256); and the port's decode of its own
    encode of the batch (the plain scan, K2's plain version) returns the
    batch, its repaired kcodes, and its contexts and symbols at every
    coded position."""
    cfg, state, c, n = _knob_batch(knob, value, named)
    got = dna.dna_process_batch(cfg, state, c, torch.where(c >= 4, 0, c), n)
    assert _knob_digest(got) == KNOB_SHA256[named]
    words, _, init = rans.rans_encode(
        common.lane_grid(got[3], 8).to(torch.int32),
        common.lane_grid(got[4], 8).to(torch.int32), cfg.scale_bits)
    dec, _, _, _, extras = dna.dna_decode_batch(cfg, state, n, words, init,
                                                40)
    assert torch.equal(dec, c) and torch.equal(extras[0], got[0])
    for g, w in zip(extras[1:3], got[1:3]):
        assert torch.equal(torch.where(got[5], g, 0), torch.where(got[5], w,
                                                                  0))


@pytest.mark.slow
@pytest.mark.parametrize("knob,value,named", _KNOBS)
def test_header_knob_digests_match_the_reference(knob, value, named):
    """KNOB_SHA256 is the reference's: its modeling of each knob's batch
    on the same state (the repair too, for the repair knob)."""
    cfg, state, c, n = _knob_batch(knob, value, named)
    jcfg = jdna.DnaConfig(**dataclasses.asdict(cfg))
    jc = jnp.asarray(c.numpy().astype(np.int32))
    jn = jnp.asarray(n.numpy().astype(np.int32))
    jk = jnp.where(jc >= 4, 0, jc)
    jstate = _jax_state(state)
    if knob == "rough":
        want = jdna.dna_process_batch_rg(jcfg, jstate, jc, jk, jn)
    else:
        jeff = jdna.dna_effective_kcodes(jcfg, jstate, jc, jk, jn)
        want = (jeff,) + tuple(jdna.dna_modeling(jcfg, jstate, jc, jeff, jn)
                               ) + (jstate.s_tc, jstate.b_tc)
    got = dna.dna_process_batch(cfg, state, c, torch.where(c >= 4, 0, c), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            np.int64))
    print(named, _knob_digest(want))
    assert _knob_digest(want) == KNOB_SHA256[named]


@pytest.mark.parametrize("prefix_len,siv_len,smer_len", [
    (10, 14, 18),     # the bench header: ramp 10..12 before the s window
    (9, 12, 11),      # the s window inside the ramp
    (12, 16, 13),     # the s window at the ramp's first column
    (0, 5, 3),        # a ramp from position 0
    (14, 13, 22)])    # no ramp column
def test_k2_step_predicates_equal_the_static_segmentation(prefix_len,
                                                          siv_len, smer_len):
    """Kernel K2 decides each position's ramp column and rough rescue from
    predicates on i; they equal the reference's static segmentation
    (_decode_segments) at every read width up to 40."""
    cfg = dataclasses.replace(bench_dna_config(), prefix_len=prefix_len,
                              siv_len=siv_len, smer_len=smer_len)

    # the predicates of csrc/dna_decode.cu's step: the ramp at
    # `i >= prefix_len && i < siv_len - 1`, the rough rescue at `i >= s_w`
    # (s_w = smer_len - 1); the header's ramp and rough are on
    def kind(i):
        ramp = prefix_len <= i < siv_len - 1
        return i, (i if ramp else None), i >= smer_len - 1

    assert cfg.prefix_ramp and cfg.rough
    for width in range(41):
        assert ([kind(i) for i in range(width)]
                == dna._decode_segments(cfg, width))


def _k2_step_events(kc, length, k, log2_base, log2_rows, S, R):
    """csrc/dna_decode.cu's insert events restated in torch: the registers
    S (the k-1 bases before i, masked) and R (its reverse complement) roll
    with each position's kc from whatever they carried in; at
    k - 1 <= i < length the event is the find's canonical query of (S, R)
    with kc as its candidate. Returns [N, L] (valid, bucket row, tag word,
    rotation j)."""
    N, width = kc.shape
    w = k - 1
    m2 = (1 << 2 * (k - 2)) - 1
    out = []
    for i in range(width):
        b = kc[:, i]
        wv, rw = S & m2, (R >> 2) & m2
        s = rw < wv
        mid = torch.where(s, rw, wv)
        mlo, mhi = mid & 0xFFFFFFFF, mid >> 32
        mt = kmers.hash_tag(mlo, mhi) & ~0xF
        row = kmers.hash_bucket(mlo, mhi, log2_base)
        if log2_rows > log2_base:
            row = row | (((mt >> 23) & ((1 << (log2_rows - log2_base)) - 1))
                         << log2_base)
        c0 = (S >> 2 * (k - 2)) & 3
        slot = torch.where(s, 4 * (3 - b) + (3 - c0), 4 * c0 + b)
        tw = ((((mt >> 23) & 0xF) << 4 | ((mt >> 4) & 0x7FFF) << 8
               | 1 << 23) << 8) | slot << 8
        j = ((tw >> 25) ^ (tw >> 8)) & 3
        out.append(((i >= w) & (i < length), row, tw, j))
        S = ((S << 2) | b) & ((1 << 2 * w) - 1)
        R = (R >> 2) | ((3 - b) << 2 * (w - 1))
    return tuple(torch.stack(t, dim=1) for t in zip(*out))


@pytest.mark.parametrize("grow", [0, 2])
def test_k2_row_events_equal_sb_canon_events(grow):
    """Kernel K2 takes the row's s/b insert events from the registers it
    rolls (carried across rows) and the find's query; they equal
    sb_canon_events of the row's kc plane — bucket row (with the growth bits
    of a grown table), cell tag word and slot rotation — at every width
    20-40, for the bench geometry."""
    cfg = bench_dna_config(6)
    rng = np.random.default_rng(grow)
    for width in range(20, 41):
        kc = torch.from_numpy(rng.integers(0, 4, (6, width)))
        length = torch.tensor([0, 1, width, width - 1, 19, width // 2])
        pos = torch.arange(width)[None, :]
        for k, log2b in ((cfg.smer_len, cfg.smer_log2_buckets),
                         (cfg.bmer_len, cfg.bmer_log2_buckets)):
            carried = torch.from_numpy(rng.integers(0, 1 << 2 * (k - 1),
                                                    (2, 6)))
            valid, row, tw, j = _k2_step_events(kc, length, k, log2b,
                                                log2b + grow, *carried)
            bkt, tag, vk = dna.sb_canon_events(cfg, kc, pos < length[:, None],
                                               k, log2b)
            c0 = k - 1
            assert torch.equal(valid[:, c0:].reshape(-1), vk)
            assert torch.equal(row[:, c0:].reshape(-1)[vk],
                               tables.kbucket_of(tag, bkt, log2b + grow,
                                                 log2b)[vk])
            assert torch.equal(tw[:, c0:].reshape(-1)[vk],
                               (tables.k2tag(tag) << 8)[vk])
            assert torch.equal(j[:, c0:].reshape(-1)[vk],
                               (((tag >> 13) ^ tag) & 3)[vk])
