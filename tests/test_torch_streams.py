"""The port's per-batch model step against fqsqueezer_tpu.pipeline._model_batch.

Both packages start from the same mid-stream state (carried across with
state_from_numpy) and model three consecutive batches; every batch's (freq,
cum) grids of every stream and every array of the new state must be equal
(tolerance 0: the codec is integer-only). The reference takes its inputs
through its own _pack_inputs; the port takes plain [R, L8] integer planes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fqsqueezer_tpu import pipeline as jp
from fqsqueezer_tpu.params import DnaMode, IdMode, Params, QualityMode
from fqsqueezer_tpu.streams import dna as jdna
from fqsqueezer_tpu.streams import quality as jq
from fqsqueezer_tpu.utils.corpus import make_genome, sample_reads
from fqsqueezer_tpu_torch import params as tparams
from fqsqueezer_tpu_torch import pipeline
from fqsqueezer_tpu_torch.ops import tables
from fqsqueezer_tpu_torch.state import state_from_numpy, state_to_numpy
from fqsqueezer_tpu_torch.streams import dna

R, L = 64, 44     # one full batch of the tiny geometry; L8 = 48


def tiny_params(siv_cap=8):
    """__graft_entry__._tiny_cfgs' geometry (8 lanes, 64-read batches, 2^12
    buckets, SIV cap 8) on the main path's modes: SE original order,
    Illumina-8 quality, no ids."""
    p = Params()
    p.genome_size = 1
    p.adjust_kmer_sizes()
    p.n_lanes = 8
    p.max_batch_reads = 64
    p.smer_log2_buckets = 12
    p.bmer_log2_buckets = 12
    p.dna_siv_cap = siv_cap
    p.dna_mode = DnaMode.SE_ORIGINAL
    p.quality_mode = QualityMode.ILLUMINA_8
    p.id_mode = IdMode.NONE
    return p


def port_params(p):
    """The port's own Params for the reference Params p: the archive header
    of one loads into the other."""
    return tparams.Params.load_params(p.store_params())


def _batches(seed, n=4):
    """Reads sampled from a small genome (so the tables hit), with ragged
    lengths, N's and zeroed tails like the FASTQ parser leaves them."""
    genome = make_genome(3000, seed)
    codes, quals = sample_reads(genome, n * R, L, seed + 1, err_rate=0.01,
                                n_rate=0.005)
    rng = np.random.default_rng(seed + 2)
    lengths = np.where(rng.random(n * R) < 0.2,
                       rng.integers(20, L, n * R), L).astype(np.int32)
    tail = np.arange(L)[None, :] >= lengths[:, None]
    codes = np.where(tail, 0, codes).astype(np.uint8)
    quals = np.where(tail, 0, quals).astype(np.uint8)
    return [(codes[i * R:(i + 1) * R], quals[i * R:(i + 1) * R],
             lengths[i * R:(i + 1) * R]) for i in range(n)]


def _jax_np(s):
    s = jax.device_get(s)
    return {"siv": s.dna.siv, "s_tc": s.dna.s_tc, "b_tc": s.dna.b_tc,
            "model": s.dna.model, "meta": s.meta, "qual": s.qual}


def _jax_step(cfgs, state, batch, qfwd):
    dcfg, qcfg, mcfg, _ = cfgs
    codes, quals, lengths = batch
    kp, nm, qp, _ = jp._pack_inputs(codes, quals, qcfg, qfwd)
    return jp._model_batch(dcfg, qcfg, mcfg, None, state, kp, nm, qp,
                           jnp.asarray(lengths), ())


def _port_step(cfgs, state, batch, qfwd):
    codes, quals, lengths = batch
    L8 = -(-codes.shape[1] // 8) * 8
    pad = ((0, 0), (0, L8 - codes.shape[1]))
    t = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    return pipeline._model_batch(
        *cfgs, state, t(np.pad(codes, pad)),
        t(qfwd[np.minimum(np.pad(quals, pad), 95)]), t(lengths))


@pytest.fixture(scope="module", params=[8, 12], ids=["tiny", "ramp"])
def runs(request):
    """Both packages over batches 1..3 from the state the reference reaches
    after batch 0. SIV cap 12 puts read positions 9 and 10 on the prefix
    ramp (prefix_len 9 < siv_len - 2)."""
    p = tiny_params(request.param)
    jcfgs = jp.make_configs(p)
    tcfgs = pipeline.make_configs(port_params(p))
    assert jcfgs[3] is None
    qfwd = jq.qual_maps(jcfgs[1].mode, jcfgs[1].qt)[0]
    batches = _batches(request.param)
    _, js = _jax_step(jcfgs, jp.state_create(*jcfgs[:2]), batches[0], qfwd)
    start = _jax_np(js)
    ts = state_from_numpy(start)
    out = []
    for b in batches[1:]:
        jgrids, js = _jax_step(jcfgs, js, b, qfwd)
        jgrids, jstate = jax.device_get(jgrids), _jax_np(js)
        tgrids, ts = _port_step(tcfgs, ts, b, qfwd)
        out.append((jgrids, jstate, tgrids, state_to_numpy(ts)))
    return p, start, out


@pytest.mark.parametrize("k", [0, 1, 2])
def test_model_batch_grids(runs, k):
    jgrids, _, tgrids, _ = runs[2][k]
    assert len(jgrids) == len(tgrids) == 3        # meta, dna, qual
    for (jf, jc), (tf, tc) in zip(jgrids, tgrids):
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_model_batch_state(runs, k):
    _, jstate, _, tstate = runs[2][k]
    for key, want in jstate.items():
        np.testing.assert_array_equal(tstate[key], np.asarray(want),
                                      err_msg=key)
        assert tstate[key].dtype == np.asarray(want).dtype


def test_state_round_trip(runs):
    _, start, _ = runs
    back = state_to_numpy(state_from_numpy(start))
    for key, want in start.items():
        np.testing.assert_array_equal(back[key], want)
    # the reached state has live tables and a filled SIV
    assert (start["s_tc"] != 0).any() and (start["siv"] != 0).any()


def test_lane_grids_match_reference():
    from fqsqueezer_tpu.streams import common as jc
    from fqsqueezer_tpu_torch.streams import common

    N, r_pl, Lw = 8, 3, 5
    x = np.random.default_rng(9).integers(0, 1 << 20, (N * r_pl, Lw, 2))
    t, j = torch.from_numpy(x), jnp.asarray(x, jnp.int32)
    grid = common.to_grid(t[..., 0], N)
    np.testing.assert_array_equal(grid, jc.to_grid(j[..., 0], N))
    np.testing.assert_array_equal(common.from_grid(grid, N, Lw), x[..., 0])
    np.testing.assert_array_equal(common.to_read_grid(t[:, 0, 0], N),
                                  jc.to_read_grid(j[:, 0, 0], N))
    blocks = common.to_row_blocks(t, N)
    np.testing.assert_array_equal(blocks, jc.to_row_blocks(j, N))
    np.testing.assert_array_equal(common.from_row_blocks(blocks), x)
    assert [common.pad_reads(n, N) for n in (0, 1, 8, 9)] == \
        [jc.pad_reads(n, N) for n in (0, 1, 8, 9)]


@pytest.mark.parametrize("mode", ["lossless", "illumina_8", "illumina_4",
                                  "binary"])
def test_quality_maps_and_contexts(mode):
    from fqsqueezer_tpu_torch.streams import quality

    for got, want in zip(quality.qual_maps(mode, 23), jq.qual_maps(mode, 23)):
        np.testing.assert_array_equal(got, want)
    tcfg, jcfg = quality.QualConfig(mode=mode), jq.QualConfig(mode=mode)
    assert (tcfg.n_sym, tcfg.n_ctx) == (jcfg.n_sym, jcfg.n_ctx)
    q = np.random.default_rng(10).integers(0, tcfg.n_sym, (16, 45))
    np.testing.assert_array_equal(
        quality.qual_ctx_plane(tcfg, torch.from_numpy(q)),
        jq.qual_ctx_plane(jcfg, jnp.asarray(q, jnp.int32)))


def test_quality_and_meta_modeling_match_reference():
    """Against a warm random model, so the cdfs are not flat."""
    from fqsqueezer_tpu.streams import meta as jmeta
    from fqsqueezer_tpu_torch.streams import meta, quality

    rng = np.random.default_rng(11)
    cfg = quality.QualConfig()
    model = rng.integers(0, 300, (cfg.n_ctx, cfg.n_sym)).astype(np.int32)
    q = rng.integers(0, cfg.n_sym, (16, 45))
    lens = rng.integers(1, 46, 16)
    got = quality.qual_modeling(cfg, torch.from_numpy(model),
                                torch.from_numpy(q), torch.from_numpy(lens))
    want = jq.qual_modeling(jq.QualConfig(), jnp.asarray(model),
                            jnp.asarray(q, jnp.int32), jnp.asarray(lens))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    mmodel = rng.integers(0, 300, (meta.N_CTX, meta.N_SYM)).astype(np.int32)
    mlens = rng.integers(0, 1 << 16, 16)
    got = meta.meta_modeling(meta.MetaConfig(), torch.from_numpy(mmodel),
                             torch.from_numpy(mlens))
    want = jmeta.meta_modeling(jmeta.MetaConfig(), jnp.asarray(mmodel),
                               jnp.asarray(mlens, jnp.int32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_dna_helpers_off_the_encode_path(runs):
    """_base_of_rank, _popcount4 and the static-prefix ramp read (all used
    by the decoder) agree with the reference too."""
    p, start, _ = runs
    dcfg = pipeline.make_configs(port_params(p))[0]
    jdcfg = jp.make_configs(p)[0]
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 4, (64, 4)) * rng.integers(0, 3, (64, 1))
    r = rng.integers(0, 5, 64)
    v = np.arange(16)
    np.testing.assert_array_equal(dna._popcount4(torch.from_numpy(v)),
                                  jdna._popcount4(jnp.asarray(v)))
    np.testing.assert_array_equal(
        dna._base_of_rank(torch.from_numpy(counts), torch.from_numpy(r)),
        jdna._base_of_rank(jnp.asarray(counts, jnp.int32), jnp.asarray(r)))
    siv = torch.from_numpy(start["siv"].astype(np.int64))
    for q in dna._ramp_cols(dcfg):
        kc = rng.integers(0, 4, (16, q))
        pfx = (kc * 4 ** np.arange(q - 1, -1, -1)).sum(axis=1)
        want = jdna._prefix_ramp_counts(jdcfg, jdna.tables.LOCAL,
                                        jnp.asarray(start["siv"]),
                                        jnp.asarray(kc, jnp.int32), q)
        np.testing.assert_array_equal(
            dna._prefix_ramp_counts(dcfg, tables.LOCAL, siv,
                                    torch.from_numpy(kc), q), want)
        np.testing.assert_array_equal(
            dna._prefix_ramp_counts_static(dcfg, tables.LOCAL, siv,
                                           torch.from_numpy(pfx), q), want)
