"""Mesh archives decoded on one device: the port against the reference.

The reference package writes an archive over a dp x tp mesh of devices
(fqsqueezer_tpu.parallel.mesh_pipeline.compress_file_mesh) and decodes it
on any number of devices with decompress_file_mesh_seq. The port decodes
such archives (fqsqueezer_tpu_torch.parallel.mesh_pipeline; its writer is
held to the same fixtures in tests/test_torch_mesh_write.py). The
reference's mesh writer is too slow for the fast tests (a minute and more
per archive on one CPU core), so the archives here are
committed fixtures it wrote (fqsqueezer_tpu_torch/testdata/mesh/, see its
README), with the sha256 of the reference decoder's output beside them
(SHA256SUMS). Each fast test decodes a fixture with the port on the CPU
and holds the output to that digest: no tolerance, every byte. The
function-level tests hold the pieces of the sequential decode to the
reference's functions on the same inputs: the batch collect's row-block
replay, a shard's decode against the frozen state (to the digests of the
reference's outputs: its decode compiles for half a minute), the
group-boundary maintenance and the id chains' lanes.

Under `slow`: the fixtures regenerated with the reference's mesh writer
(their bytes must equal the committed files) and every decode digest
recomputed with the reference's sequential decoder (chip_smoke.py's
[mesh] digests included), and the shard decode's digests with the
reference's dna_decode_batch.
"""
import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from fqsqueezer_tpu import params as jparams
from fqsqueezer_tpu_torch import checkpoint, cli
from fqsqueezer_tpu_torch import params as tparams
from fqsqueezer_tpu_torch import pipeline
from fqsqueezer_tpu_torch.parallel import mesh_pipeline
from fqsqueezer_tpu_torch.streams import dna, ids

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "fqsqueezer_tpu_torch", "testdata", "mesh")
# group budgets of the -gs 5 fixtures, so that each has two groups or more
GS5_GROUP_MEM = {"se": 1 << 20, "pe": 512 << 10}
SNAP_GROUP_MEM = 64 << 10     # a group a batch at the CPU geometry

# name -> the reference writer's inputs: (kind, corpus, dp, tp, flags of
# the geometry). kind "se" / "pe"; corpus (reads or pairs, read length,
# seed). "cpu" fixtures use mesh_params (small_params, 16 lanes), "gs5"
# ones the CLI's -gs 5 Params with 16 lanes and 2048-read (SE) or 256-read
# (PE) batches.
SPECS = {
    "se_dp4tp2": ("se", (192, 72, 13), 4, 2,
                  ("cpu", "o", "lossless", "lossless")),
    "pe_dp2tp1": ("pe", (96, 64, 17), 2, 1, ("cpu", "o", "none", "none")),
    "sorted_dp2tp1": ("se", (96, 72, 19), 2, 1,
                      ("cpu", "s", "illumina_8", "none")),
    "snap_dp2tp1": ("se", (128, 72, 29), 2, 1,
                    ("cpu", "o", "illumina_8", "lossless")),
    "gs5_se_dp4tp2": ("se", (3000, 100, 42), 4, 2,
                      ("gs5", "o", "illumina_8", "lossless")),
    "gs5_pe_dp2tp1": ("pe", (600, 100, 42), 2, 1,
                      ("gs5", "o", "none", "none")),
}
CPU_FIXTURES = [k for k, v in SPECS.items() if v[4][0] == "cpu"]


def mesh_params(mod, kind, order, qm, im, geometry="cpu"):
    """The Params a fixture was written with, from the params module of
    either package. cpu: tests.test_pipeline.small_params with 16 lanes,
    128-read batches, 2^12-bucket s/b tables and SIV cap 7 (so the group
    maintenance prunes); gs5: the CLI's -gs 5 geometry (2^22-bucket s/b
    tables, SIV cap 13) with 16 lanes, so that each shard decodes at least
    two read rows a batch, and 2048-read batches (SE) or 256 (PE: the
    reference's sequential decode unrolls a shard's rows, three a pair,
    and took more than 25 GB of host memory at 512)."""
    p = mod.Params()
    p.genome_size = 1 if geometry == "cpu" else 5
    p.adjust_kmer_sizes()
    p.dna_mode = {("se", "o"): mod.DnaMode.SE_ORIGINAL,
                  ("se", "s"): mod.DnaMode.SE_SORTED,
                  ("pe", "o"): mod.DnaMode.PE_ORIGINAL}[kind, order]
    p.quality_mode = mod.QualityMode(qm)
    p.id_mode = mod.IdMode(im)
    p.n_lanes = 16
    p.verbosity = 0
    if geometry == "cpu":
        p.max_batch_reads = 128
        p.local_log2_cells = 16
        p.smer_log2_buckets = p.bmer_log2_buckets = 12
        p.dna_siv_cap = 7
    else:
        p.max_batch_reads = 2048 if kind == "se" else 256
    return p


def write_corpus(name, d):
    """The fixture's input FASTQ file(s) in directory d: one path (SE) or
    two (PE). The CPU corpora are the reference tests' generators
    (tests.test_pipeline.make_fastq, tests.test_pe.make_pe_pair), the -gs 5
    ones the bench's (utils.corpus, 4.6 Mbp genome)."""
    kind, (n, L, seed), _, _, (geometry, *_) = SPECS[name]
    os.makedirs(d, exist_ok=True)
    if geometry == "gs5":
        from fqsqueezer_tpu_torch.utils import corpus

        if kind == "se":
            path = os.path.join(d, f"{name}.fastq")
            corpus.write_fastq_corpus(path, n, L, 4_600_000, seed=seed)
            return [path]
        paths = [os.path.join(d, f"{name}_{k}.fastq") for k in (1, 2)]
        corpus.write_pe_corpus(*paths, n, L, 4_600_000, seed=seed)
        return paths
    if kind == "se":
        from tests.test_pipeline import make_fastq

        path = os.path.join(d, f"{name}.fastq")
        make_fastq(path, n, L, seed=seed)
        return [path]
    import pathlib

    from tests.test_pe import make_pe_pair

    sub = pathlib.Path(d) / name
    sub.mkdir(exist_ok=True)
    return list(make_pe_pair(sub, n_pairs=n, read_len=L, seed=seed))


def write_fixture(name, d):
    """Write the fixture with the reference's mesh writer into directory d
    (archive, and for snap_dp2tp1 its group snapshots); returns the
    archive's path. Runs JAX on the CPU's 8 virtual devices
    (tests/conftest.py)."""
    from fqsqueezer_tpu.parallel import mesh_pipeline as jmesh

    kind, _, dp, tp, (geometry, order, qm, im) = SPECS[name]
    paths = write_corpus(name, d)
    p = mesh_params(jparams, kind, order, qm, im, geometry)
    arc = os.path.join(d, f"{name}.fqst")
    kw = {}
    if geometry == "gs5":
        kw["group_mem_bytes"] = GS5_GROUP_MEM[kind]
    if name == "snap_dp2tp1":
        kw.update(group_mem_bytes=SNAP_GROUP_MEM,
                  snapshot_prefix=os.path.join(d, name))
    data = None
    if kind == "pe":
        # compress_pe_mesh's interleave, with a group budget of our own
        from fqsqueezer_tpu import pipeline as jp
        from fqsqueezer_tpu.io import fastq as jfastq

        data = jp.interleave_pe(*(jfastq.read_fastq(f) for f in paths))
    jmesh.compress_file_mesh(p, paths[0], arc, dp=dp, tp=tp, data=data, **kw)
    return arc


def reference_decode(name, arc, d, start_group=0):
    """The reference's sequential decode of a fixture's archive (from
    group start_group, with the fixture's snapshot): the sha256 of each
    output file (mate 1, mate 2 for PE)."""
    from fqsqueezer_tpu import checkpoint as jck
    from fqsqueezer_tpu.parallel import mesh_pipeline as jmesh

    outs = [os.path.join(d, f"{name}.g{start_group}.jax_{k}.fastq")
            for k in (1, 2)][:1 + (SPECS[name][0] == "pe")]
    kw = {}
    if start_group:
        kw = dict(start_group=start_group, init_state=jck.load_state(
            snapshot(name, start_group, os.path.dirname(arc))))
    jmesh.decompress_file_mesh_seq(jparams.Params(), arc, *outs, **kw)
    return [_sha(o) for o in outs]


def snapshot(name, group, d=FIXTURES):
    return checkpoint.snapshot_path(os.path.join(d, name), group)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def fixture(name):
    return os.path.join(FIXTURES, f"{name}.fqst")


def _sums():
    """SHA256SUMS beside the fixtures: output file name -> sha256 of the
    reference's decode (NAME.fastq, NAME_1 / _2.fastq for PE; .g1 for the
    decode from the group-1 snapshot)."""
    out = {}
    with open(os.path.join(FIXTURES, "SHA256SUMS")) as f:
        for line in f:
            sha, name = line.split()
            out[name] = sha
    return out


def sum_names(name, start_group=0):
    tag = f"{name}.g{start_group}" if start_group else name
    if SPECS[name][0] == "pe":
        return [f"{tag}_1.fastq", f"{tag}_2.fastq"]
    return [f"{tag}.fastq"]


def _reads(path):
    from fqsqueezer_tpu_torch.io import fastq

    d = fastq.read_fastq(path)
    return [bytes(d.codes[i, :d.lengths[i]]) for i in range(d.n_reads)]


def test_mesh_archive_decodes_sequentially_on_one_device(tmp_path):
    """SE dp=4 tp=2 with lossless qualities and ids through `d` of the
    port's CLI, which routes a mesh header to the sequential mesh decode:
    the reference decoder's bytes, which are the input's."""
    out = str(tmp_path / "o.fastq")
    assert cli.main(["d", "--device", "cpu", "-v", "0", "-out", out,
                     fixture("se_dp4tp2")]) == 0
    assert [_sha(out)] == [_sums()[n] for n in sum_names("se_dp4tp2")]
    src = write_corpus("se_dp4tp2", str(tmp_path))[0]
    with open(src, "rb") as f, open(out, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("name", ["pe_dp2tp1", "sorted_dp2tp1"])
def test_mesh_archive_decodes_as_the_reference(tmp_path, name):
    """PE dp=2 with the anchors (the pe stream, 3 walked rows a pair) and
    no qualities, and SE sorted order (each shard's rows copy shared
    prefixes): the reference decoder's bytes; the bases are the input's
    (in sorted order, as a multiset)."""
    outs = [str(tmp_path / f"o_{k}.fastq") for k in (1, 2)][
        :len(sum_names(name))]
    st = mesh_pipeline.decompress_file_mesh(tparams.Params(), fixture(name),
                                            *outs, device="cpu")
    assert [_sha(o) for o in outs] == [_sums()[n] for n in sum_names(name)]
    srcs = write_corpus(name, str(tmp_path / "in"))
    for o, src in zip(outs, srcs):
        if SPECS[name][4][1] == "s":
            assert sorted(_reads(o)) == sorted(_reads(src))
        else:
            assert _reads(o) == _reads(src)
    assert st["n_reads"] == SPECS[name][1][0] * len(outs)


def test_mesh_snapshot_resume(tmp_path):
    """The mesh writer's group-1 snapshot (the assembled global state),
    loaded once, decodes the archive from group 1 twice: both tails are the
    reference's decode from that snapshot, which is the tail of its full
    decode, and the loaded state's tensors are unchanged afterwards."""
    state = checkpoint.load_state(snapshot("snap_dp2tp1", 1), device="cpu")
    before = [t.clone() for t in _tensors(state)]
    want = [_sums()[n] for n in sum_names("snap_dp2tp1", 1)]
    for rep in range(2):
        out = str(tmp_path / f"tail{rep}.fastq")
        st = mesh_pipeline.decompress_file_mesh(
            tparams.Params(), fixture("snap_dp2tp1"), out, start_group=1,
            init_state=state, device="cpu")
        assert [_sha(out)] == want
        assert 0 < st["n_reads"] < SPECS["snap_dp2tp1"][1][0]
    after = _tensors(state)
    assert all(torch.equal(a, b) for a, b in zip(after, before))


def _tensors(state):
    d = state.dna
    return [t for t in (d.siv, d.s_tc, d.b_tc, d.model, *(d.pe or ()),
                        state.meta, state.qual, state.id) if t is not None]


def test_legacy_mesh_pe_header_decodes_with_anchors_off():
    """The port's make_configs maps a mesh PE header written before
    dna_pe_mesh existed (no pe stream) to anchors off, as the reference's
    does; a header with the knob, and a single-device PE header without
    it, keep them on."""
    import json

    from fqsqueezer_tpu import pipeline as jp

    def configs(mod, pmod, mesh, knob):
        p = pmod.Params()
        p.dna_mode = pmod.DnaMode.PE_ORIGINAL
        p.mesh_dp, p.mesh_tp = mesh
        d = json.loads(p.store_params().decode())
        assert d["dna_pe_mesh"] == 1          # writers stamp the knob
        if not knob:
            del d["dna_pe_mesh"]
        q = pmod.Params.load_params(json.dumps(d).encode(),
                                    base=pmod.Params())
        return q.dna_pe_mesh, mod.make_configs(q)[0].pe_log2_buckets

    for mesh, knob, on in (((2, 1), False, False), ((2, 1), True, True),
                           ((1, 1), False, True)):
        got = configs(pipeline, tparams, mesh, knob)
        assert got == configs(jp, jparams, mesh, knob)
        assert got[0] == int(knob) and (got[1] > 0) == on


def test_mesh_read_lanes_equals_reference():
    from fqsqueezer_tpu.streams import ids as jids

    for R, dp, N in ((64, 4, 16), (512, 2, 16), (4096, 8, 128), (32, 1, 8)):
        got = ids.mesh_read_lanes(R, dp, N)
        np.testing.assert_array_equal(got, jids.mesh_read_lanes(R, dp, N))
        assert got.dtype == jids.mesh_read_lanes(R, dp, N).dtype


# --- function level ----------------------------------------------------------

def _dna_cfgs():
    """(port, reference) DnaConfig of the CPU fixtures' geometry."""
    from fqsqueezer_tpu import pipeline as jp

    args = ("se", "o", "none", "none")
    return (pipeline.make_configs(mesh_params(tparams, *args))[0],
            jp.make_configs(mesh_params(jparams, *args))[0])


def _jstate(d):
    """The reference's DnaState of state_to_numpy's dict."""
    import jax.numpy as jnp

    from fqsqueezer_tpu.streams import dna as jdna

    return jdna.DnaState(*(jnp.asarray(d[k]) for k in
                           ("siv", "s_tc", "b_tc", "model")), pe=None)


def _same_dna(tstate, jstate):
    import jax

    from fqsqueezer_tpu_torch.state import state_to_numpy

    got = state_to_numpy(pipeline.CodecState(dna=tstate, meta=None,
                                             qual=None))
    want = jax.device_get(jstate)
    for k in ("siv", "s_tc", "b_tc", "model"):
        w = np.asarray(getattr(want, k))
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_dna_collect_updates_replays_row_blocks_as_the_reference():
    """The mesh collect (dna_collect_updates without skip_sb) on a gathered
    batch of two shards of 32 reads over 16 lanes, from the tables a first
    such batch left (keys in them, counts rising): the s/b insert events
    of its row blocks replayed in order, the model and SIV updates — the
    reference's state, exactly."""
    import functools

    import jax
    import jax.numpy as jnp

    from fqsqueezer_tpu.streams import dna as jdna
    from fqsqueezer_tpu_torch.state import state_to_numpy

    tcfg, jcfg = _dna_cfgs()
    rng = np.random.default_rng(11)
    R, L = 2 * 32, 40
    genome = rng.integers(0, 4, 600)

    def batch():
        start = rng.integers(0, genome.size - L, R)
        codes = genome[start[:, None] + np.arange(L)[None, :]]
        codes = np.where(rng.random(codes.shape) < 0.02, 4, codes)
        lengths = rng.integers(0, L + 1, R)
        lengths[:3] = (0, 1, L)
        pos = np.arange(L)[None, :]
        codes = np.where(pos < lengths[:, None], codes, 0)
        eff = np.where(codes >= 4, rng.integers(0, 4, codes.shape), codes)
        ctx = rng.integers(0, dna._n_model_ctx(tcfg), (R, L))
        sym = rng.integers(0, dna.A_SYM, (R, L))
        act = (pos < lengths[:, None]) & (rng.random((R, L)) < 0.9)
        return (codes, eff, lengths, ctx, sym), act

    def collect(state, args, act):
        return dna.dna_collect_updates(
            tcfg, state, *(torch.from_numpy(a.astype(np.int64))
                           for a in args), torch.from_numpy(act))

    state = collect(dna.dna_state_create(tcfg, "cpu"), *batch())
    args, act = batch()
    # one compile of the whole function costs less than its ops' one each
    jstate = jax.jit(functools.partial(jdna.dna_collect_updates, jcfg))(
        _jstate(state_to_numpy(pipeline.CodecState(dna=state, meta=None,
                                                   qual=None))),
        *(jnp.asarray(a, jnp.int32) for a in args), jnp.asarray(act))
    got = collect(state, args, act)
    _same_dna(got, jstate)
    assert not torch.equal(got.s_tc, state.s_tc)
    assert int((state.s_tc != 0).sum()) > 0


def _shard_inputs():
    """One shard's DNA decode inputs: a batch of one read row over 16
    lanes, encoded from a state with real counts (utils.dna_batches, the
    CPU fixtures' geometry): (port cfg, reference cfg, DnaState, lengths,
    words, lane states, L)."""
    from fqsqueezer_tpu_torch.utils import dna_batches

    tcfg, jcfg = _dna_cfgs()
    _, state, lengths, words, x0 = dna_batches.dna_decode_inputs(
        7, 16, 1, 40, "cpu", cfg=tcfg)
    return tcfg, jcfg, state, lengths, words, x0, 40


def _decode_digests(codes, state, x, ptr, extras):
    """sha256 of each output of dna_decode_batch, as int64 arrays: codes,
    the returned state's s and b tables, final states, words consumed,
    then the extras."""
    arrays = (codes, state.s_tc, state.b_tc, x, ptr, *extras)
    return [hashlib.sha256(np.ascontiguousarray(
        np.asarray(a), dtype=np.int64).tobytes()).hexdigest()
        for a in arrays]


# _decode_digests of fqsqueezer_tpu.streams.dna.dna_decode_batch(...,
# apply_update=False) on _shard_inputs(): the reference's decode compiles
# for half a minute on one core, so the fast test holds the port to these,
# and test_reference_shard_decode_digests recomputes them
SHARD_DECODE_SHA256 = (
    "73e78c27190b04bb9ed33268133d28250c0edf8244f60a1a078eb18900110aae",
    "a055bb05e2d1922cb8b83d78251c94a864fde303404cf6dad36923d9e4cf5f02",
    "e3599507c34cfb5b1d75f1dfd2c6dfc9185455556f05270efbc321981e9253b8",
    "9c4b62527d6179ff00db87154a162095ca771dafbe3b02dba0d7145fb8f77134",
    "280263b8515b99c473d9685d1fca1b992ae0949c742ba11c9ba625d9cd984506",
    "5dd7a12aaa616306747281a15c6a8cc1867690824c3c6b87ecf318af0b0a1359",
    "ac229852b45a0bd4d832ee0b8754c87ae75543e8d5731e55567d64d3bb2c9e84",
    "b7635e2126cdd6e15434a55c9bee894614f779021ecd2d6e03ab213c54664a74",
    "7369a29eefbeebf67e9944f693b05beab1efdfadb50f18577f2201a0505fd641")


def test_dna_decode_batch_without_update_equals_reference():
    """One shard's DNA decode against the batch-frozen state: codes, the
    returned state (the row's s/b inserts in copies of the tables), final
    states, words consumed and the events for the batch collect are the
    reference's apply_update=False decode (SHARD_DECODE_SHA256); the given
    state's tables are unchanged, and a second decode from it gives the
    same."""
    tcfg, _, state, lengths, words, x0, L = _shard_inputs()
    tables0 = (state.s_tc.clone(), state.b_tc.clone())
    got = dna.dna_decode_batch(tcfg, state, lengths, words, x0, L,
                               apply_update=False)
    again = dna.dna_decode_batch(tcfg, state, lengths, words, x0, L,
                                 apply_update=False)
    assert torch.equal(state.s_tc, tables0[0])
    assert torch.equal(state.b_tc, tables0[1])
    assert not torch.equal(got[1].s_tc, tables0[0])
    assert got[1].model is state.model and got[1].siv is state.siv
    assert _decode_digests(*got[:2], *got[2:]) == _decode_digests(*again)
    assert _decode_digests(*got) == list(SHARD_DECODE_SHA256)
    assert int((got[0] > 0).sum()) > 0


@pytest.mark.parametrize("above", [False, True], ids=["at", "above"])
def test_maintenance_local_equals_reference(above):
    """The mesh's group-end maintenance on a SIV whose nonzero counters are
    exactly the prune threshold (4 * words * 5) // 10, and one more, and
    K2 tables three quarters full (past grow_tables' 0.6): the
    reference's _maintenance_local — pruned above, untouched at it; no
    table growth either way (mesh tables are presized)."""
    import jax

    from fqsqueezer_tpu.parallel import mesh_pipeline as jmesh
    from fqsqueezer_tpu_torch.state import state_to_numpy

    tcfg, jcfg = _dna_cfgs()
    state = dna.dna_state_create(tcfg, "cpu")
    n = state.siv.shape[0]
    thr = (4 * n * pipeline.SIV_PRUNE_NUM) // pipeline.SIV_PRUNE_DEN
    rng = np.random.default_rng(5)
    counters = np.zeros(4 * n, np.int64)
    hit = rng.permutation(4 * n)[:thr + above]
    counters[hit] = rng.integers(1, 4, hit.size)
    siv = (counters.reshape(n, 4) << (8 * np.arange(4))).sum(1)
    cells = torch.from_numpy(rng.integers(
        1 << 31, 1 << 32, tuple(state.s_tc.shape), dtype=np.int64))
    full = torch.arange(4)[None, :] < 3
    state = state._replace(siv=torch.from_numpy(siv),
                           s_tc=torch.where(full, cells, 0),
                           b_tc=torch.where(full, cells ^ 0x5A5A00, 0))
    got = mesh_pipeline._maintenance_local(tcfg)(state)
    want = jmesh._maintenance_local(jcfg)(_jstate(state_to_numpy(
        pipeline.CodecState(dna=state, meta=None, qual=None))))
    _same_dna(got, jax.device_get(want))
    assert torch.equal(got.siv, state.siv) != above
    assert torch.equal(got.s_tc, state.s_tc)
    assert torch.equal(got.b_tc, state.b_tc)


# --- slow: the reference's writer and decoder ------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.slow
@pytest.mark.parametrize("name", list(SPECS))
def test_reference_regenerates_fixture_and_digests(tmp_path, name):
    """The reference's mesh writer gives each committed fixture byte for
    byte (the snapshot fixture's group-1 snapshot array by array), and its
    sequential decoder the digests in SHA256SUMS (from the snapshot too:
    the tail of its full decode), or for the -gs 5 fixtures those of
    chip_smoke.py's MESH_FIXTURES."""
    d = str(tmp_path)
    arc = write_fixture(name, d)
    with open(arc, "rb") as f, open(fixture(name), "rb") as g:
        assert f.read() == g.read()
    sums = _sums()
    chip = dict(_chip_smoke().MESH_FIXTURES)
    assert (name in chip) == name.startswith("gs5")
    got = reference_decode(name, arc, d)
    assert got == (list(chip[name]) if name in chip else
                   [sums[n] for n in sum_names(name)])
    if name == "snap_dp2tp1":
        with np.load(snapshot(name, 1, d)) as z, \
                np.load(snapshot(name, 1)) as w:
            assert sorted(z.files) == sorted(w.files)
            for k in w.files:
                assert z[k].dtype == w[k].dtype
                np.testing.assert_array_equal(z[k], w[k])
        assert reference_decode(name, arc, d, 1) == [
            sums[n] for n in sum_names(name, 1)]
        full, tail = (os.path.join(d, f"{name}.g{g}.jax_1.fastq")
                      for g in (0, 1))
        with open(full, "rb") as f, open(tail, "rb") as g:
            assert f.read().endswith(g.read())


@pytest.mark.slow
def test_reference_shard_decode_digests():
    """SHARD_DECODE_SHA256 is the reference's apply_update=False decode of
    _shard_inputs()."""
    import jax
    import jax.numpy as jnp

    from fqsqueezer_tpu.streams import dna as jdna
    from fqsqueezer_tpu_torch.state import state_to_numpy

    _, jcfg, state, lengths, words, x0, L = _shard_inputs()
    d = state_to_numpy(pipeline.CodecState(dna=state, meta=None, qual=None))
    want = jax.device_get(jdna.dna_decode_batch(
        jcfg, _jstate(d), jnp.asarray(lengths.numpy(), jnp.int32),
        jnp.asarray(words.numpy().astype(np.uint32)),
        jnp.asarray(x0.numpy().astype(np.uint32)), L, apply_update=False))
    assert _decode_digests(*want) == list(SHARD_DECODE_SHA256)
