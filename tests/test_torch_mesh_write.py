"""Mesh archives written on one device, and the per-batch encoders: the port
against the reference.

The reference package writes an archive over a dp x tp mesh of devices
(fqsqueezer_tpu.parallel.mesh_pipeline.compress_file_mesh); the port
writes the same bytes on one device, the shards of a batch in turn and
one walk a stream at each group end
(fqsqueezer_tpu_torch.parallel.mesh_pipeline). The reference's mesh
writer is too slow for the fast tests, so the port is held to the
archives and snapshot it wrote (fqsqueezer_tpu_torch/testdata/mesh,
tests/test_torch_mesh.py's SPECS), every byte. The group flush's walk is
held to the chained per-batch walks it stands for on a group of more
batches than a single-device group may hold, and the CLI's `e -dp/-tp`
to the writer.

The single-step encoders (pipeline._encode_batch, the four streams'
*_encode_batch, and parallel.sharded.sharded_encode at dp 4 x tp 2) run
on __graft_entry__'s tiny configuration and batches. Compiling the
reference's side takes some 40 s on one core, so the fast tests hold the
port's outputs to digests of the reference's (ENCODE_SHA256,
SHARDED_SHA256), and `slow` recomputes them with the reference.
"""
import hashlib
import os

import numpy as np
import pytest
import torch

from fqsqueezer_tpu_torch import checkpoint, cli
from fqsqueezer_tpu_torch import params as tparams
from fqsqueezer_tpu_torch import pipeline
from fqsqueezer_tpu_torch.io import fastq
from fqsqueezer_tpu_torch.ops import rans
from fqsqueezer_tpu_torch.parallel import mesh_pipeline, sharded
from fqsqueezer_tpu_torch.streams import dna, ids, meta, quality
from fqsqueezer_tpu_torch.utils.corpus import write_fastq_corpus
from fqsqueezer_tpu_torch.utils.rans_grids import random_grid
from tests.test_torch_mesh import (CPU_FIXTURES, SNAP_GROUP_MEM, SPECS,
                                   fixture, mesh_params, snapshot,
                                   write_corpus)

SB = 14


def _same_file(a, b):
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


@pytest.mark.parametrize("name", CPU_FIXTURES)
def test_mesh_writer_writes_the_reference_fixture(tmp_path, name):
    """SE dp 4 x tp 2 with lossless qualities and ids; PE dp 2 with the
    anchors (the pe stream); SE sorted order; and SE -qm 8 -im o over
    several groups with snapshots: the port's writer on the CPU gives the
    reference mesh writer's archive, byte for byte, and for snap_dp2tp1
    its group-1 snapshot, array for array."""
    kind, _, dp, tp, (geometry, order, qm, im) = SPECS[name]
    paths = write_corpus(name, str(tmp_path))
    p = mesh_params(tparams, kind, order, qm, im, geometry)
    arc = str(tmp_path / f"{name}.fqst")
    kw = {}
    if name == "snap_dp2tp1":
        kw = dict(group_mem_bytes=SNAP_GROUP_MEM,
                  snapshot_prefix=str(tmp_path / name))
    data = None
    if kind == "pe":
        data = pipeline.interleave_pe(*(fastq.read_fastq(f) for f in paths))
    st = mesh_pipeline.compress_file_mesh(p, paths[0], arc, dp=dp, tp=tp,
                                          data=data, device="cpu", **kw)
    assert _same_file(arc, fixture(name))
    assert st["out_bytes"] == os.path.getsize(arc)
    if name == "snap_dp2tp1":
        with np.load(snapshot(name, 1, str(tmp_path))) as z, \
                np.load(snapshot(name, 1)) as w:
            assert sorted(z.files) == sorted(w.files)
            for k in w.files:
                assert z[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(z[k], w[k], err_msg=k)


def test_group_of_more_batches_than_a_single_device_group():
    """A mesh group has no batch cap: 70 batches of dp 2 shards x 8 lanes
    (two streams of different heights, padded to the flush's row
    granularity), walked once a stream, cut by shard and batch — each
    shard's words a batch and final states are those of the reference's
    chained per-batch walks (the group's batches in reverse, each from the
    states the later one left), every stream's and shard's."""
    dp, N, K = 2, 8, 70
    assert K > rans.GROUP_MAX_BATCHES
    rng = np.random.default_rng(3)
    batches = []
    for k in range(K):
        rows = rng.integers(1, 6)
        batches.append([tuple(torch.from_numpy(a) for a in random_grid(
            100 * k + si, int(rows * h), dp * N, SB)) for si, h in
            enumerate((1, 3))])
    grids, bounds = zip(*(pipeline._group_grid(
        [b[si] for b in batches], SB, dp * N) for si in range(2)))
    for si, (words, n, x) in enumerate(rans.rans_encode_shards(
            grids, SB, bounds, dp)):
        assert n.shape == (dp, K)
        at = 0
        for s in range(dp):
            cols = slice(s * N, (s + 1) * N)
            st = rans.rans_initial_states(N)
            want = [None] * K
            for k in range(K - 1, -1, -1):
                f, c = (g[:, cols] for g in batches[k][si])
                w, e, st = rans.rans_encode_walk_plain(f, c, SB, st)
                want[k] = rans.words_to_i32(w[e.bool()])
            for k in range(K):
                assert int(n[s, k]) == want[k].numel()
                assert torch.equal(words[at:at + want[k].numel()], want[k])
                at += want[k].numel()
            assert torch.equal(x[cols], st)
        assert at == words.numel()


# --- the CLI -----------------------------------------------------------------

def _tiny_geometry(parse):
    """cli.parse_args with mesh_params' CPU geometry (16 lanes, 128-read
    batches, 2^12-bucket tables, SIV cap 7) in place of the CLI's, whose
    tables and 2048 lanes take GiBs on a CPU."""
    def parse_args(argv):
        p = parse(argv)
        p.n_lanes, p.max_batch_reads, p.local_log2_cells = 16, 128, 16
        p.smer_log2_buckets = p.bmer_log2_buckets = 12
        p.dna_siv_cap = 7
        return p
    return parse_args


def test_cli_writes_and_decodes_a_mesh_archive(tmp_path, monkeypatch):
    """`e -s -om o -qm 8 -im o -gs 1 -dp 2 -tp 1` writes the archive
    compress_file_mesh writes at those Params (2 shards, tp 1 in the
    header), and the CLI's `d` decodes it to the input's bases, lengths
    and ids, the qualities as the Illumina-8 bins give them. 48 reads: a
    batch of 32, then one of 16 padded to 32, whose shard 1 is all
    padding."""
    from tests.test_pipeline import make_fastq

    monkeypatch.setattr(cli, "parse_args", _tiny_geometry(cli.parse_args))
    src = str(tmp_path / "in.fastq")
    make_fastq(src, 48, 72, seed=31)
    arc, out = str(tmp_path / "cli.fqst"), str(tmp_path / "o.fastq")
    flags = ["-s", "-om", "o", "-qm", "8", "-im", "o", "-gs", "1", "-dp",
             "2", "-tp", "1"]
    assert cli.main(["e", *flags, "--device", "cpu", "-v", "0", "-out", arc,
                     src]) == 0
    p = mesh_params(tparams, "se", "o", "illumina_8", "lossless")
    want = str(tmp_path / "want.fqst")
    mesh_pipeline.compress_file_mesh(p, src, want, dp=2, tp=1,
                                     device="cpu")
    assert _same_file(arc, want)
    assert cli.main(["d", "--device", "cpu", "-v", "0", "-out", out,
                     arc]) == 0
    got, ref = fastq.read_fastq(out), fastq.read_fastq(src)
    fwd, rev = quality.qual_maps("illumina_8", 20)
    assert got.ids == ref.ids
    np.testing.assert_array_equal(got.lengths, ref.lengths)
    np.testing.assert_array_equal(got.codes, ref.codes)
    in_len = np.arange(ref.quals.shape[1])[None, :] < ref.lengths[:, None]
    np.testing.assert_array_equal(
        got.quals, np.where(in_len, rev[fwd[ref.quals]], 0))


@pytest.mark.parametrize("case", ["route_sb", "tp3", "H0", "H5", "H6",
                                  "canon0_rg"])
def test_cli_refuses_what_the_mesh_writer_cannot_write(tmp_path,
                                                       monkeypatch, case):
    """A tp that does not divide the s/b tables' rows and the SIV's words
    (-tp 3) exits 1 with one line naming it, before any input is read,
    whatever the header: today's, with mesh_route_sb (the owner-routed
    s/b exchange), an older writer's knobs (HEADER_GENERATIONS H0, H5,
    H6), or row-global context-keyed tables (dna_canon=0 with
    dna_row_global=1), which the mesh writer once refused themselves and
    now writes, so the line names the tp alone: the last at -tp 1 and 2
    through the CLI's e, its d giving the input's reads. The writer
    itself raises the same ValueError."""
    parse = _tiny_geometry(cli.parse_args)
    tp = "3"
    im = "o" if case.startswith("H") else "n"

    def parse_args(argv):
        p = parse(argv)
        p.mesh_route_sb = int(case == "route_sb")
        if case.startswith("H"):
            tparams.header_generation(p, case)
            p.smer_log2_buckets = p.bmer_log2_buckets = 12
        if case == "canon0_rg":
            p.dna_canon, p.dna_row_global = 0, 1
        return p

    monkeypatch.setattr(cli, "parse_args", parse_args)
    argv = ["e", "-s", "-om", "o", "-qm", "8", "-im", im, "-dp", "2", "-tp",
            tp, "--device", "cpu", "-out", str(tmp_path / "o.fqst"),
            str(tmp_path / "absent.fastq")]
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    msg = e.value.code
    assert isinstance(msg, str) and "\n" not in msg and msg.startswith(
        "error: ")
    key = "-tp 3"
    p = parse_args(["e", "-s", "-om", "o", "-qm", "8", "-im", im, "x"])
    with pytest.raises(ValueError) as v:
        mesh_pipeline.compress_file_mesh(p, "absent.fastq", "absent.fqst",
                                         dp=2, tp=int(tp), device="cpu")
    assert key in msg and key in str(v.value)
    for gone in ("mesh_route_sb", "id codec", "s/b tables other than"):
        assert gone not in msg
    assert "\n" not in str(v.value)
    assert not os.path.exists(tmp_path / "o.fqst")
    if case != "canon0_rg":
        return
    src = str(tmp_path / "in.fastq")
    write_fastq_corpus(src, 32, 40, 20_000, seed=3)
    for tp in ("1", "2"):
        arc, out = str(tmp_path / f"tp{tp}.fqst"), str(tmp_path / "o.fq")
        assert cli.main([*argv[:11], tp, "--device", "cpu", "-v", "0",
                         "-out", arc, src]) == 0
        assert cli.main(["d", "--device", "cpu", "-v", "0", "-out", out,
                         arc]) == 0
        got, ref = fastq.read_fastq(out), fastq.read_fastq(src)
        np.testing.assert_array_equal(got.lengths, ref.lengths)
        np.testing.assert_array_equal(got.codes, ref.codes)


# --- the single-step encoders --------------------------------------------------

def tiny_params(mod, dp=1, tp=1):
    """__graft_entry__._tiny_cfgs's Params, from either package's params
    module."""
    p = mod.Params()
    p.genome_size = 1
    p.adjust_kmer_sizes()
    p.n_lanes = 8
    p.max_batch_reads = 64
    p.smer_log2_buckets = p.bmer_log2_buckets = 12
    p.local_log2_cells = 10
    p.dna_siv_cap = 8
    p.id_mode = mod.IdMode.LOSSLESS
    p.max_id_len = 12
    p.mesh_dp, p.mesh_tp = dp, tp
    return p


def tiny_batch(icfg, R=16, L=40, seed=0, n_lanes=8):
    """__graft_entry__._tiny_batch's arrays, through the port's id
    tokenizer: (codes, kcodes, lengths, qsyms, id planes)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(R, L)).astype(np.int32)
    qsyms = rng.integers(0, 8, size=(R, L)).astype(np.int32)
    id_batch = ids.encode_ids_host(
        [f"SIM.{r} {r}".encode() for r in range(R)],
        ids.read_lanes(R, n_lanes), icfg.n_fields, icfg.max_id_len,
        [None] * n_lanes)
    return (codes, codes.copy(), np.full((R,), L, np.int32), qsyms,
            id_batch)


def _sha(arrays):
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a), dtype=np.int64)
        h.update(np.int64(a.size).tobytes())
        h.update(a.tobytes())
    return h.hexdigest()


def stream_digest(shard_words, n, states):
    """One stream's output: each shard's words, the word counts, the lane
    states."""
    return _sha(list(shard_words) + [n, states])


def state_digest(arrays):
    """A codec state as checkpoint.state_to_arrays gives it: keys, dtypes,
    values."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(f"{k}:{a.dtype.str}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def port_digests(outs, dp):
    """{meta, id, dna, qual, state} digests of the port's single-step
    outputs (words shard-major, cut by the counts)."""
    out = {}
    for name, (w, n, x) in zip(("meta", "id", "dna", "qual"), outs[:4]):
        n = np.atleast_1d(_np(n)).astype(np.int64)
        at = np.concatenate([[0], np.cumsum(n)])
        out[name] = stream_digest([_np(w)[at[s]:at[s + 1]]
                                   for s in range(dp)], n, _np(x))
    out["state"] = state_digest(checkpoint.state_to_arrays(outs[4]))
    return out


# digests (port_digests' keys) of the reference's second step on
# __graft_entry__'s tiny inputs: fqsqueezer_tpu.pipeline._encode_batch from
# the state its first step left (batch seed 0, then seed 1), and
# fqsqueezer_tpu.parallel.sharded.make_sharded_encode at dp 4 x tp 2
# (64-read batches; the second takes 53 reads, so shard 3 has 5);
# test_reference_encoder_digests recomputes them
ENCODE_SHA256 = {
    "meta": "e3d325c6e0eaaf2185da4880ce4c5c25d0995df4860b40c67b5ae6490cf813bc",
    "id": "76992ff0d8e2a146336de1db6a5ca169bfa1dd24c2baa52d3b7ca2e1f165a8f2",
    "dna": "e69fc6e309db555b848cd140b27aac5d61b077c8aec1919a8a031dddce151e5f",
    "qual": "5bfb8a68581dd6e8b5957f41c510745dd49ac6840040d9e598bd2cdaaad0f544",
    "state":
    "0b2478d2ec2c74930749223cf2e212a9fd5992a9b7eb68ee8054a6b548f40b18"}
SHARDED_SHA256 = {
    "meta": "3e9ba2508b2b37c93ad2bb7b90bf38bb37c99537a135875bb1e960b248081d69",
    "id": "5120af358708a3436ad0ac1b0c2488e1bb2c45021185d5797e9bd0c1f7d27d77",
    "dna": "20d3e7267ae42d7dd04941258820df1a2edf1cc01e19a35447cc1592f5901e68",
    "qual": "b5861f91817095e8795c60c94613c46aadf48a77c7b1c7b5b309bc42600f0203",
    "state":
    "1b1058f221e5b588fcd38d9957c89a13bd4c2fa2ff5b1180dc8cae9e3813aa0f"}
SHARDED_TAKES = (64, 53)


def _port_encode_steps():
    p = tiny_params(tparams)
    cfgs = pipeline.make_configs(p)
    state = pipeline.state_create(*cfgs[:2], cfgs[3], "cpu")
    steps = []
    for seed in (0, 1):
        batch = tiny_batch(cfgs[3], seed=seed)
        outs = pipeline._encode_batch(*cfgs, state, *batch)
        steps.append((state, batch, outs))
        state = outs[4]
    return cfgs, steps


def test_encode_batch_equals_reference():
    """pipeline._encode_batch's second step (meta, id, dna and qual
    streams' words, counts and states, and every array of the new state)
    is the reference's (ENCODE_SHA256); each stream's *_encode_batch on
    the same state and batch gives that stream's words, counts, states and
    model or DNA state."""
    (dcfg, qcfg, mcfg, icfg), steps = _port_encode_steps()
    state, batch, outs = steps[1]
    assert port_digests(outs, 1) == ENCODE_SHA256
    codes, kcodes, lengths, qsyms = (torch.from_numpy(a).to(torch.int64)
                                     for a in batch[:4])
    id_batch = tuple(torch.from_numpy(a) for a in batch[4])
    new = outs[4]
    lcp = (meta.compute_lcp(codes, lengths, mcfg.n_lanes, mcfg.lcp_stride)
           if mcfg.with_lcp else None)
    singles = (
        (meta.meta_encode_batch(mcfg, state.meta, lengths, lcp), 0,
         [new.meta]),
        (ids.id_encode_batch(icfg, state.id, *id_batch), 1, [new.id]),
        (dna.dna_encode_batch(dcfg, state.dna, codes, kcodes, lengths,
                              lcp), 2, list(new.dna[:4])),
        (quality.qual_encode_batch(qcfg, state.qual, qsyms, lengths), 3,
         [new.qual]))
    for (w, n, x, got), k, want in singles:
        assert n == outs[k][1] and torch.equal(w, outs[k][0])
        assert torch.equal(x, outs[k][2])
        got = list(got[:4]) if k == 2 else [got]
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _port_sharded_steps():
    p = tiny_params(tparams, 4, 2)
    cfgs = pipeline.make_configs(p)
    state = pipeline.state_create(*cfgs[:2], cfgs[3], "cpu")
    outs = None
    for seed, take in zip((0, 1), SHARDED_TAKES):
        batch = tiny_batch(cfgs[3], R=64, seed=seed)
        outs = sharded.sharded_encode(*cfgs, state, *batch, take, 4)
        state = outs[4]
    return outs


def test_sharded_encode_equals_reference():
    """The single-step mesh encode at dp 4 x tp 2, second step (53 of 64
    reads, so the last shard's padding rows code no id): each shard's
    words, the counts and the lane states of every stream, and every
    array of the new state, are the reference's make_sharded_encode's
    (SHARDED_SHA256)."""
    assert port_digests(_port_sharded_steps(), 4) == SHARDED_SHA256


@pytest.mark.slow
def test_reference_encoder_digests():
    """ENCODE_SHA256 and SHARDED_SHA256 are the reference's, on the inputs
    of __graft_entry__._tiny_cfgs and _tiny_batch, which are the port
    tests' tiny_params and tiny_batch."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    import __graft_entry__ as graft
    from fqsqueezer_tpu import checkpoint as jck
    from fqsqueezer_tpu import params as jparams
    from fqsqueezer_tpu import pipeline as jp
    from fqsqueezer_tpu.parallel import sharded as jsh

    def digests(outs, dp):
        out = {}
        for name, (w, n, x) in zip(("meta", "id", "dna", "qual"), outs[:4]):
            w, n, x = (np.asarray(a) for a in (w, n, x))
            n = np.atleast_1d(n).astype(np.int64)
            cap = w.size // dp
            out[name] = stream_digest([w[s * cap:s * cap + n[s]]
                                       for s in range(dp)], n, x)
        out["state"] = state_digest(jck.state_to_arrays(
            jax.device_get(outs[4])))
        return out

    for dp, tp in ((1, 1), (4, 2)):
        p, cfgs = graft._tiny_cfgs(dp, tp)
        assert p.store_params() == tiny_params(jparams, dp, tp).store_params()
        state = jp.state_create(*cfgs[:2], cfgs[3])
        if dp > 1:
            mesh = jsh.make_mesh(dp * tp, tp=tp)
            state = jax.device_put(state, jax.tree.map(
                lambda s: NamedSharding(mesh, s),
                jsh.state_specs(True, True),
                is_leaf=lambda x: isinstance(x, P)))
            enc = jsh.make_sharded_encode(*cfgs, mesh)
        for seed, take in zip((0, 1), SHARDED_TAKES):
            R = 64 if dp > 1 else 16
            batch = graft._tiny_batch(cfgs[3], R=R, seed=seed)
            mine = tiny_batch(pipeline.make_configs(tiny_params(
                tparams, dp, tp))[3], R=R, seed=seed)
            for a, b in zip(batch[:4] + tuple(batch[4]),
                            mine[:4] + tuple(mine[4])):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            if dp > 1:
                put = lambda a: jax.device_put(
                    jnp.asarray(a), NamedSharding(mesh, P("dp")))
                outs = enc(state, *(put(a) for a in batch[:4]),
                           tuple(put(a) for a in batch[4]), jnp.int32(take))
            else:
                outs = jp._encode_batch(*cfgs, state, *batch)
            state = outs[4]
        assert digests(outs, dp) == (SHARDED_SHA256 if dp > 1
                                     else ENCODE_SHA256)
