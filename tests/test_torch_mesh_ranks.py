"""Mesh archives written and decoded on ranks: the port against the reference.

The reference package runs a dp x tp mesh archive on a mesh of devices
(fqsqueezer_tpu.parallel: make_sharded_model / make_sharded_decode, whose
shards meet in all_gathers over dp). The port runs it on ranks, one
process each (fqsqueezer_tpu_torch.parallel.comm, mesh_pipeline.run_ranks):
rank r of R holds dp shards [r * dp / R, (r + 1) * dp / R), the shards'
events, routed s/b lists and coded words are gathered in shard order, and
rank 0 writes the archive or the FASTQ. Here the ranks are gloo processes
on the CPU. The module spawns its two ranks once (`ranks`) and every
fast test reads what they did:

  * the archives of route_se_dp2tp4 (the owner-routed s/b exchange at tp
    4) and h1_se_dp2tp1 (H1's local tables and deltas, a group a batch),
    byte for byte the JAX mesh writer's committed fixtures
    (fqsqueezer_tpu_torch/testdata/mesh_legacy);
  * the decodes of route_drop_dp2tp4, whose route cap dropped events: the
    ranks replay the writer's routed exchange as the JAX mesh decode does,
    and give its output (DROP_MESH_SHA), where the one-process sequential
    decode fails as the JAX sequential decode does
    (test_torch_mesh_legacy.py::test_route_drop_fails_as_the_reference);
    of h0_pe_dp2tp1 (PE) and of h4_se_dp4tp2 (two shards a rank) to the
    JAX decoder's SHA256SUMS; and of snap_dp2tp1 from its group-1
    snapshot (testdata/mesh), every rank loading it;
  * the gather against torch.cat in shard order, padded word buffers too.

A rank that raises ends every rank, and the CLI exits with one line
within its time limit. Under `slow`: the JAX mesh decode on the 8 virtual CPU
devices (tests/conftest.py) recomputes DROP_MESH_SHA and h4_se_dp4tp2's
digest, and four ranks write and decode the dp 4 fixtures and run the
single-step mesh encode (sharded.sharded_encode) at dp 4 x tp 2 to the
digests of the JAX make_sharded_encode's outputs
(tests/test_torch_mesh_write.py's SHARDED_SHA256).
"""
import hashlib
import os
import time

import numpy as np
import pytest
import torch

from fqsqueezer_tpu_torch import cli
from fqsqueezer_tpu_torch import params as tparams
from fqsqueezer_tpu_torch.parallel import comm, mesh_pipeline
from tests import test_torch_mesh as tm
from tests import test_torch_mesh_legacy as tml
from tests import test_torch_mesh_write as tmw

# sha256 of fqsqueezer_tpu.parallel.mesh_pipeline.decompress_file_mesh's
# output of route_drop_dp2tp4 on the 8 virtual CPU devices (its mesh
# decode: dp x tp = 8 devices); test_reference_mesh_decode_digests
# recomputes it
DROP_MESH_SHA = ("b494fecb39686908ebf70de3646ce3521965c761018a183a2dd32bad"
                 "1d71e33d")
WRITES = ("route_se_dp2tp4", "h1_se_dp2tp1")
DECODES = ("route_drop_dp2tp4", "h0_pe_dp2tp1", "h4_se_dp4tp2")
RANK_TIMEOUT = 240


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _write_job(name, d):
    """run_ranks' job writing a mesh_legacy fixture from its regenerated
    input into directory d."""
    _, kind, _, _, _, _, dp, tp, budget, _ = tml.SPECS[name]
    paths = tml.write_inputs(name, d)
    kw = dict(p=tml.fixture_params(tparams, name), out_path=os.path.join(
        d, f"{name}.fqst"), dp=dp, tp=tp)
    if budget is not None:
        kw["group_mem_bytes"] = budget
    if kind == "pe":
        return "compress_pe", dict(kw, in1=paths[0], in2=paths[1])
    return "compress", dict(kw, in_path=paths[0])


def _decode_job(name, d):
    return "decompress", dict(
        zip(("out_path", "out_path2"),
            [os.path.join(d, n) for n in tml.out_names(name)]),
        p_cli=tparams.Params(), in_path=tml.fixture(name))


def _gather_data():
    """Two ranks' trees (every dtype the mesh gathers, a None leaf, a 0-d
    leaf, an empty one) and word buffers of different lengths, one
    empty."""
    rng = np.random.default_rng(5)
    trees = [[rng.integers(-2 ** 40, 2 ** 40, (3, 5)),
              (rng.random((3, 7)) < 0.5, None),
              rng.integers(0, 2 ** 31, (3,)).astype(np.int32),
              np.array(7 + r, dtype=np.int64),
              np.zeros((0, 4), np.int64)] for r in range(2)]
    words = [rng.integers(0, 1 << 16, 11).astype(np.int32),
             np.zeros((0,), np.int32)]
    return trees, words


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One spawn of two gloo ranks on the CPU running every job the fast
    tests read: (directory, {job name: rank 0's record}, every rank's
    records)."""
    d = str(tmp_path_factory.mktemp("ranks"))
    trees, words = _gather_data()
    snap = tm.snapshot("snap_dp2tp1", 1)
    named = [("gather", ("gather", dict(trees=trees, words=words)))]
    named += [(f"write {n}", _write_job(n, d)) for n in WRITES]
    named += [(f"decode {n}", _decode_job(n, d)) for n in DECODES]
    named.append(("resume", ("decompress", dict(
        p_cli=tparams.Params(), in_path=tm.fixture("snap_dp2tp1"),
        out_path=os.path.join(d, "snap.g1.fastq"), start_group=1,
        snapshot=snap))))
    recs = mesh_pipeline.run_ranks([j for _, j in named], 2, "gloo", "cpu",
                                   timeout=RANK_TIMEOUT)
    return d, {k: r for (k, _), r in zip(named, recs[0])}, recs


def test_gather_is_cat_in_shard_order(ranks):
    """comm.gather_tree on each rank: every leaf the ranks' leaves
    concatenated in rank order (0-d ones stacked, None kept), dtypes
    kept; comm.gather_padded: the ranks' word buffers of different
    lengths, padded and cut back, concatenated."""
    _, by_job, recs = ranks
    trees, words = _gather_data()
    for rec in recs:
        got = rec[0]["result"]
        t = [torch.from_numpy(np.asarray(x)) for x in
             (trees[0][0], trees[1][0])]
        want = [torch.cat(t).numpy(),
                (np.concatenate([trees[0][1][0], trees[1][1][0]]), None),
                np.concatenate([trees[0][2], trees[1][2]]),
                np.array([7, 8]), np.zeros((0, 4), np.int64)]
        tree = got["tree"]
        np.testing.assert_array_equal(tree[0], want[0])
        assert tree[0].dtype == np.int64
        np.testing.assert_array_equal(tree[1][0], want[1][0])
        assert tree[1][0].dtype == np.bool_ and tree[1][1] is None
        np.testing.assert_array_equal(tree[2], want[2])
        assert tree[2].dtype == np.int32
        np.testing.assert_array_equal(tree[3], want[3])
        assert tree[4].shape == (0, 4)
        np.testing.assert_array_equal(got["words"], np.concatenate(words))
    assert comm.gather_tree(None, trees[0]) is trees[0]


@pytest.mark.parametrize("name", WRITES)
def test_ranks_write_the_reference_mesh_archive(ranks, name):
    """Two ranks, one shard each, write the JAX mesh writer's archive byte
    for byte; rank 0 alone writes (the others' stats count no bytes)."""
    d, by_job, recs = ranks
    with open(os.path.join(d, f"{name}.fqst"), "rb") as f, \
            open(tml.fixture(name), "rb") as g:
        assert f.read() == g.read()
    i = list(by_job).index(f"write {name}")
    assert recs[0][i]["result"]["out_bytes"] == os.path.getsize(
        tml.fixture(name))
    assert recs[1][i]["result"]["out_bytes"] == 0
    assert recs[0][i]["result"]["route_dropped"] == 0


@pytest.mark.parametrize("name", DECODES)
def test_ranks_decode_as_the_reference_mesh_decode(ranks, name):
    """route_drop_dp2tp4 decodes to the JAX mesh decode's output (the
    routed exchange replayed); h0_pe_dp2tp1 (both mates) and
    h4_se_dp4tp2 (dp 4 on two ranks) to the JAX decoder's SHA256SUMS."""
    d, by_job, _ = ranks
    outs = [os.path.join(d, n) for n in tml.out_names(name)]
    want = ([DROP_MESH_SHA] if name == "route_drop_dp2tp4" else
            [tml._sums()[n] for n in tml.out_names(name)])
    assert [_sha(o) for o in outs] == want
    n = tml.SPECS[name][5][0]
    assert by_job[f"decode {name}"]["result"]["n_reads"] == n * len(outs)


def test_ranks_resume_from_a_group_snapshot(ranks):
    """Every rank loads snap_dp2tp1's group-1 snapshot and the ranks
    decode the archive from group 1: the JAX decoder's tail."""
    d, by_job, _ = ranks
    assert _sha(os.path.join(d, "snap.g1.fastq")) == tm._sums()[
        "snap_dp2tp1.g1.fastq"]
    assert 0 < by_job["resume"]["result"]["n_reads"] < 128


def test_a_failing_rank_ends_the_cli_with_one_line(tmp_path, monkeypatch,
                                                   capsys):
    """The CLI's `d` of a mesh archive on ranks (its route forced to dp
    ranks and, with no cards here, to gloo on the CPU): rank 0 cannot
    open the output (its directory is missing) while rank 1 decodes on
    and waits in its first gather. Every rank is ended and the CLI exits
    1 with rank 0's error in one line, well within the time limit; at -v
    1 it printed its route."""
    run = mesh_pipeline.run_ranks
    monkeypatch.setattr(cli, "mesh_ranks", lambda device, dp: dp)
    monkeypatch.setattr(mesh_pipeline, "run_ranks", lambda jobs, world: run(
        jobs, world, "gloo", "cpu", timeout=RANK_TIMEOUT))
    out = str(tmp_path / "missing" / "o.fastq")
    t0 = time.monotonic()
    with pytest.raises(SystemExit) as e:
        cli.main(["d", "--device", "cpu", "-v", "1", "-out", out,
                  tml.fixture("h6_se_dp2tp2")])
    msg = e.value.code
    assert isinstance(msg, str) and "\n" not in msg
    assert msg.startswith("error: rank 0: FileNotFoundError") and out in msg
    assert time.monotonic() - t0 < 60
    assert "mesh: 2 ranks on 2 cards (nccl)" in capsys.readouterr().out


def test_ranks_the_machine_cannot_hold_fail_before_spawning(monkeypatch):
    """nccl wants one card a rank and fails with one line where torch sees
    fewer (no fallback to gloo); ranks must divide dp; the CLI takes dp
    ranks only without --device and with dp cards or more."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for world, backend, device, what in (
            (2, "nccl", None, "nccl needs one CUDA card a rank"),
            (1, "nccl", "cuda:0", "name no device"),
            (2, "gloo", "cuda:0", "no CUDA device"),
            (2, "mpi", None, "backend")):
        with pytest.raises(ValueError) as e:
            mesh_pipeline.run_ranks([], world, backend, device)
        assert what in str(e.value) and "\n" not in str(e.value)
    with pytest.raises(ValueError) as e:
        comm.shards(comm.Comm(0, 3, torch.device("cpu"), False), 4)
    assert "ranks must divide dp" in str(e.value)
    assert list(comm.shards(comm.Comm(1, 2, torch.device("cpu"), False),
                            4)) == [2, 3]
    assert cli.mesh_ranks("cuda", 2) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [cli.mesh_ranks(dev, dp) for dev, dp in (
        ("cuda", 4), ("cuda", 2), ("cuda", 8), ("cuda:0", 2),
        ("cpu", 2))] == [4, 2, 0, 0, 0]


# --- slow ------------------------------------------------------------------------

@pytest.mark.slow
def test_reference_mesh_decode_digests(tmp_path):
    """The JAX package's mesh decode (decompress_file_mesh with dp x tp
    devices: the 8 virtual CPU devices) of route_drop_dp2tp4 gives
    DROP_MESH_SHA, and of h4_se_dp4tp2 its SHA256SUMS line, which the
    sequential decode gave."""
    import jax

    from fqsqueezer_tpu import params as jparams
    from fqsqueezer_tpu.parallel import mesh_pipeline as jmesh

    assert len(jax.devices()) >= 8
    for name, want in (("route_drop_dp2tp4", DROP_MESH_SHA),
                       ("h4_se_dp4tp2", tml._sums()["h4_se_dp4tp2.fastq"])):
        out = str(tmp_path / f"{name}.fastq")
        jmesh.decompress_file_mesh(jparams.Params(), tml.fixture(name), out)
        assert _sha(out) == want, name


@pytest.mark.slow
def test_four_ranks_write_and_decode_the_dp4_fixtures(tmp_path):
    """Four ranks, one shard each: h4_se_dp4tp2 and se_dp4tp2 written byte
    for byte as the JAX mesh writer wrote them, and decoded to the JAX
    decoder's digests; and sharded.sharded_encode at dp 4 x tp 2, its
    second step (53 of 64 reads): each shard's words, the counts and lane
    states of every stream gathered in shard order, and every array of
    the new state, the JAX make_sharded_encode's (SHARDED_SHA256), on
    every rank."""
    d = str(tmp_path)
    kind, _, dp, tp, (geometry, order, qm, im) = tm.SPECS["se_dp4tp2"]
    src = tm.write_corpus("se_dp4tp2", d)[0]
    jobs = [_write_job("h4_se_dp4tp2", d), _decode_job("h4_se_dp4tp2", d),
            ("compress", dict(p=tm.mesh_params(tparams, kind, order, qm, im,
                                               geometry),
                              in_path=src, out_path=f"{d}/se_dp4tp2.fqst",
                              dp=dp, tp=tp)),
            ("decompress", dict(p_cli=tparams.Params(),
                                in_path=tm.fixture("se_dp4tp2"),
                                out_path=f"{d}/se_dp4tp2.out.fastq"))]
    p = tmw.tiny_params(tparams, 4, 2)
    icfg = tmw.pipeline.make_configs(p)[3]
    jobs.append(("encode", dict(p=p, dp=4, tp=2, batches=[
        (tmw.tiny_batch(icfg, R=64, seed=seed), take)
        for seed, take in zip((0, 1), tmw.SHARDED_TAKES)])))
    recs = mesh_pipeline.run_ranks(jobs, 4, "gloo", "cpu", timeout=600)
    for rec in recs:
        assert tmw.port_digests(rec[-1]["result"], 4) == tmw.SHARDED_SHA256
    for name, fix in (("h4_se_dp4tp2", tml.fixture("h4_se_dp4tp2")),
                      ("se_dp4tp2", tm.fixture("se_dp4tp2"))):
        with open(f"{d}/{name}.fqst", "rb") as f, open(fix, "rb") as g:
            assert f.read() == g.read(), name
    assert _sha(f"{d}/h4_se_dp4tp2.fastq") == tml._sums()[
        "h4_se_dp4tp2.fastq"]
    assert _sha(f"{d}/se_dp4tp2.out.fastq") == tm._sums()["se_dp4tp2.fastq"]
