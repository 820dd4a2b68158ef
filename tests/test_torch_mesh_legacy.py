"""Mesh archives of every header a JAX mesh writer stores: the port against
the reference.

The reference's mesh writer (fqsqueezer_tpu.parallel.mesh_pipeline)
takes every s/b table family on a dp x tp mesh, so it writes mesh
archives under the older writers' headers (params.HEADER_GENERATIONS
H0-H6: batch-frozen table_* and ktable_* tables, H1-H4's in-batch local
statistics, row-global ktable_* tables, id codec v1) and, with
mesh_route_sb, through the owner-routed s/b exchange
(fqsqueezer_tpu.parallel.sharded.sb_routed_updates). The port writes and
decodes them on one device (fqsqueezer_tpu_torch.parallel). The
reference's mesh writer runs on the CPU's 8 virtual devices
(tests/conftest.py) and is too slow for the fast tests, so the archives
are committed fixtures it wrote (fqsqueezer_tpu_torch/testdata/
mesh_legacy, see its README), with the sha256 of its sequential decoder's
output of each (SHA256SUMS). The fast tests hold the port's writer to
each fixture byte for byte and its decode to those digests, and the
decode to the input wherever the reference round-trips. One fixture,
route_drop_dp2tp4, is an input whose routed exchange drops events past
its cap: the reference's sequential decode, which replays the replicated
exchange, fails its payload checksum (ROADMAP.md, F7), and the port's
fails the same way.

The function-level tests hold the batch's s/b update of the batch-frozen
families on one table to the reference's tp-sharded TpBackend (events
masked to each owner's rows) on a dp 2 x tp 2 mesh, and the routed
exchange (route_cap, sb_routed_updates) to the reference's at tp 4.
Under `slow` the reference rewrites every fixture and recomputes every
digest.
"""
import hashlib
import os
import re

import numpy as np
import pytest
import torch

from fqsqueezer_tpu_torch import params as tparams
from fqsqueezer_tpu_torch import pipeline
from fqsqueezer_tpu_torch.io import fastq
from fqsqueezer_tpu_torch.parallel import mesh_pipeline, sharded
from fqsqueezer_tpu_torch.streams import dna, ids
from fqsqueezer_tpu_torch.utils.corpus import (write_fastq_corpus,
                                               write_pe_corpus,
                                               write_repeat_corpus)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "fqsqueezer_tpu_torch", "testdata",
                        "mesh_legacy")
GENOME = 20_000
# the reads route_drop_dp2tp4 draws from its random sequence, the rest
# poly-A: in its first batch the last of the n_lanes / dp lanes of each
# shard's routed row blocks (their events come last in each owner's list,
# behind the poly-A lanes', past the cap), and reads of its second and
# third batches, which read the tables back
DROP_ODD = (14, 15, 30, 31, 60, 61, 62, 63, 92, 93, 94, 95, 96)
# the reference's sequential decode of route_drop_dp2tp4
DROP_ERROR = "payload checksum mismatch (seq mesh decode)"

# name -> (generation (None: today's header), kind, order, -qm, -im,
# corpus: (reads or pairs, read length, seed), dp, tp, group budget in
# bytes (None: the writer's default), mesh_route_sb). A budget of 1 makes
# every batch a group, so the group-end maintenance runs between batches.
SPECS = {
    "h0_se_dp2tp2": ("H0", "se", "o", "lossless", "lossless", (40, 48, 31),
                     2, 2, 1, 0),
    "h0_pe_dp2tp1": ("H0", "pe", "o", "lossless", "lossless", (40, 48, 33),
                     2, 1, None, 0),
    "h0_sorted_dp2tp1": ("H0", "se", "s", "illumina_8", "none",
                         (96, 48, 35), 2, 1, None, 0),
    "h1_se_dp2tp1": ("H1", "se", "o", "lossless", "lossless", (80, 40, 37),
                     2, 1, 1, 0),
    "h1_pe_dp2tp1": ("H1", "pe", "o", "lossless", "lossless", (40, 48, 39),
                     2, 1, None, 0),
    "h4_se_dp4tp2": ("H4", "se", "o", "illumina_8", "lossless",
                     (160, 40, 41), 4, 2, 1, 0),
    "h6_se_dp2tp2": ("H6", "se", "o", "lossless", "lossless", (80, 32, 43),
                     2, 2, 1, 0),
    "route_se_dp2tp4": (None, "se", "o", "illumina_8", "lossless",
                        (64, 84, 45), 2, 4, None, 1),
    "route_drop_dp2tp4": (None, "se", "o", "illumina_8", "lossless",
                          (97, 89, 1), 2, 4, None, 1),
}
LOCAL_GENERATIONS = ("H1", "H2", "H3", "H4")


def fixture_params(mod, name):
    """The Params a fixture was written with, from the params module of
    either package: tests/test_torch_mesh.py's CPU geometry (-gs 1 k-mers,
    16 lanes, 128-read batches, 2^12-bucket s/b tables, SIV cap 7), the
    generation's knobs (HEADER_GENERATIONS, the k-mer geometry re-tuned
    as that writer did, the tables then cut to 2^12 buckets) and 2^10
    local cells for H1-H4; mesh_route_sb as SPECS has it."""
    gen, kind, order, qm, im, _, _, _, _, route = SPECS[name]
    p = mod.Params()
    p.genome_size = 1
    p.adjust_kmer_sizes()
    p.dna_mode = {("se", "o"): mod.DnaMode.SE_ORIGINAL,
                  ("se", "s"): mod.DnaMode.SE_SORTED,
                  ("pe", "o"): mod.DnaMode.PE_ORIGINAL}[kind, order]
    p.quality_mode = mod.QualityMode(qm)
    p.id_mode = mod.IdMode(im)
    if gen is not None:
        for k, v in tparams.HEADER_GENERATIONS[gen].items():
            setattr(p, k, v)
        p.adjust_kmer_sizes()
    p.n_lanes = 16
    p.verbosity = 0
    p.max_batch_reads = 128
    p.smer_log2_buckets = p.bmer_log2_buckets = 12
    p.dna_siv_cap = 7
    if gen is None:
        p.local_log2_cells = 16
    elif gen in LOCAL_GENERATIONS:
        p.local_log2_cells = 10
    p.mesh_route_sb = route
    return p


def write_inputs(name, d):
    """The fixture's input FASTQ file(s) in directory d: utils.corpus's
    generators of a 20,000-base genome, or for route_drop_dp2tp4 its
    low-complexity corpus (write_repeat_corpus)."""
    kind, (n, L, seed) = SPECS[name][1], SPECS[name][5]
    os.makedirs(d, exist_ok=True)
    if kind == "pe":
        paths = [os.path.join(d, f"{name}_{k}.fastq") for k in (1, 2)]
        write_pe_corpus(*paths, n, L, GENOME, seed=seed)
        return paths
    path = os.path.join(d, f"{name}.fastq")
    if name == "route_drop_dp2tp4":
        write_repeat_corpus(path, n, L, seed=seed, odd=DROP_ODD)
    else:
        write_fastq_corpus(path, n, L, GENOME, seed=seed)
    return [path]


def write_archive(mesh_mod, fastq_mod, interleave, name, paths, arc, **kw):
    """compress_file_mesh of either package (the PE mates interleaved as
    compress_pe_mesh does), with the fixture's group budget."""
    _, kind, _, _, _, _, dp, tp, budget, _ = SPECS[name]
    p = fixture_params(tparams if mesh_mod is mesh_pipeline else
                       _jparams(), name)
    if budget is not None:
        kw["group_mem_bytes"] = budget
    data = None
    if kind == "pe":
        data = interleave(*(fastq_mod.read_fastq(f) for f in paths))
    return mesh_mod.compress_file_mesh(p, paths[0], arc, dp=dp, tp=tp,
                                       data=data, **kw)


def _jparams():
    from fqsqueezer_tpu import params as jparams

    return jparams


def fixture(name):
    return os.path.join(FIXTURES, f"{name}.fqst")


def out_names(name):
    if SPECS[name][1] == "pe":
        return [f"{name}_1.fastq", f"{name}_2.fastq"]
    return [f"{name}.fastq"]


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _sums():
    """SHA256SUMS: output file name -> sha256 of the reference's
    sequential decode."""
    out = {}
    with open(os.path.join(FIXTURES, "SHA256SUMS")) as f:
        for line in f:
            sha, name = line.split()
            out[name] = sha
    return out


ROUND_TRIPS = [n for n in SPECS if n != "route_drop_dp2tp4"]


# --- the fixtures -------------------------------------------------------------

# the writer checks of the H0 PE and sorted fixtures run under `slow`, for
# the fast tests' clock (chip_smoke.py's [mesh_legacy] writes every
# fixture on the card)
WRITER_SLOW = ("h0_pe_dp2tp1", "h0_sorted_dp2tp1")


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow) if n in WRITER_SLOW else n
    for n in SPECS])
def test_port_writes_the_reference_mesh_archive(tmp_path, name):
    """H0 (table_* cells sharded by tp, id codec v1; PE with the anchors
    off; sorted order), H1 (local tables, DNA and quality deltas per
    shard; SE and PE), H4 (ktable_* batch-frozen, klocal_*), H6 (row-global
    ktable_* on the shard's copy), and mesh_route_sb at tp 4 with nothing
    dropped and with the cap's drop: the port's mesh writer on the CPU
    gives the reference mesh writer's archive, byte for byte."""
    paths = write_inputs(name, str(tmp_path))
    arc = str(tmp_path / f"{name}.fqst")
    st = write_archive(mesh_pipeline, fastq, pipeline.interleave_pe, name,
                       paths, arc, device="cpu")
    with open(arc, "rb") as f, open(fixture(name), "rb") as g:
        assert f.read() == g.read()
    assert (st["route_dropped"] > 0) == (name == "route_drop_dp2tp4")


def _reads(path, with_ids=True):
    """A FASTQ file's (bases, id) a read; the id b"" without with_ids."""
    d = fastq.read_fastq(path)
    return [(bytes(d.codes[i, :d.lengths[i]]), d.ids[i] if with_ids else b"")
            for i in range(d.n_reads)]


@pytest.mark.parametrize("name", ROUND_TRIPS)
def test_port_decodes_as_the_reference(tmp_path, monkeypatch, name):
    """The port's sequential mesh decode of each fixture is the
    reference's (SHA256SUMS), and its reads (bases and ids, as a multiset
    in sorted order) the input's; lossless ones are the input, byte for
    byte. The host detokenizer takes the padding rows as the header's id
    codec has it (v1: like real reads; v2: masked)."""
    seen = []

    def spy(*args, n_valid=None, fn=ids.decode_ids_host):
        seen.append(n_valid)
        return fn(*args, n_valid=n_valid)

    monkeypatch.setattr(ids, "decode_ids_host", spy)
    outs = [str(tmp_path / n) for n in out_names(name)]
    st = mesh_pipeline.decompress_file_mesh(tparams.Params(), fixture(name),
                                            *outs, device="cpu")
    # the host detokenizer masks padding rows under id codec v2 only
    p = fixture_params(tparams, name)
    if p.id_mode != tparams.IdMode.NONE:
        assert seen and all((v is None) == (p.id_codec_v < 2)
                            for v in seen)
    sums = _sums()
    assert [_sha(o) for o in outs] == [sums[n] for n in out_names(name)]
    srcs = write_inputs(name, str(tmp_path / "in"))
    _, _, order, qm, im, (n, _, _) = SPECS[name][:6]
    assert st["n_reads"] == n * len(outs)
    with_ids = im != "none"
    for o, src in zip(outs, srcs):
        if order == "s":
            assert sorted(_reads(o, with_ids)) == sorted(_reads(src,
                                                                with_ids))
        elif qm == "lossless":
            assert _sha(o) == _sha(src)
        else:
            assert _reads(o) == _reads(src)


def test_route_drop_fails_as_the_reference(tmp_path):
    """route_drop_dp2tp4: the routed exchange dropped events that the
    sequential decode's replicated exchange applies, so the tables part
    after the first batch and the decode fails its payload checksum —
    the reference's decompress_file_mesh_seq fails so (ROADMAP.md F7), and
    so does the port's, through the CLI's d as one line
    (mesh_pipeline.decompress_file_mesh's ValueError)."""
    from fqsqueezer_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["d", "--device", "cpu", "-v", "0", "-out",
                  str(tmp_path / "o.fastq"), fixture("route_drop_dp2tp4")])
    assert e.value.code == f"error: {DROP_ERROR}"


def test_codec_v1_mesh_tokenizes_padding_reads(tmp_path, monkeypatch):
    """Id codec v1 on a mesh: the host tokenizer takes a padded batch's
    padding reads like real ones (n_valid None, ids.host_n_valid), as the
    reference's mesh writer and decoder do; the v2 mask (n_valid = take)
    gives other planes and chains, and so another archive.
    h0_se_dp2tp2's second batch holds 8 reads padded to 32 (its dp shard
    0 has 8 padding rows, shard 1 16): every call the port's mesh writer
    makes of the tokenizer passes n_valid None, and its planes are the
    reference tokenizer's (test_port_decodes_as_the_reference holds the
    decoder's calls)."""
    from fqsqueezer_tpu.streams import ids as jids

    calls = []

    def spy(*args, n_valid=None, fn=ids.encode_ids_host):
        calls.append((args, n_valid))
        return fn(*args, n_valid=n_valid)

    monkeypatch.setattr(ids, "encode_ids_host", spy)
    paths = write_inputs("h0_se_dp2tp2", str(tmp_path))
    write_archive(mesh_pipeline, fastq, pipeline.interleave_pe,
                  "h0_se_dp2tp2", paths, str(tmp_path / "w.fqst"),
                  device="cpu")
    assert [nv for _, nv in calls] == [None, None]
    idl, lanes, n_fields, max_len, _ = calls[1][0]
    assert idl[8:] == [b""] * 24 and len(idl) == 32
    want = jids.encode_ids_host(idl, lanes, n_fields, max_len, [None] * 2,
                                n_valid=None)
    v2 = jids.encode_ids_host(idl, lanes, n_fields, max_len, [None] * 2,
                              n_valid=8)
    got = ids.encode_ids_host(idl, lanes, n_fields, max_len, [None] * 2,
                              n_valid=None)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert any(not np.array_equal(g, v) for g, v in zip(got, v2))


# --- function level ------------------------------------------------------------

def _sb_batch(seed, R, L, n_keys=3):
    """A gathered batch's (kcodes, active), [R, L]: reads drawn from n_keys
    short random sequences, so k-mers recur within the batch and fall in
    a few buckets together."""
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, 4, (n_keys, L))
    kcodes = seqs[rng.integers(0, n_keys, R)]
    mut = rng.random(kcodes.shape) < 0.05
    kcodes = np.where(mut, rng.integers(0, 4, kcodes.shape), kcodes)
    lengths = rng.integers(L // 2, L + 1, R)
    active = np.arange(L)[None, :] < lengths[:, None]
    return kcodes.astype(np.int32), active


def _tp_mesh(dp, tp):
    from fqsqueezer_tpu.parallel import sharded as jsh

    return jsh.make_mesh(dp * tp, tp=tp)


@pytest.mark.parametrize("gen", ["H0", "H3", "H4"])
def test_batch_frozen_collect_equals_the_tp_backend(gen):
    """The batch's s/b update of a batch-frozen family (H0's table_*
    cells with two claim rounds, H3's fused update, H4's ktable_* cells),
    the events of a dp 2 x tp 2 batch with duplicate keys in one bucket
    applied to one table in shard order (the port's collect_batch): the
    reference's TpBackend on the mesh, each owner's rows taking the
    events masked to its range, word for word. 2^6-bucket tables, so
    buckets take many keys and fill."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from fqsqueezer_tpu import pipeline as jp
    from fqsqueezer_tpu.parallel import sharded as jsh
    from fqsqueezer_tpu.streams import dna as jdna

    def cfgs(mod, pmod):
        p = pmod.Params()
        p.genome_size = 1
        p.adjust_kmer_sizes()
        for k, v in tparams.HEADER_GENERATIONS[gen].items():
            setattr(p, k, v)
        p.adjust_kmer_sizes()
        p.n_lanes, p.local_log2_cells = 16, 0
        p.smer_log2_buckets = p.bmer_log2_buckets = 6
        p.mesh_dp, p.mesh_tp = 2, 2
        return mod.make_configs(p)[0]

    tcfg, jcfg = cfgs(pipeline, tparams), cfgs(jp, _jparams())
    assert not tcfg.row_global and tcfg.canon == (gen == "H4")
    mesh = _tp_mesh(2, 2)
    be = jsh.TpBackend("tp", 2, 2)
    spec = (P("tp"), P("tp"), P(), P())
    step = jax.jit(jax.shard_map(
        lambda s, b, k, a: jdna._apply_sb_updates(jcfg, be, s, b, k, a),
        mesh=mesh, in_specs=spec, out_specs=(P("tp"), P("tp")),
        check_vma=False))
    state = dna.dna_state_create(tcfg, "cpu")
    s_t, b_t = state.s_tc, state.b_tc
    s_j, b_j = (jax.device_put(jnp.asarray(t.numpy().astype(np.uint32)),
                               NamedSharding(mesh, P("tp")))
                for t in (s_t, b_t))
    for seed in range(2):
        kcodes, active = _sb_batch(seed, 2 * 32, 40)
        s_t, b_t = dna._apply_sb_updates(
            tcfg, dna.tables.LOCAL, s_t, b_t,
            torch.from_numpy(kcodes.astype(np.int64)),
            torch.from_numpy(active))
        s_j, b_j = step(s_j, b_j, jnp.asarray(kcodes), jnp.asarray(active))
        for t, j in ((s_t, s_j), (b_t, b_j)):
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(jax.device_get(j)).astype(np.int64))
    # buckets took several keys each, some beyond their cells
    assert int((s_t[:, 0] != 0).sum()) > 32


@pytest.mark.parametrize("n_tp", [1, 2, 4, 8])
def test_route_cap_equals_the_reference(n_tp):
    from fqsqueezer_tpu.parallel import sharded as jsh

    for n in (0, 1, 255, 256, 511, 512, 513, 688, 1024, 1025, 4104, 99999):
        assert sharded.route_cap(n, n_tp) == jsh._route_cap(n, n_tp)
        if n_tp <= 2:
            assert sharded.route_cap(n, n_tp) == n


def test_sb_routed_updates_equal_the_reference():
    """The owner-routed exchange at dp 2 x tp 4 on two batches, the second
    from the tables the first left: rows whose first 7 of 8 lanes a
    routed block are poly-A, so that one owner's events pass route_cap
    and the rest (the 8th lane's among them) drop; each shard's capped
    events, a global row a call — the reference's sb_routed_updates on
    the mesh, word for word, and the drop counted. (route_se_dp2tp4 holds
    the exchange where nothing drops.)"""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from fqsqueezer_tpu import pipeline as jp
    from fqsqueezer_tpu.parallel import sharded as jsh

    def cfgs(mod, pmod):
        p = pmod.Params()
        p.genome_size = 1
        p.adjust_kmer_sizes()
        p.n_lanes = 16
        p.smer_log2_buckets = p.bmer_log2_buckets = 10
        p.mesh_dp, p.mesh_tp, p.mesh_route_sb = 2, 4, 1
        return mod.make_configs(p)[0]

    tcfg, jcfg = cfgs(pipeline, tparams), cfgs(jp, _jparams())
    assert tcfg.route_sb and jcfg.route_sb
    mesh = _tp_mesh(2, 4)
    be = jsh.TpBackend("tp", 4, 2)
    step = jax.jit(jax.shard_map(
        lambda s, b, k, a: jsh.sb_routed_updates(jcfg, be, s, b, k, a,
                                                 "dp"),
        mesh=mesh, in_specs=(P("tp"), P("tp"), P("dp"), P("dp")),
        out_specs=(P("tp"), P("tp")), check_vma=False))
    state = dna.dna_state_create(tcfg, "cpu")
    s_t, b_t = state.s_tc, state.b_tc
    s_j, b_j = (jax.device_put(jnp.asarray(t.numpy().astype(np.uint32)),
                               NamedSharding(mesh, P("tp")))
                for t in (s_t, b_t))
    rng = np.random.default_rng(4)
    R, L = 2 * 32, 90
    drops = []
    for _ in range(2):
        kcodes = rng.integers(0, 4, (R, L)).astype(np.int32)
        # in each shard's row blocks of 8 lanes, lanes 0-6 poly-A
        kcodes[(np.arange(R) % 32) // 4 < 7] = 0
        active = np.arange(L)[None, :] < rng.integers(L - 4, L + 1, R)[:,
                                                                        None]
        s_t, b_t, dropped = sharded.sb_routed_updates(
            tcfg, s_t, b_t, torch.from_numpy(kcodes.astype(np.int64)),
            torch.from_numpy(active), 2, 4)
        drops.append(int(dropped))
        s_j, b_j = step(s_j, b_j, jnp.asarray(kcodes), jnp.asarray(active))
        for t, j in ((s_t, s_j), (b_t, b_j)):
            np.testing.assert_array_equal(
                t.numpy(), np.asarray(jax.device_get(j)).astype(np.int64))
    assert all(d > 0 for d in drops)


@pytest.mark.parametrize("gen", ["H0", "H4"])
def test_maintenance_local_equals_the_reference(gen, capsys):
    """The mesh's group-end maintenance under H0 (table_* cells: nothing
    to clamp) and H4 (ktable_* cells, whose u16 counters clamp at 0x8000
    — live, as in the reference's own test with dna_sb_proto 0), on
    tables three quarters full with counters near the wrap and a SIV past
    the prune threshold: the reference's _maintenance_local, array for
    array; the tables are never grown. Its verbosity-1 telemetry
    (_run_maintenance) prints the family's fills as the reference's
    (table_fill_stats for table_* cells), and the growth warning of each
    table past the single-device threshold."""
    import jax
    import jax.numpy as jnp

    from fqsqueezer_tpu.ops import tables as jtables
    from fqsqueezer_tpu.parallel import mesh_pipeline as jmesh
    from fqsqueezer_tpu.streams import dna as jdna

    name = {"H0": "h0_se_dp2tp2", "H4": "h4_se_dp4tp2"}[gen]
    tcfg = pipeline.make_configs(fixture_params(tparams, name))[0]
    from fqsqueezer_tpu import pipeline as jp

    jcfg = jp.make_configs(fixture_params(_jparams(), name))[0]
    state = dna.dna_state_create(tcfg, "cpu")
    rng = np.random.default_rng(7)
    n = state.siv.shape[0]
    siv = rng.integers(0, 1 << 32, n, dtype=np.int64)
    tabs = [rng.integers(1 << 16, 1 << 32, tuple(t.shape), dtype=np.int64)
            for t in (state.s_tc, state.b_tc)]
    for t in tabs:
        t[rng.random(t.shape[0]) < 0.25] = 0
    state = state._replace(siv=torch.from_numpy(siv),
                           s_tc=torch.from_numpy(tabs[0]),
                           b_tc=torch.from_numpy(tabs[1]))
    p = fixture_params(tparams, name)
    p.verbosity = 1
    got = mesh_pipeline._run_maintenance(
        p, tcfg, mesh_pipeline._maintenance_local(tcfg),
        pipeline.CodecState(dna=state, meta=None, qual=None)).dna
    jstate = jdna.DnaState(
        *(jnp.asarray(a.astype(np.uint32)) for a in (siv, *tabs)),
        model=jnp.zeros((1, 1), jnp.uint32), pe=None)
    want = jax.device_get(jmesh._maintenance_local(jcfg)(jstate))
    # the verbosity-1 telemetry: the family's fill counts, the reference's
    fill = (jtables.ktable_fill_stats if tcfg.canon
            else jtables.table_fill_stats)
    su, bu = (int(fill(t)[0]) for t in (jstate.s_tc, jstate.b_tc))
    nz = int(jtables.siv_fill(jstate.siv)[0])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"  mesh fills: smer {su:,} bmer {bu:,} siv nz {nz:,}"
    assert len(out) == 3 and all("WARNING: mesh" in o for o in out[1:])
    for k in ("siv", "s_tc", "b_tc"):
        np.testing.assert_array_equal(
            getattr(got, k).numpy(),
            np.asarray(getattr(want, k)).astype(np.int64), err_msg=k)
    assert got.s_tc.shape == state.s_tc.shape
    assert torch.equal(got.s_tc, state.s_tc) == (gen == "H0")
    assert not torch.equal(got.siv, state.siv)


def test_check_mesh_holds_each_family_to_its_rows():
    """check_mesh divides the rows the state's s/b tables really have: H0's
    context-keyed tables at the -gs 1 geometry take one bucket bit fewer
    than canonical ones (header_generation), and a tp that divides those
    rows is taken; one that does not, refused in one line."""
    p = tparams.Params()
    p.genome_size = 1
    p.adjust_kmer_sizes()
    canon_bits = p.smer_log2_buckets
    tparams.header_generation(p, "H0")
    assert p.smer_log2_buckets == canon_bits - 1
    dcfg = pipeline.make_configs(p)[0]
    rows = (1 << dcfg.smer_log2_buckets, 1 << dcfg.bmer_log2_buckets)
    assert dna.table_family(dcfg)[0] == "table"
    sharded.check_mesh(dcfg, 2, rows[0])
    with pytest.raises(ValueError, match="-tp 3") as e:
        sharded.check_mesh(dcfg, 2, 3)
    assert "\n" not in str(e.value) and str(rows[0]) in str(e.value)


# --- slow: the reference's writer and decoder ------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", list(SPECS))
def test_reference_writes_the_fixtures(tmp_path, name):
    """The reference's mesh writer on the CPU's 8 virtual devices gives
    each committed fixture byte for byte (with ROTATE_MESH_LEGACY=1 it
    rewrites it), and its sequential decoder the digests in SHA256SUMS —
    for route_drop_dp2tp4 the payload checksum error."""
    from fqsqueezer_tpu import pipeline as jp
    from fqsqueezer_tpu.io import fastq as jfastq
    from fqsqueezer_tpu.parallel import mesh_pipeline as jmesh

    paths = write_inputs(name, str(tmp_path))
    arc = str(tmp_path / f"{name}.fqst")
    write_archive(jmesh, jfastq, jp.interleave_pe, name, paths, arc)
    with open(arc, "rb") as f:
        blob = f.read()
    if os.environ.get("ROTATE_MESH_LEGACY") == "1":
        with open(fixture(name), "wb") as f:
            f.write(blob)
    with open(fixture(name), "rb") as g:
        assert blob == g.read()
    outs = [str(tmp_path / f"jax_{n}") for n in out_names(name)]
    if name == "route_drop_dp2tp4":
        with pytest.raises(ValueError, match=re.escape(DROP_ERROR)):
            jmesh.decompress_file_mesh_seq(_jparams().Params(), arc, *outs)
        return
    jmesh.decompress_file_mesh_seq(_jparams().Params(), arc, *outs)
    got = [_sha(o) for o in outs]
    print(name, got)
    assert got == [_sums()[n] for n in out_names(name)]
