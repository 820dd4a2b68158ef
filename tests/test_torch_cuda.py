"""Kernels K1, K3, K2, K4 and K5 on a CUDA card: each launches, equals its
plain torch version exactly (K2 with its row's table update and the
in-batch local statistics, K3 with the in-batch deltas, K4 under both id
codecs), and refuses what it does not take instead of falling back. Imports
no JAX and nothing of the reference package, so it runs on a machine with a
card and neither of them:

    python -m pytest tests/test_torch_cuda.py -q

Without a card every test skips (the kernel has no CPU mode)."""
import types

import pytest
import torch

from fqsqueezer_tpu_torch.ops import rans
from fqsqueezer_tpu_torch.utils.rans_grids import (adversarial_grid,
                                                   random_grid)

SB = 14


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel K1 has no CPU mode)")


def _grid(seed, T, N):
    return tuple(torch.from_numpy(a) for a in random_grid(seed, T, N, SB))


def _same(got, want):
    return all(g.device.type == "cuda" and g.dtype == w.dtype
               and torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("T,N", [(40, 256), (300, 256), (97, 8), (1, 3),
                                 (65, 100), (64, 32), (200, 37)])
def test_k1_equals_plain_walk(T, N):
    _card()
    f, c = (t.cuda() for t in _grid(T + N, T, N))
    init = rans.rans_initial_states(N, "cuda")
    before = rans.K1_LAUNCHES
    got = rans.rans_encode_walk(f, c, SB, init)
    assert rans.K1_LAUNCHES == before + 1
    assert _same(got, rans.rans_encode_walk_plain(f, c, SB, init))


@pytest.mark.cuda
def test_k1_equals_plain_walk_on_adversarial_grid():
    """Edge freqs (1, 2, 3, 2^SB - 1, the no-op 2^SB) and edge starting
    states (2^16, 2^32 - 1, around the emit threshold)."""
    _card()
    f, c, init = (torch.from_numpy(a).cuda()
                  for a in adversarial_grid(7, 300, 256, SB))
    assert _same(rans.rans_encode_walk(f, c, SB, init),
                 rans.rans_encode_walk_plain(f, c, SB, init))


@pytest.mark.cuda
def test_k1_multi_stream_launch_equals_single_walks():
    """Grids of unequal T and N in one launch."""
    _card()
    shapes = [(512, 64), (130, 256), (1, 3), (300, 37), (0, 8)]
    grids = [tuple(t.cuda() for t in _grid(i, T, N))
             for i, (T, N) in enumerate(shapes)]
    inits = [torch.randint(1 << 16, 1 << 32, (N,), device="cuda")
             for _, N in shapes]
    before = rans.K1_LAUNCHES
    multi = rans.rans_encode_walks(grids, SB, inits)
    assert rans.K1_LAUNCHES == before + 1
    for (f, c), init, got in zip(grids, inits, multi):
        assert _same(got, rans.rans_encode_walk(f, c, SB, init))
        assert _same(got, rans.rans_encode_walk_plain(f, c, SB, init))


@pytest.mark.cuda
def test_k1_group_encode_equals_cpu_path():
    _card()
    T, N = 600, 64
    f, c = _grid(3, T, N)
    rb = torch.full((rans.GROUP_MAX_BATCHES + 1,), T, dtype=torch.int64)
    rb[:4] = torch.tensor([0, 150, 151, 420])
    got = rans.rans_encode_group(f.cuda(), c.cuda(), SB, rb.cuda())
    want = rans.rans_encode_group(f, c, SB, rb)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_k1_refuses_instead_of_falling_back():
    _card()
    f, c = (t.cuda() for t in _grid(5, 16, 8))
    init = rans.rans_initial_states(8, "cuda")
    before = rans.K1_LAUNCHES
    for args in ((f.long(), c.long(), SB, init),          # wrong dtype
                 (f.t(), c.t(), SB, init[:16].repeat(2)),  # not contiguous
                 (f, c, SB, init.cpu())):                  # wrong device
        with pytest.raises(ValueError):
            rans.rans_encode_walk(*args)
    with pytest.raises(ValueError):          # more grids than a launch takes
        rans.rans_encode_walks([(f, c)] * (rans.K1_MAX_STREAMS + 1), SB)
    assert rans.K1_LAUNCHES == before


# --- K3: the quality decode scan ----------------------------------------------

def _k3_inputs(seed, N, r_pl, L, n_words, mode="illumina_8"):
    from fqsqueezer_tpu_torch.streams import quality
    from fqsqueezer_tpu_torch.utils.rans_grids import quality_batch

    cfg = quality.QualConfig(mode=mode, n_lanes=N)
    arrs = quality_batch(seed, N, r_pl, L, cfg.n_ctx, cfg.n_sym, n_words)
    return cfg, [torch.from_numpy(a).cuda() for a in arrs]


# the last two: the main path's batch (2048 lanes, 2 rows) and sorted
# order's (1024 lanes, 4 rows)
K3_CASES = [(8, 1, 40, 400), (8, 2, 104, 5), (100, 2, 40, 8000),
            (256, 1, 104, 30), (1024, 2, 40, 90_000), (2048, 2, 104, 400_000),
            (2047, 1, 1, 10), (1024, 4, 104, 400_000)]


@pytest.mark.cuda
@pytest.mark.parametrize("N,r_pl,L,n_words", K3_CASES)
def test_k3_equals_plain_scan(N, r_pl, L, n_words, mode="illumina_8"):
    """Symbols, final states and words consumed, exactly; lengths 0, 1 and
    L among them, and short word arrays whose reads clamp."""
    from fqsqueezer_tpu_torch.streams import quality

    _card()
    cfg, (model, lengths, words, init) = _k3_inputs(N + L, N, r_pl, L,
                                                    n_words, mode)
    before = quality.K3_LAUNCHES
    got = quality.qual_decode_scan(cfg, model, lengths, words, init, L)
    assert quality.K3_LAUNCHES == before + 1
    want = quality.qual_decode_scan_plain(cfg, model, lengths, words, init,
                                          L)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["binary", "illumina_4", "lossless"])
@pytest.mark.parametrize("N,r_pl,L,n_words", K3_CASES)
def test_k3_equals_plain_scan_other_modes(N, r_pl, L, n_words, mode):
    """The same cases with 2-, 4- and 96-symbol models."""
    test_k3_equals_plain_scan(N, r_pl, L, n_words, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["binary", "illumina_4", "illumina_8",
                                  "lossless"])
@pytest.mark.parametrize("N,r_pl,L,n_words", [K3_CASES[k]
                                              for k in (0, 2, 5, 7)])
def test_k3_with_deltas_equals_plain_scan(N, r_pl, L, n_words, mode):
    """K3's delta instantiation (QualConfig.with_local): the in-batch
    deltas read beside the model, each row's events added with atomics at
    its end; symbols, states and words consumed, exactly, in one launch."""
    import dataclasses

    from fqsqueezer_tpu_torch.streams import quality

    _card()
    cfg, (model, lengths, words, init) = _k3_inputs(N + L + 3, N, r_pl, L,
                                                    n_words, mode)
    cfg = dataclasses.replace(cfg, with_local=True)
    before = quality.K3_LAUNCHES
    got = quality.qual_decode_scan(cfg, model, lengths, words, init, L)
    assert quality.K3_LAUNCHES == before + 1
    want = quality.qual_decode_scan_plain(cfg, model, lengths, words, init,
                                          L)
    torch.cuda.synchronize()
    assert _same(got, want)


@pytest.mark.cuda
def test_k3_refuses_instead_of_falling_back():
    from fqsqueezer_tpu_torch.streams import quality

    _card()
    cfg, (model, lengths, words, init) = _k3_inputs(1, 8, 2, 16, 50)
    before = quality.K3_LAUNCHES
    for args in ((model.long(), lengths, words, init),      # wrong dtype
                 (model, lengths.long(), words, init),
                 (model, lengths, words[:0], init),          # no words
                 (model, lengths, words.cpu(), init),        # wrong device
                 (model, lengths[:7], words, init),          # R % N != 0
                 (model.t(), lengths, words, init)):         # wrong shape
        with pytest.raises(ValueError):
            quality.qual_decode_scan(cfg, *args, 16)
    unaligned = torch.empty(model.numel() + 1, dtype=torch.int32,
                            device="cuda")[1:].view(model.shape)
    with pytest.raises(ValueError):                # 4-byte aligned rows
        quality.qual_decode_scan(cfg, unaligned, lengths, words, init, 16)
    # a symbol count K3 does not take (16), in a config of the same layout
    odd = types.SimpleNamespace(**{
        k: getattr(cfg, k) for k in ("mode", "qt", "scale_bits", "n_lanes",
                                     "with_local", "hist_bits", "n_hist",
                                     "hist_mask", "n_ctx")}, n_sym=16)
    with pytest.raises(ValueError, match="16-symbol"):
        quality.qual_decode_scan(
            odd, torch.zeros((cfg.n_ctx, 16), dtype=torch.int32,
                             device="cuda"), lengths, words, init, 16)
    big = quality.QualConfig(n_lanes=4096)
    with pytest.raises(ValueError):
        quality.qual_decode_scan(
            big, model, lengths.repeat(512), words,
            init.repeat(512), 16)
    assert quality.K3_LAUNCHES == before


# --- K2: the DNA decode scan, one launch a read row ---------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("N,r_pl,L,grow,short", [
    (8, 2, 104, False, False), (8, 1, 20, False, False), (8, 2, 40, True, True),
    (256, 2, 104, True, False), (256, 1, 40, False, True),
    (2048, 2, 104, False, False), (2048, 1, 104, True, True)])
def test_k2_equals_plain_row_scan(N, r_pl, L, grow, short):
    """The four planes, final states, words consumed, carried registers and
    both updated s/b tables of every row, exactly, against
    dna_decode_row_plain (the scan, then _apply_sb_updates), on encoded
    batches whose lengths include 0, 1 and L; grown s/b tables; word
    streams cut short (reads past the end clamp, so K2 and the plain scan
    decode the same wrong bases)."""
    from fqsqueezer_tpu_torch.tools.k2_compare import check_rows
    from fqsqueezer_tpu_torch.utils.dna_batches import dna_decode_inputs

    _card()
    batch = dna_decode_inputs(N + L, N, r_pl, L, "cuda", grow, short)
    assert len(check_rows(*batch, L)) == r_pl


@pytest.mark.cuda
@pytest.mark.parametrize("sorted_reads", [False, True])
@pytest.mark.parametrize("gen", ["H1", "H2", "H4"])
def test_k2_with_local_statistics_equals_plain_row_scan(gen, sorted_reads):
    """K2's local-statistics instantiations (H1: local_* cells and the DNA
    deltas; H2: local_* cells; H4: klocal_* cells beside ktable ones), in
    original and sorted order: every row against the plain row step on
    the local state the rows before it left, exactly."""
    import dataclasses

    from fqsqueezer_tpu_torch.tools.k2_compare import check_rows
    from fqsqueezer_tpu_torch.utils.dna_batches import (dna_decode_inputs,
                                                         legacy_dna_config)

    _card()
    cfg = dataclasses.replace(legacy_dna_config(gen, 256),
                              smer_log2_buckets=12, bmer_log2_buckets=12,
                              local_log2_cells=14)
    out = dna_decode_inputs(int(gen[1]) + sorted_reads, 256, 3, 104, "cuda",
                            sorted_reads=sorted_reads, cfg=cfg)
    rows = check_rows(*out[:5], 104, *out[5:])
    assert len(rows) == 3 and all(a[10] is not None for a, _ in rows)


@pytest.mark.cuda
@pytest.mark.parametrize("N,r_pl,L", [(8, 3, 40), (256, 2, 104),
                                      (1024, 4, 104), (2048, 2, 264)])
def test_k2_with_lcp_equals_plain_row_scan(N, r_pl, L):
    """Sorted order: each row copies the prefix it shares with the previous
    read row (lcp from 0 to the whole read, a duplicate lane, the cap of
    255 on reads of 264); the four planes at every position, copied ones
    included, the states, words, registers and both tables, exactly."""
    from fqsqueezer_tpu_torch.tools.k2_compare import check_rows
    from fqsqueezer_tpu_torch.utils.dna_batches import dna_decode_inputs

    _card()
    cfg, state, lengths, words, init, lcp = dna_decode_inputs(
        N + L + 1, N, r_pl, L, "cuda", sorted_reads=True)
    assert (lcp == torch.minimum(lengths, torch.full_like(lengths, 255))
            ).any() and ((lcp > 0) & (lcp < lengths)).any()
    assert len(check_rows(cfg, state, lengths, words, init, L, lcp)) == r_pl


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sorted", "pe", "canon0"])
def test_k2_position_maps_and_table_rows_equal_plain_row_scan(kind):
    """The header knobs: the sorted-mode position map on sorted rows
    (dna_sorted_ctx), the paired-end map on rowA and rowB
    (dna_pe_pos_ctx), and row-global context-keyed table cells (dna_canon
    0 with dna_row_global 1: K2, then the row's table update as torch
    ops, in place); every row exactly against the plain row step, both
    tables included, and each row takes its map."""
    import dataclasses

    from fqsqueezer_tpu_torch.tools.k2_compare import (check_rows,
                                                       check_spec_rows)
    from fqsqueezer_tpu_torch.utils import dna_batches as db

    _card()
    if kind == "pe":
        cfg, state, specs, words, init, _ = db.pe_row_inputs(
            7, 256, 2, 104, "cuda", pe_pos_ctx=True)
        rows = check_spec_rows(cfg, state, specs, words, init, 104)
        assert [a[11] is not None for a, _ in rows] == [
            k % 3 != 0 for k in range(len(rows))]
        return
    cfg = dataclasses.replace(db.bench_dna_config(256),
                              smer_log2_buckets=db.LOG2_BUCKETS,
                              bmer_log2_buckets=db.LOG2_BUCKETS)
    cfg = (dataclasses.replace(cfg, sorted_ctx=True) if kind == "sorted"
           else dataclasses.replace(cfg, canon=False, sb_proto=0, rough=0))
    *batch, lcp = db.dna_decode_inputs(9, 256, 3, 104, "cuda",
                                       sorted_reads=True, cfg=cfg)
    rows = check_rows(*batch, 104, lcp)
    assert all((a[11] is not None) == (kind == "sorted") for a, _ in rows)


@pytest.mark.cuda
@pytest.mark.parametrize("N,r_pl,L", [(8, 5, 40), (8, 5, 104),
                                      (1024, 2, 104)])
def test_k2_on_anchored_rows_equals_plain_row_scan(N, r_pl, L):
    """Paired-end: rowA and rowB copy their anchor's B bases (rows with
    and without an anchor, anchors at read2's start and end, empty rowBs,
    read2 shorter than B) through the prefix copy; every row exactly
    against the plain row step, and the decode gives the encoded rows."""
    from fqsqueezer_tpu_torch.tools.k2_compare import check_spec_rows
    from fqsqueezer_tpu_torch.utils.dna_batches import pe_row_inputs

    _card()
    cfg, state, specs, words, init, bases = pe_row_inputs(
        N + L + 2, N, r_pl, L, "cuda")
    rows = check_spec_rows(cfg, state, specs, words, init, L)
    assert len(rows) == 3 * r_pl
    # some anchored lanes copy their whole row (read2 shorter than B, or
    # an anchor at read2's end: rowA is the anchor alone)
    assert any(lcp is not None and bool(((lcp > 0) & (lcp == length)).any())
               for length, lcp, _, _ in specs)
    for (_, plain), want in zip(rows, bases):
        assert torch.equal(plain[0][0], want)


def _update_cases(cfg, tc, kcodes, length, k: int, log2_base: int) -> dict:
    """How often each hard case of the row update (tables.k2_update) occurs
    among one row's width-k insert events (dna.sb_canon_events of its kc
    plane [N, L] and lengths [N]) against the row-start table tc: events
    of a key that the row holds more than once ("duplicate"), found keys
    whose count is 255 ("count_255"), new keys whose bucket is full
    ("full_bucket"), and cells that two or more different new keys pick
    ("race")."""
    from fqsqueezer_tpu_torch.ops import tables
    from fqsqueezer_tpu_torch.streams import dna

    pos = torch.arange(kcodes.shape[1], device=kcodes.device)[None, :]
    bkt, tag, valid = dna.sb_canon_events(cfg, kcodes, pos < length[:, None],
                                          k, log2_base)
    bkt, tag = bkt[valid], tag[valid]
    rows = tables.kbucket_of(tag, bkt, tc.shape[0].bit_length() - 1,
                             log2_base)
    row = tc[rows]
    tw = tables.k2tag(tag) << 8
    match = (row & 0xFFFFFF00) == tw[:, None]
    found = match.any(dim=1)
    cellv = torch.where(match, row, 0).sum(dim=1) & 0xFFFFFFFF
    empty = row == tables.EMPTY
    key = rows * (1 << 32) + tw
    _, inv, n_key = torch.unique(key, return_inverse=True, return_counts=True)
    # the cell each new key picks (k2_update's rotation of the empty mask)
    bm = (empty.to(torch.int64) << torch.arange(4, device=tc.device)).sum(1)
    j = ((tag >> 13) ^ tag) & 3
    rot = ((bm >> j) | (bm << (4 - j))) & 0xF
    first = torch.tensor([0, 0, 1, 0, 2, 0, 1, 0, 3, 0, 1, 0, 2, 0, 1, 0],
                         device=tc.device)[rot]
    new = ~found & (bm > 0)
    picks = torch.unique(torch.stack([rows * 4 + ((j + first) & 3), tw],
                                     dim=1)[new], dim=0)
    _, n_pick = torch.unique(picks[:, 0], return_counts=True)
    return {"duplicate": int((n_key[inv] > 1).sum()),
            "count_255": int((found & ((cellv & 0xFF) == 0xFF)).sum()),
            "full_bucket": int((~found & (bm == 0)).sum()),
            "race": int((n_pick > 1).sum())}


@pytest.mark.cuda
def test_k2_row_update_on_adversarial_tables():
    """The row update's hard cases, each present in the batch's events:
    keys the row holds more than once, found keys at count 255, new keys
    whose row-start bucket is full, and different new keys that pick one
    empty cell; K2's tables equal k2_update's exactly."""
    from fqsqueezer_tpu_torch.tools.k2_compare import check_rows
    from fqsqueezer_tpu_torch.utils.dna_batches import dna_decode_inputs

    _card()
    cfg, state, lengths, words, init = dna_decode_inputs(
        11, 256, 2, 104, "cuda", adversarial=True)
    rows = check_rows(cfg, state, lengths, words, init, 104)
    seen = dict.fromkeys(("duplicate", "count_255", "full_bucket", "race"),
                         0)
    for (_, st, length, *_), want in rows:
        kc = want[0][1]
        for tc, k, log2b in ((st.s_tc, cfg.smer_len, cfg.smer_log2_buckets),
                             (st.b_tc, cfg.bmer_len, cfg.bmer_log2_buckets)):
            for case, n in _update_cases(cfg, tc, kc, length, k,
                                         log2b).items():
                seen[case] += n
    assert all(n > 0 for n in seen.values()), seen


@pytest.mark.cuda
def test_k2_batch_launches_once_a_row_and_never_the_plain_scan(monkeypatch):
    """dna_decode_batch on CUDA tensors: one K2 launch a read row, no plain
    row scan, and the same codes, state and extras as the batch decoded
    through the plain row scan on the same card."""
    from fqsqueezer_tpu_torch.streams import dna
    from fqsqueezer_tpu_torch.utils.dna_batches import dna_decode_inputs

    _card()
    cfg, state, lengths, words, init = dna_decode_inputs(5, 256, 2, 104,
                                                         "cuda")
    plain = dna.dna_decode_row_plain

    def refuse(*a, **k):
        raise AssertionError("the plain row scan ran on CUDA tensors")

    monkeypatch.setattr(dna, "dna_decode_row_plain", refuse)
    before = dna.K2_LAUNCHES
    # K2 updates the tables in place: it gets copies
    got = dna.dna_decode_batch(
        cfg, state._replace(s_tc=state.s_tc.clone(), b_tc=state.b_tc.clone()),
        lengths, words, init, 104)
    assert dna.K2_LAUNCHES == before + 2
    monkeypatch.setattr(dna, "dna_decode_row", plain)
    want = dna.dna_decode_batch(cfg, state, lengths, words, init, 104)
    assert dna.K2_LAUNCHES == before + 2
    codes, st, x, ptr, extras = got
    wcodes, wst, wx, wptr, wextras = want
    for g, w in zip((codes, x, ptr, *extras, st.siv, st.s_tc, st.b_tc,
                     st.model),
                    (wcodes, wx, wptr, *wextras, wst.siv, wst.s_tc, wst.b_tc,
                     wst.model)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_k2_batch_runs_no_torch_table_update(monkeypatch):
    """On the card the row's s/b table update is K2's: dna_decode_batch
    calls neither _apply_sb_updates nor the table module's k2_update, and
    its state holds the tables K2 updated in place."""
    from fqsqueezer_tpu_torch.ops import tables
    from fqsqueezer_tpu_torch.streams import dna
    from fqsqueezer_tpu_torch.utils.dna_batches import dna_decode_inputs

    _card()
    cfg, state, lengths, words, init = dna_decode_inputs(7, 256, 2, 104,
                                                         "cuda")

    def refuse(*a, **k):
        raise AssertionError("a torch table update ran on CUDA tensors")

    for mod, name in ((dna, "_apply_sb_updates"), (tables, "k2_update"),
                      (tables, "ktable_update")):
        monkeypatch.setattr(mod, name, refuse)
    s_tc, b_tc = state.s_tc, state.b_tc
    before = (s_tc.clone(), b_tc.clone())
    _, st, *_ = dna.dna_decode_batch(cfg, state, lengths, words, init, 104)
    assert st.s_tc is s_tc and st.b_tc is b_tc
    assert not torch.equal(s_tc, before[0])
    assert not torch.equal(b_tc, before[1])


@pytest.mark.cuda
def test_k2_refuses_instead_of_falling_back():
    import dataclasses

    from fqsqueezer_tpu_torch.ops import tables
    from fqsqueezer_tpu_torch.streams import dna
    from fqsqueezer_tpu_torch.utils.dna_batches import dna_decode_inputs

    _card()
    cfg, st, lengths, words, init = dna_decode_inputs(1, 8, 1, 24, "cuda")
    ptr = torch.zeros((), dtype=torch.int64, device="cuda")
    regs = torch.zeros((dna.K2_NREGS, 8), dtype=torch.int64, device="cuda")
    good = (cfg, st, lengths, words, init, ptr, regs, 24)
    before = dna.K2_LAUNCHES
    dna.dna_decode_row(*good)
    assert dna.K2_LAUNCHES == before + 1

    def bad(k, v):
        a = list(good)
        a[k] = v
        return a

    rows = st.s_tc.shape[0]
    unaligned = torch.empty(rows * 4 + 1, dtype=torch.int64,
                            device="cuda")[1:].view(rows, 4)
    for args in (bad(3, words.long()),                  # wrong dtype
                 bad(2, lengths.int()),
                 bad(4, init.cpu()),                    # wrong device
                 bad(6, regs[:, :7]),                   # wrong shape
                 bad(6, regs.t().contiguous().t()),     # not contiguous
                 bad(5, ptr.reshape(1)),
                 bad(7, 0),                             # no positions
                 bad(3, words[:0]),                     # no words
                 bad(1, st._replace(model=st.model[:-1])),
                 bad(1, st._replace(siv=st.siv.int())),
                 bad(1, st._replace(s_tc=unaligned)),   # 8-byte aligned rows
                 bad(1, st._replace(b_tc=st.b_tc[:3])),  # not 2^k rows
                 bad(1, st._replace(b_tc=st.s_tc)),     # the tables overlap
                 bad(0, dataclasses.replace(cfg, n_lanes=4096))):
        with pytest.raises(ValueError):
            dna.dna_decode_row(*args)
    with pytest.raises(ValueError):          # another table backend
        dna.dna_decode_row(*good, be=tables.LocalBackend())
    with pytest.raises(ValueError):  # a position map without a prefix copy
        dna.dna_decode_row(*bad(0, dataclasses.replace(cfg,
                                                       sorted_ctx=True)),
                           pos=dna.PosMap(1, lengths))
    with pytest.raises(ValueError):     # tables of another family's width
        dna.dna_decode_row(*bad(1, st._replace(
            s_tc=torch.zeros((rows, tables.KW), dtype=torch.int64,
                             device="cuda"),
            b_tc=torch.zeros((rows, tables.KW), dtype=torch.int64,
                             device="cuda"))))
    lcp = torch.zeros(8, dtype=torch.int64, device="cuda")
    src = torch.zeros((8, 24), dtype=torch.int64, device="cuda")
    dna.dna_decode_row(*good, lcp=lcp, src=src)
    assert dna.K2_LAUNCHES == before + 2
    for lcp_src in ((lcp, None), (None, src),             # one without other
                    (lcp.int(), src), (lcp, src[:, :23]),  # dtype, shape
                    (lcp, src.cpu()),                      # device
                    (lengths + 1, src), (lcp - 1, src)):   # outside 0..length
        with pytest.raises(ValueError):
            dna.dna_decode_row(*good, *lcp_src)
    assert dna.K2_LAUNCHES == before + 2


# --- K4 and K5: the id and meta decode scans ----------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 256, 1024, 2048])
@pytest.mark.parametrize("codec_v,n_pad,short", [(2, 0, False),
                                                 (2, 37, False),
                                                 (1, 0, False),
                                                 (1, 37, False),
                                                 (2, 11, True)])
def test_k4_equals_plain_scan(N, codec_v, n_pad, short):
    """The grid, final states and words consumed, exactly, on encoded id
    batches (utils/id_batches: F = 12 fields, escapes of up to M = 40 raw
    bytes; models whose flag and delta rows are mostly zero-width steps,
    a quarter of the rows all zero): both codecs, with padding rows (v2
    codes nothing there, v1 codes them), and with the words cut short so
    that reads past the end clamp."""
    from fqsqueezer_tpu_torch.streams import ids
    from fqsqueezer_tpu_torch.utils.id_batches import id_scan_inputs

    _card()
    cfg, table, R, words, init, nv = id_scan_inputs(
        N + codec_v + n_pad, N, 2, 12, 40, codec_v=codec_v,
        n_pad=min(n_pad, 2 * N - 1), device="cuda", short=short)
    before = ids.K4_LAUNCHES
    got = ids.id_decode_scan(cfg, table, R, words, init, nv)
    assert ids.K4_LAUNCHES == before + 1
    want = ids.id_decode_scan_plain(cfg, table, R, words, init, nv)
    torch.cuda.synchronize()
    assert _same(got, want)


@pytest.mark.cuda
def test_k4_equals_plain_scan_on_long_ids():
    """A long raw-byte tail (M = 300: lengths take both bytes) at the main
    path's 2048 lanes."""
    from fqsqueezer_tpu_torch.streams import ids
    from fqsqueezer_tpu_torch.utils.id_batches import id_scan_inputs

    _card()
    cfg, table, R, words, init, nv = id_scan_inputs(3, 2048, 2, 12, 300,
                                                    n_pad=100,
                                                    device="cuda")
    got = ids.id_decode_scan(cfg, table, R, words, init, nv)
    want = ids.id_decode_scan_plain(cfg, table, R, words, init, nv)
    torch.cuda.synchronize()
    assert _same(got, want)
    assert (got[0][:, 62] > 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("N,r_pl", [(8, 3), (1024, 4), (2048, 2)])
@pytest.mark.parametrize("with_lcp", [False, True])
def test_k5_equals_plain_scan(N, r_pl, with_lcp):
    """W = 2 (lengths) and 3 (with the LCP): symbols, states and words
    consumed, exactly, and short words."""
    from fqsqueezer_tpu_torch.streams import meta
    from fqsqueezer_tpu_torch.utils.id_batches import meta_scan_inputs

    _card()
    for short in (False, True):
        cfg, table, R, words, init = meta_scan_inputs(
            N + r_pl + short, N, r_pl, with_lcp, device="cuda", short=short)
        before = meta.K5_LAUNCHES
        got = meta.meta_decode_scan(cfg, table, R, words, init)
        assert meta.K5_LAUNCHES == before + 1
        want = meta.meta_decode_scan_plain(cfg, table, R, words, init)
        torch.cuda.synchronize()
        assert _same(got, want)


@pytest.mark.cuda
def test_k4_k5_refuse_instead_of_falling_back():
    import dataclasses

    from fqsqueezer_tpu_torch.streams import ids, meta
    from fqsqueezer_tpu_torch.utils.id_batches import (id_scan_inputs,
                                                       meta_scan_inputs)

    _card()
    cfg, table, R, words, init, nv = id_scan_inputs(1, 8, 2, 3, 20,
                                                    device="cuda")
    before = ids.K4_LAUNCHES
    for args in ((cfg, table.long(), R, words, init),      # wrong dtype
                 (cfg, table, R, words.long(), init),
                 (cfg, table, R, words[:0], init),          # no words
                 (cfg, table, R, words.cpu(), init),        # wrong device
                 (cfg, table, R - 1, words, init),          # R % N != 0
                 (cfg, table[:-1], R, words, init),         # wrong shape
                 (dataclasses.replace(cfg, n_lanes=4096), table, 4096,
                  words, init.repeat(512)),
                 (dataclasses.replace(cfg, n_fields=13), table, R, words,
                  init)):
        with pytest.raises(ValueError):
            ids.id_decode_scan(*args, nv)
    assert ids.K4_LAUNCHES == before
    mcfg, mtable, mR, mwords, minit = meta_scan_inputs(1, 8, 2, True,
                                                       device="cuda")
    before = meta.K5_LAUNCHES
    for args in ((mcfg, mtable.long(), mR, mwords, minit),
                 (mcfg, mtable, mR, mwords[:0], minit),
                 (mcfg, mtable, mR, mwords, minit.cpu()),
                 (mcfg, mtable[:2].contiguous(), mR, mwords, minit),
                 (mcfg, mtable, mR + 1, mwords, minit)):
        with pytest.raises(ValueError):
            meta.meta_decode_scan(*args)
    assert meta.K5_LAUNCHES == before


@pytest.mark.cuda
def test_decode_batches_launch_k4_and_k5_once_and_never_the_plain_scans(
        monkeypatch):
    """id_decode_batch and meta_decode_batch on CUDA tensors: one K4 and
    one K5 launch, no plain scan, and the same outputs as the batches
    decoded through the plain scans on the same card."""
    from fqsqueezer_tpu_torch.streams import ids, meta
    from fqsqueezer_tpu_torch.utils.id_batches import (id_scan_inputs,
                                                       meta_scan_inputs)

    _card()
    cfg, table, R, words, init, nv = id_scan_inputs(5, 256, 2, 4, 24,
                                                    n_pad=9, device="cuda")
    mcfg, mtable, mR, mwords, minit = meta_scan_inputs(5, 256, 2, True,
                                                       device="cuda")
    # counts only on the symbols each context codes, as a real stream
    # leaves them: the decoded delta symbols stay in 0..8
    id_model = torch.randint(0, 30, (ids.N_CTX, ids.N_SYM),
                             dtype=torch.int32, device="cuda") * \
        torch.from_numpy(ids._alpha_lut_np()).cuda()
    m_model = torch.randint(0, 30, (meta.N_CTX, meta.N_SYM),
                            dtype=torch.int32, device="cuda")
    plain = ids.id_decode_scan_plain, meta.meta_decode_scan_plain

    def refuse(*a, **k):
        raise AssertionError("a plain scan ran on CUDA tensors")

    monkeypatch.setattr(ids, "id_decode_scan_plain", refuse)
    monkeypatch.setattr(meta, "meta_decode_scan_plain", refuse)
    k4, k5 = ids.K4_LAUNCHES, meta.K5_LAUNCHES
    got_i = ids.id_decode_batch(cfg, id_model, R, words, init, nv)
    got_m = meta.meta_decode_batch(mcfg, m_model, mR, mwords, minit)
    assert (ids.K4_LAUNCHES, meta.K5_LAUNCHES) == (k4 + 1, k5 + 1)
    monkeypatch.setattr(ids, "id_decode_scan", lambda *a: plain[0](*a))
    monkeypatch.setattr(meta, "meta_decode_scan", lambda *a: plain[1](*a))
    want_i = ids.id_decode_batch(cfg, id_model, R, words, init, nv)
    want_m = meta.meta_decode_batch(mcfg, m_model, mR, mwords, minit)
    assert (ids.K4_LAUNCHES, meta.K5_LAUNCHES) == (k4 + 1, k5 + 1)
    assert _same(got_i, want_i) and _same(got_m, want_m)
