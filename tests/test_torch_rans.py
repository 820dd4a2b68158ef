"""The port's rANS encode (ops/rans.py) against the reference package, exact.

The reference walk runs the way the reference's own tests run it on the CPU:
the lax.scan path of rans_encode / rans_encode_group, and the Pallas kernel
in interpret mode. The port's walk runs its plain torch version (CPU
tensors). Tolerance 0: the coder is integer-only. Also here: the plain
version of K1's reciprocal divide against //.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hst

from fqsqueezer_tpu.ops import rans as jrans
from fqsqueezer_tpu_torch.ops import rans
from fqsqueezer_tpu_torch.utils.rans_grids import adversarial_grid

SB = 14


def _grid(rng, T, N):
    """Random legit (freq, cum) grids with ~15% masked no-op slots (the
    generator of tests/test_rans_pallas.py)."""
    raw = rng.integers(1, 50, size=(T, N, 5)).astype(np.int64)
    cum = np.cumsum(raw, axis=-1)
    cdf = np.concatenate([np.zeros_like(cum[..., :1]), cum], axis=-1)
    cdf = (cdf << SB) // cum[..., -1:]
    syms = rng.integers(0, 5, size=(T, N))
    f = np.take_along_axis(cdf, syms[..., None] + 1, axis=-1)[..., 0] - \
        np.take_along_axis(cdf, syms[..., None], axis=-1)[..., 0]
    c = np.take_along_axis(cdf, syms[..., None], axis=-1)[..., 0]
    mask = rng.random((T, N)) < 0.85
    f = np.where(mask, f, 1 << SB)
    c = np.where(mask, c, 0)
    return f.astype(np.uint32), c.astype(np.uint32)


def _t32(a):
    return torch.from_numpy(a.astype(np.int32))


@pytest.mark.parametrize("T", [40, 256, 300])
def test_walk_matches_pallas_interpret(T):
    N = 256
    f, c = _grid(np.random.default_rng(11 + T), T, N)
    init = np.full((N,), jrans.RANS_L, np.uint32)
    wpl, epl, st = jrans._rans_encode_pallas(
        jnp.asarray(f), jnp.asarray(c), SB, jnp.asarray(init),
        interpret=True)
    before = rans.K1_LAUNCHES
    w, e, x = rans.rans_encode_walk(_t32(f), _t32(c), SB,
                                    torch.from_numpy(init.astype(np.int64)))
    assert rans.K1_LAUNCHES == before      # CPU tensors: the plain walk
    assert w.dtype == torch.int16 and e.dtype == torch.uint8
    np.testing.assert_array_equal(rans.words_to_i32(w).numpy(),
                                  np.asarray(wpl))
    np.testing.assert_array_equal(e.numpy(), np.asarray(epl))
    np.testing.assert_array_equal(x.numpy(), np.asarray(st))


@pytest.mark.parametrize("T,N,seed", [(40, 256, 1), (300, 256, 2),
                                      (97, 8, 3)])
def test_encode_matches_scan(T, N, seed):
    rng = np.random.default_rng(seed)
    f, c = _grid(rng, T, N)
    init = rng.integers(jrans.RANS_L, 1 << 32, size=N,
                        dtype=np.uint64).astype(np.uint32)
    w_ref, n_ref, st_ref = jrans.rans_encode(
        jnp.asarray(f), jnp.asarray(c), SB, jnp.asarray(init))
    w, n, st = rans.rans_encode(_t32(f), _t32(c), SB,
                                torch.from_numpy(init.astype(np.int64)))
    assert int(n) == int(n_ref)
    np.testing.assert_array_equal(w.numpy()[:int(n)],
                                  np.asarray(w_ref)[:int(n_ref)])
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_ref))


@pytest.mark.parametrize("N,bounds", [
    (8, [0, 37, 100, 180, 300]),
    (256, [0, 4, 8, 212]),
    (16, [0, 300]),
])
def test_group_matches_reference(N, bounds):
    """Ragged batch row bounds, padded no-op tail, unused bound entries."""
    T_real = bounds[-1]
    T = -(-T_real // jrans.GROUP_PAD_ROWS) * jrans.GROUP_PAD_ROWS
    f, c = _grid(np.random.default_rng(N + T_real), T, N)
    f[T_real:], c[T_real:] = 1 << SB, 0
    rb = np.full((jrans.GROUP_MAX_BATCHES + 1,), T_real, np.int32)
    rb[:len(bounds)] = bounds
    w_ref, n_ref, st_ref = jrans.rans_encode_group(
        jnp.asarray(f), jnp.asarray(c), SB, jnp.asarray(rb))
    w, n_per, st = rans.rans_encode_group(_t32(f), _t32(c), SB,
                                          torch.from_numpy(rb))
    np.testing.assert_array_equal(n_per.numpy(), np.asarray(n_ref))
    total = int(n_per.sum())
    np.testing.assert_array_equal(w.numpy()[:total],
                                  np.asarray(w_ref)[:total])
    np.testing.assert_array_equal(st.numpy(), np.asarray(st_ref))


def _bad_k1_args(case):
    f = torch.full((6, 8), 1 << SB, dtype=torch.int32)
    c = torch.zeros((6, 8), dtype=torch.int32)
    init = rans.rans_initial_states(8)
    return {"dtype": ([(f.long(), c)], SB, [init]),
            "shape": ([(f, c[:5])], SB, [init]),
            "contiguity": ([(f.t(), c.t())], SB, [init[:6]]),
            "init": ([(f, c)], SB, [init[:7]]),
            "scale_bits": ([(f, c)], 17, [init]),
            "second_grid": ([(f, c), (f, c.long())], SB, [init, init])}[case]


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "init",
                                  "scale_bits", "second_grid"])
def test_k1_wrapper_checks_before_launch(case):
    """K1's wrapper refuses what the kernel does not take, before it builds
    or launches anything."""
    before = rans.K1_LAUNCHES
    with pytest.raises(ValueError):
        rans._rans_encode_walks_cuda(*_bad_k1_args(case))
    assert rans.K1_LAUNCHES == before


def test_walk_has_no_fallback_for_other_devices():
    f = torch.full((3, 4), 1 << SB, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no walk for device"):
        rans.rans_encode_walk(f, torch.zeros_like(f), SB,
                              rans.rans_initial_states(4, "meta"))


def test_walk_preserves_noop_rows():
    """(f = 2^SB, c = 0) rows leave every state unchanged and emit nothing."""
    N = 8
    x0 = torch.tensor([1 << 16, (1 << 32) - 1, 12345678, 1 << 31,
                       99999, 1 << 20, 3 << 30, 70000], dtype=torch.int64)
    f = torch.full((5, N), 1 << SB, dtype=torch.int32)
    c = torch.zeros((5, N), dtype=torch.int32)
    _, e, x = rans.rans_encode_walk(f, c, SB, x0)
    assert not e.any()
    assert torch.equal(x, x0)


def _ragged_bounds(T_real, cuts):
    rb = np.full((jrans.GROUP_MAX_BATCHES + 1,), T_real, np.int32)
    rb[:len(cuts)] = cuts
    return rb


def test_walks_of_unequal_grids_equal_single_walks():
    """The multi-stream entry point on CPU tensors: per grid, the single
    walk's planes and states, from the given starting states."""
    rng = np.random.default_rng(21)
    grids, inits = [], []
    for T, N in ((5, 8), (130, 16), (64, 8), (1, 3)):
        f, c = _grid(rng, T, N)
        grids.append((_t32(f), _t32(c)))
        inits.append(torch.from_numpy(rng.integers(
            jrans.RANS_L, 1 << 32, size=N, dtype=np.uint64).astype(np.int64)))
    before = rans.K1_LAUNCHES
    multi = rans.rans_encode_walks(grids, SB, inits)
    assert rans.K1_LAUNCHES == before and len(multi) == len(grids)
    for (f, c), init, got in zip(grids, inits, multi):
        want = rans.rans_encode_walk(f, c, SB, init)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert rans.rans_encode_walks([], SB) == []


def test_groups_of_unequal_T_match_reference():
    """One flush's streams through rans_encode_groups against the reference
    rans_encode_group of each stream (its lax.scan walk): the T differ."""
    specs = [(8, [0, 3, 40]), (8, [0, 100, 101, 600]), (8, [0, 512])]
    grids, bounds, refs = [], [], []
    for i, (N, cuts) in enumerate(specs):
        T_real = cuts[-1]
        T = -(-T_real // jrans.GROUP_PAD_ROWS) * jrans.GROUP_PAD_ROWS
        f, c = _grid(np.random.default_rng(40 + i), T, N)
        f[T_real:], c[T_real:] = 1 << SB, 0
        rb = _ragged_bounds(T_real, cuts)
        grids.append((_t32(f), _t32(c)))
        bounds.append(torch.from_numpy(rb))
        refs.append(jrans.rans_encode_group(
            jnp.asarray(f), jnp.asarray(c), SB, jnp.asarray(rb)))
    assert len({g[0].shape[0] for g in grids}) > 1
    for (w, n_per, st), (w_ref, n_ref, st_ref) in zip(
            rans.rans_encode_groups(grids, SB, bounds), refs):
        np.testing.assert_array_equal(n_per.numpy(), np.asarray(n_ref))
        total = int(n_per.sum())
        assert w.numel() == total
        np.testing.assert_array_equal(w.numpy(), np.asarray(w_ref)[:total])
        np.testing.assert_array_equal(st.numpy(), np.asarray(st_ref))


def test_reciprocal_divide_on_adversarial_values():
    """K1's divide (multiply by floor((2^32-1)/f), one correction) equals //
    at the edges: f in {1, 2, 3, 2^SB - 1, 2^SB, 2^16}, x at 0, 2^16,
    2^32 - 1, around every multiple boundary it can reach and around the
    emit threshold f << (32 - SB)."""
    top = 1 << SB
    fs = [1, 2, 3, 5, 7, top - 1, top, (1 << 16) - 1, 1 << 16]
    xs = {0, 1, 1 << 16, (1 << 32) - 1, (1 << 32) - 2, 1 << 31}
    for f in fs:
        for k in (1, 2, (1 << 32) // f - 1, (1 << 32) // f):
            xs.update({k * f - 1, k * f, k * f + 1})
        xs.update({(f << (32 - SB)) - 1, f << (32 - SB), (f << (32 - SB)) + 1})
    xs = sorted(x for x in xs if 0 <= x < 1 << 32)
    x = torch.tensor(xs, dtype=torch.int64)[:, None]
    f = torch.tensor(fs, dtype=torch.int64)[None, :]
    m = rans.reciprocal_u32(f)
    assert int(m.max()) < 1 << 32 and int(m[0, 0]) == (1 << 32) - 1
    q1 = rans.umulhi32(x, m)
    assert bool(((x // f - q1) >= 0).all()) and bool(((x // f - q1) <= 1).all())
    assert torch.equal(rans.div_by_reciprocal(x, f), x // f)
    # the grid chip_smoke.py gives the kernel: every state against its row
    fa, _, ia = adversarial_grid(7, 300, 256, SB)
    fa, ia = torch.from_numpy(fa).long(), torch.from_numpy(ia)
    assert torch.equal(rans.div_by_reciprocal(ia[None, :], fa),
                       ia[None, :] // fa)


@settings(max_examples=300, deadline=None, database=None)
@given(hst.lists(hst.tuples(hst.integers(0, (1 << 32) - 1),
                           hst.integers(1, 1 << 14)),
                min_size=1, max_size=64))
def test_reciprocal_divide_sweep(pairs):
    x = torch.tensor([p[0] for p in pairs], dtype=torch.int64)
    f = torch.tensor([p[1] for p in pairs], dtype=torch.int64)
    assert torch.equal(rans.umulhi32(x, f), (x * f) >> 32)
    assert torch.equal(rans.div_by_reciprocal(x, f), x // f)
