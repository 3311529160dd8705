"""qtesla_tpu_torch twiddle tables and plain transforms against the JAX
package.

- tables: ``get_tables(name)`` (built from qtesla_tpu.params) equals
  ``from_jax_tables(qtesla_tpu.ops.tables.get_tables(name))`` and the JAX
  stage arrays and (L, n) per-lane tables, and the compact kernel rows are
  the merged-psi tables.
- transforms: ``ntt_fwd_merged``, ``intt_inv_merged`` and ``pointwise_mul``
  equal the JAX jnp functions on the same numpy inputs.

Tolerance: none (integer equality)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtesla_tpu.ops import ntt as JN
from qtesla_tpu.ops import tables as JT
from qtesla_tpu.params import get_params
from qtesla_tpu_torch.ops import ntt as TN
from qtesla_tpu_torch.ops.tables import from_jax_tables, get_tables

SETS = ["smallprime", "qtesla-i", "qtesla-iii-speed",
        pytest.param("qtesla-p-i", marks=pytest.mark.slow),
        pytest.param("qtesla-p-iii", marks=pytest.mark.slow)]


def _pairs_equal(got, want):
    assert len(got) == len(want)
    for (gw, gs), (ww, ws) in zip(got, want):
        assert gw.dtype == np.uint32 and gs.dtype == np.uint32
        np.testing.assert_array_equal(gw, ww)
        np.testing.assert_array_equal(gs, ws)


@pytest.mark.parametrize("name", SETS)
def test_tables_match_jax(name):
    mine = get_tables(name)
    jtbl = JT.get_tables(name)
    via_jax = from_jax_tables(jtbl)
    for t in (mine, via_jax):
        _pairs_equal(t.ct_fwd_stages, jtbl.ct_fwd_stages)
        _pairs_equal(t.gs_inv_stages, jtbl.gs_inv_stages)
        _pairs_equal([t.ninv_fold], [jtbl.ninv_fold])
    np.testing.assert_array_equal(mine.packed, via_jax.packed)
    # the (L, n) per-lane stage twiddles the MXU planner reads
    for t in (mine, via_jax):
        for field in ("ct_fwd_full", "gs_inv_full"):
            got, want = getattr(t, field), getattr(jtbl, field)
            assert got.dtype == np.uint32
            np.testing.assert_array_equal(got, want)

    # the compact rows are the merged-psi tables, n^{-1} folded into the
    # last inverse stage (entries 0 and 1 of row 2)
    ps = get_params(name)
    q = ps.q
    np.testing.assert_array_equal(mine.fwd_tw, ps.psi_rev)
    np.testing.assert_array_equal(mine.fwd_tw_shoup, ps.psi_rev_shoup)
    np.testing.assert_array_equal(mine.inv_tw[2:], ps.ipsi_rev[2:])
    np.testing.assert_array_equal(mine.inv_tw_shoup[2:], ps.ipsi_rev_shoup[2:])
    assert mine.inv_tw[0] == ps.n_inv
    assert mine.inv_tw[1] == int(ps.ipsi_rev[1]) * ps.n_inv % q
    assert mine.packed.shape == (4, ps.n) and mine.packed.dtype == np.uint32
    # the JAX full-width forward table's bit-clear lanes are these twiddles
    for s in range(ps.logn):
        t = ps.n >> (s + 1)
        lanes = jtbl.ct_fwd_full_signed[s][np.arange(ps.n) & t == 0]
        np.testing.assert_array_equal(
            lanes, np.repeat(mine.fwd_tw[1 << s:2 << s], t))


def _operands(name, batch=3, seed=5):
    ps = get_params(name)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, ps.q, (2, batch, ps.n), dtype=np.uint32)
    x[:, 0] = ps.q - 1
    return ps, x[0], x[1]


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


@pytest.mark.parametrize("name", SETS)
def test_transforms_match_jax(name):
    ps, x, y = _operands(name)
    jtbl = JT.get_tables(name)
    tbl = get_tables(name)
    fwd = jax.jit(functools.partial(JN.ntt_fwd_merged, tbl=jtbl))
    inv = jax.jit(functools.partial(JN.intt_inv_merged, tbl=jtbl))
    pw = jax.jit(functools.partial(JN.pointwise_mul, tbl=jtbl))

    X = TN.ntt_fwd_merged(_t(x), tbl)
    np.testing.assert_array_equal(X.numpy(), np.asarray(fwd(jnp.asarray(x))))
    Y = TN.ntt_fwd_merged(_t(y), tbl)
    Z = TN.pointwise_mul(X, Y, tbl)
    Xj, Yj = (jnp.asarray(v.numpy().astype(np.uint32)) for v in (X, Y))
    np.testing.assert_array_equal(Z.numpy(), np.asarray(pw(Xj, Yj)))
    z = TN.intt_inv_merged(Z, tbl)
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(inv(jnp.asarray(Z.numpy().astype(np.uint32)))))
    np.testing.assert_array_equal(TN.intt_inv_merged(X, tbl).numpy(), x)


def test_twiddles_cached_per_device():
    tbl = get_tables("smallprime")
    tw = TN.twiddles(tbl, torch.device("cpu"))
    assert tw is TN.twiddles(tbl, torch.device("cpu"))
    assert tw.dtype == torch.uint32 and tuple(tw.shape) == (4, tbl.n)
    np.testing.assert_array_equal(tw.numpy(), tbl.packed)


def test_pointwise_mul_lazy_operands():
    """The pointwise product is exact for operands up to 2^32 - 1, as the
    kernels feed it lazy forward outputs."""
    tbl = get_tables("qtesla-iii-speed")
    ps = tbl.ps
    rng = np.random.default_rng(6)
    a = rng.integers(0, 1 << 32, (4, ps.n), dtype=np.uint64)
    b = rng.integers(0, 4 * ps.q, (4, ps.n), dtype=np.uint64)
    a[0] = (1 << 32) - 1
    got = TN.pointwise_mul(_t(a), _t(b), tbl).numpy()
    want = (a.astype(object) * b.astype(object)) % ps.q
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_tables_match_jax_at_2pow18():
    """At n = 2^18, q = 1056440321 (the largest prime the registry takes
    there) every table of the port's vectorised build equals the JAX
    package's: the stage tables, the cyclic and Stockham tables, the
    weighting rows and the bit reversal, each with its Shoup companion, and
    the compact rows the kernels read are built from them."""
    from qtesla_tpu import params as JP
    from qtesla_tpu_torch import params as TP

    name, n, q = "tables-n262144", 1 << 18, 1056440321
    for reg in (JP, TP):
        reg.register_param_set(name, n, q)
    try:
        mine, jtbl = get_tables(name), JT.get_tables(name)
        for field in ("ct_fwd_stages", "gs_inv_stages", "stockham_fwd",
                      "stockham_inv"):
            _pairs_equal(getattr(mine, field), getattr(jtbl, field))
        _pairs_equal([mine.ninv_fold], [jtbl.ninv_fold])
        for field in ("cyc_fwd", "cyc_inv"):
            got, want = getattr(mine, field), getattr(jtbl, field)
            assert sorted(got) == sorted(want)
            _pairs_equal([got[h] for h in sorted(got)],
                         [want[h] for h in sorted(want)])
        _pairs_equal([(mine.phi, mine.phi_shoup),
                      (mine.inv_phi, mine.inv_phi_shoup),
                      (mine.ipsi_pow, mine.ipsi_pow_shoup)],
                     [(jtbl.phi, jtbl.phi_shoup),
                      (jtbl.inv_phi, jtbl.inv_phi_shoup),
                      (jtbl.ipsi_pow, jtbl.ipsi_pow_shoup)])
        np.testing.assert_array_equal(mine.bitrev, jtbl.bitrev)
        via_jax = from_jax_tables(jtbl)
        np.testing.assert_array_equal(mine.packed, via_jax.packed)
        np.testing.assert_array_equal(mine.pairing_packed,
                                      via_jax.pairing_packed)
    finally:
        for reg in (JP, TP):
            del reg.PARAM_SETS[name]
            reg.get_params.cache_clear()
        get_tables.cache_clear()
