"""The port's cyclic, Stockham, matrix and four-step transforms, the seven
pipelines of JAX's ``ALGORITHMS`` and the pairing kernels' twins (B10)
against the JAX package.

- tables: the cyclic, Stockham, weighting and bit-reversal fields of
  ``ops/tables.py`` (built from qtesla_tpu.params and via
  ``from_jax_tables``) equal JAX's ``NttTables`` on all 5 sets, and the
  compact pairing table holds them;
- transforms: each new ``ops/ntt.py`` function equals its JAX counterpart at
  smallprime, the cyclic and Stockham ones also at qtesla-iii-speed;
- pipelines: ``polymul_negacyclic(algo=...)`` for gs_ct, ct_ct, gs_gs,
  ct_gs, stockham, four_step and matrix equals JAX's same-algo pipeline and
  its merged one at smallprime, gs_ct and stockham also at
  qtesla-iii-speed; ``ntt``/``intt`` with ``algo="stockham"``;
- B10: ``polymul_pairing`` on CPU tensors (the twin) equals JAX's
  ``polymul_pairing_fn`` kernel in interpret mode at smallprime, random
  rows together with the q-1 and delta-impulse edge rows.  gs_ct and
  stockham run in the default tier, as tests/test_pairings_pallas.py tiers
  them; the other three under ``slow``.

Tolerance: none (integer equality).  Inputs are made with numpy from a seed
and fed to both sides."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtesla_tpu.models import polymul as JP
from qtesla_tpu.ops import ntt as JN
from qtesla_tpu.ops import tables as JT
from qtesla_tpu.ops.ntt_pairings_pallas import polymul_pairing_fn
from qtesla_tpu.params import get_params
from qtesla_tpu_torch.models import polymul as TP
from qtesla_tpu_torch.ops import ntt as TN
from qtesla_tpu_torch.ops import ntt_pairings as TPa
from qtesla_tpu_torch.ops.tables import from_jax_tables, get_tables

SETS = ["smallprime", "qtesla-i", "qtesla-iii-speed", "qtesla-p-i",
        "qtesla-p-iii"]
FAST_PAIRINGS = ("gs_ct", "stockham")
PIPELINES = ("gs_ct", "ct_ct", "gs_gs", "ct_gs", "stockham", "four_step",
             "matrix")
_WEIGHTS = ("phi", "phi_shoup", "inv_phi", "inv_phi_shoup", "ipsi_pow",
            "ipsi_pow_shoup", "bitrev")


def _pairs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == np.uint32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", SETS)
def test_tables_match_jax(name):
    jtbl = JT.get_tables(name)
    for t in (get_tables(name), from_jax_tables(jtbl)):
        for field in ("cyc_fwd", "cyc_inv"):
            got, want = getattr(t, field), getattr(jtbl, field)
            assert sorted(got) == sorted(int(h) for h in want)
            _pairs_equal([got[int(h)] for h in want], list(want.values()))
        for field in ("stockham_fwd", "stockham_inv"):
            _pairs_equal(getattr(t, field), getattr(jtbl, field))
        for field in _WEIGHTS:
            got, want = getattr(t, field), getattr(jtbl, field)
            assert got.dtype == want.dtype, field
            np.testing.assert_array_equal(got, want, err_msg=field)
    # the pairing kernels' compact table: the cyclic stage of half-width h
    # at entries [h, 2h) (forward, Shoup, inverse, Shoup), the widest stage
    # omega^{+-j} for j < n/2, then phi and phi^{-1} n^{-1} with Shoup rows
    mine = get_tables(name)
    n, half = mine.n, mine.n // 2
    packed = mine.pairing_packed
    assert packed.shape == (8, n) and packed.dtype == np.uint32
    for row, field in ((0, "cyc_fwd"), (2, "cyc_inv")):
        for h, (w, wsh) in getattr(jtbl, field).items():
            np.testing.assert_array_equal(packed[row, h:2 * h], w[0])
            np.testing.assert_array_equal(packed[row + 1, h:2 * h], wsh[0])
        w = get_params(name).omega_powers(n, inverse=row == 2)[:half]
        np.testing.assert_array_equal(packed[row, half:], w)
        np.testing.assert_array_equal(
            packed[row + 1, half:], (w.astype(np.int64) << 32) // mine.q)
    for row, field in enumerate(_WEIGHTS[:4], start=4):
        np.testing.assert_array_equal(packed[row], getattr(jtbl, field))


def _x(name, batch=3, seed=51):
    ps = get_params(name)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, ps.q, (batch, ps.n), dtype=np.uint32)
    x[0] = ps.q - 1
    return x


def _jax(fn, name, x, **kw):
    tbl = JT.get_tables(name)
    return np.asarray(jax.jit(functools.partial(fn, tbl=tbl, **kw))(
        jnp.asarray(x)))


def _mine(fn, name, x, **kw):
    out = fn(torch.from_numpy(x.astype(np.int64)), get_tables(name), **kw)
    assert out.dtype == torch.int64
    return out.numpy()


_CYCLIC = [("gs_fwd_cyclic", {}), ("gs_inv_cyclic", {}),
           ("gs_inv_cyclic", {"scale_ninv": False}), ("ct_fwd_cyclic", {}),
           ("ct_inv_cyclic", {}), ("ct_inv_cyclic", {"scale_ninv": False}),
           ("stockham_fwd", {}), ("stockham_inv", {}),
           ("stockham_inv", {"scale_ninv": False})]
_OTHER = [("matrix_ntt", {}), ("matrix_ntt", {"inverse": True}),
          ("fourstep_ntt", {}), ("fourstep_ntt", {"n1": 8}),
          ("fourstep_ntt", {"n1": 4, "inverse": True}),
          ("fourstep_intt", {}), ("fourstep_intt", {"n1": 8}),
          ("bitrev_permute", {}), ("weight_psi", {}),
          ("weight_ipsi_ninv", {}), ("weight_ipsi", {}),
          ("bitrev_weight_ipsi_ninv", {}), ("weight_psi_bitrev", {})]


@pytest.mark.parametrize("name", ["smallprime", "qtesla-iii-speed"])
def test_cyclic_and_stockham_transforms_match_jax(name):
    x = _x(name)
    for fname, kw in _CYCLIC:
        np.testing.assert_array_equal(
            _mine(getattr(TN, fname), name, x, **kw),
            _jax(getattr(JN, fname), name, x, **kw), err_msg=f"{fname} {kw}")


@pytest.mark.parametrize("fname,kw", _OTHER,
                         ids=[f"{f}-{i}" for i, (f, _) in enumerate(_OTHER)])
def test_other_transforms_match_jax(fname, kw):
    x = _x("smallprime")
    np.testing.assert_array_equal(
        _mine(getattr(TN, fname), "smallprime", x, **kw),
        _jax(getattr(JN, fname), "smallprime", x, **kw))


def test_transforms_invert():
    """Round trips: forward then inverse gives x back."""
    name = "qtesla-i"
    x = torch.from_numpy(_x(name).astype(np.int64))
    tbl = get_tables(name)
    for fwd, inv in ((TN.stockham_fwd, TN.stockham_inv),
                     (TN.fourstep_ntt, TN.fourstep_intt)):
        assert torch.equal(inv(fwd(x, tbl), tbl), x)
    assert torch.equal(
        TN.bitrev_permute(TN.gs_inv_cyclic(
            TN.bitrev_permute(TN.gs_fwd_cyclic(x, tbl), tbl), tbl), tbl), x)


@pytest.mark.parametrize("algo", PIPELINES)
def test_pipelines_match_jax(algo):
    name = "smallprime"
    ps = get_params(name)
    x, y = _x(name, 4, seed=52), _x(name, 4, seed=53)
    got = TP.polymul_negacyclic(torch.from_numpy(x), torch.from_numpy(y), ps,
                                algo=algo)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JP.polymul_negacyclic(x, y, ps, algo=algo)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JP.polymul_negacyclic(x, y, ps)))
    np.testing.assert_array_equal(
        TP.NegacyclicPolymul(name)(torch.from_numpy(x), torch.from_numpy(y),
                                   algo).numpy(), got.numpy())


@pytest.mark.parametrize("algo", FAST_PAIRINGS)
def test_pipelines_match_jax_real_set(algo):
    name = "qtesla-iii-speed"
    ps = get_params(name)
    x, y = _x(name, 3, seed=54), _x(name, 3, seed=55)
    got = TP.polymul_negacyclic(torch.from_numpy(x), torch.from_numpy(y), ps,
                                algo=algo).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JP.polymul_negacyclic(x, y, ps, algo=algo)))
    np.testing.assert_array_equal(
        got, np.asarray(JP.polymul_negacyclic(x, y, ps)))


@pytest.mark.parametrize("name", ["smallprime", "qtesla-iii-speed"])
def test_stockham_ntt_intt_match_jax(name):
    ps = get_params(name)
    x = _x(name, 3, seed=56)
    X = TP.ntt(torch.from_numpy(x), ps, "stockham")
    np.testing.assert_array_equal(
        X.numpy(), np.asarray(JP.ntt(jnp.asarray(x), ps, "stockham")))
    np.testing.assert_array_equal(
        TP.intt(X, ps, "stockham").numpy(),
        np.asarray(JP.intt(jnp.asarray(X.numpy()), ps, "stockham")))
    np.testing.assert_array_equal(TP.intt(X, ps, "stockham").numpy(), x)


def _edge_operands(n, q, seed=57):
    """Random rows, then tests/test_pairings_pallas.py's edge rows: x all
    q-1 against the identity, a shift by X and an all-(q-1) y."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, q, (6, n), dtype=np.uint32)
    y = rng.integers(0, q, (6, n), dtype=np.uint32)
    x[3:] = q - 1
    y[3:] = 0
    y[3, 0] = 1
    y[4, 1] = 1
    y[5] = q - 1
    return x, y


@pytest.mark.parametrize("pairing", [
    p if p in FAST_PAIRINGS else pytest.param(p, marks=pytest.mark.slow)
    for p in sorted(TPa.PAIRINGS)])
def test_pairing_twin_matches_pallas_interpret(pairing):
    name = "smallprime"
    ps = get_params(name)
    x, y = _edge_operands(ps.n, ps.q)
    ref = np.asarray(polymul_pairing_fn(name, pairing, interpret=True)(x, y))
    got = TPa.polymul_pairing_fn(name, pairing)(torch.from_numpy(x),
                                                torch.from_numpy(y))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got[3].numpy(), x[3])     # identity


def test_pairing_wrapper_contract():
    tbl = get_tables("smallprime")
    x = torch.from_numpy(_x("smallprime", 2))
    with pytest.raises(ValueError, match="unknown pairing"):
        TPa.polymul_pairing(x, x, tbl, "nope")
    with pytest.raises(ValueError, match="unknown pairing"):
        TPa.polymul_pairing_fn("smallprime", "nope")
    with pytest.raises(ValueError, match="shapes differ"):
        TPa.polymul_pairing(x, x[:1], tbl, "gs_ct")
    with pytest.raises(TypeError, match="uint32"):
        TPa.polymul_pairing(x.to(torch.int64), x, tbl, "gs_ct")
    with pytest.raises(ValueError, match="pairing twiddles"):
        TPa.polymul_pairing(x, x, tbl, "gs_ct",
                            tw=torch.from_numpy(tbl.packed))
    # leading axes pass through; the module holds the pairing table
    z = TPa.polymul_pairing(x.reshape(1, 2, -1), x.reshape(1, 2, -1), tbl,
                            "ct_gs")
    assert tuple(z.shape) == (1, 2, tbl.n)
    mod = TP.NegacyclicPolymul("smallprime")
    np.testing.assert_array_equal(mod.pairing_twiddles.numpy(),
                                  tbl.pairing_packed)
    assert TPa.pairing_twiddles(tbl, torch.device("cpu")) is \
        TPa.pairing_twiddles(tbl, torch.device("cpu"))
