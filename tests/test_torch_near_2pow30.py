"""The port at q = 1073479681 = 2^30 - 2^18 + 1, the twin of the JAX
package's ``tests/test_params.py`` ``test_register_near_2pow30_prime``.
There 4q is 1,048,572 below 2^32: the kernels' lazy ranges ("q < 2^30, so
4q < 2^32") are as tight as the port allows, and the MXU plan takes four
digit classes and the canonical forward hand-off (``fwd_bound = q``).

- planners at n = 64: ``get_mxu_tables``, the fold plan and the SP plans
  at (n1, k) = (8, 2) and (8, 4) equal JAX's field by field;
- every CPU algo of the port (``models.ALGORITHMS``; the kernel algos
  through their plain versions) equals JAX's merged product, JAX's
  ``polymul_mxu_fn`` in interpret mode and the big-int oracle;
- the kernels' twins: the pass twins of B1-B4, B10's five pairing pass
  twins, the five ``*_mxu_plain`` modes (B7 on rows at ``pw_bound - 1``)
  and the SP plain pipelines (two-operand, fixed, folded) at k = 2 and 4,
  against the oracle and, at n = 64, JAX's merged transforms; at n = 1024 a
  canary of the same twins against the oracle and the port's merged
  transforms.

Operands have a row of q - 1 in both x and y (the fixed forms' constant is
that row); B3's input has a row of 2q - 1.  The sets are registered in
both registries for this module and removed after it.  Tolerance: none
(integer equality).  Inputs are made with numpy from a seed."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtesla_tpu import params as JPARAMS
from qtesla_tpu.models import polymul as JP
from qtesla_tpu.ops import ntt_mxu as JM
from qtesla_tpu.parallel import sharded_mxu as JS
from qtesla_tpu_torch import params as TPARAMS
from qtesla_tpu_torch import polymul_negacyclic_oracle
from qtesla_tpu_torch.models import polymul as TP
from qtesla_tpu_torch.ops import mxu_tables as MT
from qtesla_tpu_torch.ops import ntt_fused as F
from qtesla_tpu_torch.ops import ntt_mxu as M
from qtesla_tpu_torch.ops import ntt_pairings as P
from qtesla_tpu_torch.ops.tables import get_tables
from qtesla_tpu_torch.parallel import sharded_mxu as S
from qtesla_tpu_torch.parallel import sharded_mxu_tables as ST

Q = 1073479681
SMALL = ("near-2pow30-n64", 64, Q)
CANARY = ("near-2pow30-n1024", 1024, Q)
ROWS = 3


@pytest.fixture(scope="module", autouse=True)
def near_sets():
    """Both sets in both packages' registries for this module."""
    for reg in (JPARAMS, TPARAMS):
        for entry in (SMALL, CANARY):
            reg.register_param_set(*entry)
    yield
    for reg in (JPARAMS, TPARAMS):
        for name, _, _ in (SMALL, CANARY):
            del reg.PARAM_SETS[name]
        reg.get_params.cache_clear()


@functools.lru_cache(maxsize=None)
def _operands(name):
    """x, y (ROWS, n) with row 0 all q - 1 in both, and the rows of the
    big-int oracle's x * y and x * y[0]."""
    ps = TPARAMS.get_params(name)
    rng = np.random.default_rng(0x2030)
    x, y = rng.integers(0, Q, (2, ROWS, ps.n), dtype=np.uint32)
    x[0], y[0] = Q - 1, Q - 1
    z = np.stack([polymul_negacyclic_oracle(x[b], y[b], ps)
                  for b in range(ROWS)]).astype(np.uint32)
    zf = np.stack([polymul_negacyclic_oracle(x[b], y[0], ps)
                   for b in range(ROWS)]).astype(np.uint32)
    return x, y, z, zf


def _t(v):
    return torch.from_numpy(np.ascontiguousarray(v))


def _ref_ntt(name, v):
    """The merged forward: JAX's at n = 64, the port's at the canary."""
    if name == SMALL[0]:
        return np.asarray(JP.ntt(jnp.asarray(v), JPARAMS.get_params(name)))
    return TP.ntt(_t(v), name).numpy()


def _ref_intt(name, v):
    if name == SMALL[0]:
        return np.asarray(JP.intt(jnp.asarray(v), JPARAMS.get_params(name)))
    return TP.intt(_t(v), name).numpy()


# ----------------------------------------------------------------------
# Planners against JAX's.
# ----------------------------------------------------------------------

def test_mxu_tables_and_fold_plan_match_jax():
    name = SMALL[0]
    jmt, mine = JM.get_mxu_tables(name), MT.get_mxu_tables(name)
    for f in MT._FIELDS:
        g, w = getattr(mine, f), getattr(jmt, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, (f, g, w)
    # JAX's regression: the planner prunes the all-singleton composition
    assert len(mine.groups_f) >= 2 and len(mine.groups_i) >= 2
    # the canonical forward hand-off and four classes
    assert (mine.D, mine.fwd_bound, mine.pw_bound) == (4, Q, Q)
    assert MT.pointwise_bound(Q) == JM.pointwise_bound(Q)
    for groups, bounds in ((jmt.groups_f, jmt.bounds_f),
                           (jmt.groups_i, jmt.bounds_i)):
        assert MT._recombine_bound(groups, bounds, Q) == \
            JM._recombine_bound(groups, bounds, Q)
    jfp, fp = JM.fixed_fold_plan(name), MT.fixed_fold_plan(name)
    assert MT.from_jax_fold_plan(jfp) == fp == MT.fold_plan(mine)
    for f in MT.FixedFoldPlan.__dataclass_fields__:
        assert getattr(fp, f) == getattr(jfp, f), f
    assert fp.Dout == 4 and fp.Din <= 6 and max(fp.bounds) < 1 << 24


def _eq(got, want, what):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, (what, got, want)


@pytest.mark.parametrize("k", [2, 4])
def test_sp_plans_match_jax(k):
    jplans = JS.fourstep_mxu_plans(SMALL[0], 8, k)
    mine = ST.fourstep_mxu_plans(SMALL[0], 8, k)
    for f in ST._LAYOUT_FIELDS + ST._PLAN_FIELDS:
        _eq(getattr(mine, f), getattr(jplans, f), f)
    for f in ST._ROLL_FIELDS:
        _eq(getattr(mine.rolls, f), getattr(jplans.rolls, f), "rolls." + f)
    for p in ("p1", "p2f", "p2i", "p3", "p3x"):
        for f in ST.DIGIT_FIELDS:
            _eq(getattr(getattr(mine, p), f), getattr(getattr(jplans, p), f),
                f"{p}.{f}")
    for f in ST.FOLD_FIELDS:
        _eq(getattr(mine.p2x, f), getattr(jplans.p2x, f), "p2x." + f)


# ----------------------------------------------------------------------
# Every CPU algo against JAX and the oracle.
# ----------------------------------------------------------------------

def test_jax_matches_the_oracle():
    """JAX's merged product and its MXU kernel in interpret mode, as JAX's
    own test runs them, equal the oracle."""
    name = SMALL[0]
    x, y, z, _ = _operands(name)
    got = JP.polymul_negacyclic(jnp.asarray(x), jnp.asarray(y),
                                JPARAMS.get_params(name), algo="merged")
    np.testing.assert_array_equal(np.asarray(got), z)
    got = JM.polymul_mxu_fn(name, interpret=True)(x, y)
    np.testing.assert_array_equal(np.asarray(got), z)


@pytest.mark.parametrize("algo", TP.ALGORITHMS)
def test_cpu_algo_matches_jax_and_oracle(algo):
    x, y, z, _ = _operands(SMALL[0])
    got = TP.polymul_negacyclic(_t(x), _t(y), SMALL[0], algo=algo)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), z, err_msg=algo)


# ----------------------------------------------------------------------
# The kernels' twins.
# ----------------------------------------------------------------------

def _sp_plans(name, k):
    return ST.fourstep_mxu_plans(name, 1 << (get_tables(name).logn // 2), k)


def _folded_sp(x, a, plans):
    spec = S.fixed_spectrum(a, plans)
    fold = S.fold_sp_operand(*ST.fourstep_fold_tables(plans, spec.numpy()),
                             plans, "cpu")
    return S.polymul_fixed_folded_fourstep_mxu_plain(x, fold, plans)


# name: (what the output is, twin (name, x, y, a) -> z); "product" x * y,
# "fixed" x * a with a = y[0] (each fixed twin takes its own path's
# spectrum), "ntt" and "intt" the transforms
TWINS = {
    "B1": ("product", lambda nm, x, y, a: F.polymul_fused_passes_plain(
        x, y, get_tables(nm))),
    "B2": ("ntt", lambda nm, x, y, a: F.ntt_passes_plain(x, get_tables(nm))),
    "B3": ("intt", lambda nm, x, y, a: F.intt_passes_plain(
        x, get_tables(nm))),
    "B4": ("fixed", lambda nm, x, y, a: F.polymul_fixed_fused_passes_plain(
        x, F.ntt_passes_plain(a, get_tables(nm)), get_tables(nm))),
    **{f"B10 {p}": ("product", functools.partial(
        lambda nm, x, y, a, p: P.polymul_pairing_passes_plain(
            x, y, get_tables(nm), p), p=p)) for p in P.PAIRINGS},
    "B5": ("product", lambda nm, x, y, a: M.polymul_mxu_plain(
        x, y, MT.get_mxu_tables(nm))),
    "B6": ("ntt", lambda nm, x, y, a: M.ntt_mxu_plain(
        x, MT.get_mxu_tables(nm))),
    "B7": ("intt", lambda nm, x, y, a: M.intt_mxu_plain(
        x, MT.get_mxu_tables(nm))),
    "B8": ("fixed", lambda nm, x, y, a: M.polymul_fixed_mxu_plain(
        x, M.ntt_mxu_plain(a, MT.get_mxu_tables(nm)),
        MT.get_mxu_tables(nm))),
    "B9": ("fixed", lambda nm, x, y, a: M.polymul_fixed_folded_mxu_plain(
        x, M.fold_operand(M.ntt_mxu_plain(a, MT.get_mxu_tables(nm)),
                          MT.get_mxu_tables(nm)), MT.get_mxu_tables(nm))),
    **{f"SP k={k}": ("product", functools.partial(
        lambda nm, x, y, a, k: S.polymul_fourstep_mxu_plain(
            x, y, _sp_plans(nm, k)), k=k)) for k in (2, 4)},
    **{f"fixed SP k={k}": ("fixed", functools.partial(
        lambda nm, x, y, a, k: S.polymul_fixed_fourstep_mxu_plain(
            x, S.fixed_spectrum(a, _sp_plans(nm, k)), _sp_plans(nm, k)),
        k=k)) for k in (2, 4)},
    **{f"folded SP k={k}": ("fixed", functools.partial(
        lambda nm, x, y, a, k: _folded_sp(x, a, _sp_plans(nm, k)), k=k))
       for k in (2, 4)},
}


@pytest.mark.parametrize("twin", TWINS)
@pytest.mark.parametrize("name", [SMALL[0], CANARY[0]],
                         ids=["n64", "n1024-canary"])
def test_twin_matches_oracle(name, twin):
    """Products against the oracle; transforms against the merged
    transforms (JAX's at n = 64), with the forward's input holding a row of
    q - 1, B3's a row of 2q - 1 and B7's a row of pw_bound - 1 (pw_bound =
    q here)."""
    kind, fn = TWINS[twin]
    x, y, z, zf = _operands(name)
    n = x.shape[1]
    if kind == "intt":
        bound = (2 * Q if twin == "B3"
                 else MT.get_mxu_tables(name).pw_bound)
        v = np.random.default_rng(0x2031).integers(0, bound, (ROWS, n),
                                                   dtype=np.uint32)
        v[0] = bound - 1
        got = fn(name, _t(v), None, None)
        want = _ref_intt(name, v % Q)
    else:
        got = fn(name, _t(x), _t(y), _t(y[:1]))
        want = {"product": z, "fixed": zf}.get(kind)
        if kind == "ntt":
            want = _ref_ntt(name, x)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want, err_msg=twin)
