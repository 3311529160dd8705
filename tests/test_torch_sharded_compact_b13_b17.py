"""The plain products over the compact tables that B13 (``sp_seg2_fixed``)
and B17 (``sp_seg1_classes``) multiply: ``seg2_fixed_compact_plain`` (K2f's
and K2i's n2-blocks, ``w2fc`` and ``w2ic``, against a stored spectrum row)
and ``seg1_classes_compact_plain`` (K1's lambda-major blocks, ``w1c``, the
biased raw class sums).

- each equals its dense twin (``seg2_fixed_plain``, ``seg1_classes_plain``)
  and JAX's interpret-mode ``_make_seg2_fixed`` / ``_make_seg1_classes``
  bit for bit (B13 mod q: JAX's output may be lazy), at B in {1, 3, 64},
  random and all-(q-1) operands, one shard at a time and all at once;
- B13 against JAX's own lazy spectrum (``_make_seg2_fwd_only``'s output, as
  JAX's fixed prepare stores it) and against a spectrum of uint32 values up
  to 2^32 - 1;
- smallprime (every shard) and qtesla-iii-speed at k = 4 (the middle shard)
  here; every other set and model axis, and n = 8192 against the dense
  twins, in the slow tier.

Tolerance: none (exact integers).  Inputs are made with numpy from a seed.
"""

import functools

import numpy as np
import pytest
import torch

from qtesla_tpu.parallel import sharded_mxu as JS
from qtesla_tpu.params import get_params
from qtesla_tpu_torch import register_param_set
from qtesla_tpu_torch.parallel import sharded_classes as C
from qtesla_tpu_torch.parallel import sharded_mxu as S
from qtesla_tpu_torch.parallel import sharded_mxu_tables as ST

SETS = ["smallprime", "qtesla-i", "qtesla-iii-speed", "qtesla-p-i",
        "qtesla-p-iii"]
CASES = [(name, k) for name in SETS for k in (2, 4, 8)
         if not (name == "smallprime" and k == 8)]
FAST = [("smallprime", 2), ("qtesla-iii-speed", 4)]
BATCHES = (1, 3, 64)
WIDE = ("qtesla-iii-speed-n8192", 8192, 8404993)


def _n1(name):
    return 1 << (get_params(name).logn // 2)


def _shards(name, k):
    """Every shard at smallprime, the middle one elsewhere."""
    return range(k) if name == "smallprime" else (k // 2,)


@functools.lru_cache(maxsize=None)
def _jax(name, k):
    plans = JS.fourstep_mxu_plans(name, _n1(name), k)
    segs = (JS._make_seg2_fixed(plans, 256, True),
            JS._make_seg2_fwd_only(plans, 256, True))
    if name.startswith("qtesla-p-"):
        return plans, None, segs + (None,)
    cp = JS.class_boundary_plan(name, _n1(name), k)
    return plans, cp, segs + (JS._make_seg1_classes(plans, cp, 256, True),)


def _operand(q, shape, worst, seed):
    if worst:
        return np.full(shape, q - 1, dtype=np.uint32)
    return np.random.default_rng(seed).integers(0, q, shape, dtype=np.uint32)


def _spectra(name, k, seed):
    """JAX's own lazy spectrum, each shard's row through its
    ``_make_seg2_fwd_only`` as the fixed prepare stores it, and a spectrum
    of uint32 values up to 2^32 - 1; (k, nloc) each."""
    jplans, _, (_, jfwd, _) = _jax(name, k)
    rng = np.random.default_rng(seed)
    nloc = jplans.nloc
    rows = rng.integers(0, jplans.q, (k, 1, nloc), dtype=np.uint32)
    lazy = np.concatenate([np.asarray(jfwd(r, jplans.p2f.W,
                                           jplans.p2f.const))
                           for r in rows]).astype(np.uint32)
    full = rng.integers(0, 1 << 32, (k, nloc), dtype=np.uint32)
    full[:, ::7] = 0xFFFFFFFF
    return {"lazy": lazy, "full": full}


def _check_b13(name, k, x, spectra, shards):
    jplans, _, (jfixed, _, _) = _jax(name, k)
    plans = ST.fourstep_mxu_plans(name, _n1(name), k)
    q = plans.q
    p2f, p2i = jplans.p2f, jplans.p2i
    xt = torch.from_numpy(x)[None]
    for what, spec in spectra.items():
        st = torch.from_numpy(spec)
        for d in shards:
            sl = slice(d, d + 1)
            got = S.seg2_fixed_compact_plain(xt, st, plans, first=d)
            assert got.dtype == torch.uint32 and got.shape == xt.shape
            assert int(got.to(torch.int64).max()) < q
            assert torch.equal(got, S.seg2_fixed_plain(xt, st, plans,
                                                       first=d))
            want = np.asarray(jfixed(x, spec[d], p2f.W, p2f.const, p2i.W[sl],
                                     p2i.const[sl])) % q
            np.testing.assert_array_equal(got[0].numpy(), want,
                                          err_msg=f"B13 {what} shard {d}")
        xs = torch.from_numpy(np.stack([x] * k))
        got = S.seg2_fixed_compact_plain(xs, st, plans)
        assert torch.equal(got, S.seg2_fixed_plain(xs, st, plans))
        # on CPU tensors the wrapper runs the dense twin
        assert torch.equal(S.sp_seg2_fixed(xs, st, plans), got)


def _check_b17(name, k, x, shards):
    jplans, jcp, (_, _, jseg1c) = _jax(name, k)
    plans = ST.fourstep_mxu_plans(name, _n1(name), k)
    cp = ST.class_boundary_plan(name, _n1(name), k)
    assert not jplans.rolls.fwd_lazy         # canonical hand-off: bit exact
    xt = torch.from_numpy(x)[None]
    for d in shards:
        sl = slice(d, d + 1)
        got = C.seg1_classes_compact_plain(xt, plans, cp, first=d)
        assert got.dtype == torch.uint32
        assert got.shape == (1, x.shape[0], cp.Dout * plans.nloc)
        assert torch.equal(got, C.seg1_classes_plain(xt, plans, cp,
                                                     first=d))
        np.testing.assert_array_equal(
            got[0].numpy(), np.asarray(jseg1c(x, jplans.p1.W[sl])),
            err_msg=f"B17 shard {d}")
    xs = torch.from_numpy(np.stack([x] * k))
    got = C.seg1_classes_compact_plain(xs, plans, cp)
    assert torch.equal(got, C.seg1_classes_plain(xs, plans, cp))
    assert torch.equal(C.sp_seg1_classes(xs, plans, cp), got)


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name,k", FAST)
def test_b13_compact_twin_matches_dense_and_pallas(name, k, batch, worst):
    """What B13 multiplies, against JAX's lazy spectrum and a full-range
    one."""
    plans = ST.fourstep_mxu_plans(name, _n1(name), k)
    x = _operand(plans.q, (batch, plans.nloc), worst, 91)
    _check_b13(name, k, x, _spectra(name, k, 92), _shards(name, k))


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name,k", FAST)
def test_b17_compact_twin_matches_dense_and_pallas(name, k, batch, worst):
    """What B17 multiplies: the biased raw class sums over K1's blocks."""
    plans = ST.fourstep_mxu_plans(name, _n1(name), k)
    x = _operand(plans.q, (batch, plans.nloc), worst, 93)
    _check_b17(name, k, x, _shards(name, k))


@pytest.mark.slow
@pytest.mark.parametrize("name,k", [c for c in CASES if c not in FAST])
def test_b13_b17_compact_twins_slow_tier(name, k):
    """Every other set and model axis, the first and last shard, random and
    all-(q-1) operands (B17 on the sets of at most 3 classes): slow because
    each plan pair takes up to a minute to build."""
    plans = ST.fourstep_mxu_plans(name, _n1(name), k)
    spectra = _spectra(name, k, 94)
    for worst in (False, True):
        x = _operand(plans.q, (3, plans.nloc), worst, 95)
        _check_b13(name, k, x, spectra, (0, k - 1))
        if not name.startswith("qtesla-p-"):
            _check_b17(name, k, x, (0, k - 1))


@pytest.mark.slow
@pytest.mark.parametrize("k", [2, 4, 8])
def test_b13_b17_compact_twins_match_dense_at_n8192(k):
    """n = 8192 on the qtesla-iii-speed prime (blocks of 2, 4 and 8 lanes in
    K1, one 128-lane block a tile in K2f and K2i): the compact twins equal
    the dense ones; slow because the plans take tens of seconds."""
    register_param_set(*WIDE)
    name, n1 = WIDE[0], 64
    plans = ST.fourstep_mxu_plans(name, n1, k)
    cp = ST.class_boundary_plan(name, n1, k)
    rng = np.random.default_rng(96)
    x = torch.from_numpy(rng.integers(0, plans.q, (k, 2, plans.nloc),
                                      dtype=np.uint32))
    spec = torch.from_numpy(rng.integers(0, 1 << 32, (k, plans.nloc),
                                         dtype=np.uint32))
    assert torch.equal(S.seg2_fixed_compact_plain(x, spec, plans),
                       S.seg2_fixed_plain(x, spec, plans))
    assert torch.equal(C.seg1_classes_compact_plain(x, plans, cp),
                       C.seg1_classes_plain(x, plans, cp))
