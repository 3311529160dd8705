"""The port's fixed-operand sequence-parallel paths (plain and folded) in
``parallel/sharded_mxu.py`` and ``parallel/sharded_mxu_tables.py`` against
the JAX package's ``qtesla_tpu/parallel/sharded_mxu.py``.

- ``fourstep_fold_tables`` equals JAX's (l.586) bit for bit, for a lazy
  spectrum and its canonical form, and ``from_jax_fourstep_fold_tables``
  carries JAX's pair across;
- the twins of B13, B14, B15 and of B16 under p3x (what the wrappers run on
  CPU tensors) equal JAX's ``_make_seg2_fixed``, ``_make_seg2_fwd_only``,
  ``_make_seg2_folded`` and ``_make_seg3(plan=p3x)`` in interpret mode, with
  that shard's table slice, mod q (JAX's outputs may be lazy);
- B15's operand holds the nonzero blocks of the folded W
  (``fold_sp_operand``: ``compact_tables`` under the "rows" layout), which
  expand back to W, JAX's too; the twin over those blocks
  (``seg2_folded_compact_plain``, what the kernel multiplies) equals the
  dense twin and JAX's interpret-mode ``_make_seg2_folded`` on all 5 sets at
  every model axis their split takes (smallprime and a qtesla-iii-speed
  canary in the default tier, the rest ``slow``), and
  ``row_compact_fields`` refuses a folded plan it cannot lay out;
- B14's twin over K2f's nonzero blocks (``seg2_fwd_compact_plain``, what
  the kernel multiplies) equals the dense twin and JAX's interpret-mode
  ``_make_seg2_fwd_only`` (mod q) for x random and all q - 1, on the same
  cases as B15's; ``row_compact_fields(one_product=True)`` lays out both;
- both entry points equal JAX's ``polymul_fixed_fourstep_mxu_fn`` and
  ``polymul_fixed_folded_fourstep_mxu_fn`` on the (data 2, model 4) CPU mesh
  in interpret mode at B in {1, 3, 8}, the port's merged fixed path and the
  big-int oracle; ``multiply`` takes JAX's prepared spectrum and the folded
  tables carried from JAX;
- the wrappers raise on bad input, and ``local_fixed_pipeline_fn`` is one
  shard of the segments.

Tolerance: none (exact residues).  Inputs are made with numpy from a
seed."""

import functools

import numpy as np
import pytest
import torch

from qtesla_tpu.parallel import make_mesh as jmake_mesh
from qtesla_tpu.parallel import sharded_mxu as JS
from qtesla_tpu.params import get_params
from qtesla_tpu_torch import polymul_negacyclic_oracle
from qtesla_tpu_torch.models import (polymul_fixed_fn,
                                     polymul_fixed_folded_fourstep_mxu_fn,
                                     polymul_fixed_fourstep_mxu_fn)
from qtesla_tpu_torch.parallel import make_mesh
from qtesla_tpu_torch.parallel import sharded_mxu as S
from qtesla_tpu_torch.parallel import sharded_mxu_tables as ST


def _n1(name):
    return 1 << (get_params(name).logn // 2)


# ----------------------------------------------------------------------
# Folded tables.
# ----------------------------------------------------------------------

def _check_fold_tables(name, k):
    jplans = JS.fourstep_mxu_plans(name, _n1(name), k)
    plans = ST.fourstep_mxu_plans(name, _n1(name), k)
    q = plans.q
    rng = np.random.default_rng(61)
    lazy = rng.integers(0, 1 << 32, plans.n, dtype=np.uint32)
    canon = lazy % np.uint32(q)
    W, c = JS.fourstep_fold_tables(jplans, lazy)
    for spec in (lazy, canon.reshape(k, plans.nloc)):
        mine = ST.fourstep_fold_tables(plans, spec)
        for got, want in zip(mine, (W, c)):
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    for got, want in zip(ST.from_jax_fourstep_fold_tables(W, c), (W, c)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,k", [("smallprime", 2),
                                    ("qtesla-iii-speed", 2),
                                    ("qtesla-iii-speed", 4),
                                    ("qtesla-iii-speed", 8)])
def test_fold_tables_match_jax(name, k):
    _check_fold_tables(name, k)


@pytest.mark.slow
def test_fold_tables_match_jax_p3():
    """p-III, k = 4 (non-canonical p2x, four classes): slow because JAX's
    planner and object-int builder take about 9 s together here."""
    _check_fold_tables("qtesla-p-iii", 4)


def test_fold_tables_reject_bad_input():
    plans = ST.fourstep_mxu_plans("smallprime", 4, 2)
    with pytest.raises(ValueError, match="n=32"):
        ST.fourstep_fold_tables(plans, np.zeros(16, dtype=np.uint32))
    W, c = ST.fourstep_fold_tables(plans, np.zeros(32, dtype=np.uint32))
    with pytest.raises(ValueError, match="int8"):
        ST.from_jax_fourstep_fold_tables(W.astype(np.int16), c)
    with pytest.raises(ValueError, match="uint32"):
        ST.from_jax_fourstep_fold_tables(W, c[:, :, 0])


# ----------------------------------------------------------------------
# Segments against the interpret-mode Pallas kernels.
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_fixed_segs(name, k):
    plans = JS.fourstep_mxu_plans(name, _n1(name), k)
    return plans, (JS._make_seg2_fixed(plans, 256, True),
                   JS._make_seg2_fwd_only(plans, 256, True),
                   JS._make_seg2_folded(plans, 256, True),
                   JS._make_seg3(plans, 256, True, plan=plans.p3x))


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("name,k", [("smallprime", 2),
                                    ("qtesla-iii-speed", 4)])
def test_fixed_segment_twins_match_pallas_interpret(name, k, worst):
    jplans, (jfixed, jfwd, jfolded, jseg3x) = _jax_fixed_segs(name, k)
    plans = ST.fourstep_mxu_plans(name, _n1(name), k)
    q, nloc = plans.q, plans.nloc
    rng = np.random.default_rng(62)
    x = rng.integers(0, q, (3, nloc), dtype=np.uint32)
    # the spectrum as JAX stores it: lazy, any uint32
    spec = rng.integers(0, 1 << 32, (k, nloc), dtype=np.uint32)
    if worst:
        x[:], spec[:] = q - 1, q - 1
    W, c = JS.fourstep_fold_tables(jplans, spec)
    fold = S.fold_sp_operand(W, c, plans, "cpu")
    xt, st = torch.from_numpy(x)[None], torch.from_numpy(spec)
    p2f, p2i, p3x = jplans.p2f, jplans.p2i, jplans.p3x
    for d in range(k):
        sl = slice(d, d + 1)
        pairs = [
            ("B13", S.seg2_fixed_plain(xt, st, plans, first=d),
             jfixed(x, spec[d], p2f.W, p2f.const, p2i.W[sl], p2i.const[sl])),
            ("B14", S.seg2_fwd_plain(xt, plans, first=d),
             jfwd(x, p2f.W, p2f.const)),
            ("B15", S.seg2_folded_plain(xt, fold, plans, first=d),
             jfolded(x, W[sl], c[sl])),
            ("B16 p3x", S.seg3_plain(xt, plans, first=d, folded=True),
             jseg3x(x, p3x.W[sl], p3x.const[sl])),
        ]
        for what, got, want in pairs:
            got = got[0].numpy()
            assert got.dtype == np.uint32 and int(got.max()) < q, what
            np.testing.assert_array_equal(got, np.asarray(want) % q,
                                          err_msg=f"{what} shard {d}")
        # the wrappers run the twins on CPU tensors
        assert torch.equal(S.sp_seg2_fixed(xt, st, plans, first=d),
                           pairs[0][1])
        assert torch.equal(S.sp_seg2_fwd(xt, plans, first=d), pairs[1][1])
        assert torch.equal(S.sp_seg2_folded(xt, fold, plans, first=d),
                           pairs[2][1])
        assert torch.equal(S.sp_seg3(xt, plans, first=d, folded=True),
                           pairs[3][1])


# ----------------------------------------------------------------------
# The paths.
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_fixed_paths(name, kind, data=2, model=4):
    """JAX's fixed and folded SP products of 8 numpy-seeded rows against
    one constant on the CPU mesh, interpret mode: (x, a, spectrum, (W, c),
    z, z folded)."""
    ps = get_params(name)
    rng = np.random.default_rng(63)
    x = rng.integers(0, ps.q, (8, ps.n), dtype=np.uint32)
    a = rng.integers(0, ps.q, ps.n, dtype=np.uint32)
    if kind == "worst":
        x[:], a[:] = ps.q - 1, ps.q - 1
    mesh = jmake_mesh(data=data, model=model)
    prep, mul = JS.polymul_fixed_fourstep_mxu_fn(name, mesh, interpret=True)
    spec = prep(a)
    prepx, mulx = JS.polymul_fixed_folded_fourstep_mxu_fn(name, mesh,
                                                          interpret=True)
    W, c = prepx(a)
    return (x, a, np.asarray(spec), (np.asarray(W), np.asarray(c)),
            np.asarray(mul(x, spec)), np.asarray(mulx(x, W, c)))


@pytest.mark.parametrize("kind", ["random", "worst"])
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_fixed_paths_match_jax_mesh(batch, kind):
    name, k = "qtesla-iii-speed", 4
    x, a, jspec, jfold, z, zx = _jax_fixed_paths(name, kind)
    x, z, zx = x[:batch], z[:batch], zx[:batch]
    ps = get_params(name)
    cpu4 = make_mesh(model=k, device="cpu")
    xt, at = torch.from_numpy(x), torch.from_numpy(a)
    prep, mul = polymul_fixed_fourstep_mxu_fn(name, cpu4)
    spec = prep(at)
    assert spec.dtype == torch.uint32 and tuple(spec.shape) == (ps.n,)
    np.testing.assert_array_equal(spec.numpy(), jspec % ps.q)
    got = mul(xt, spec)
    assert got.dtype == torch.uint32 and tuple(got.shape) == (batch, ps.n)
    np.testing.assert_array_equal(got.numpy(), z)
    # JAX's lazy spectrum carries across
    assert torch.equal(mul(xt, torch.from_numpy(jspec.copy())), got)
    prepx, mulx = polymul_fixed_folded_fourstep_mxu_fn(name, cpu4)
    op = prepx(at)
    plans = ST.fourstep_mxu_plans(name, _n1(name), k)
    for got_t, want_t in zip(op, S.fold_sp_operand(*jfold, plans, "cpu")):
        assert torch.equal(got_t, want_t)
    gotx = mulx(xt, *op)
    np.testing.assert_array_equal(gotx.numpy(), zx)
    carried = S.fold_sp_operand(
        *ST.from_jax_fourstep_fold_tables(*jfold), plans, "cpu")
    assert torch.equal(mulx(xt, *carried), gotx)
    # the operand holds JAX's W's nonzero blocks: they expand back to it
    np.testing.assert_array_equal(
        ST.expand_compact(carried.w.numpy(), ST.compact_layout(plans, "rows"),
                          plans.p2x.din), jfold[0])
    # the port's merged fixed path and the plain whole paths
    mprep, mmul = polymul_fixed_fn(name, "merged")
    assert torch.equal(mmul(xt, mprep(at)), got)
    assert torch.equal(S.polymul_fixed_fourstep_mxu_plain(xt, spec, plans),
                       got)
    assert torch.equal(
        S.polymul_fixed_folded_fourstep_mxu_plain(xt, op, plans), got)
    if batch == 3:
        for r in (0, 2):
            np.testing.assert_array_equal(
                got[r].numpy(),
                polymul_negacyclic_oracle(x[r], a, ps).astype(np.uint32))


@pytest.mark.parametrize("name,k", [("smallprime", 2), ("qtesla-i", 8),
                                    ("qtesla-p-i", 4)])
def test_fixed_paths_match_merged_and_oracle(name, k):
    """The two fixed paths at other sets and model axes, against the merged
    fixed path and two oracle rows, batched over two leading axes; q near
    2^30 (qtesla-p-i) takes the fold builder's 15-bit split."""
    ps = get_params(name)
    rng = np.random.default_rng(64)
    x = torch.from_numpy(rng.integers(0, ps.q, (2, 2, ps.n), dtype=np.uint32))
    a = torch.from_numpy(rng.integers(0, ps.q, ps.n, dtype=np.uint32))
    mprep, mmul = polymul_fixed_fn(name, "merged")
    want = mmul(x, mprep(a))
    mesh = make_mesh(model=k, device="cpu")
    prep, mul = polymul_fixed_fourstep_mxu_fn(name, mesh)
    prepx, mulx = polymul_fixed_folded_fourstep_mxu_fn(name, mesh)
    for got in (mul(x, prep(a)), mulx(x, *prepx(a))):
        assert got.shape == x.shape and torch.equal(got, want)
    for r in (0, 1):
        np.testing.assert_array_equal(
            want[r, 1].numpy(), polymul_negacyclic_oracle(
                x[r, 1].numpy(), a.numpy(), ps).astype(np.uint32))


def test_local_fixed_pipeline_is_one_shard_of_the_segments():
    name = "qtesla-iii-speed"
    rng = np.random.default_rng(65)
    pipe, plans = S.local_fixed_pipeline_fn(name, 4)
    for folded in (False, True):
        x = torch.from_numpy(rng.integers(0, plans.q, (3, plans.nloc),
                                          dtype=np.uint32))
        spec = rng.integers(0, plans.q, (4, plans.nloc), dtype=np.uint32)
        const = (S.fold_sp_operand(*ST.fourstep_fold_tables(plans, spec),
                                   plans, "cpu") if folded
                 else torch.from_numpy(spec))
        got = pipe(x, const)
        assert tuple(got.shape) == (3, plans.nloc)
        v = S.seg1_plain(x[None], plans, first=1)
        w = (S.seg2_folded_plain(v, const, plans, first=1) if folded
             else S.seg2_fixed_plain(v, const, plans, first=1))
        assert torch.equal(got, S.seg3_plain(w, plans, first=1,
                                             folded=folded)[0])


def test_fixed_wrappers_reject_bad_input():
    plans = ST.fourstep_mxu_plans("smallprime", 4, 2)
    k, nloc = plans.k, plans.nloc
    rng = np.random.default_rng(66)
    x = torch.from_numpy(rng.integers(0, plans.q, (k, 3, nloc),
                                      dtype=np.uint32))
    spec = torch.from_numpy(rng.integers(0, plans.q, (k, nloc),
                                         dtype=np.uint32))
    with pytest.raises(TypeError, match="spectrum"):
        S.sp_seg2_fixed(x, spec.to(torch.int64), plans)
    with pytest.raises(ValueError, match="spectrum must be"):
        S.sp_seg2_fixed(x, spec[:1], plans)
    with pytest.raises(ValueError, match="contiguous"):
        S.sp_seg2_fixed(x, spec.t().contiguous().t(), plans)
    meta = torch.empty((k, nloc), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="spectrum must be contiguous on"):
        S.sp_seg2_fixed(x, meta, plans)
    with pytest.raises(ValueError, match="model axis"):
        S.sp_seg2_fixed(x, spec, plans, first=1)
    with pytest.raises(TypeError, match="uint32"):
        S.sp_seg2_fwd(x.to(torch.int32), plans)
    with pytest.raises(ValueError, match="shards"):
        S.sp_seg2_fwd(x[0], plans)
    fold = S.fold_sp_operand(*ST.fourstep_fold_tables(plans, spec.numpy()),
                             plans, "cpu")
    assert torch.equal(S.sp_seg2_folded(x, fold, plans),
                       S.seg2_folded_plain(x, fold, plans))
    for bad in (S.FoldedSpOperand(fold.w.to(torch.int32), fold.c),
                S.FoldedSpOperand(fold.w, fold.c[:1].contiguous()),
                S.FoldedSpOperand(fold.w[..., :-32].contiguous(), fold.c),
                # the dense tables are not the operand
                S.FoldedSpOperand(S.dense_folded_tables(fold, plans),
                                  fold.c)):
        with pytest.raises(ValueError, match="folded SP operand"):
            S.sp_seg2_folded(x, bad, plans)
    with pytest.raises(ValueError, match=f"n={nloc}"):
        S.sp_seg3(x[..., :nloc // 2].contiguous(), plans, folded=True)
    # the entry points: operands on the mesh's device, n values each
    prep, mul = polymul_fixed_fourstep_mxu_fn("smallprime", make_mesh(model=2))
    with pytest.raises(ValueError, match="mesh on cuda"):
        prep(spec.reshape(-1))
    with pytest.raises(ValueError, match="mesh on cuda"):
        mul(x[0], spec)
    prep, mul = polymul_fixed_fourstep_mxu_fn(
        "smallprime", make_mesh(model=2, device="cpu"))
    with pytest.raises(ValueError, match="n=32"):
        prep(spec[0])
    with pytest.raises(ValueError, match="n=32"):
        mul(x[0], spec)
    prepx, mulx = polymul_fixed_folded_fourstep_mxu_fn("smallprime",
                                                       make_mesh(model=2))
    with pytest.raises(ValueError, match="mesh on cuda"):
        prepx(spec.reshape(-1))
    # a model axis the split does not take raises when the pair is built
    with pytest.raises(ValueError, match="divide"):
        polymul_fixed_folded_fourstep_mxu_fn(
            "smallprime", make_mesh(model=16, device="cpu"))


# ----------------------------------------------------------------------
# B15 over the folded tables' nonzero blocks.
# ----------------------------------------------------------------------

_FOLD_CASES = [(name, k) for name in ("smallprime", "qtesla-i",
                                      "qtesla-iii-speed", "qtesla-p-i",
                                      "qtesla-p-iii")
               for k in (2, 4, 8) if not (name == "smallprime" and k == 8)]
_FOLD_CHEAP = {("smallprime", 2), ("qtesla-iii-speed", 4)}


@pytest.mark.parametrize("name,k", [
    (n, k) if (n, k) in _FOLD_CHEAP else
    pytest.param(n, k, marks=pytest.mark.slow) for n, k in _FOLD_CASES])
def test_folded_compact_twin_matches_dense_and_pallas(name, k):
    """B15's twin over the operand's compact blocks against the dense twin
    and JAX's interpret-mode ``_make_seg2_folded`` (mod q), each shard with
    its own slice, for x random and all q - 1 against a lazy spectrum with
    entries of q - 1; the compact operand expands back to JAX's W."""
    jplans = JS.fourstep_mxu_plans(name, _n1(name), k)
    jfolded = (_jax_fixed_segs(name, k)[1][2] if (name, k) in _FOLD_CHEAP
               else JS._make_seg2_folded(jplans, 256, True))
    plans = ST.fourstep_mxu_plans(name, _n1(name), k)
    q, nloc = plans.q, plans.nloc
    rng = np.random.default_rng(69)
    spec = rng.integers(0, 1 << 32, (k, nloc), dtype=np.uint32)
    spec[:, ::3] = q - 1
    W, c = JS.fourstep_fold_tables(jplans, spec)
    fold = S.fold_sp_operand(W, c, plans, "cpu")
    np.testing.assert_array_equal(
        ST.expand_compact(fold.w.numpy(), ST.compact_layout(plans, "rows"),
                          plans.p2x.din), W)
    for worst in (False, True):
        x = rng.integers(0, q, (3, nloc), dtype=np.uint32)
        if worst:
            x[:] = q - 1
        xt = torch.from_numpy(x)[None]
        for d in range(k):
            got = S.seg2_folded_compact_plain(xt, fold, plans, first=d)
            assert got.dtype == torch.uint32 and int(got.numpy().max()) < q
            assert torch.equal(got, S.seg2_folded_plain(xt, fold, plans,
                                                        first=d))
            np.testing.assert_array_equal(
                got[0].numpy(),
                np.asarray(jfolded(x, W[d:d + 1], c[d:d + 1])) % q,
                err_msg=f"shard {d} worst={worst}")


@pytest.mark.parametrize("name", ["smallprime", "qtesla-i",
                                  "qtesla-iii-speed", "qtesla-p-i",
                                  "qtesla-p-iii"])
def test_folded_operand_is_the_nonzero_blocks(name):
    """``fold_sp_operand`` keeps the folded W's diagonal blocks over the
    n2-blocks (blocks of max(n2, 8) lanes, F's Dout classes, depth din * s
    padded to 32), which expand back to W and hold every nonzero entry; the
    dense tables ``dense_folded_tables`` rebuilds are W in the kernels'
    output-major layout."""
    plans = ST.fourstep_mxu_plans(name, _n1(name), 4)
    lay = ST.compact_layout(plans, "rows")
    p = plans.p2x
    spec = np.random.default_rng(70).integers(0, plans.q, plans.n,
                                              dtype=np.uint32)
    W, c = ST.fourstep_fold_tables(plans, spec)
    fold = S.fold_sp_operand(W, c, plans, "cpu")
    assert lay.s == min(plans.TW, max(plans.n2, 8))
    assert tuple(fold.w.shape) == (4, plans.A, lay.nblk, p.Dout * lay.s,
                                   ST.compact_depth(p.din, lay.s))
    assert fold.w.dtype == torch.int8 and fold.c.dtype == torch.uint32
    assert np.count_nonzero(fold.w.numpy()) == np.count_nonzero(W)
    np.testing.assert_array_equal(
        ST.expand_compact(fold.w.numpy(), lay, p.din), W)
    np.testing.assert_array_equal(fold.c.numpy(), c[..., 0, :])
    dense = S.dense_folded_tables(fold, plans)
    assert tuple(dense.shape) == (4, plans.A, p.Dout * plans.TW,
                                  -(-p.din * plans.TW // 32) * 32)
    np.testing.assert_array_equal(
        np.moveaxis(dense.numpy()[..., :p.din * plans.TW].reshape(
            4, plans.A, p.Dout * plans.TW, p.din, plans.TW), 2, -1), W)


@pytest.mark.parametrize("name,k", [
    (n, k) if (n, k) in _FOLD_CHEAP else
    pytest.param(n, k, marks=pytest.mark.slow) for n, k in _FOLD_CASES])
def test_fwd_compact_twin_matches_dense_and_pallas(name, k):
    """B14's twin over K2f's compact blocks (``tabs.w2fc``) against the
    dense twin and JAX's interpret-mode ``_make_seg2_fwd_only`` (mod q: JAX
    stores lazy values) on every shard's rows at once (the table is shared),
    for x random, with rows of q - 1, and all q - 1."""
    jplans = JS.fourstep_mxu_plans(name, _n1(name), k)
    jfwd = (_jax_fixed_segs(name, k)[1][1] if (name, k) in _FOLD_CHEAP
            else JS._make_seg2_fwd_only(jplans, 256, True))
    plans = ST.fourstep_mxu_plans(name, _n1(name), k)
    q, nloc = plans.q, plans.nloc
    rng = np.random.default_rng(73)
    for worst in (False, True):
        x = rng.integers(0, q, (k, 3, nloc), dtype=np.uint32)
        x[:, 0] = q - 1
        if worst:
            x[:] = q - 1
        xt = torch.from_numpy(x)
        got = S.seg2_fwd_compact_plain(xt, plans)
        assert got.dtype == torch.uint32 and int(got.numpy().max()) < q
        assert torch.equal(got, S.seg2_fwd_plain(xt, plans))
        want = np.asarray(jfwd(x.reshape(k * 3, nloc), jplans.p2f.W,
                               jplans.p2f.const)) % q
        np.testing.assert_array_equal(got.numpy().reshape(k * 3, nloc), want,
                                      err_msg=f"worst={worst}")


def test_row_compact_fields_refuse_what_the_kernel_refuses():
    """A row plan is fixed (B13) or one product (B14, B15), not both; a
    one-product plan takes no K2i layout, one const row and no p2i planes
    (B15 at 3 planes under p2x, B14 at 4 under p2f); a plan whose warp's
    planes do not fit a block raises."""
    plans = ST.fourstep_mxu_plans("qtesla-iii-speed", 32, 4)
    with pytest.raises(ValueError, match="not both"):
        S.row_compact_fields(plans, 3, 3, 2, fixed=True, one_product=True)
    f = S.row_compact_fields(plans, 3, 3, 2, one_product=True)
    assert f["rows"] == 32 and f["c2"].kp == 0 and f["smem_tables"] == 1
    fwd = S.row_compact_fields(plans, 4, 3, 2, one_product=True)
    assert fwd["c1"].kp == 128 and fwd["c2"].kp == 0 and fwd["rows"] == 32
    fixed = S.row_compact_fields(plans, 4, 3, 2, fixed=True)
    assert fixed["c2"].kp == 96
    with pytest.raises(ValueError, match="do not fit"):
        S.row_compact_fields(plans, 250, 3, 2, one_product=True)
