"""The split form of the MXU path (B5-B9 past one block's reach, n >= 32768;
``ops/ntt_mxu_split.py``, ``csrc/ntt_mxu_split.cu``) and its block-wise
planner (``ops/mxu_tables.py``), on the CPU, against the JAX package.

- The planner: ``MxuTables`` and the fold plan and tables, planned a lane
  block at a time (``_fwd_blocks``, ``_inv_blocks``: the diagonal blocks of
  the dense stage matrices, which are zero off them), equal JAX's dense
  planner (``MxuTables``, ``fixed_fold_plan``, ``fixed_fold_tables``) field
  by field at smallprime, n = 64 and qtesla-iii-speed (``slow``: n =
  8192).  Past ``MAX_TABLE_BYTES`` (n = 2^25) the plan raises, naming the
  bytes, before any table is built.
- The wide stages' sweep plans (``passes.sweep_plan(n, kind, low=7)``, B2
  and B3 over the index bits from 7 up) against the launcher's checks,
  restated; the split kernel's plan (``split_plan``) against its launcher's.
- The split form forced at n = 1024 (``split=True``: B2's sweeps through
  ``passes.SweepModel``, the block products, B3's sweeps) in all five modes
  against JAX's interpret-mode ``polymul_mxu_fn``, ``ntt_mxu_fn``,
  ``intt_mxu_fn``, ``polymul_fixed_mxu_fn``,
  ``polymul_fixed_folded_mxu_fn`` at qtesla-iii-speed (at (1024,
  1073479681) against JAX's merged transforms and product, and in
  ``slow`` against the interpret-mode kernels too) and the oracle, on
  random rows and rows of q - 1 (B7: pw_bound - 1), at B in {1, 3, 64};
  and against the one-block twins.
- ``slow``: the planner at n = 32768 (q = 786433 and 1073479681), with its
  seconds; the split form there against JAX's ``polymul_fn(name,
  "merged")`` and the oracle's rows; ``ntt(x, "mxu") == ntt(x, "fused")``.

Tolerance: none (integer equality).  Inputs are made with numpy from a
seed; the sets are registered in both packages' registries for the module
and removed after it."""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtesla_tpu import params as JPARAMS
from qtesla_tpu.models import polymul as JP
from qtesla_tpu.ops import ntt as JN
from qtesla_tpu.ops import ntt_mxu as JM
from qtesla_tpu.ops import tables as JT
from qtesla_tpu_torch import params as TPARAMS
from qtesla_tpu_torch.models import intt, ntt, polymul_fixed_fn
from qtesla_tpu_torch.models import polymul as TP
from qtesla_tpu_torch.ops import mxu_tables as MT
from qtesla_tpu_torch.ops import ntt_mxu as M
from qtesla_tpu_torch.ops import ntt_mxu_split as MS
from qtesla_tpu_torch.ops import passes as Ps
from qtesla_tpu_torch.oracle import negacyclic_schoolbook
from qtesla_tpu_torch.params import get_params

Q30 = 1073479681
# (name, n, q) registered for the module
REGISTERED = (("split-n64", 64, 257), ("split-q30-n1024", 1024, Q30),
              ("split-n8192", 8192, 8404993),
              ("split-n32768", 32768, 786433),
              ("split-q30-n32768", 32768, Q30),
              ("split-n2pow25", 1 << 25, 469762049))
FORCED = ("qtesla-iii-speed", "split-q30-n1024")
MODES = ("product", "fixed", "folded", "ntt", "intt")
BATCH = 64


@pytest.fixture(scope="module", autouse=True)
def registered():
    for reg in (JPARAMS, TPARAMS):
        for entry in REGISTERED:
            reg.register_param_set(*entry)
    yield
    for reg in (JPARAMS, TPARAMS):
        for name, _, _ in REGISTERED:
            del reg.PARAM_SETS[name]
        reg.get_params.cache_clear()


# ----------------------------------------------------------------------
# The planner.
# ----------------------------------------------------------------------

def _assert_tables_equal(got, want):
    for f in MT._FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, (f, g, w)


@pytest.mark.parametrize("name", [
    "smallprime", "split-n64", "qtesla-iii-speed",
    pytest.param("split-n8192", marks=pytest.mark.slow)])
def test_block_planner_matches_jax_and_dense(name):
    """Field by field JAX's dense planner, the fold plan and one
    constant's fold tables too; ``_fwd_blocks`` and ``_inv_blocks`` give
    the dense stage matrix's diagonal blocks, and it is zero off them."""
    mt = MT.MxuTables(MT.get_tables(name))
    jmt = JM.get_mxu_tables(name)
    _assert_tables_equal(mt, jmt)
    fp = MT.fold_plan(mt)
    assert fp == MT.from_jax_fold_plan(JM.fixed_fold_plan(name))
    spec = np.random.default_rng(5).integers(0, mt.q, mt.n, dtype=np.uint32)
    W, c = MT.fold_tables(mt, fp, spec)
    jW, jc = JM.fixed_fold_tables(name, spec)
    np.testing.assert_array_equal(W, np.asarray(jW))
    np.testing.assert_array_equal(c, np.asarray(jc))
    if mt.n > 1024:
        return
    bw, nb = mt.bw, mt.nb
    for dense, blocks in (
            (MT._fwd_matrix(mt.tbl, mt.Lr), MT._fwd_blocks(mt.tbl, mt.Lr,
                                                            bw)),
            (MT._inv_matrix(mt.tbl, mt.logn - mt.Lr),
             MT._inv_blocks(mt.tbl, mt.logn - mt.Lr, bw))):
        for b in range(nb):
            sl = slice(b * bw, (b + 1) * bw)
            np.testing.assert_array_equal(blocks[b], dense[sl, sl])
            rest = dense[sl].copy()
            rest[:, sl] = 0
            assert not rest.any()
        # a chunk of blocks is those blocks
        np.testing.assert_array_equal(
            MT._fwd_blocks(mt.tbl, mt.Lr, bw, nb - 1, nb),
            MT._fwd_blocks(mt.tbl, mt.Lr, bw)[nb - 1:])
    if mt.Lr:
        with pytest.raises(ValueError, match="not local"):
            MT._fwd_blocks(mt.tbl, mt.Lr - 1, bw)


def test_plan_past_the_table_limit_raises_before_building(monkeypatch):
    """n = 2^25 (q = 469762049, 4 classes): the tables would take 128 GiB;
    get_mxu_tables and the "mxu" entry points raise naming the bytes and
    the limit without building a table (the NTT tables included)."""
    name, n, q = REGISTERED[-1]
    need = MT.table_bytes(n, q)
    assert need == (4 + 4) * 4 * 128 * n > MT.MAX_TABLE_BYTES

    def refuse(*_):
        raise AssertionError("a table was built")

    monkeypatch.setattr(MT, "get_tables", refuse)
    monkeypatch.setattr(MT, "_fwd_blocks", refuse)
    MT.get_mxu_tables.cache_clear()
    start = time.perf_counter()
    for fn in (lambda: MT.get_mxu_tables(name),
               lambda: M.polymul_mxu_fn.__wrapped__(name),
               lambda: polymul_fixed_fn(name),
               lambda: polymul_fixed_fn(name, "mxu-folded")):
        with pytest.raises(ValueError, match=rf"{need} bytes .* past the "
                                             rf"{MT.MAX_TABLE_BYTES} bytes"):
            fn()
    assert time.perf_counter() - start < 5
    # the largest ring of the sweep rings stays under the limit
    assert MT.table_bytes(1 << 20, 1012924417) <= MT.MAX_TABLE_BYTES


# ----------------------------------------------------------------------
# Plans against the launchers' checks.
# ----------------------------------------------------------------------

def _sweep_launcher_accepts(plan, L):
    """``plan_ok`` of ``csrc/pass_sweeps.cu`` for a plan that starts at
    ``low`` > 0, restated: B2 or B3, one to three windows covering [low,
    L), one launch each (B2 from the top down, B3 from low up), each an
    upper window with its three column bits."""
    kind = Ps.SWEEP_KIND_NAMES[plan.kind]
    W, low = plan.windows, plan.win_lo[0]
    if (kind not in ("B2", "B3") or not 1 <= W <= 3 or not 0 < low < L
            or plan.win_hi[W - 1] != L or plan.sweeps != W):
        return False
    for w in range(1, W):
        if plan.win_lo[w] != plan.win_hi[w - 1]:
            return False
    for i in range(W):
        w = W - 1 - i if kind == "B2" else i
        lo, hi = plan.win_lo[w], plan.win_hi[w]
        S = hi - lo + 3
        want = dict(lo=lo, hi=hi, fwd=kind == "B2", inv=kind == "B3", cb=0,
                    cols=3, ops=1, split=1, ld=0, ld_refl=0, st=0,
                    st_refl=0, tiles=1 << (L - S),
                    threads=min(1024, max(32, 1 << (S - 3))),
                    smem=4 * ((1 << S) + (1 << S >> 5) + 8))
        if S > 15 or any(getattr(plan, f)[i] != v for f, v in want.items()):
            return False
    return True


@pytest.mark.parametrize("kind", ["B2", "B3"])
def test_wide_sweep_plans_meet_the_launchers_checks(kind):
    """At every n from 2^8 to 2^25, B2's and B3's plans from bit 7 up cover
    [7, L) with windows of at most 12 bits, run each stage once and in
    order, and meet the launcher's checks; other kinds and a low of 0 or L
    are refused."""
    for L in range(8, 26):
        plan = Ps.sweep_plan(1 << L, kind, low=7)
        assert _sweep_launcher_accepts(plan, L), (kind, L)
        bits = []
        for i in range(plan.sweeps):
            bits += list(range(plan.hi[i] - 1, plan.lo[i] - 1, -1)) \
                if kind == "B2" else list(range(plan.lo[i], plan.hi[i]))
        assert bits == (list(range(L - 1, 6, -1)) if kind == "B2"
                        else list(range(7, L)))
        assert plan.sweeps == (1 if L <= 19 else 2)
    for bad in (("B1", 7), ("gs_ct", 7), ("B2", 18), ("B3", 20)):
        with pytest.raises(ValueError, match="bit 0"):
            Ps.sweep_plan(1 << 18, bad[0], low=bad[1])


@pytest.mark.parametrize("name", ["qtesla-iii-speed", "split-q30-n1024",
                                  "qtesla-p-iii"])
def test_split_plans_meet_the_launchers_checks(name):
    """``split_plan`` of every mode against ``launch_split``'s checks,
    restated, and the shared memory its block takes; n < 256 refused."""
    mt = MT.get_mxu_tables(name)
    for i, mode in enumerate(MS.MODES):
        p = MS.split_plan(mt, mode)
        di = MT.fold_plan(mt).Din if mode == "folded" else mt.Di
        assert (p.mode, p.bw, p.n, p.nb * 128, p.lr) == (
            i, 128, mt.n, mt.n, mt.logn - 7)
        assert p.rows == (32 if mode == "product" else 64)
        assert (p.df, p.di) == (mt.Df, di)
        assert (p.stages_f, p.stages_i) == (2 * mt.Df, 2 * di)
        for din, lb in ((p.df, p.fwd_lb), (p.di, p.inv_lb)):
            assert (lb == 7 and din <= 6) or (lb == 8 and din <= 4)
        rows = 64
        ks = 64 * max(p.stages_f, p.stages_i) + 16
        assert MS.split_smem(p) == rows * (512 + ks) <= 232448
    assert MS.split_launches(mt.n, "product") == {
        "ntt_fused": 2, "polymul_mxu_split": 1, "intt_fused": 1}
    small = MT.get_mxu_tables("smallprime")
    with pytest.raises(ValueError, match="n >= 256"):
        MS.split_plan(small, "product")
    x = torch.zeros((1, small.n), dtype=torch.uint32)
    with pytest.raises(ValueError, match="n >= 256"):
        M.ntt_mxu(x, small, split=True)


def test_split_form_is_the_plans_choice():
    """The wrappers take the split form from SPLIT_FROM and at smaller n
    only when forced; its tables keep no dense copy."""
    assert M.SPLIT_FROM == 32768
    mt = MT.get_mxu_tables("qtesla-iii-speed")
    assert not M.split_form(mt) and M.split_form(mt, True)
    big = MT.get_mxu_tables("split-n32768")
    assert M.split_form(big) and not M.split_form(big, False)
    tabs = M.host_tables(big)
    assert tabs.wf is None and tabs.wi is None
    assert M.host_tables(mt).wf is not None


# ----------------------------------------------------------------------
# The forced split form against JAX's interpret-mode kernels.
# ----------------------------------------------------------------------

def _operands(name):
    """64 rows of x and y (row 0 all q - 1 in both), a constant y[0] and
    inverse inputs below pw_bound (row 0 all pw_bound - 1)."""
    ps = get_params(name)
    q, n = ps.q, ps.n
    rng = np.random.default_rng(91)
    x = rng.integers(0, q, (BATCH, n), dtype=np.uint32)
    y = rng.integers(0, q, (BATCH, n), dtype=np.uint32)
    x[0] = y[0] = q - 1
    bound = MT.get_mxu_tables(name).pw_bound
    lazy = rng.integers(0, bound, (BATCH, n), dtype=np.uint32)
    lazy[0] = bound - 1
    return x, y, lazy


@functools.lru_cache(maxsize=None)
def _jax_refs(name, ref="interpret"):
    """JAX's interpret-mode kernels of every mode on ``_operands(name)``,
    or (``ref`` "merged") its merged transforms and product."""
    x, y, lazy = _operands(name)
    if ref == "merged":
        tbl = JT.get_tables(name)
        fwd = jax.jit(functools.partial(JN.ntt_fwd_merged, tbl=tbl))
        inv = jax.jit(functools.partial(JN.intt_inv_merged, tbl=tbl))
        pm = JP.polymul_fn(name, "merged")
        zf = np.asarray(pm(x, np.broadcast_to(y[:1], y.shape)))
        q = get_params(name).q
        return np.array(fwd(jnp.asarray(y[:1]))), {
            "product": np.asarray(pm(x, y)),
            "ntt": np.asarray(fwd(jnp.asarray(x))),
            "intt": np.asarray(inv(jnp.asarray(lazy % q))),
            "fixed": zf, "folded": zf}
    spec = np.array(JM.ntt_mxu_fn(name, interpret=True)(y[:1]))
    return spec, {
        "product": np.asarray(JM.polymul_mxu_fn(name, interpret=True)(x, y)),
        "ntt": np.asarray(JM.ntt_mxu_fn(name, interpret=True)(x)),
        "intt": np.asarray(JM.intt_mxu_fn(name, interpret=True)(lazy)),
        "fixed": np.asarray(JM.polymul_fixed_mxu_fn(name, interpret=True)(
            x, spec)),
        "folded": np.asarray(JM.polymul_fixed_folded_mxu_fn(
            name, interpret=True)(x, *JM.fixed_fold_tables(name, spec[0])))}


def _port(mode, name, x, y, lazy, spec, split):
    mt = MT.get_mxu_tables(name)
    t = torch.from_numpy
    if mode == "product":
        out = M.polymul_mxu(t(x), t(y), mt, split=split)
    elif mode == "ntt":
        out = M.ntt_mxu(t(x), mt, split=split)
    elif mode == "intt":
        out = M.intt_mxu(t(lazy), mt, split=split)
    elif mode == "fixed":
        out = M.polymul_fixed_mxu(t(x), t(spec), mt, split=split)
    else:
        out = M.polymul_fixed_folded_mxu(
            t(x), M.fold_operand(t(spec), mt), mt, split=split)
    assert out.dtype == torch.uint32
    return out.numpy()


@pytest.mark.parametrize("batch", [1, 3, BATCH])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name, ref", [
    ("qtesla-iii-speed", "interpret"), ("split-q30-n1024", "merged"),
    pytest.param("split-q30-n1024", "interpret", marks=pytest.mark.slow)])
def test_forced_split_matches_pallas_interpret(name, ref, mode, batch):
    """Rows 0 .. batch - 1 (row 0 of q - 1, or pw_bound - 1 for B7) of the
    split form bit for bit JAX's interpret-mode kernel (at the q30 set in
    ``slow``, else JAX's merged transforms and product, what its tests
    hold the kernels to) and the one-block twin."""
    x, y, lazy = (a[:batch] for a in _operands(name))
    spec, refs = _jax_refs(name, ref)
    got = _port(mode, name, x, y, lazy, spec, True)
    np.testing.assert_array_equal(got, refs[mode][:batch])
    np.testing.assert_array_equal(
        got, _port(mode, name, x, y, lazy, spec, False))


@pytest.mark.parametrize("name", FORCED)
def test_forced_split_matches_the_oracle(name):
    """The split product's row 0 (all q - 1) and row 1, and the fixed
    product's, against the schoolbook oracle."""
    ps = get_params(name)
    x, y, lazy = (a[:2] for a in _operands(name))
    spec = M.ntt_mxu(torch.from_numpy(y[:1]),
                     MT.get_mxu_tables(name)).numpy()
    z = _port("product", name, x, y, lazy, spec, True)
    zf = _port("fixed", name, x, y, lazy, spec, True)
    for r in range(2):
        np.testing.assert_array_equal(z[r], negacyclic_schoolbook(
            x[r], y[r], ps).astype(np.uint32))
    np.testing.assert_array_equal(zf[1], negacyclic_schoolbook(
        x[1], y[0], ps).astype(np.uint32))


def test_forced_split_round_trip_and_models():
    """intt(ntt(x)) == x in the split form, and the models' "mxu" entry
    points (the plan's form at n = 1024) equal it."""
    name = "split-q30-n1024"
    x, y, _ = _operands(name)
    mt = MT.get_mxu_tables(name)
    xt, yt = torch.from_numpy(x[:3]), torch.from_numpy(y[:3])
    X = M.ntt_mxu(xt, mt, split=True)
    assert torch.equal(M.intt_mxu(X, mt, split=True), xt)
    assert torch.equal(ntt(xt, name, "mxu"), X)
    assert torch.equal(TP.polymul_negacyclic(xt, yt, name, "mxu"),
                       M.polymul_mxu(xt, yt, mt, split=True))


# ----------------------------------------------------------------------
# n = 32768 (slow).
# ----------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("name", ["split-n32768", "split-q30-n32768"])
def test_split_form_at_32768(name):
    """The planner in seconds (printed), equal to JAX's fold plan; the
    split form of every mode against JAX's merged product and transform,
    the oracle's row of q - 1, intt(ntt(x)) == x, ntt "mxu" == "fused" and
    polymul_fixed_fn's "mxu" and "mxu-folded" pairs."""
    ps = get_params(name)
    q, n = ps.q, ps.n
    MT.get_mxu_tables.cache_clear()
    start = time.perf_counter()
    mt = MT.get_mxu_tables(name)
    print(f"{name}: planner {time.perf_counter() - start:.2f} s")
    rng = np.random.default_rng(3)
    x = rng.integers(0, q, (2, n), dtype=np.uint32)
    y = rng.integers(0, q, (2, n), dtype=np.uint32)
    x[0] = y[0] = q - 1
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    z = M.polymul_mxu(xt, yt, mt)
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(JP.polymul_fn(name, "merged")(x, y)))
    np.testing.assert_array_equal(z[0].numpy(), negacyclic_schoolbook(
        x[0], y[0], ps).astype(np.uint32))
    X = ntt(xt, name, "mxu")
    assert torch.equal(X, ntt(xt, name, "fused"))
    assert torch.equal(intt(X, name, "mxu"), xt)
    for algo in ("mxu", "mxu-folded"):
        prepare, multiply = polymul_fixed_fn(name, algo)
        zf = multiply(xt, prepare(yt[:1]))
        np.testing.assert_array_equal(
            zf.numpy(),
            np.asarray(JP.polymul_fn(name, "merged")(x, y[:1].repeat(2, 0))))
