"""The nonzero blocks of the sequence-parallel digit tables
(``compact_layout``, ``compact_tables``, ``expand_compact`` in
``parallel/sharded_mxu_tables.py``), which the kernels B11 (``sp_seg1``),
B16 (``sp_seg3``, under p3 and p3x), B12 (``sp_seg2``) and B18
(``sp_seg2_classes``) multiply, and the plain products that read them
(``seg1_compact_plain``, ``seg3_compact_plain``, ``seg2_compact_plain``,
``seg2_classes_compact_plain``).

- the compact tables expanded back equal the dense tables of every plan and
  of the class plan, so every entry outside the blocks is zero; a layout of
  the wrong kind raises; the class tables' diagonal blocks are all one;
- the compact products equal the dense twins ``seg1_plain`` and
  ``seg2_classes_plain`` at B in {1, 3, 64}, random and all-(q-1) operands;
- through them JAX's interpret-mode ``_make_seg1`` and
  ``_make_seg2_classes`` match, the latter on JAX's own B17 output;
- ``seg3_compact_plain`` equals ``seg3_plain`` and JAX's interpret-mode
  ``_make_seg3`` under p3 and p3x: smallprime and qtesla-iii-speed here,
  every set at every model axis in the slow tier;
- ``SpDeviceTables.w2fc`` (K2f's n2-blocks) expands back to the dense K2f,
  and ``seg2_compact_plain`` equals ``seg2_plain`` and JAX's
  interpret-mode ``_make_seg2``, likewise;
- the compact plans pick rows and route inside the kernels' shared memory;
  the depth order of the column tables (``korder``) is the order the
  kernels' packed split writes.

Tolerance: none (exact integers).  Inputs are made with numpy from a seed.
"""

import functools

import numpy as np
import pytest
import torch

from qtesla_tpu.parallel import sharded_mxu as JS
from qtesla_tpu.params import get_params
from qtesla_tpu_torch.parallel import sharded_classes as C
from qtesla_tpu_torch.parallel import sharded_mxu as S
from qtesla_tpu_torch.parallel import sharded_mxu_tables as ST

SETS = ["smallprime", "qtesla-i", "qtesla-iii-speed", "qtesla-p-i",
        "qtesla-p-iii"]
# every set with each model axis its four-step split takes
CASES = [(name, k) for name in SETS for k in (2, 4, 8)
         if not (name == "smallprime" and k == 8)]
FAST = [("smallprime", 2), ("smallprime", 4), ("qtesla-iii-speed", 4)]
BATCHES = (1, 3, 64)


def _n1(name):
    return 1 << (get_params(name).logn // 2)


def _plans(name, k):
    return ST.fourstep_mxu_plans(name, _n1(name), k)


def _operands(q, shape, worst, seed):
    if worst:
        return np.full(shape, q - 1, dtype=np.uint32)
    return np.random.default_rng(seed).integers(0, q, shape, dtype=np.uint32)


# ----------------------------------------------------------------------
# The tables.
# ----------------------------------------------------------------------

def _check_tables(name, k):
    plans = _plans(name, k)
    TW, Bk, n2k, n2 = plans.TW, plans.Bk, plans.n2k, plans.n2
    cols, rows = (ST.compact_layout(plans, kind)
                  for kind in ("columns", "rows"))
    # the structure comes from the plan's shapes
    assert cols.s == min(TW, max(Bk, 8)) and rows.s == min(TW, max(n2, 8))
    lanes = np.arange(TW)
    np.testing.assert_array_equal(cols.pos, (lanes % n2k) * Bk + lanes // n2k)
    np.testing.assert_array_equal(rows.pos, lanes)
    for lay in (cols, rows):
        assert lay.nblk * lay.s == TW
        np.testing.assert_array_equal(lay.lane[lay.pos], lanes)
    # byte 4w + j of a plane: position w + j * s/4 (columns), 4w + j (rows)
    byte = np.arange(cols.s)
    np.testing.assert_array_equal(
        cols.korder, (byte >> 2) + (byte & 3) * (cols.s // 4))
    np.testing.assert_array_equal(rows.korder, np.arange(rows.s))
    assert (cols.lq, rows.lq) == (cols.ls - 2, 0)
    tables = [(cols, plans.p1), (cols, plans.p3), (cols, plans.p3x),
              (rows, plans.p2f), (rows, plans.p2i)]
    for lay, p in tables:
        blocks = ST.compact_tables(p.W, lay)
        kp = ST.compact_depth(p.din, lay.s)
        assert blocks.dtype == np.int8 and kp % 32 == 0
        assert blocks.shape == (*p.W.shape[:-3], lay.nblk,
                                p.W.shape[-1] // TW * lay.s, kp)
        assert p.din * lay.s <= kp < p.din * lay.s + 32
        assert not blocks[..., p.din * lay.s:].any()
        # nothing of the dense table lies outside the blocks
        np.testing.assert_array_equal(ST.expand_compact(blocks, lay, p.din),
                                      p.W)
    tabs = S.host_tables(plans)
    np.testing.assert_array_equal(tabs.w1c.numpy(),
                                  ST.compact_tables(plans.p1.W, cols))
    np.testing.assert_array_equal(tabs.w2ic.numpy(),
                                  ST.compact_tables(plans.p2i.W, rows))
    # K1 is not block-diagonal as its lanes lie, K2i not in lambda-major
    # order: the check on the entries sees it
    if cols.nblk > 1 and n2k > 1:
        with pytest.raises(ValueError, match="outside"):
            ST.compact_tables(plans.p1.W, rows if rows.nblk > 1 else
                              ST.CompactLayout(**{**rows.__dict__,
                                                  "s": cols.s,
                                                  "nblk": cols.nblk}))
    if rows.nblk > 1 and n2k > 1:
        with pytest.raises(ValueError, match="outside"):
            ST.compact_tables(plans.p2i.W, cols)
    return plans, rows


def _check_class_tables(name, k):
    plans, rows = _check_tables(name, k)
    cp = ST.class_boundary_plan(name, _n1(name), k)
    W = np.concatenate(cp.W, axis=0)
    blocks = ST.compact_tables(W, rows)
    np.testing.assert_array_equal(ST.expand_compact(blocks, rows, sum(cp.dins)),
                                  W)
    # K2f = kron(I, R2): one block serves every n2-block of a tile
    w2cc = C.host_compact_class_table(cp, plans)
    assert tuple(w2cc.shape) == (cp.Dout * rows.s,
                                 ST.compact_depth(sum(cp.dins), rows.s))
    for b in range(rows.nblk):
        np.testing.assert_array_equal(blocks[b], w2cc.numpy())
    w2c, _ = C.host_class_tables(cp)
    dense = ST.expand_compact(np.broadcast_to(w2cc.numpy(), blocks.shape),
                              rows, sum(cp.dins))
    np.testing.assert_array_equal(S._kernel_layout(dense).numpy(),
                                  w2c.numpy())


@pytest.mark.parametrize("name,k", FAST)
def test_compact_tables_expand_to_dense(name, k):
    _check_class_tables(name, k)


@pytest.mark.slow
@pytest.mark.parametrize("name,k", [c for c in CASES if c not in FAST])
def test_compact_tables_expand_to_dense_slow_tier(name, k):
    """The other sets and model axes: slow because each SP plan takes up to
    10 s to build (30 s at qtesla-p-iii)."""
    if name.startswith("qtesla-p-"):
        _check_tables(name, k)          # four classes: no class plan
    else:
        _check_class_tables(name, k)


def test_compact_layout_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown table kind"):
        ST.compact_layout(_plans("smallprime", 2), "diagonal")
    plans = _plans("qtesla-iii-speed", 4)
    with pytest.raises(ValueError, match="lanes"):
        ST.compact_tables(_plans("smallprime", 2).p1.W,
                          ST.compact_layout(plans, "columns"))


# ----------------------------------------------------------------------
# The plain products over the compact tables.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name,k", FAST)
def test_compact_products_match_dense_twins(name, k, batch, worst):
    plans = _plans(name, k)
    cp = ST.class_boundary_plan(name, _n1(name), k)
    x, y = (torch.from_numpy(v) for v in _operands(
        plans.q, (2, k, batch, plans.nloc), worst, 81))
    got = S.seg1_compact_plain(x, plans)
    assert got.dtype == torch.uint32 and got.shape == x.shape
    assert torch.equal(got, S.seg1_plain(x, plans))
    d = k // 2
    assert torch.equal(S.seg1_compact_plain(x[d:d + 1], plans, first=d),
                       got[d:d + 1])
    u, v = (C.seg1_classes_plain(t, plans, cp) for t in (x, y))
    got = C.seg2_classes_compact_plain(u, v, plans, cp)
    assert got.dtype == torch.uint32 and got.shape == x.shape
    assert torch.equal(got, C.seg2_classes_plain(u, v, plans, cp))
    assert torch.equal(
        C.seg2_classes_compact_plain(u[d:d + 1], v[d:d + 1], plans, cp,
                                     first=d), got[d:d + 1])
    # on CPU tensors the wrappers take the dense twins
    assert torch.equal(S.sp_seg1(x, plans), S.seg1_plain(x, plans))
    assert torch.equal(C.sp_seg2_classes(u, v, plans, cp), got)


@pytest.mark.slow
@pytest.mark.parametrize("name,k", [("qtesla-i", 2), ("qtesla-i", 8),
                                    ("qtesla-iii-speed", 2),
                                    ("qtesla-iii-speed", 8),
                                    ("qtesla-p-i", 4), ("qtesla-p-iii", 2)])
def test_compact_products_match_dense_twins_slow_tier(name, k):
    """The other block shapes (s = 8, 32; widened blocks at qtesla-p-iii,
    k = 2): slow because each SP plan takes up to 30 s to build."""
    plans = _plans(name, k)
    for worst in (False, True):
        x, y = (torch.from_numpy(v) for v in _operands(
            plans.q, (2, k, 3, plans.nloc), worst, 82))
        assert torch.equal(S.seg1_compact_plain(x, plans),
                           S.seg1_plain(x, plans))
        if not name.startswith("qtesla-p-"):
            cp = ST.class_boundary_plan(name, _n1(name), k)
            u, v = (C.seg1_classes_plain(t, plans, cp) for t in (x, y))
            assert torch.equal(
                C.seg2_classes_compact_plain(u, v, plans, cp),
                C.seg2_classes_plain(u, v, plans, cp))


def test_compact_class_sums_match_dense_class_sums():
    """``compact_class_sums`` equals ``class_sums`` on raw digit planes,
    before any recombination: K1's lambda-major blocks at qtesla-iii-speed,
    k = 4."""
    from qtesla_tpu_torch.ops.ntt_mxu import _digit_planes, class_sums
    plans = _plans("qtesla-iii-speed", 4)
    tabs = S.host_tables(plans)
    p, D = plans.p1, plans.p1.W.shape[-1] // plans.TW
    v = torch.from_numpy(_operands(plans.q, (4, 5, plans.A, plans.TW), False,
                                   83)).to(torch.int64)
    planes = _digit_planes(v, p.off, p.din, p.base)
    got = S.compact_class_sums(planes, tabs.w1c,
                               ST.compact_layout(plans, "columns"), D)
    assert torch.equal(got, class_sums(planes, tabs.w1, D))


# ----------------------------------------------------------------------
# Against the interpret-mode Pallas kernels.
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_segs(name, k):
    plans = JS.fourstep_mxu_plans(name, _n1(name), k)
    cp = JS.class_boundary_plan(name, _n1(name), k)
    return plans, cp, (JS._make_seg1(plans, 256, True),
                       JS._make_seg1_classes(plans, cp, 256, True),
                       JS._make_seg2_classes(plans, cp, 256, True))


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name,k", [("smallprime", 2),
                                    ("qtesla-iii-speed", 4)])
def test_compact_products_match_pallas_interpret(name, k, batch, worst):
    jplans, jcp, (jseg1, jseg1c, jseg2c) = _jax_segs(name, k)
    plans = _plans(name, k)
    cp = ST.class_boundary_plan(name, _n1(name), k)
    q, nloc = plans.q, plans.nloc
    x, y = _operands(q, (2, batch, nloc), worst, 84)
    xt = torch.from_numpy(x)[None]
    # one shard at the small sets' every k, the middle shard at q-III
    for d in (range(k) if name == "smallprime" else (k // 2,)):
        sl = slice(d, d + 1)
        want = np.asarray(jseg1(x, jplans.p1.W[sl], jplans.p1.const[sl])) % q
        got = S.seg1_compact_plain(xt, plans, first=d)
        assert int(got.to(torch.int64).max()) < q
        np.testing.assert_array_equal(got[0].numpy(), want,
                                      err_msg=f"B11 shard {d}")
        # B18 on JAX's own B17 output: the state carried across
        ux, uy = (np.asarray(jseg1c(v, jplans.p1.W[sl])) for v in (x, y))
        want = np.asarray(jseg2c(ux, uy, *jcp.W, jcp.const[sl],
                                 jplans.p2i.W[sl], jplans.p2i.const[sl])) % q
        uxt, uyt = (torch.from_numpy(u.copy())[None] for u in (ux, uy))
        got = C.seg2_classes_compact_plain(uxt, uyt, plans, cp, first=d)
        assert int(got.to(torch.int64).max()) < q
        np.testing.assert_array_equal(got[0].numpy(), want,
                                      err_msg=f"B18 shard {d}")


# ----------------------------------------------------------------------
# Rows and route of the compact kernels.
# ----------------------------------------------------------------------

def test_compact_route_prefers_shared_tables_then_rows():
    """``compact_route``: tables in shared memory with two blocks an SM,
    then one block, then the tables from L2, then fewer rows; a row that
    never fits raises."""
    block = 232448

    def smem(per_row, tables):
        return lambda rows, t: rows * per_row + t * tables

    assert S.compact_route(smem(1024, 50 << 10)) == (16, 1)
    assert S.compact_route(smem(4 << 10, 50 << 10)) == (32, 1)
    assert S.compact_route(smem(6 << 10, 50 << 10)) == (16, 1)
    assert S.compact_route(smem(2 << 10, 200 << 10)) == (16, 0)
    assert S.compact_route(smem(12 << 10, 200 << 10)) == (16, 0)
    assert S.compact_route(smem(16 << 10, 200 << 10)) == (block // (16 << 10),
                                                         0)
    with pytest.raises(ValueError, match="does not fit"):
        S.compact_route(smem(block + 1, 0))
    for nblk, kp in ((8, 64), (1, 288), (16, 32), (1, 1152), (4, 96)):
        ks = S.planes_stride(nblk, kp)
        assert ks % 64 == 32 and 0 <= ks - nblk * (kp + 8) < 64


def test_table_stride_spreads_fragment_rows():
    """The row segment kernel's table rows in shared memory: a depth padded
    to 32 mod 64, so that the 16 threads of a half-warp's 8-byte fragment
    load (rows g < 4, bytes 8 tig of a row) fall on 32 distinct banks; the
    depths that already are (288 and 96 at qtesla-iii-speed) keep their
    stride, and K2f's 128 becomes 160."""
    for kp in (32, 64, 96, 128, 256, 288, 384, 512):
        ts = S.table_stride(kp)
        assert ts % 64 == 32 and kp <= ts < kp + 64
        banks = {(g * ts + tig * 8) // 4 % 32 + w
                 for g in range(4) for tig in range(4) for w in range(2)}
        assert len(banks) == 32
    assert [S.table_stride(kp) for kp in (288, 96, 128)] == [288, 96, 160]


def test_main_path_plans_hold_tables_in_shared_memory():
    """qtesla-iii-speed, k = 4: B11 runs 16 rows a buffer beside its
    shard's 48 KiB of tables, two blocks an SM; B18 8 + 8 rows a warp
    beside 36 KiB of tables; the depths are 64, 288 and 96 where the dense
    tables run 384, 1152 and 384."""
    plans = _plans("qtesla-iii-speed", 4)
    cp = ST.class_boundary_plan("qtesla-iii-speed", 32, 4)
    p11 = S.seg1_compact_plan(plans)
    assert (p11.rows, p11.smem_tables, 1 << p11.c1.ls, p11.c1.kp) == (
        16, 1, 16, 64)
    assert S.plan_for(plans, "sp_seg1").kp1 == 384
    p18 = C.plan_for(plans, cp, "sp_seg2_classes")
    assert (p18.rows, p18.smem_tables, 1 << p18.c1.ls) == (16, 1, 32)
    assert (p18.c1.kp, p18.c2.kp) == (288, 96)
    sp2 = S.plan_for(plans, "sp_seg2")
    assert (sum(cp.dins) * plans.TW, sp2.kp2) == (1152, 384)
    # B12 takes B18's layout and route with two units a warp; its first
    # product is 128 deep where the dense one runs 512
    p12 = S.seg2_compact_plan(plans)
    assert (p12.rows, p12.smem_tables, 1 << p12.c1.ls) == (32, 1, 32)
    assert (p12.c1.kp, p12.c2.kp, sp2.kp1) == (128, 96, 512)


# ----------------------------------------------------------------------
# B16: the inverse column segment over K3's nonzero blocks.
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_seg3(name, k):
    plans = JS.fourstep_mxu_plans(name, _n1(name), k)
    return plans, (JS._make_seg3(plans, 256, True),
                   JS._make_seg3(plans, 256, True, plan=plans.p3x))


def _check_seg3(name, k, x, shards):
    """seg3_compact_plain on x (S=1 shards at each d of ``shards``, and all
    k at once) against seg3_plain and JAX's _make_seg3, p3 and p3x."""
    jplans, jsegs = _jax_seg3(name, k)
    plans = _plans(name, k)
    q = plans.q
    xt = torch.from_numpy(x)
    for folded, jseg, jp in ((False, jsegs[0], jplans.p3),
                             (True, jsegs[1], jplans.p3x)):
        got = S.seg3_compact_plain(xt, plans, folded=folded)
        assert got.dtype == torch.uint32 and got.shape == xt.shape
        assert torch.equal(got, S.seg3_plain(xt, plans, folded=folded))
        for d in shards:
            sl = slice(d, d + 1)
            one = S.seg3_compact_plain(xt[sl], plans, first=d, folded=folded)
            assert torch.equal(one, got[sl])
            want = np.asarray(jseg(x[d], jp.W[sl], jp.const[sl])) % q
            np.testing.assert_array_equal(
                one[0].numpy(), want, err_msg=f"B16 folded={folded} shard {d}")
        # on CPU tensors the wrapper takes the dense twin
        assert torch.equal(S.sp_seg3(xt, plans, folded=folded), got)


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name,k", FAST)
def test_seg3_compact_products_match_dense_twins(name, k, batch, worst):
    """``seg3_compact_plain`` equals ``seg3_plain`` under p3 and p3x."""
    plans = _plans(name, k)
    x = torch.from_numpy(_operands(plans.q, (k, batch, plans.nloc), worst,
                                   85))
    for folded in (False, True):
        got = S.seg3_compact_plain(x, plans, folded=folded)
        assert got.dtype == torch.uint32 and got.shape == x.shape
        assert torch.equal(got, S.seg3_plain(x, plans, folded=folded))
        d = k // 2
        assert torch.equal(
            S.seg3_compact_plain(x[d:d + 1], plans, first=d, folded=folded),
            got[d:d + 1])


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("name,k", [("smallprime", 2),
                                    ("qtesla-iii-speed", 4)])
def test_seg3_compact_products_match_pallas_interpret(name, k, worst):
    """Through the compact K3, shard by shard, JAX's interpret-mode
    ``_make_seg3`` (p3 and p3x) mod q: every shard at smallprime, the
    middle one at qtesla-iii-speed."""
    plans = _plans(name, k)
    x = _operands(plans.q, (k, 3, plans.nloc), worst, 86)
    _check_seg3(name, k, x, range(k) if name == "smallprime" else (k // 2,))


@pytest.mark.slow
@pytest.mark.parametrize("name,k", [c for c in CASES
                                    if c not in (("smallprime", 2),
                                                 ("qtesla-iii-speed", 4))])
def test_seg3_compact_products_match_pallas_interpret_slow_tier(name, k):
    """Every other set and model axis, random and all-(q-1), two shards:
    slow because each plan takes up to 30 s to build on both sides."""
    plans = _plans(name, k)
    for worst in (False, True):
        x = _operands(plans.q, (k, 3, plans.nloc), worst, 87)
        _check_seg3(name, k, x, (0, k - 1))


def test_main_path_b16_depth():
    """qtesla-iii-speed, k = 4: B16 multiplies depth 64 where the dense K3
    runs 512, p3 and p3x alike, with its shard's 48 KiB of blocks in shared
    memory beside two buffers of 16 rows."""
    plans = _plans("qtesla-iii-speed", 4)
    tabs = S.host_tables(plans)
    for folded, w3c in ((False, tabs.w3c), (True, tabs.w3xc)):
        p16 = S.seg3_compact_plan(plans, folded)
        assert (p16.rows, p16.smem_tables, 1 << p16.c1.ls, p16.c1.kp) == (
            16, 1, 16, 64)
        assert w3c[0].numel() == 48 << 10
    assert S.plan_for(plans, "sp_seg3").kp1 == S.plan_for(
        plans, "sp_seg3 p3x").kp1 == 512


# ----------------------------------------------------------------------
# B12: the row segment over K2f's and K2i's nonzero blocks.
# ----------------------------------------------------------------------

def _check_w2fc(name, k):
    """``w2fc`` holds K2f's n2-blocks (``compact_tables`` of p2f's one
    shared table in the "rows" layout) and nothing else: expanded back it is
    the dense K2f, zero outside its blocks.  K2f = kron(I, R2), so its
    blocks are all one; the kernel reads each n2-block's own block all the
    same and does not rely on it."""
    plans = _plans(name, k)
    rows = ST.compact_layout(plans, "rows")
    p = plans.p2f
    w2fc = S.host_tables(plans).w2fc.numpy()
    D = p.W.shape[-1] // plans.TW
    assert w2fc.shape == (rows.nblk, D * rows.s,
                          ST.compact_depth(p.din, rows.s))
    np.testing.assert_array_equal(w2fc, ST.compact_tables(p.W, rows))
    np.testing.assert_array_equal(ST.expand_compact(w2fc, rows, p.din), p.W)
    assert np.count_nonzero(w2fc) == np.count_nonzero(p.W)
    assert not w2fc[..., p.din * rows.s:].any()
    for b in range(rows.nblk):
        np.testing.assert_array_equal(w2fc[b], w2fc[0])


@pytest.mark.parametrize("name,k", FAST)
def test_w2fc_expands_to_dense_k2f(name, k):
    _check_w2fc(name, k)


@pytest.mark.slow
@pytest.mark.parametrize("name,k", [c for c in CASES if c not in FAST])
def test_w2fc_expands_to_dense_k2f_slow_tier(name, k):
    """The other sets and model axes: slow because each SP plan takes up to
    30 s to build."""
    _check_w2fc(name, k)


@functools.lru_cache(maxsize=None)
def _jax_seg2(name, k):
    plans = JS.fourstep_mxu_plans(name, _n1(name), k)
    return plans, JS._make_seg2(plans, 256, True)


def _check_seg2(name, k, x, y, shards):
    """seg2_compact_plain on x and y (S=1 shards at each d of ``shards``,
    and all k at once) against seg2_plain and JAX's _make_seg2."""
    jplans, jseg2 = _jax_seg2(name, k)
    plans = _plans(name, k)
    q = plans.q
    xt, yt = (torch.from_numpy(v)[None] for v in (x, y))
    for d in shards:
        sl = slice(d, d + 1)
        got = S.seg2_compact_plain(xt, yt, plans, first=d)
        assert got.dtype == torch.uint32 and int(got.to(torch.int64).max()) < q
        assert torch.equal(got, S.seg2_plain(xt, yt, plans, first=d))
        p2f, p2i = jplans.p2f, jplans.p2i
        want = np.asarray(jseg2(x, y, p2f.W, p2f.const, p2i.W[sl],
                                p2i.const[sl])) % q
        np.testing.assert_array_equal(got[0].numpy(), want,
                                      err_msg=f"B12 shard {d}")
    xs, ys = (torch.from_numpy(np.stack([v] * k)) for v in (x, y))
    got = S.seg2_compact_plain(xs, ys, plans)
    assert torch.equal(got, S.seg2_plain(xs, ys, plans))
    # on CPU tensors the wrapper runs the dense twin
    assert torch.equal(S.sp_seg2(xs, ys, plans), got)


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name,k", [("smallprime", 2),
                                    ("qtesla-iii-speed", 4)])
def test_seg2_compact_twin_matches_dense_and_pallas(name, k, batch, worst):
    """What B12 multiplies: smallprime at every shard, the middle shard at
    qtesla-iii-speed, B in {1, 3, 64}, random and all-(q-1) operands."""
    q, nloc = _plans(name, k).q, _plans(name, k).nloc
    x, y = _operands(q, (2, batch, nloc), worst, 86)
    _check_seg2(name, k, x, y, range(k) if name == "smallprime" else
                (k // 2,))


@pytest.mark.slow
@pytest.mark.parametrize("name,k", [c for c in CASES
                                    if c not in (("smallprime", 2),
                                                 ("qtesla-iii-speed", 4))])
def test_seg2_compact_twin_matches_dense_and_pallas_slow_tier(name, k):
    """Every other set and model axis, each shard, random and all-(q-1)
    operands: slow because each plan pair takes up to a minute to build."""
    plans = _plans(name, k)
    for worst in (False, True):
        x, y = _operands(plans.q, (2, 3, plans.nloc), worst, 87)
        _check_seg2(name, k, x, y, range(k))
