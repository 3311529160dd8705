"""The sequence-parallel (SP) paths past n = 32768, on the CPU.

- The split an entry point takes where none is given
  (``distributed.sp_n1``): JAX's 2^(log2(n) // 2) up to n = 16384, n / 128
  from 32768, n2 <= 128 at every log2(n) from 1 to 25; an explicit call
  with JAX's default split still refuses, naming n / 128.
- The fault: at (32768, 786433) on a model axis of 4, ``polymul_sp_fn``
  at ``batch_hint=2`` (the four-step) equals JAX's ``polymul_sp_fn`` on 4
  host CPU devices (JAX's "auto" runs its jnp locals there, its kernels
  refusing n2 = 256) and the port's merged path.
- The tile-wise planner (``sharded_mxu_tables.fourstep_mxu_plans``) field
  for field against JAX's ``fourstep_mxu_plans`` and, for K1, K3 and K2i,
  against the object-int loops the port's planner ran before (``_loop_
  matrices`` below, JAX's l.314-357) at smallprime, n = 64 and q-III at k in
  {2, 4, 8}; ``fourstep_fold_tables`` against JAX's; ``slow``: at (32768,
  786433) and (65536, 786433), k = 4, with the seconds.
- The split form of B11, B16 and B17 (``sp_column_split``, forced with
  ``split=True`` at small nloc): its model (B2's and B3's sweeps through
  ``passes.SweepModel``, then the compact products) against JAX's
  interpret-mode ``_make_seg1``, ``_make_seg3`` and ``_make_seg1_classes``
  at q-III, k = 4, on random rows and rows of q - 1 at B in {1, 3}; the
  wide stages' hand-off inside p1's split bound at q = 1073479681 and at
  the largest prime of each ring; the route (``column_split``) and the
  split plan against the tile kernel's shared memory at the chip's rings.
- The 2^25 refusal: the plan raises, naming the bytes, before any table
  is built.
- ``slow``: every SP entry point at n = 65536 (k = 2 split, k = 4 block)
  against ``polymul_fn(name, "merged")`` and the C++ oracle on two rows,
  row 1 all q - 1.

Tolerance: none (exact residues).  Inputs are made with numpy from a seed;
the sets are registered in both packages' registries for the module and
removed after it."""

import time

import jax
import numpy as np
import pytest
import torch

from qtesla_tpu import params as JPARAMS
from qtesla_tpu.parallel import make_mesh as jmake_mesh
from qtesla_tpu.parallel import polymul_sp_fn as jpolymul_sp_fn
from qtesla_tpu.parallel import sharded_mxu as JS
from qtesla_tpu_torch import params as TPARAMS
from qtesla_tpu_torch.models.polymul import polymul_fn
from qtesla_tpu_torch.ops import mxu_tables as MT
from qtesla_tpu_torch.ops.tables import get_tables
from qtesla_tpu_torch.parallel import make_mesh
from qtesla_tpu_torch.parallel import sharded_classes as C
from qtesla_tpu_torch.parallel import sharded_mxu as S
from qtesla_tpu_torch.parallel import sharded_mxu_tables as ST
from qtesla_tpu_torch.parallel import sp_column_split as SC
from qtesla_tpu_torch.parallel.distributed import sp_n1
from qtesla_tpu_torch.parallel.ulysses import polymul_sp_fn
from qtesla_tpu_torch.utils import native

Q30 = 1073479681
SETS = {"sp-n64": (64, 12289), "sp-n32768": (32768, 786433),
        "sp-n65536": (65536, 786433), "sp-q30-n8192": (8192, Q30),
        "sp-n2pow25": (1 << 25, 469762049)}


@pytest.fixture(scope="module", autouse=True)
def registered():
    """The sets in both registries for this module."""
    for reg in (JPARAMS, TPARAMS):
        for name, (n, q) in SETS.items():
            reg.register_param_set(name, n, q)
    yield
    for reg in (JPARAMS, TPARAMS):
        for name in SETS:
            del reg.PARAM_SETS[name]
        reg.get_params.cache_clear()


def _n1(name):
    return sp_n1(get_tables(name).n)


def _rows(q, B, n, seed, worst_row=None):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, q, (B, n), dtype=np.uint32)
    if worst_row is not None:
        x[worst_row] = q - 1
    return x


# ----------------------------------------------------------------------
# The split where none is given, and the fault it repairs.
# ----------------------------------------------------------------------

def test_sp_n1_rule_every_ring():
    for logn in range(1, 26):
        n = 1 << logn
        n1 = sp_n1(n)
        n2 = n // n1
        assert n1 * n2 == n and n2 <= 128, logn
        assert n1 == (1 << (logn // 2) if logn <= 14 else n // 128), logn
        for k in (2, 4, 8):
            if k <= min(n1, n2):
                assert n1 % k == 0 and n2 % k == 0


def test_explicit_default_split_still_refuses():
    """JAX's own default split at n = 32768 leaves n2 = 256: an explicit
    ``polymul_fourstep_mxu_fn`` refuses it as JAX's planner does, naming
    n / 128; the entry points that pick the split take n / 128."""
    cpu4 = make_mesh(model=4, device="cpu")
    with pytest.raises(ValueError, match="n1 >= n/128 = 256"):
        S.polymul_fourstep_mxu_fn("sp-n32768", cpu4)
    with pytest.raises(ValueError, match="exceeds"):
        JS.fourstep_mxu_plans("sp-n32768", 128, 4)
    with pytest.raises(ValueError, match="n2=256 exceeds"):
        S.polymul_fourstep_mxu_fn("sp-n32768", cpu4, n1=128)


def test_small_batch_sp_matches_jax_at_32768():
    """The fault: the port's four-step at batch_hint 2 refused n = 32768;
    now it takes n1 = 256 and equals JAX's product (its jnp locals) and the
    merged path, row 1 all q - 1."""
    n, q = SETS["sp-n32768"]
    x, y = (_rows(q, 2, n, s, 1) for s in (81, 82))
    jm = jmake_mesh(data=1, model=4, devices=jax.devices()[:4])
    want = np.asarray(jpolymul_sp_fn("sp-n32768", jm, batch_hint=2)(x, y))
    got = polymul_sp_fn("sp-n32768", make_mesh(model=4, device="cpu"),
                        batch_hint=2)(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), want)
    merged = polymul_fn("sp-n32768", "merged")(torch.from_numpy(x),
                                                torch.from_numpy(y))
    assert torch.equal(got, merged)


# ----------------------------------------------------------------------
# The tile-wise planner.
# ----------------------------------------------------------------------

def _loop_matrices(name, n1, k):
    """K1, K3 and K2i as the object-int loops of JAX's planner (and the
    port's before it) build them, from the dense stage matrices."""
    tbl = get_tables(name)
    q, n = tbl.q, tbl.n
    n2 = n // n1
    g = ST._shape(n, n1, k)
    n2k, n1k, TW, A, Bk, Lr = (g[f] for f in ("n2k", "n1k", "TW", "A", "Bk",
                                              "Lr"))
    t1 = ST._subtables(name, q, n1)
    T = ST._fourstep_tables(name, n1)
    W, Winv = T["W"].astype(object), T["Winv"].astype(object)
    phi, ipsi = tbl.phi.astype(object), tbl.ipsi_pow.astype(object)
    k1map = JS._k1_position_map(JS._subtables(name, n1))
    Mf = MT._fwd_matrix(t1, Lr)
    Mi = MT._inv_matrix(t1, n1.bit_length() - 1 - Lr)
    R2i = ST._transform_matrix(ST._subtables(name, q, n2), True).astype(object)
    K1 = np.zeros((k, A, TW, TW), dtype=object)
    K3 = np.zeros((k, A, TW, TW), dtype=object)
    for d in range(k):
        for t in range(A):
            for c in range(Bk):
                p = t * Bk + c
                for b in range(Bk):
                    mf = int(Mf[p, t * Bk + b]) % q
                    mi = int(Mi[p, t * Bk + b]) % q
                    for lam in range(n2k):
                        j2 = d * n2k + lam
                        i, o = b * n2k + lam, c * n2k + lam
                        if mf:
                            K1[d, t, i, o] = (int(phi[j2]) * mf % q
                                              * int(W[int(k1map[p]), j2])) % q
                        if mi:
                            K3[d, t, i, o] = mi * int(ipsi[j2]) % q
    R = TW // n2
    K2i = np.zeros((k, A, TW, TW), dtype=object)
    for d in range(k):
        for bb in range(A):
            for rho in range(R):
                p = d * n1k + bb * R + rho
                sl = slice(rho * n2, (rho + 1) * n2)
                K2i[d, bb, sl, sl] = (R2i * Winv[int(k1map[p])][None, :]) % q
    return K1, K3, K2i


def _eq(got, want, what):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, (what, got, want)


def _assert_plans_equal(got, want):
    for f in ST._LAYOUT_FIELDS + ST._PLAN_FIELDS:
        _eq(getattr(got, f), getattr(want, f), f)
    for f in ST._ROLL_FIELDS:
        _eq(getattr(got.rolls, f), getattr(want.rolls, f), "rolls." + f)
    for p in ("p1", "p2f", "p2i", "p3", "p3x"):
        for f in ST.DIGIT_FIELDS:
            _eq(getattr(getattr(got, p), f), getattr(getattr(want, p), f),
                f"{p}.{f}")
    for f in ST.FOLD_FIELDS:
        _eq(getattr(got.p2x, f), getattr(want.p2x, f), "p2x." + f)


@pytest.mark.parametrize("name,k", [
    ("smallprime", 2), ("smallprime", 4), ("sp-n64", 2), ("sp-n64", 4),
    ("qtesla-iii-speed", 2), ("qtesla-iii-speed", 4),
    ("qtesla-iii-speed", 8)])
def test_tile_planner_matches_jax_and_the_loops(name, k):
    """Field for field JAX's plans (q-III's against JAX's are
    ``test_torch_sharded_mxu.py``'s ``test_plans_match_jax``, at k = 2, 4,
    8), and K1, K3 and K2i the loops' matrices."""
    n1 = 1 << (get_tables(name).logn // 2)
    mine = ST.fourstep_mxu_plans(name, n1, k, "cpu")
    if name != "qtesla-iii-speed":
        _assert_plans_equal(mine, JS.fourstep_mxu_plans(name, n1, k))
    K1, K3, K2i = _loop_matrices(name, n1, k)
    cols = ST.compact_layout(mine, "columns")
    for got, want, what in ((mine.K1, K1, "K1"), (mine.K2i, K2i, "K2i"),
                            (mine.blocks["K3"].dense(cols), K3, "K3")):
        _eq(got, want, what)
    # the compact tables are the dense ones' nonzero blocks
    for p in ("p1", "p3", "p3x", "p2f", "p2i"):
        dp = getattr(mine, p)
        np.testing.assert_array_equal(dp.Wc, ST.compact_tables(dp.W, dp.lay))


def test_fold_tables_match_jax_tile_by_tile():
    """``fourstep_fold_tables`` (F a chunk of tiles at a time, the dense W
    expanded from its blocks) against JAX's; ``fourstep_fold_blocks`` of
    one shard's row is that shard's blocks."""
    name, k = "sp-n64", 4
    plans = ST.fourstep_mxu_plans(name, 8, k)
    jplans = JS.fourstep_mxu_plans(name, 8, k)
    spec = _rows(plans.q, 1, plans.n, 83, None)[0]
    W, c = ST.fourstep_fold_tables(plans, spec)
    jW, jc = JS.fourstep_fold_tables(jplans, spec)
    np.testing.assert_array_equal(W, np.asarray(jW))
    np.testing.assert_array_equal(c, np.asarray(jc))
    Wc, cc = ST.fourstep_fold_blocks(plans, spec.reshape(k, -1)[2:3],
                                     first=2)
    np.testing.assert_array_equal(
        Wc, ST.compact_tables(W[2:3], ST.compact_layout(plans, "rows")))
    np.testing.assert_array_equal(cc, c[2:3])


@pytest.mark.slow
@pytest.mark.parametrize("name", ["sp-n32768", "sp-n65536"])
def test_tile_planner_matches_jax_at_large_rings(name):
    n1, k = _n1(name), 4
    start = time.perf_counter()
    mine = ST.fourstep_mxu_plans(name, n1, k)
    mine_s = time.perf_counter() - start
    start = time.perf_counter()
    jplans = JS.fourstep_mxu_plans(name, n1, k)
    jax_s = time.perf_counter() - start
    print(f"{name} k={k}: the tile-wise planner {mine_s:.2f} s, JAX's "
          f"{jax_s:.2f} s (this host's CPU)")
    _assert_plans_equal(mine, jplans)


def test_table_bytes_refused_before_anything_is_built(monkeypatch):
    """At 2^25 K2i's blocks alone would take n * n2 * din * D bytes, past
    MAX_TABLE_BYTES: the plan raises naming them, before any table (the
    ring's NTT tables included) is built."""
    n, q = SETS["sp-n2pow25"]

    def built(name):
        raise AssertionError(f"tables of {name} built")

    monkeypatch.setattr(ST, "get_tables", built)
    start = time.perf_counter()
    with pytest.raises(ValueError, match=r"\d+ bytes .* GiB\), past the "):
        ST.fourstep_mxu_plans("sp-n2pow25", sp_n1(n), 4)
    assert time.perf_counter() - start < 2
    need = ST.sp_table_bytes(n, q, sp_n1(n), 4)
    assert need > MT.MAX_TABLE_BYTES >= ST.sp_table_bytes(1 << 20, 1012924417,
                                                          1 << 13, 4)


def test_sp_table_limit_pinned_at_2pow22(monkeypatch):
    """The SP plan of (2^22, 998244353) at k = 4, n1 = 2^15, the largest
    phase 3e runs, needs 9.5 GiB and is allowed; (2^23, 754974721) needs 19
    GiB and refuses, naming the bytes, before any table is built."""
    ok = ST.sp_table_bytes(1 << 22, 998244353, 1 << 15, 4)
    assert 9.5 * 2**30 <= ok < 9.6 * 2**30 and ok <= MT.MAX_TABLE_BYTES
    ST.check_sp_table_bytes(1 << 22, 998244353, 1 << 15, 4)
    n, q = 1 << 23, 754974721
    need = ST.sp_table_bytes(n, q, sp_n1(n), 4)
    assert 19 * 2**30 <= need < 19.1 * 2**30
    TPARAMS.register_param_set("sp-n2pow23", n, q)

    def built(name):
        raise AssertionError(f"tables of {name} built")

    monkeypatch.setattr(ST, "get_tables", built)
    try:
        for fn in (lambda: ST.check_sp_table_bytes(n, q, sp_n1(n), 4),
                   lambda: ST.fourstep_mxu_plans("sp-n2pow23", sp_n1(n), 4,
                                                 "cpu")):
            with pytest.raises(ValueError, match=rf"{need} bytes \(19.0 GiB"
                                                 rf"\), past the "):
                fn()
    finally:
        del TPARAMS.PARAM_SETS["sp-n2pow23"]
        TPARAMS.get_params.cache_clear()


def test_compact_twin_in_chunks_of_tiles(monkeypatch):
    """The compact twins' product taken a chunk of tiles at a time (as at
    the large rings, where a float64 copy of K2i would not fit the card)
    equals it taken at once: q-III, k = 4, the rows' K2i and the shared
    K2f."""
    plans = ST.fourstep_mxu_plans("qtesla-iii-speed", 32, 4)
    tabs = S.device_tables(plans, torch.device("cpu"))
    x, y = (torch.from_numpy(_rows(plans.q, 3, 4 * plans.nloc, sd, 1)
                             .reshape(3, 4, plans.nloc).transpose(1, 0, 2)
                             .copy()) for sd in (91, 92))
    vx, vy = (S.a2a_fwd(S.seg1_compact_plain(t, plans, tabs), plans)
              for t in (x, y))
    whole = S.seg2_compact_plain(vx, vy, plans, tabs)
    per_tile = 8 * tabs.w2ic[..., :1, :, :, :].numel()
    monkeypatch.setattr(S, "_TWIN_BYTES", per_tile)
    assert plans.A > 1
    assert torch.equal(S.seg2_compact_plain(vx, vy, plans, tabs), whole)


# ----------------------------------------------------------------------
# The split form.
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_segments():
    name, k = "qtesla-iii-speed", 4
    plans = JS.fourstep_mxu_plans(name, 32, k)
    cp = JS.class_boundary_plan(name, 32, k)
    return plans, cp, (JS._make_seg1(plans, 256, True),
                       JS._make_seg3(plans, 256, True),
                       JS._make_seg1_classes(plans, cp, 256, True))


@pytest.mark.parametrize("B", [1, 3])
def test_forced_split_twins_match_pallas_interpret(jax_segments, B):
    """B11, B16 and B17 in their split form (the sweeps' model, then the
    compact products) at q-III, k = 4 against JAX's interpret-mode
    kernels, mod q (JAX's B11 and B16 hand on lazy values; its B17 sums
    canonical ones, so they agree exactly), and against their block twins:
    one random row, and three rows of which the middle one is all q - 1."""
    jplans, jcp, (jseg1, jseg3, jseg1c) = jax_segments
    plans = ST.fourstep_mxu_plans("qtesla-iii-speed", 32, 4)
    cp = ST.class_boundary_plan("qtesla-iii-speed", 32, 4)
    q = plans.q
    x = _rows(q, B, plans.nloc, 84 + B, 1 if B > 1 else None)
    xt = torch.from_numpy(x)[None]
    for d in range(plans.k):
        sl = slice(d, d + 1)
        pairs = (
            (S.sp_seg1(xt, plans, first=d, split=True),
             jseg1(x, jplans.p1.W[sl], jplans.p1.const[sl]), q, "B11"),
            (S.sp_seg3(xt, plans, first=d, split=True),
             jseg3(x, jplans.p3.W[sl], jplans.p3.const[sl]), q, "B16"),
            (C.sp_seg1_classes(xt, plans, cp, first=d, split=True),
             jseg1c(x, jplans.p1.W[sl]), None, "B17"))
        for got, want, mod, what in pairs:
            want = np.asarray(want)
            np.testing.assert_array_equal(
                got[0].numpy(), want % mod if mod else want,
                err_msg=f"{what} shard {d}")
        assert torch.equal(pairs[0][0], S.sp_seg1(xt, plans, first=d,
                                                  split=False))
        assert torch.equal(pairs[1][0], S.sp_seg3(xt, plans, first=d,
                                                  split=False))
        assert torch.equal(
            S.sp_seg3(xt, plans, first=d, folded=True, split=True),
            S.sp_seg3(xt, plans, first=d, folded=True, split=False))


@pytest.mark.parametrize("name,n1,k", [
    ("sp-q30-n8192", 64, 4), ("qtesla-iii-speed-like", 32, 4),
    ("sp-n65536", 512, 2)])
def test_sweeps_hand_off_inside_the_split(name, n1, k):
    """The wide stages' output (B2's sweeps, rows of q - 1 and random)
    lies below q, inside what p1's split covers (``rolls.fwd_bound``), and
    equals the block form's wide stages; at q = 1073479681 (4q 1,048,572
    below 2^32) the sweeps' lazy ranges hold (``SweepModel`` asserts
    them)."""
    if name == "qtesla-iii-speed-like":
        name = "qtesla-iii-speed"
    plans = ST.fourstep_mxu_plans(name, n1, k)
    x = torch.from_numpy(_rows(plans.q, 4, k * plans.nloc, 85, 1)
                         .reshape(4, k, plans.nloc).transpose(1, 0, 2)
                         .copy())
    v = SC.column_sweeps(x, plans, inverse=False)
    assert int(v.max()) < plans.q <= plans.rolls.fwd_bound
    assert torch.equal(v, S._wide_stages(x, plans, S.device_tables(
        plans, torch.device("cpu"))))
    z = SC.column_sweeps(v, plans, inverse=True)
    assert int(z.max()) < plans.q


# the chip's rings: (name, n, q, k, split form)
RINGS = [("r32768-k2", 32768, 786433, 2, False),
         ("r32768-k4", 32768, 786433, 4, False),
         ("r32768-k8", 32768, 786433, 8, False),
         ("r65536-k2", 65536, 786433, 2, True),
         ("r65536-k4", 65536, 786433, 4, False),
         ("r65536-k8", 65536, 786433, 8, False),
         ("r131072-k4", 131072, 786433, 4, True),
         ("r131072-k8", 131072, 786433, 8, False),
         ("r2pow18-k4", 1 << 18, 7340033, 4, True),
         ("r2pow19-k4", 1 << 19, 7340033, 4, True),
         ("r2pow20-k4", 1 << 20, 1012924417, 4, True),
         ("r2pow20-k8", 1 << 20, 1012924417, 8, True),
         ("r2pow21-k2", 1 << 21, 998244353, 2, True),
         ("r2pow21-k4", 1 << 21, 998244353, 4, True),
         ("r2pow22-k4", 1 << 22, 998244353, 4, True)]


@pytest.mark.parametrize("ring", RINGS, ids=[r[0] for r in RINGS])
def test_route_and_split_plan_fit_the_kernels(ring):
    """Where the column segments take their split form (from nloc =
    32768, every segment alike: B11, B16 under p3 and p3x, B17 with its
    staged class sums) and that the split plan fits the tile kernel: 32
    rows, the tile's tables in shared memory, within a block's 227 KiB at
    every plane count a split takes; the sweeps cover the row's bits from
    log2(TW) = 7 up; the launches' grids stay inside the card's limits (the
    tile kernel's y dimension, A tiles a shard, and the row kernel's, one
    column an n2-block of a shard, at most 65535) and the tables inside
    ``MAX_TABLE_BYTES``.  From the shapes alone (the planes' depths at
    every din), no table is built."""
    _, n, q, k, split = ring
    shape = ST._shape(n, sp_n1(n), k)
    assert shape["TW"] == 128 and shape["n2"] == 128
    D = MT._ndigits(q)
    lay = ST.compact_layout(ST._Fields(**shape), "columns")
    for din in (3, 4, 5, 6):
        digit = ST._Fields(din=din)
        plans = ST._Fields(**shape, D=D, p1=digit, p3=digit, p3x=digit)
        for seg, class_sums in (("sp_seg1", False), ("sp_seg3", False),
                                ("sp_seg3 p3x", False), ("sp_seg1", True)):
            assert S.column_split(plans, seg, class_sums) == split, (seg,
                                                                     din)
        c1 = S.CompactDims(ls=lay.ls, llam=lay.llam, lbk=lay.lbk, lq=lay.lq,
                           kp=ST.compact_depth(din, lay.s))
        plan = S.SpCompactPlan(tw=128, rows=SC.SPLIT_ROWS, d=D, c1=c1,
                               smem_tables=1)
        assert SC.split_smem(plan) + 1024 <= 233472
        if D <= 3:
            assert SC.split_smem(plan, class_sums=True) + 1024 <= 233472
    sweep = SC.column_sweep_plan(ST._Fields(**shape), inverse=False)
    assert sweep.win_lo[0] == 7
    assert sweep.win_hi[sweep.windows - 1] == shape["nloc"].bit_length() - 1
    rows = ST.compact_layout(ST._Fields(**shape), "rows")
    assert shape["A"] <= 65535 and shape["nloc"] >> rows.ls <= 65535
    assert ST.sp_table_bytes(n, q, sp_n1(n), k) <= MT.MAX_TABLE_BYTES


# ----------------------------------------------------------------------
# Every SP entry point at n = 65536.
# ----------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.parametrize("k", [2, 4])
def test_sp_entry_points_at_65536(k):
    """k = 2 runs the column segments' split form, k = 4 their block form
    (nloc = 32768 and 16384): the SP product, both fixed pairs, the class
    path, the four-step entry point and one shard's local work against
    the merged path and, on both rows (row 1 all q - 1), the C++ oracle."""
    name = "sp-n65536"
    n, q = SETS[name]
    n1 = sp_n1(n)
    x, y = (torch.from_numpy(_rows(q, 2, n, s, 1)) for s in (86, 87))
    a = torch.from_numpy(_rows(q, 1, n, 88)[0])
    mesh = make_mesh(model=k, device="cpu")
    plans = ST.fourstep_mxu_plans(name, n1, k)
    assert S.column_split(plans) == (k == 2)
    merged = polymul_fn(name, "merged")
    want = merged(x, y)
    want_a = merged(x, a.expand(2, n).contiguous())
    oracle = native.negacyclic_schoolbook(x.numpy(), y.numpy(), q)
    np.testing.assert_array_equal(want.numpy(), oracle)
    got = {"SP": S.polymul_fourstep_mxu_fn(name, mesh, n1=n1)(x, y),
           "four-step": polymul_sp_fn(name, mesh, batch_hint=1)(x, y),
           "classes": C.polymul_fourstep_mxu_classes_fn(name, mesh, n1=n1)(
               x, y)}
    for what, z in got.items():
        assert torch.equal(z, want), what
    prep, mul = S.polymul_fixed_fourstep_mxu_fn(name, mesh, n1=n1)
    assert torch.equal(mul(x, prep(a)), want_a)
    prep, mul = S.polymul_fixed_folded_fourstep_mxu_fn(name, mesh, n1=n1)
    assert torch.equal(mul(x, *prep(a)), want_a)
    # one shard's local work is the stacked segments' shard d
    pipe, lp = S.local_pipeline_fn(name, k, n1=n1)
    d = min(1, k - 1)
    sx, sy = (S.to_shards(t, plans) for t in (x, y))
    w = S.a2a_inv(S.sp_seg2(S.a2a_fwd(S.sp_seg1(sx, plans), plans),
                            S.a2a_fwd(S.sp_seg1(sy, plans), plans), plans),
                  plans)
    vx, vy = (S.sp_seg1(t[d:d + 1], plans, first=d) for t in (sx, sy))
    assert torch.equal(pipe(sx[d], sy[d]),
                       S.sp_seg3(S.sp_seg2(vx, vy, plans, first=d), plans,
                                 first=d)[0])
    assert torch.equal(S.from_shards(S.sp_seg3(w, plans), plans), want)
