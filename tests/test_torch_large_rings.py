"""The port at the JAX package's largest rings and smallest, on the CPU.

- Pass plans where a row spans a thread-block cluster (B1, B4 and the five
  B10 pairings at n = 32768 to 131072, B2 and B3 at 65536 to 262144)
  against the launchers' checks (``csrc/pass_stages.cuh``
  ``launch_pass_kernel``, restated): C = T / most blocks of at most 512
  threads (1024 for one transform), one row a cluster, a block's shared
  memory for its n / C indices; each exchange the plan's ``cross`` mask
  keeps in its block stores and loads only that block's indices, found by
  walking the kernel's layouts (windows, bit-reversal renamings, Stockham's
  threads), and each it marks crosses blocks; the block plans (n <= 16384;
  B2, B3 <= 32768) keep one block a row and no cross mask; past the limits
  the cluster planners raise and name them, and the kernels' own plans
  (``passes.kernel_plan``) are their sweep forms' up to 2^25.
- The pass twins of B1, B4, B2, B3 and the five pairings under those plans
  (``passes.PassModel`` asserts every exchange the plan keeps in a block)
  against JAX's interpret-mode kernels (``ntt_pallas.py``
  ``_polymul_kernel``, ``_polymul_fixed_kernel``, ``_ntt_kernel``,
  ``_intt_kernel``, ``ntt_pairings_pallas.py`` ``_pairing_kernel``) at n =
  32768, q = 1073479681, B = 2 with a row of q - 1; ``slow``: n = 65536
  and two rows against the C++ oracle.
- B5-B9 at n <= 16, where the MXU lane block (bw = n) is narrower than
  the MMA's 32-deep step: the twins and the lane-packed tables the kernel
  reads (``mxu_tables.lane_packed``, 32 / n rows a row of 32 lanes against
  block-diagonal tables, its stream expanded back) against JAX's
  ``polymul_mxu_fn``, ``ntt_mxu_fn`` and ``intt_mxu_fn`` in interpret mode
  at every n and q JAX computes there (n = 2 to 16 at q = 16417, n = 8 and
  16 at 536871233 and 1073479681, n = 16 at 97); the stream plans of all
  five modes are the packed ones.
- The registration sweep (``utils/fuzz_params.py``): its primes are
  ``scripts/fuzz_params.py``'s, its plan lines carry JAX's
  ``MxuTables`` and fold-plan fields at n = 64 primes of each decision
  region, and its checks pass on the CPU there; ``slow``: the whole sweep
  at n = 64 and 256.

Tolerance: none (integer equality).  Inputs are made with numpy from a
seed; the sets are registered in both packages' registries for the module
and removed after it."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from qtesla_tpu import params as JPARAMS
from qtesla_tpu.ops import ntt_mxu as JM
from qtesla_tpu.ops import ntt_pallas as JK
from qtesla_tpu.ops.ntt_pairings_pallas import polymul_pairing_fn
from qtesla_tpu_torch import params as TPARAMS
from qtesla_tpu_torch.ops import mxu_tables as MT
from qtesla_tpu_torch.ops import ntt_fused as F
from qtesla_tpu_torch.ops import ntt_mxu as M
from qtesla_tpu_torch.ops import ntt_pairings as P
from qtesla_tpu_torch.ops import passes as TPs
from qtesla_tpu_torch.ops.tables import get_tables
from qtesla_tpu_torch.utils import fuzz_params as FZ
from qtesla_tpu_torch.utils import native

REPO = Path(__file__).resolve().parent.parent
Q30 = 1073479681
LARGE = {32768: ("large-n32768", 32768, Q30),
         65536: ("large-n65536", 65536, Q30)}
# (n, q) of B5-B9 below 32 lanes that JAX's interpret-mode kernel computes
SMALL = [(2, 16417), (4, 16417), (8, 16417), (16, 16417), (8, 536871233),
         (16, 536871233), (8, Q30), (16, Q30), (16, 97)]
# n = 64 primes of the sweep's decision regions: two classes, a split of
# base 128 both ways, an inverse split of base 128 alone, four classes
SWEEP_PRIMES = [17921, 262657, 33555073, 536872321]


@pytest.fixture(scope="module", autouse=True)
def registered():
    """The large and small sets in both registries for this module."""
    entries = list(LARGE.values()) + [(f"small-n{n}-q{q}", n, q)
                                      for n, q in SMALL]
    for reg in (JPARAMS, TPARAMS):
        for entry in entries:
            reg.register_param_set(*entry)
    yield
    for reg in (JPARAMS, TPARAMS):
        for name, _, _ in entries:
            del reg.PARAM_SETS[name]
        reg.get_params.cache_clear()


# ----------------------------------------------------------------------
# The cluster plans against the launchers' checks.
# ----------------------------------------------------------------------

# kernel -> (forward from the narrowest stage up, inverse likewise,
# Stockham, operands); None: no such transform
KINDS = {"B1": (False, True, False, 2), "B4": (False, True, False, 1),
         "B2": (False, None, False, 1), "B3": (None, True, False, 1),
         **{p: (f == "dit", i == "dit", p == "stockham", 2)
            for p, (f, i) in P.PAIRINGS.items()}}


def _plan(kind, n):
    if kind in P.PAIRINGS:
        return P.pairing_pass_plan(n, kind)
    return {"B1": F.fused_pass_plan, "B4": F.fixed_pass_plan,
            "B2": F.ntt_pass_plan, "B3": F.intt_pass_plan}[kind](n)


def _exchanges(plan, n, kind):
    """The kernel's exchanges in order: ((b, vt), (b2, vt2)) with vt the
    virtual thread of each thread t, from the load's window [tb, L) of t
    through the bit-reversal renamings and Stockham's thread map."""
    fwd_up, inv_up, stk, _ = KINDS[kind]
    L = n.bit_length() - 1
    tb = L - (plan.radix.bit_length() - 1)
    t = torch.arange(plan.threads)
    b, vt, out = tb, t, []

    def to(b2, hi=None):
        nonlocal b, vt
        vt2 = TPs.stockham_thread(t, L - hi, tb) if stk else t
        out.append(((b, vt), (b2, vt2)))
        b, vt = b2, vt2

    if fwd_up is not None:
        if fwd_up:
            b, vt = 0, TPs.brev(t, tb)
        for p in range(1, plan.passes):
            to(plan.fwd_b[p], plan.fwd_hi[p])
        if inv_up is None:
            to(tb)
        elif (not fwd_up) != inv_up:
            b, vt = tb - b, TPs.brev(vt, tb)
    else:
        to(0)
    if inv_up is not None:
        for p in range(1, plan.passes):
            to(plan.inv_b[p], plan.inv_hi[p])
    return out


def _launcher_accepts(plan, n, kind):
    """``launch_pass_kernel``'s checks of the threads, the cluster and the
    shared memory, restated."""
    fwd_up, inv_up, _, ops = KINDS[kind]
    L, r = n.bit_length() - 1, plan.radix.bit_length() - 1
    C, P_ = plan.cluster, plan.passes
    both = fwd_up is not None and inv_up is not None
    most = (512 if both else 1024) if P_ >= 3 else 256
    block = plan.rows * plan.threads // C
    m = n // C
    return ((plan.radix, P_) in TPs.PASS_SHAPES
            and plan.threads == 1 << (L - r) and 1 <= C <= 8
            and C & (C - 1) == 0 and block <= most and block % 32 == 0
            and (C == 1 or (plan.rows == 1 and plan.threads == C * most))
            and (P_ == 1 or (ops * (m + m // 32) <= plan.row_stride
                             and plan.rows * plan.row_stride * 4 <= 232448)))


@pytest.mark.parametrize("kind", list(KINDS))
def test_cluster_plans_meet_the_launchers_checks(kind):
    """Every plan from n = 2 to the kernel's largest meets the launcher's
    checks; a cluster exactly where one block of ``most`` threads cannot
    hold the row; the plan's cross mask marks exactly the exchanges whose
    indices leave the block of the thread that stores or loads them
    (the block of thread t is t >> (tb - c), that of index i is i >> (L -
    c)); a block plan keeps cluster 1 and mask 0."""
    fwd_up, inv_up, _, _ = KINDS[kind]
    one = fwd_up is None or inv_up is None
    top = 18 if one else 17
    for L in range(1, top + 1):
        n = 1 << L
        plan = _plan(kind, n)
        assert _launcher_accepts(plan, n, kind), (kind, n)
        clustered = n >= (65536 if one else 32768)
        assert (plan.cluster > 1) == clustered, (kind, n)
        if not clustered:
            assert plan.cross == 0
            continue
        c = plan.cluster.bit_length() - 1
        tb = L - (plan.radix.bit_length() - 1)
        block = torch.arange(plan.threads)[:, None] >> (tb - c)
        mdl = TPs.PassModel(plan, n, 3, 1)
        for e, sides in enumerate(_exchanges(plan, n, kind)):
            local = all(bool(((mdl.window(vt, b) >> (L - c)) == block).all())
                        for b, vt in sides)
            assert bool(plan.cross >> e & 1) != local, (kind, n, e)
        assert plan.cross >> len(_exchanges(plan, n, kind)) == 0
    assert "a cluster of" in TPs.describe_pass_plan(
        _plan(kind, 1 << top))


@pytest.mark.parametrize("kind", list(KINDS))
def test_cluster_plans_refuse_past_their_limit(kind):
    """One length past the cluster form's largest its planner refuses
    (more than 8 blocks a cluster, naming the largest n; from 2^21 five
    passes), and the kernel's own plan there (``passes.kernel_plan``) is
    its sweep form's, at every n to 2^25; past 2^25, the largest ring the
    registry takes, the kernel's plan is refused, naming 2^25."""
    fwd_up, inv_up, _, _ = KINDS[kind]
    one = fwd_up is None or inv_up is None
    n_max = 262144 if one else 131072
    with pytest.raises(ValueError, match=f"more than the 8 a cluster takes "
                                         fr"\(n <= {n_max}\)"):
        _plan(kind, 2 * n_max)
    with pytest.raises(ValueError, match="5 passes, no kernel"):
        _plan(kind, 1 << 21)
    assert n_max == TPs.cluster_reach(kind)
    assert isinstance(TPs.kernel_plan(n_max, kind), TPs.PassPlan)
    for L in range(n_max.bit_length(), 26):
        assert isinstance(TPs.kernel_plan(1 << L, kind), TPs.SweepPlan)
    with pytest.raises(ValueError, match=r"the sweep form takes n <= 2\^25"):
        TPs.kernel_plan(1 << 26, kind)


# ----------------------------------------------------------------------
# The pass twins against JAX's interpret-mode kernels.
# ----------------------------------------------------------------------

def _large_operands(n):
    name, _, q = LARGE[n]
    rng = np.random.default_rng(n + 22)
    x, y = rng.integers(0, q, (2, 2, n), dtype=np.uint32)
    x[0], y[0] = q - 1, q - 1
    lazy = rng.integers(0, 2 * q, (2, n), dtype=np.uint32)
    lazy[0] = 2 * q - 1
    return name, get_tables(name), x, y, lazy


def _twin_and_jax(kind, n):
    """The pass twin's output and JAX's interpret-mode kernel's."""
    name, tbl, x, y, lazy = _large_operands(n)
    t = torch.from_numpy
    if kind == "B1":
        return (F.polymul_fused_passes_plain(t(x), t(y), tbl).numpy(),
                np.asarray(JK.polymul_fused_fn(name, interpret=True)(x, y)))
    if kind == "B4":
        spec = F.ntt_plain(t(y[1]), tbl).numpy()
        spec[::5] = tbl.q - 1
        return (F.polymul_fixed_fused_passes_plain(t(x), t(spec),
                                                   tbl).numpy(),
                np.asarray(JK.polymul_fixed_fused_fn(name, interpret=True)(
                    x, spec)))
    if kind == "B2":
        return (F.ntt_passes_plain(t(x), tbl).numpy(),
                np.asarray(JK.ntt_fused_fn(name, interpret=True)(x)))
    if kind == "B3":
        return (F.intt_passes_plain(t(lazy), tbl).numpy(),
                np.asarray(JK.intt_fused_fn(name, interpret=True)(lazy)))
    return (P.polymul_pairing_passes_plain(t(x), t(y), tbl, kind).numpy(),
            np.asarray(polymul_pairing_fn(name, kind, interpret=True)(x, y)))


@pytest.mark.parametrize("n", [
    32768, pytest.param(65536, marks=pytest.mark.slow)])
@pytest.mark.parametrize("kind", list(KINDS))
def test_cluster_twins_match_jax_interpret(kind, n):
    """Each pass twin under its cluster plan (B2, B3 at 32768 under their
    block plan) equals JAX's interpret-mode kernel and its own plain
    version on 2 rows, one all q - 1 (B3: 2q - 1)."""
    got, want = _twin_and_jax(kind, n)
    np.testing.assert_array_equal(got, want)
    name, tbl, x, y, lazy = _large_operands(n)
    t = torch.from_numpy
    plain = {"B2": lambda: F.ntt_plain(t(x), tbl),
             "B3": lambda: F.intt_plain(t(lazy), tbl)}.get(
        kind, lambda: F.polymul_plain(t(x), t(y), tbl))
    if kind != "B4":
        np.testing.assert_array_equal(got, plain().numpy())


@pytest.mark.slow
@pytest.mark.parametrize("n", [32768, 65536])
def test_cluster_twins_match_the_oracle(n):
    """B1's and each pairing's twin, and B3's twin through B2's on the
    product's spectrum, against two rows of the C++ oracle."""
    if not native.native_available():
        pytest.skip("the C++ oracle does not build here")
    name, tbl, x, y, _ = _large_operands(n)
    t = torch.from_numpy
    want = native.negacyclic_schoolbook(x, y, tbl.q)
    np.testing.assert_array_equal(
        F.polymul_fused_passes_plain(t(x), t(y), tbl).numpy(), want)
    for p in P.PAIRINGS:
        np.testing.assert_array_equal(P.polymul_pairing_passes_plain(
            t(x), t(y), tbl, p).numpy(), want)
    spec = F._barrett(F.ntt_passes_plain(t(x), tbl).to(torch.int64),
                      F.ntt_passes_plain(t(y), tbl).to(torch.int64), tbl)
    np.testing.assert_array_equal(
        F.intt_passes_plain(spec.to(torch.uint32), tbl).numpy(), want)


# ----------------------------------------------------------------------
# B5-B9 below 32 lanes.
# ----------------------------------------------------------------------

def _small(n, q):
    name = f"small-n{n}-q{q}"
    rng = np.random.default_rng(n * 7 + q % 1000)
    x, y = rng.integers(0, q, (2, 5, n), dtype=np.uint32)
    x[0], y[0] = q - 1, q - 1
    return name, MT.get_mxu_tables(name), x, y


def _packed_product(mt, x, y):
    """B5's product as the kernel computes it: rows packed 32 / n to a row
    of 32 lanes, both block matmuls against the tables read back from the
    packed stream it copies (``expand_stream``), their const rows, and the
    pointwise product between."""
    pk = MT.lane_packed(mt)
    wf, wi = MT.expand_stream(MT.stream_tables(pk), pk)
    layout = [M._kernel_layout(w) for w in (wf, wi)]
    cf, ci = (torch.from_numpy(c[:, 0].copy()) for c in (pk.constf,
                                                       pk.consti))
    xs, ys = (v.to(torch.int64) for v in M._packed(
        mt, torch.from_numpy(x), torch.from_numpy(y)))
    X, Y = (M._block_matmul(v, layout[0], cf, pk.group_bias_f, pk.fwd_off,
                            pk.Df, pk.fwd_base, pk) for v in (xs, ys))
    z = M._block_matmul(X * Y % mt.q, layout[1], ci, pk.group_bias_i,
                        pk.inv_off, pk.Di, pk.inv_base, pk)
    return M._unpacked(z.to(torch.uint32), torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("n,q", SMALL)
def test_small_mxu_matches_jax_interpret(n, q):
    """At n <= 16 the MXU twins (B5, B6, B7) and the lane-packed product
    equal JAX's interpret-mode kernels; the packed tables hold 32 / n
    copies of each block on their diagonal, and every stream mode plans
    the packed rows of 32 lanes."""
    name, mt, x, y = _small(n, q)
    t = torch.from_numpy
    want = np.asarray(JM.polymul_mxu_fn(name, interpret=True)(x, y))
    np.testing.assert_array_equal(M.polymul_mxu(t(x), t(y), mt).numpy(),
                                  want)
    np.testing.assert_array_equal(_packed_product(mt, x, y), want)
    np.testing.assert_array_equal(
        M.ntt_mxu(t(x), mt).numpy(),
        np.asarray(JM.ntt_mxu_fn(name, interpret=True)(x)))
    spec = M.ntt_mxu(t(y), mt).numpy()
    np.testing.assert_array_equal(
        M.intt_mxu(t(spec), mt).numpy(),
        np.asarray(JM.intt_mxu_fn(name, interpret=True)(spec)))
    pk = MT.lane_packed(mt)
    k = 32 // n
    assert (pk.n, pk.bw, pk.nb, pk.Lr) == (32, 32, 1, 0)
    for c in range(k):
        blk = pk.wf[0, :, c * n:(c + 1) * n].reshape(mt.Df, n, mt.D, k, n)
        np.testing.assert_array_equal(blk[:, :, :, c],
                                      mt.wf[0].reshape(mt.Df, n, mt.D, n))
        assert not np.delete(blk, c, axis=3).any()
    for mode in M.STREAM_MODES:
        plan = M.stream_plan(mt, mode)
        assert (plan.n, plan.bw, plan.nb, plan.lr) == (32, 32, 1, 0)


@pytest.mark.parametrize("n,q", [(4, 16417), (16, Q30)])
def test_small_mxu_fixed_forms(n, q):
    """B8's and B9's twins at n <= 16, B9's operand lane packed (its
    stages those of 32-lane blocks), against B4's plain product; a batch
    that fills no whole packed row pads and slices back."""
    name, mt, x, y = _small(n, q)
    tbl = get_tables(name)
    t = torch.from_numpy
    spec = F.ntt_plain(t(y[1]), tbl)
    want = F.polymul_fixed_plain(t(x), spec, tbl).numpy()
    np.testing.assert_array_equal(
        M.polymul_fixed_mxu(t(x), spec, mt).numpy(), want)
    op = M.fold_operand(spec, mt)
    fp = MT.fold_plan(mt)
    assert tuple(op.stages.shape) == (MT.stream_stages(fp.Din, 32),
                                      MT.STAGE_DEPTH * 32 * fp.Dout)
    np.testing.assert_array_equal(
        M.polymul_fixed_folded_mxu(t(x), op, mt).numpy(), want)
    packed = M._packed(mt, t(x))[0]
    assert packed.shape == (-(-5 * n // 32), 32)
    assert torch.equal(M._unpacked(packed, t(x)), t(x))


# ----------------------------------------------------------------------
# The registration sweep.
# ----------------------------------------------------------------------

def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_fuzz_params", REPO / "scripts" / "fuzz_params.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,per,bits", [(64, 1, range(15, 31)),
                                        (64, 2, range(15, 20)),
                                        (2048, 1, (15, 20, 25, 30))])
def test_sweep_primes_are_the_jax_scripts(n, per, bits):
    """``primes_for_n`` (the port's primality test) picks the JAX
    script's primes (sympy's)."""
    pytest.importorskip("sympy")
    jax_primes = [q for b in bits
                  for q in _jax_script().primes_for_n(n, per, b, b)]
    assert FZ.primes_for_n(n, per, bits) == jax_primes


@pytest.mark.parametrize("q", SWEEP_PRIMES)
def test_sweep_plans_match_jax_and_pass_on_cpu(q):
    """At n = 64 the sweep's plan line carries JAX's MxuTables fields (D,
    Df@fwd_base, Di@inv_base, fwd_lazy) and fold plan (Din@base), the
    primes reach two classes and base-128 splits, and ``check_prime`` (B1
    to B18's twins, the SP and class paths, the C++ or big-int oracle)
    finds no mismatch on the CPU."""
    name = f"fuzz-64-{q}"
    JPARAMS.register_param_set(name, 64, q)
    try:
        jmt, jfp = JM.get_mxu_tables(name), JM.fixed_fold_plan(name)
        want = (f"D={jmt.D} Df={jmt.Df}@{jmt.fwd_base} Di={jmt.Di}@"
                f"{jmt.inv_base} lazy={jmt.fwd_lazy} fold Din={jfp.Din}@"
                f"{jfp.base}")
        line, bad = FZ.check_prime(64, q, torch.device("cpu"), True,
                                   np.random.default_rng(q))
        assert bad == []
        assert line.startswith(want + " sp=k2 n1=8 B11-B16"), line
        assert ("B17-B18" in line) == (jmt.D <= 3)
    finally:
        del JPARAMS.PARAM_SETS[name]
        JPARAMS.get_params.cache_clear()
        del TPARAMS.PARAM_SETS[name]
        TPARAMS.get_params.cache_clear()


def test_sweep_regions():
    """The n = 64 primes above span the regions the card's shipped sets
    never reach: two digit classes, a base-128 split both ways, an inverse
    split of base 128 alone."""
    lines = []
    for q in SWEEP_PRIMES:
        TPARAMS.register_param_set(f"region-{q}", 64, q)
        try:
            lines.append(FZ.plan_line(MT.get_mxu_tables(f"region-{q}")))
        finally:
            del TPARAMS.PARAM_SETS[f"region-{q}"]
            TPARAMS.get_params.cache_clear()
    assert lines[0].startswith("D=2 Df=2@256 Di=2@256")
    assert lines[1].startswith("D=3 Df=3@128 Di=3@128")
    assert "Df=4@256 Di=4@128" in lines[2]
    assert lines[3].startswith("D=4")


@pytest.mark.slow
@pytest.mark.parametrize("n", [64, 256])
def test_sweep_passes_on_cpu(n):
    """The whole sweep (one prime a bit size, 15 to 30 bits, with the SP
    kernels) finds no mismatch on the CPU, and its command exits 0."""
    assert FZ.sweep(n, FZ.primes_for_n(n, 1), "cpu", sp=True,
                    log=lambda line: None) == 0
    assert FZ.main(["--n", str(n), "--per-decade", "1", "--device", "cpu",
                    "--sp"]) == 0
