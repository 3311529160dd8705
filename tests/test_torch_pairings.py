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
- The pass kernels' schedules (``pairing_pass_plan`` for the five pairings,
  ``ntt_fused.fused_pass_plan`` for B1): the CPU twins against the plain
  pipelines on every set and at other lengths, under another split and
  against JAX's interpret-mode kernel; Stockham's twin pass by pass against
  the plain Stockham stages under its position map; the plans against the
  launchers' checks, their refusals, and the exchanges' banks.

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
from qtesla_tpu_torch import register_param_set
from qtesla_tpu_torch.models import polymul as TP
from qtesla_tpu_torch.ops import ntt as TN
from qtesla_tpu_torch.ops import ntt_fused as TF
from qtesla_tpu_torch.ops import ntt_pairings as TPa
from qtesla_tpu_torch.ops import passes as TPs
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


# ----------------------------------------------------------------------
# The pass kernels' schedule (pairing_pass_plan) and its CPU twin.
# ----------------------------------------------------------------------

# lengths no registered set has: R = n below 32, two passes of 2 threads a
# row, three passes of 128 threads (q prime, q = 1 mod 2n)
_OTHER_LENGTHS = [(2, 5), (4, 17), (8, 17), (16, 97), (64, 257),
                  (4096, 40961)]


def _pass_operands(n, q, rows=7, seed=58):
    """Random rows, then rows of 0 and of q - 1 in either operand."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, q, (rows, n), dtype=np.uint32)
    y = rng.integers(0, q, (rows, n), dtype=np.uint32)
    x[0], y[1], x[2], y[2], x[3] = 0, 0, q - 1, q - 1, q - 1
    return torch.from_numpy(x), torch.from_numpy(y)


@pytest.mark.parametrize("name", SETS + [f"pairing-n{n}" for n, _ in
                                         _OTHER_LENGTHS])
def test_pass_schedule_twin_matches_plain(name):
    """The pass twin equals the plain pipeline bit for bit, for each of the
    five pairings, on every set and at every radix the planner chooses (32
    from n = 32 on; n itself below)."""
    if name.startswith("pairing-n"):
        _register_other_length(name)
    tbl = get_tables(name)
    x, y = _pass_operands(tbl.n, tbl.q)
    for p in TPa.PAIRINGS:
        plan = TPa.pairing_pass_plan(tbl.n, p)
        assert plan.radix == min(tbl.n, 32)
        got = TPa.polymul_pairing_passes_plain(x, y, tbl, p, plan)
        assert got.dtype == torch.uint32
        np.testing.assert_array_equal(
            got.numpy(), TPa.polymul_pairing_plain(x, y, tbl, p).numpy(),
            err_msg=f"{name} {p}")


def _register_other_length(name):
    n = int(name.rsplit("n", 1)[1])
    register_param_set(name, n, dict(_OTHER_LENGTHS)[n])


@pytest.mark.parametrize("pairing", list(TPa.PAIRINGS))
def test_pass_schedule_twin_matches_pallas_interpret(pairing):
    name = "smallprime"
    ps = get_params(name)
    x, y = _edge_operands(ps.n, ps.q)
    ref = np.asarray(polymul_pairing_fn(name, pairing, interpret=True)(x, y))
    got = TPa.polymul_pairing_passes_plain(
        torch.from_numpy(x), torch.from_numpy(y), get_tables(name), pairing)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("rows", [1, 3, 17])
def test_pass_schedule_twin_pads_whole_blocks(rows):
    """Batches that do not fill their last block of 16 rows (the rows past
    the batch compute on row 0 and are dropped)."""
    tbl = get_tables("qtesla-i")
    x, y = (torch.from_numpy(np.resize(a.numpy(), (rows, tbl.n)))
            for a in _pass_operands(tbl.n, tbl.q))
    assert TPa.pairing_pass_plan(tbl.n, "gs_gs").rows == 16
    np.testing.assert_array_equal(
        TPa.polymul_pairing_passes_plain(x, y, tbl, "gs_gs").numpy(),
        TPa.polymul_pairing_plain(x, y, tbl, "gs_gs").numpy())


def _plan(n, scheme):
    """The plan of a pairing's pass kernel, or of B1's ("fused")."""
    if scheme == "fused":
        return TF.fused_pass_plan(n)
    return TPa.pairing_pass_plan(n, scheme)


# scheme -> (forward from the narrowest stage up, inverse likewise, a bit
# reversal between the two, Stockham's windows), as the launchers take it
_ORDERS = {p: (f == "dit", i == "dit", (f != "dit") != (i == "dit"),
               p == "stockham") for p, (f, i) in TPa.PAIRINGS.items()}
_ORDERS["fused"] = (False, True, False, False)
SCHEMES = [*TPa.PAIRINGS, "fused"]
# another split each launcher takes at qtesla-i (n = 512): the smaller pass
# first; Stockham's last pass is whole, so it splits its first 4 stages
_OTHER_SPLITS = {"stockham": [2, 2, 5]}


def _sizes(plan):
    return [plan.fwd_hi[p] - plan.fwd_lo[p] for p in range(plan.passes)]


def _other_split(n, scheme, sizes):
    """``scheme``'s plan at n with the stages split as ``sizes``."""
    plan = TPs.PassPlan.from_buffer_copy(_plan(n, scheme))
    L, r = n.bit_length() - 1, plan.radix.bit_length() - 1
    plan.passes = len(sizes)
    fwd_up, inv_up, _, stk = _ORDERS[scheme]
    for side, up in (("fwd", fwd_up), ("inv", inv_up)):
        for p, row in enumerate(TPs.schedule(L, r, sizes, up, stk)):
            for f, v in zip(("lo", "hi", "b"), row):
                getattr(plan, f"{side}_{f}")[p] = v
    return plan


@pytest.mark.parametrize("pairing", list(TPa.PAIRINGS))
def test_pass_schedule_twin_under_another_split(pairing):
    """A plan the planner does not make but the launcher takes (qtesla-i
    split 4 + 5, the smaller pass first; Stockham 2 + 2 + 5) gives the
    same product."""
    tbl = get_tables("qtesla-i")
    sizes = _OTHER_SPLITS.get(pairing, [4, 5])
    plan = _other_split(tbl.n, pairing, sizes)
    assert _launcher_accepts(plan, tbl.n, pairing)
    assert _sizes(plan) == sizes != _sizes(_plan(tbl.n, pairing))
    x, y = _pass_operands(tbl.n, tbl.q)
    np.testing.assert_array_equal(
        TPa.polymul_pairing_passes_plain(x, y, tbl, pairing, plan).numpy(),
        TPa.polymul_pairing_plain(x, y, tbl, pairing).numpy())


@pytest.mark.parametrize("n,pairing,match", [
    (1024, "nope", "unknown pairing"),
    (1, "gs_ct", "power of two"),
    (768, "gs_ct", "power of two"),
    (1 << 21, "gs_ct", "5 passes, no kernel"),
    (1 << 20, "ct_gs", "a cluster of 64 blocks"),
    (262144, "gs_ct", "8192 threads a row"),
    (262144, "gs_gs", "more than the 8 a cluster takes"),
    (768, "stockham", "power of two"),
    (1 << 21, "stockham", "5 passes, no kernel"),
    (262144, "stockham", r"n <= 131072"),
    (1, "fused", "power of two"),
    (1 << 21, "fused", "5 passes, no kernel"),
    (262144, "fused", "a cluster of 16 blocks of 512"),
])
def test_pass_planner_refuses_what_the_launcher_refuses(n, pairing, match):
    """The planners raise for what the launchers refuse (no kernel for the
    passes, a row across more blocks than a cluster of 8); the launchers'
    own refusals are tested on the card (test_torch_device.py)."""
    with pytest.raises(ValueError, match=match):
        _plan(n, pairing)


def _launcher_accepts(plan, n, scheme):
    """The launchers' checks of ``csrc/pass_stages.cuh``
    (launch_pass_kernel), restated."""
    fwd_up, inv_up, reflect, stk = _ORDERS[scheme]
    L = n.bit_length() - 1
    r = plan.radix.bit_length() - 1
    tb = L - r
    P = plan.passes
    if ((plan.radix, P) not in TPs.PASS_SHAPES or plan.threads != 1 << tb
            or plan.rows < 1 or plan.rows * plan.threads % 32
            or plan.rows * plan.threads > (512 if P == 3 else 256)):
        return False
    for side, up in (("fwd", fwd_up), ("inv", inv_up)):
        lo, hi, b = (list(getattr(plan, f"{side}_{f}"))[:P]
                     for f in ("lo", "hi", "b"))
        edge = 0 if up else L
        for p in range(P):
            if (lo[p] >= hi[p] or not 0 <= b[p] <= min(lo[p], tb)
                    or hi[p] > b[p] + r or (lo[p] if up else hi[p]) != edge
                    or (stk and b[p] != hi[p] - r)):
                return False
            edge = hi[p] if up else lo[p]
        if edge != (L if up else 0):
            return False
    last = plan.fwd_b[P - 1]
    first = tb - last if reflect else last
    if plan.fwd_b[0] != (0 if fwd_up else tb) or plan.inv_b[0] != first:
        return False
    return P == 1 or (2 * (n + n // 32) <= plan.row_stride
                      and plan.rows * plan.row_stride * 4 <= 232448)


@pytest.mark.parametrize("pairing", SCHEMES)
def test_pass_plans_meet_the_launchers_checks(pairing):
    """Every plan the planners make, n = 2 to 16384, passes the launcher's
    checks; fused ends: the inverse starts in the window where the
    product lies.  Stockham's windows are its own: a plan with a short last
    pass or the cyclic windows of a short middle pass is refused."""
    for L in range(1, 15):
        plan = _plan(1 << L, pairing)
        assert _launcher_accepts(plan, 1 << L, pairing), (L, pairing)
        assert plan.passes == -(-L // min(L, 5))
    # at n = 1024 a warp holds a row: two passes, one exchange each way
    plan = _plan(1024, pairing)
    assert (plan.radix, plan.threads, plan.rows, plan.passes) == (32, 32, 8,
                                                                  2)
    assert "R=32, threads a row 32" in TPs.describe_pass_plan(plan)
    # qtesla-i split 5 + 4 (the cyclic planner's) and, with the cyclic
    # windows, 2 + 2 + 5: Stockham refuses both, the others take them
    for sizes in ([5, 4], [2, 2, 5]):
        plan = TPs.PassPlan.from_buffer_copy(_plan(512, pairing))
        plan.passes = len(sizes)
        fwd_up, inv_up, _, _ = _ORDERS[pairing]
        for side, up in (("fwd", fwd_up), ("inv", inv_up)):
            for p, row in enumerate(TPs.schedule(9, 5, sizes, up)):
                for f, v in zip(("lo", "hi", "b"), row):
                    getattr(plan, f"{side}_{f}")[p] = v
        assert _launcher_accepts(plan, 512, pairing) == (
            pairing != "stockham"), (pairing, sizes)


@pytest.mark.parametrize("n", [512, 1024])
def test_pass_exchanges_are_free_of_bank_conflicts(n):
    """At the sets' lengths of one warp or less a row, every shared-memory
    store and load of an exchange reaches 32 distinct banks from a warp's
    32 threads (rows of 16 threads: two rows a warp, T words apart), for
    the virtual threads each kernel exchanges from and to: the thread, its
    reversal after a bit reversal, Stockham's thread map."""
    for scheme in SCHEMES:
        plan = _plan(n, scheme)
        L, r, T = n.bit_length() - 1, 5, plan.threads
        tb = L - r
        lanes = torch.arange(32)
        t, slot = lanes % T, lanes // T

        def banks(vt, b, c):
            i = ((vt & ((1 << b) - 1)) | ((vt >> b) << (b + r))) | (c << b)
            return (slot * plan.row_stride + i + (i >> 5)) % 32

        for side in ("fwd", "inv"):
            for p in range(plan.passes):
                b = getattr(plan, f"{side}_b")[p]
                hi = getattr(plan, f"{side}_hi")[p]
                vts = ([TPs.stockham_thread(t, L - hi, tb)]
                       if scheme == "stockham" else [t, TPs.brev(t, tb)])
                for vt in vts:
                    for c in range(32):
                        assert banks(vt, b, c).unique().numel() == 32, (
                            scheme, side, b, c)


@pytest.mark.parametrize("name", ["smallprime", "qtesla-i",
                                  "qtesla-iii-speed", "pairing-n4096"])
def test_stockham_twin_runs_stockham_stages(name):
    """After each pass, the Stockham twin's values equal ``N._stockham``'s
    values after as many stages (the forward on the psi-weighted operands,
    the inverse on their pointwise product), modulo q, at the Stockham
    positions its DIF indices stand for (``passes.stockham_index``): the
    kernel runs Stockham's own butterflies, on its own windows."""
    if name.startswith("pairing-n"):
        _register_other_length(name)
    tbl = get_tables(name)
    n, L, q = tbl.n, tbl.logn, tbl.q
    x, y = _pass_operands(n, q, rows=4)
    trace = []
    TPa.polymul_pairing_passes_plain(x, y, tbl, "stockham", trace=trace)
    assert len(trace) == 2 * TPa.pairing_pass_plan(n, "stockham").passes
    xw, yw = (TN.weight_psi(a.to(torch.int64), tbl) for a in (x, y))
    prod = TN.pointwise_mul(TN.stockham_fwd(xw, tbl),
                            TN.stockham_fwd(yw, tbl), tbl)
    pos = torch.arange(n)
    for side, lo, hi, idx, V in trace:
        st = L - lo
        if side == "fwd":
            want = [TN._stockham(a, tbl, "stockham_fwd", stages=st)
                    for a in (xw, yw)]
        else:
            want = [TN._stockham(prod, tbl, "stockham_inv", stages=st)]
        at = TPs.stockham_index(pos, st, L)
        for o, w in enumerate(want):
            got = torch.zeros(V.shape[0], n, dtype=torch.int64)
            got[:, idx] = V[:, o]
            np.testing.assert_array_equal(
                (got[:x.shape[0], at] % q).numpy(), w.numpy(),
                err_msg=f"{name} {side} stage {st} operand {o}")
