"""The CPU twins of B1's, B4's and B10 Stockham's register-pass schedules
against the plain pipelines, JAX's interpret-mode kernels and the big-int
oracle.

- ``ntt_fused.polymul_fused_passes_plain`` (B1 under ``fused_pass_plan``)
  and ``ntt_pairings.polymul_pairing_passes_plain(..., "stockham")``
  against ``polymul_plain`` and the Stockham plain pipeline on all 5 sets at
  B in {1, 3, 64}, with rows of q - 1 in both operands, and two rows of
  each against the big-int oracle;
- both against JAX's ``_polymul_kernel`` (``polymul_fused_fn``) and
  ``_pairing_kernel`` with ``pairing="stockham"`` in interpret mode at
  smallprime for B in {1, 3, 64}, plus a qtesla-iii-speed canary for B1;
- B1's twin at lengths no set has (R = n below 32, three passes), under
  splits its planner does not make, and over batches that do not fill
  their last block;
- B4's twin (``ntt_fused.polymul_fixed_fused_passes_plain`` under
  ``fixed_pass_plan``) against ``polymul_fixed_plain`` and JAX's
  ``_polymul_fixed_kernel`` (``polymul_fixed_fused_fn``) in interpret mode
  on all 5 sets at B in {1, 3, 64}, x random and all q - 1, the spectrum
  random, all 0 and all q - 1, and against the oracle; and at every length
  ``chip_smoke.py`` checks on the card (2 to 16384); B4's plan is B1's
  with one operand's shared memory a row;
- B3's twin (``ntt_fused.intt_passes_plain`` under ``intt_pass_plan``, the
  inverse's passes alone) against ``intt_plain`` and JAX's ``_intt_kernel``
  (``intt_fused_fn``) in interpret mode on all 5 sets at B in {1, 3, 64} on
  rows below 2q with rows of 2q - 1, through the forward against the
  oracle, and at every length from 2 to 32768 (n >= 8192 ``slow``); its
  plan is B4's inverse with no forward passes, and ``pass_plan`` refuses
  an inverse alone that is not one operand's from the narrowest stage up;
- B2's twin (``ntt_fused.ntt_passes_plain`` under ``ntt_pass_plan``, the
  forward's passes alone, then one more exchange back to the load's
  window and a coalesced store) against ``ntt_plain`` and JAX's
  ``_ntt_kernel`` (``ntt_fused_fn``) in interpret mode on all 5 sets at B
  in {1, 3, 64} with rows of q - 1, through B3's twin back to x and
  through the product against the oracle, and at every length from 2 to 32768 (n >= 8192 ``slow``); its plan is
  B4's forward with no inverse passes, and ``pass_plan`` refuses a forward
  alone that is not one operand's from the widest stage down.

Tolerance: none (integer equality).  Inputs are made with numpy from a seed
and fed to every side."""

import numpy as np
import pytest
import torch

from qtesla_tpu import params as JPARAMS
from qtesla_tpu.oracle import polymul_negacyclic_oracle
from qtesla_tpu.ops import ntt_pallas as JK
from qtesla_tpu.ops.ntt_pairings_pallas import polymul_pairing_fn
from qtesla_tpu.params import get_params
from qtesla_tpu_torch import params as TPARAMS
from qtesla_tpu_torch import register_param_set
from qtesla_tpu_torch.ops import ntt_fused as TF
from qtesla_tpu_torch.ops import ntt_pairings as TPa
from qtesla_tpu_torch.ops import passes as TPs
from qtesla_tpu_torch.ops.tables import get_tables

SETS = ["smallprime", "qtesla-i", "qtesla-iii-speed", "qtesla-p-i",
        "qtesla-p-iii"]
# lengths no registered set has (q prime, q = 1 mod 2n)
_OTHER_LENGTHS = {2: 5, 4: 17, 16: 97, 64: 257, 4096: 40961}


def _operands(n, q, batch, seed=61):
    """Random rows; row 0 of x and the last row of y all q - 1, and (B > 1)
    row 1 of both."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, q, (batch, n), dtype=np.uint32)
    y = rng.integers(0, q, (batch, n), dtype=np.uint32)
    x[0], y[-1] = q - 1, q - 1
    if batch > 1:
        x[1], y[1] = q - 1, q - 1
    return x, y


def _twins(x, y, tbl):
    t = torch.from_numpy
    return (TF.polymul_fused_passes_plain(t(x), t(y), tbl),
            TPa.polymul_pairing_passes_plain(t(x), t(y), tbl, "stockham"))


@pytest.mark.parametrize("name", SETS)
def test_pass_twins_match_plain_and_oracle(name):
    tbl = get_tables(name)
    ps = get_params(name)
    for batch in (1, 3, 64):
        x, y = _operands(tbl.n, tbl.q, batch)
        b1, stk = _twins(x, y, tbl)
        assert b1.dtype == stk.dtype == torch.uint32
        t = torch.from_numpy
        np.testing.assert_array_equal(
            b1.numpy(), TF.polymul_plain(t(x), t(y), tbl).numpy())
        np.testing.assert_array_equal(
            stk.numpy(),
            TPa.polymul_pairing_plain(t(x), t(y), tbl, "stockham").numpy())
    for row in (0, 1):
        want = polymul_negacyclic_oracle(x[row], y[row], ps).astype(np.uint32)
        np.testing.assert_array_equal(b1[row].numpy(), want)
        np.testing.assert_array_equal(stk[row].numpy(), want)


@pytest.mark.parametrize("batch", [1, 3, 64])
def test_pass_twins_match_pallas_interpret(batch):
    name = "smallprime"
    ps = get_params(name)
    x, y = _operands(ps.n, ps.q, batch)
    b1, stk = _twins(x, y, get_tables(name))
    np.testing.assert_array_equal(
        b1.numpy(), np.asarray(JK.polymul_fused_fn(name, interpret=True)(x, y)))
    np.testing.assert_array_equal(
        stk.numpy(), np.asarray(polymul_pairing_fn(name, "stockham",
                                                   interpret=True)(x, y)))


def test_fused_twin_matches_pallas_interpret_real_set():
    """qtesla-iii-speed canary (n = 1024, the kernel built for its length's
    schedule) at B = 3."""
    name = "qtesla-iii-speed"
    ps = get_params(name)
    x, y = _operands(ps.n, ps.q, 3)
    b1, _ = _twins(x, y, get_tables(name))
    np.testing.assert_array_equal(
        b1.numpy(), np.asarray(JK.polymul_fused_fn(name, interpret=True)(x, y)))


@pytest.mark.parametrize("n", sorted(_OTHER_LENGTHS))
def test_fused_twin_at_other_lengths(n):
    name = f"fused-n{n}"
    register_param_set(name, n, _OTHER_LENGTHS[n])
    tbl = get_tables(name)
    plan = TF.fused_pass_plan(n)
    assert plan.radix == min(n, 32)
    x, y = _operands(n, tbl.q, 5)
    t = torch.from_numpy
    np.testing.assert_array_equal(
        TF.polymul_fused_passes_plain(t(x), t(y), tbl).numpy(),
        TF.polymul_plain(t(x), t(y), tbl).numpy())


def _split(plan, n, sizes):
    """B1's plan at n with its stages split as ``sizes``: the forward from
    the widest stage down, the inverse from the narrowest up."""
    plan = TPs.PassPlan.from_buffer_copy(plan)
    plan.passes = len(sizes)
    L = n.bit_length() - 1
    for side, up in (("fwd", False), ("inv", True)):
        for p, row in enumerate(TPs.schedule(L, 5, sizes, up)):
            for f, v in zip(("lo", "hi", "b"), row):
                getattr(plan, f"{side}_{f}")[p] = v
    return plan


@pytest.mark.parametrize("name,sizes", [
    ("qtesla-i", [4, 5]), ("qtesla-i", [2, 2, 5]),
    ("qtesla-iii-speed", [3, 3, 4])])
def test_fused_twin_under_another_split(name, sizes):
    """Plans the planner does not make but the launcher takes give the same
    product."""
    tbl = get_tables(name)
    plan = _split(TF.fused_pass_plan(tbl.n), tbl.n, sizes)
    x, y = (torch.from_numpy(a) for a in _operands(tbl.n, tbl.q, 5))
    np.testing.assert_array_equal(
        TF.polymul_fused_passes_plain(x, y, tbl, plan).numpy(),
        TF.polymul_plain(x, y, tbl).numpy())


@pytest.mark.parametrize("rows", [1, 9, 17])
def test_fused_twin_pads_whole_blocks(rows):
    """Batches that do not fill their last block of 16 rows (the rows past
    the batch compute on row 0 and are dropped)."""
    tbl = get_tables("qtesla-i")
    assert TF.fused_pass_plan(tbl.n).rows == 16
    x, y = (torch.from_numpy(a) for a in _operands(tbl.n, tbl.q, rows))
    np.testing.assert_array_equal(
        TF.polymul_fused_passes_plain(x, y, tbl).numpy(),
        TF.polymul_plain(x, y, tbl).numpy())


# every length chip_smoke.py checks the pass kernels at on the card (its
# PASS_LENGTHS, but for its second prime at n = 8192, q = 1073479681, whose
# twins tests/test_torch_near_2pow30.py holds at n = 64 and 1024): (n, q),
# q prime and 1 mod 2n
PASS_LENGTHS = [(2, 5), (4, 17), (8, 17), (16, 97), (32, 193), (64, 257),
                (128, 257), (256, 7681), (512, 12289), (1024, 12289),
                (2048, 12289), (4096, 40961), (8192, 8404993),
                (16384, 786433)]


def _spectrum(n, q, kind, rng):
    if kind == "random":
        return rng.integers(0, q, n, dtype=np.uint32)
    return np.full(n, 0 if kind == "0" else q - 1, dtype=np.uint32)


def _fixed_sides(x, spec, tbl, name):
    """B4's twin, its plain version and JAX's interpret-mode kernel."""
    t = torch.from_numpy
    twin = TF.polymul_fixed_fused_passes_plain(t(x), t(spec), tbl)
    assert twin.dtype == torch.uint32
    plain = TF.polymul_fixed_plain(t(x), t(spec), tbl)
    jk = np.asarray(JK.polymul_fixed_fused_fn(name, interpret=True)(x, spec))
    return twin.numpy(), plain.numpy(), jk


@pytest.mark.parametrize("name", SETS)
def test_fixed_twin_matches_plain_pallas_and_oracle(name):
    tbl = get_tables(name)
    n, q = tbl.n, tbl.q
    rng = np.random.default_rng(67)
    for batch in (1, 3, 64):
        for x_kind in ("random", "q-1"):
            x = (rng.integers(0, q, (batch, n), dtype=np.uint32)
                 if x_kind == "random"
                 else np.full((batch, n), q - 1, dtype=np.uint32))
            for spec_kind in ("random", "0", "q-1"):
                twin, plain, jk = _fixed_sides(
                    x, _spectrum(n, q, spec_kind, rng), tbl, name)
                np.testing.assert_array_equal(twin, plain,
                                              err_msg=(batch, x_kind,
                                                       spec_kind))
                np.testing.assert_array_equal(twin, jk, err_msg=(
                    batch, x_kind, spec_kind))
    # a constant's canonical spectrum: the product is the negacyclic one
    x, a = _operands(n, q, 2)
    spec = TF.ntt_plain(torch.from_numpy(a[:1]), tbl).numpy()
    twin = TF.polymul_fixed_fused_passes_plain(
        torch.from_numpy(x), torch.from_numpy(spec), tbl).numpy()
    ps = get_params(name)
    for row in (0, 1):
        np.testing.assert_array_equal(
            twin[row], polymul_negacyclic_oracle(x[row], a[0], ps).astype(
                np.uint32))


@pytest.mark.parametrize("n,q", PASS_LENGTHS)
def test_fixed_twin_at_every_pass_length(n, q):
    """B4's twin at every length its kernels run (R = n below 32, two
    passes, three), against its plain version and JAX's interpret-mode
    kernel, x with a row of q - 1 and a spectrum that holds q - 1; its plan
    is B1's with the shared memory of one operand a row."""
    name = f"fixed-n{n}"
    for reg in (JPARAMS, TPARAMS):
        reg.register_param_set(name, n, q)
    try:
        tbl = get_tables(name)
        rng = np.random.default_rng(n)
        x = rng.integers(0, q, (3, n), dtype=np.uint32)
        x[0] = q - 1
        spec = _spectrum(n, q, "random", rng)
        spec[::3] = q - 1
        twin, plain, jk = _fixed_sides(x, spec, tbl, name)
        np.testing.assert_array_equal(twin, plain)
        np.testing.assert_array_equal(twin, jk)
    finally:
        for reg in (JPARAMS, TPARAMS):
            del reg.PARAM_SETS[name]
            reg.get_params.cache_clear()
    plan, b1 = TF.fixed_pass_plan(n), TF.fused_pass_plan(n)
    for f, _ in TPs.PassPlan._fields_:
        if f != "row_stride":
            assert list(np.ravel(getattr(plan, f))) == list(
                np.ravel(getattr(b1, f))), f
    if plan.passes > 1:
        pad = plan.threads if plan.threads < 32 else 0
        assert plan.row_stride == -(-(n + n // 32) // 32) * 32 + pad
        assert plan.row_stride - pad >= n + n // 32
        assert b1.row_stride - pad >= 2 * (n + n // 32)
    else:
        assert plan.row_stride == b1.row_stride == 0


def test_fixed_pass_plan_refuses_what_the_launcher_refuses():
    """A row length that is not a power of two from 2, or one past the
    kernels' three passes, raises; so does an operand count other than the
    kernels' 1 or 2."""
    for n in (1, 3, 48, 32768):
        with pytest.raises(ValueError):
            TF.fixed_pass_plan(n)
    with pytest.raises(ValueError, match="operands"):
        TPs.pass_plan(1024, False, True, operands=3)


# ----------------------------------------------------------------------
# B3: the inverse's passes alone.
# ----------------------------------------------------------------------

def _lazy(n, q, batch, rng):
    """Rows below 2q, the kernel's input range; row 0 (and the last) all
    2q - 1."""
    X = rng.integers(0, 2 * q, (batch, n), dtype=np.uint32)
    X[0], X[-1] = 2 * q - 1, 2 * q - 1
    return X


@pytest.mark.parametrize("name", SETS)
def test_intt_twin_matches_plain_pallas_and_oracle(name):
    tbl = get_tables(name)
    n, q = tbl.n, tbl.q
    rng = np.random.default_rng(68)
    jk = JK.intt_fused_fn(name, interpret=True)
    for batch in (1, 3, 64):
        X = _lazy(n, q, batch, rng)
        twin = TF.intt_passes_plain(torch.from_numpy(X), tbl)
        assert twin.dtype == torch.uint32 and twin.shape == (batch, n)
        np.testing.assert_array_equal(
            twin.numpy(), TF.intt_plain(torch.from_numpy(X), tbl).numpy(),
            err_msg=f"B={batch}")
        np.testing.assert_array_equal(twin.numpy(), np.asarray(jk(X)),
                                      err_msg=f"B={batch}")
    # through the forward and the pointwise product: the negacyclic product
    x, y = (torch.from_numpy(a) for a in _operands(n, q, 2))
    spec = TF._barrett(TF.ntt_plain(x, tbl).to(torch.int64),
                       TF.ntt_plain(y, tbl).to(torch.int64), tbl)
    z = TF.intt_passes_plain(spec.to(torch.uint32), tbl).numpy()
    ps = get_params(name)
    for row in (0, 1):
        np.testing.assert_array_equal(z[row], polymul_negacyclic_oracle(
            x[row].numpy(), y[row].numpy(), ps).astype(np.uint32))


@pytest.mark.parametrize("n,q", [
    pytest.param(n, q, marks=pytest.mark.slow) if n >= 8192 else (n, q)
    for n, q in PASS_LENGTHS + [(32768, 786433)]])
def test_intt_twin_at_every_length(n, q):
    """B3's twin at every length its kernels run (R = n below 32, two
    passes, three, and 1024 threads a row at n = 32768), against
    ``intt_plain`` and JAX's interpret-mode kernel, on rows below 2q with
    rows of 2q - 1; its plan is B4's inverse (the same radix, threads, rows
    and shared memory a row up to 16384) with the forward's fields 0."""
    name = f"intt-n{n}"
    for reg in (JPARAMS, TPARAMS):
        reg.register_param_set(name, n, q)
    try:
        tbl = get_tables(name)
        X = _lazy(n, q, 3, np.random.default_rng(n))
        twin = TF.intt_passes_plain(torch.from_numpy(X), tbl).numpy()
        np.testing.assert_array_equal(
            twin, TF.intt_plain(torch.from_numpy(X), tbl).numpy())
        np.testing.assert_array_equal(
            twin, np.asarray(JK.intt_fused_fn(name, interpret=True)(X)))
    finally:
        for reg in (JPARAMS, TPARAMS):
            del reg.PARAM_SETS[name]
            reg.get_params.cache_clear()
    plan = TF.intt_pass_plan(n)
    for side in ("lo", "hi", "b"):
        assert list(getattr(plan, f"fwd_{side}")) == [0] * TPs.MAX_PASSES
    assert plan.inv_b[0] == 0 and plan.radix == min(n, 32)
    if n <= 16384:
        b4 = TF.fixed_pass_plan(n)
        for f, _ in TPs.PassPlan._fields_:
            if not f.startswith("fwd_"):
                assert list(np.ravel(getattr(plan, f))) == list(
                    np.ravel(getattr(b4, f))), f
    else:
        assert (plan.threads, plan.rows, plan.passes) == (1024, 1, 3)
        with pytest.raises(ValueError, match="threads a row"):
            TF.fixed_pass_plan(n)


def test_intt_pass_plan_refuses_what_the_launcher_refuses():
    """No plan past 32768 or off the powers of two; an inverse alone runs
    on one operand, from the narrowest stage up, in cyclic windows; the
    plans with a forward (B1's, B4's) keep their 512-thread limit."""
    for n in (1, 3, 48, 65536):
        with pytest.raises(ValueError):
            TF.intt_pass_plan(n)
    for kw in ({"operands": 2}, {"operands": 1, "stockham": True}):
        with pytest.raises(ValueError, match="inverse alone"):
            TPs.pass_plan(1024, None, True, **kw)
    with pytest.raises(ValueError, match="inverse alone"):
        TPs.pass_plan(1024, None, False, operands=1)
    with pytest.raises(ValueError, match="512 a block"):
        TPs.pass_plan(32768, False, True, operands=1)
    assert "forward none" in TPs.describe_pass_plan(TF.intt_pass_plan(1024))


# ----------------------------------------------------------------------
# B2: the forward's passes alone.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", SETS)
def test_ntt_twin_matches_plain_pallas_and_oracle(name):
    tbl = get_tables(name)
    n, q = tbl.n, tbl.q
    jk = JK.ntt_fused_fn(name, interpret=True)
    for batch in (1, 3, 64):
        x, _ = _operands(n, q, batch, seed=71)
        xt = torch.from_numpy(x)
        plain, want = TF.ntt_plain(xt, tbl).numpy(), np.asarray(jk(x))
        np.testing.assert_array_equal(plain, want, err_msg=f"B={batch}")
        twin = TF.ntt_passes_plain(xt, tbl)
        assert twin.dtype == torch.uint32 and twin.shape == (batch, n)
        np.testing.assert_array_equal(twin.numpy(), want,
                                      err_msg=f"B={batch}")
        # B3's twin takes B2's output back to x
        assert torch.equal(TF.intt_passes_plain(twin, tbl), xt)
    # through the product and B3's twin: the negacyclic product
    x, y = (torch.from_numpy(a) for a in _operands(n, q, 2, seed=72))
    spec = TF._barrett(TF.ntt_passes_plain(x, tbl).to(torch.int64),
                       TF.ntt_passes_plain(y, tbl).to(torch.int64), tbl)
    z = TF.intt_passes_plain(spec.to(torch.uint32), tbl).numpy()
    ps = get_params(name)
    for row in (0, 1):
        np.testing.assert_array_equal(z[row], polymul_negacyclic_oracle(
            x[row].numpy(), y[row].numpy(), ps).astype(np.uint32))


@pytest.mark.parametrize("n,q", [
    pytest.param(n, q, marks=pytest.mark.slow) if n >= 8192 else (n, q)
    for n, q in PASS_LENGTHS + [(32768, 786433)]])
def test_ntt_twin_at_every_length(n, q):
    """B2's twin at every length its kernels run (R = n below 32, two
    passes, three, and 1024 threads a row at n = 32768) against ``ntt_plain`` and JAX's interpret-mode kernel, with rows
    of q - 1; its plan is B4's forward (the same radix, threads, rows and
    shared memory a row up to 16384) with the inverse's fields 0."""
    name = f"ntt-n{n}"
    for reg in (JPARAMS, TPARAMS):
        reg.register_param_set(name, n, q)
    try:
        tbl = get_tables(name)
        x, _ = _operands(n, q, 3, seed=n)
        want = np.asarray(JK.ntt_fused_fn(name, interpret=True)(x))
        xt = torch.from_numpy(x)
        np.testing.assert_array_equal(TF.ntt_plain(xt, tbl).numpy(), want)
        np.testing.assert_array_equal(TF.ntt_passes_plain(xt, tbl).numpy(),
                                      want)
    finally:
        for reg in (JPARAMS, TPARAMS):
            del reg.PARAM_SETS[name]
            reg.get_params.cache_clear()
    plan = TF.ntt_pass_plan(n)
    for side in ("lo", "hi", "b"):
        assert list(getattr(plan, f"inv_{side}")) == [0] * TPs.MAX_PASSES
    assert plan.fwd_b[0] == (n.bit_length() - 1) - (min(n, 32).bit_length()
                                                    - 1)
    assert plan.fwd_b[plan.passes - 1] == 0 and plan.radix == min(n, 32)
    if n <= 16384:
        b4 = TF.fixed_pass_plan(n)
        for f, _ in TPs.PassPlan._fields_:
            if not f.startswith("inv_"):
                assert list(np.ravel(getattr(plan, f))) == list(
                    np.ravel(getattr(b4, f))), f
    else:
        assert (plan.threads, plan.rows, plan.passes) == (1024, 1, 3)
        assert plan.row_stride == n + n // 32


def test_ntt_pass_plan_refuses_what_the_launcher_refuses():
    """No plan past 32768 or off the powers of two; a forward alone runs on
    one operand, from the widest stage down, in cyclic windows; a plan runs
    some transform."""
    for n in (1, 3, 48, 65536):
        with pytest.raises(ValueError):
            TF.ntt_pass_plan(n)
    for fwd_up, kw in ((False, {"operands": 2}), (True, {"operands": 1}),
                       (False, {"operands": 1, "stockham": True})):
        with pytest.raises(ValueError, match="forward alone"):
            TPs.pass_plan(1024, fwd_up, None, **kw)
    with pytest.raises(ValueError, match="forward, an inverse or both"):
        TPs.pass_plan(1024, None, None, operands=1)
    described = TPs.describe_pass_plan(TF.ntt_pass_plan(1024))
    assert "inverse none" in described and "forward [5,10)@5 [0,5)@0" in (
        described)
