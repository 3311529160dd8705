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
  with one operand's shared memory a row.

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
# PASS_LENGTHS): (n, q), q prime and 1 mod 2n
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
