"""The CPU twins of B1's and B10 Stockham's register-pass schedules against
the plain pipelines, JAX's interpret-mode kernels and the big-int oracle.

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
  their last block.

Tolerance: none (integer equality).  Inputs are made with numpy from a seed
and fed to every side."""

import numpy as np
import pytest
import torch

from qtesla_tpu.oracle import polymul_negacyclic_oracle
from qtesla_tpu.ops import ntt_pallas as JK
from qtesla_tpu.ops.ntt_pairings_pallas import polymul_pairing_fn
from qtesla_tpu.params import get_params
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
