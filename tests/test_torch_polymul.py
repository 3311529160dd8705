"""The port's fused functions and its polymul slice against the JAX package.

- The four wrappers of ``qtesla_tpu_torch.ops.ntt_fused`` on CPU tensors
  (their plain versions) against the Pallas kernels of
  ``qtesla_tpu.ops.ntt_pallas`` run in interpret mode, at smallprime for
  B in {1, 3, 64} with random and all-(q-1) operands, plus a
  qtesla-iii-speed canary at B = 3.
- ``polymul_negacyclic(..., algo="fused")``, ``NegacyclicPolymul`` and the
  fixed-operand pair against JAX ``polymul_negacyclic`` and the big-int
  oracle.

Tolerance: none (integer equality).  Inputs are made with numpy from a seed
and fed to both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtesla_tpu.models import polymul as JP
from qtesla_tpu.ops import ntt_pallas as JK
from qtesla_tpu.oracle import polymul_negacyclic_oracle
from qtesla_tpu.params import get_params
from qtesla_tpu_torch.models import polymul as TP
from qtesla_tpu_torch.ops import ntt_fused as TK

KINDS = ("polymul", "polymul_fixed", "ntt", "intt")


def _operands(name, batch, worst, seed=11):
    ps = get_params(name)
    rng = np.random.default_rng(seed)
    q = ps.q
    if worst:
        x = np.full((2, batch, ps.n), q - 1, dtype=np.uint32)
        lazy = np.full((batch, ps.n), 2 * q - 1, dtype=np.uint32)
    else:
        x = rng.integers(0, q, (2, batch, ps.n), dtype=np.uint32)
        lazy = rng.integers(0, 2 * q, (batch, ps.n), dtype=np.uint32)
    return ps, x[0], x[1], lazy


def _both(kind, name, x, y, lazy):
    """(port, JAX interpret-mode kernel) outputs as numpy uint32."""
    t = torch.from_numpy
    if kind == "polymul":
        mine = TK.polymul_fused_fn(name)(t(x), t(y))
        ref = JK.polymul_fused_fn(name, interpret=True)(x, y)
    elif kind == "polymul_fixed":
        spec = np.array(JK.ntt_fused_fn(name, interpret=True)(y[:1]))
        mine = TK.polymul_fixed_fused_fn(name)(t(x), t(spec))
        ref = JK.polymul_fixed_fused_fn(name, interpret=True)(x, spec)
    elif kind == "ntt":
        mine = TK.ntt_fused_fn(name)(t(x))
        ref = JK.ntt_fused_fn(name, interpret=True)(x)
    else:
        mine = TK.intt_fused_fn(name)(t(lazy))
        ref = JK.intt_fused_fn(name, interpret=True)(lazy)
    assert mine.dtype == torch.uint32
    return mine.numpy(), np.asarray(ref)


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_fused_matches_pallas_interpret(kind, batch, worst):
    _, x, y, lazy = _operands("smallprime", batch, worst)
    mine, ref = _both(kind, "smallprime", x, y, lazy)
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("kind", KINDS)
def test_fused_matches_pallas_interpret_real_set(kind):
    """qtesla-iii-speed canary (n = 1024) at B = 3."""
    _, x, y, lazy = _operands("qtesla-iii-speed", 3, False)
    x[0], y[0] = get_params("qtesla-iii-speed").q - 1, 0
    mine, ref = _both(kind, "qtesla-iii-speed", x, y, lazy)
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("name", [
    "smallprime", "qtesla-iii-speed",
    pytest.param("qtesla-i", marks=pytest.mark.slow),
    pytest.param("qtesla-p-i", marks=pytest.mark.slow),
    pytest.param("qtesla-p-iii", marks=pytest.mark.slow)])
def test_slice_matches_jax_and_oracle(name):
    ps, x, y, _ = _operands(name, 4, False, seed=12)
    x[0] = ps.q - 1
    want = np.asarray(JP.polymul_negacyclic(jnp.asarray(x), jnp.asarray(y),
                                            ps))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for algo in ("fused", "merged"):
        got = TP.polymul_negacyclic(xt, yt, ps, algo=algo)
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want[1], polymul_negacyclic_oracle(x[1], y[1], ps).astype(np.uint32))

    mod = TP.NegacyclicPolymul(name)
    np.testing.assert_array_equal(mod(xt, yt, algo="fused").numpy(), want)
    np.testing.assert_array_equal(mod(xt, yt).numpy(), want)


def test_slice_batch_shapes_and_transforms():
    """Leading batch axes pass through; ntt/intt round-trip for both
    algos; the two algos agree on the spectrum."""
    ps, x, y, _ = _operands("smallprime", 6, False, seed=13)
    xt = torch.from_numpy(x).reshape(2, 3, ps.n)
    yt = torch.from_numpy(y).reshape(2, 3, ps.n)
    z = TP.polymul_negacyclic(xt, yt, "smallprime", algo="fused")
    assert tuple(z.shape) == (2, 3, ps.n)
    want = np.asarray(JP.polymul_negacyclic(jnp.asarray(x), jnp.asarray(y),
                                            ps))
    np.testing.assert_array_equal(z.reshape(6, ps.n).numpy(), want)
    X = {algo: TP.ntt(xt, ps, algo) for algo in ("merged", "fused")}
    np.testing.assert_array_equal(X["merged"].numpy(), X["fused"].numpy())
    for algo in ("merged", "fused"):
        np.testing.assert_array_equal(TP.intt(X[algo], ps, algo).numpy(),
                                      xt.numpy())


@pytest.mark.parametrize("algo", ["fused", "merged"])
def test_fixed_operand_pair(algo):
    """multiply(x, prepare(a)) equals the two-operand product with a
    broadcast, and the JAX fixed pair."""
    name = "smallprime"
    ps, x, y, _ = _operands(name, 5, False, seed=14)
    a = y[:1]
    prep, mul = TP.polymul_fixed_fn(name, algo)
    z = mul(torch.from_numpy(x), prep(torch.from_numpy(a)))
    both = np.ascontiguousarray(np.broadcast_to(a, x.shape))
    np.testing.assert_array_equal(
        z.numpy(), TP.polymul_negacyclic(torch.from_numpy(x),
                                         torch.from_numpy(both), name).numpy())
    jprep, jmul = JP.polymul_fixed_fn(name, "merged")
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(jmul(jnp.asarray(x), jprep(jnp.asarray(a)))))
