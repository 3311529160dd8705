"""The port's Nussbaumer paths (``qtesla_tpu_torch/ops/ringz32.py``,
``qtesla_tpu_torch/ops/nussbaumer.py``, ``algo="nussbaumer"``) against the
JAX package's ``qtesla_tpu/ops/ringz32.py`` and ``ops/nussbaumer.py``.

- the ring ops against big ints and bit for bit against JAX's, with 0,
  2^32 - 2 and 2^32 - 1 among the inputs; the normalised residue does not
  depend on the order of the operations, the representation of zero before
  ``ring_normalize`` does;
- ``nussbaumer_plan`` equal to JAX's for n = 4 ... 8192;
- the ring path and the mod-q path, each with both base products, against
  JAX's ``nussbaumer_negacyclic_ring`` / ``nussbaumer_negacyclic_modq`` at
  n = 32 and 64 (the ring path also before normalising), random and
  all-(q-1) (ring: all-(2^32-1)) operands, and against the big-int oracle;
- ``polymul_nussbaumer_fn`` / ``polymul_nussbaumer_q_fn`` against JAX's at
  smallprime, forced chunking (B = 7, chunk 2) against one chunk, the
  ring path's out-of-domain guard raising where JAX's does;
- ``algo="nussbaumer"`` through ``polymul_negacyclic``, ``polymul_fn`` and
  ``NegacyclicPolymul.forward``;
- a qtesla-iii-speed canary, torch only, against the port's oracle and its
  merged path; the comparison with JAX at qtesla-iii-speed is ``slow``, as
  JAX's own q-III Nussbaumer test is.

Tolerance: none (exact residues).  Inputs are made with numpy from a
seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtesla_tpu.ops import nussbaumer as JN
from qtesla_tpu.ops import ringz32 as JR
from qtesla_tpu.params import ParamSet as JParamSet
from qtesla_tpu_torch import get_params, polymul_negacyclic_oracle
from qtesla_tpu_torch.models import polymul as TP
from qtesla_tpu_torch.ops import nussbaumer as TN
from qtesla_tpu_torch.ops import ringz32 as TR
from qtesla_tpu_torch.oracle import negacyclic_schoolbook

M = (1 << 32) - 1
BASES = ["karatsuba", "schoolbook"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ring_inputs(rng, size=2048):
    a = rng.integers(0, 1 << 32, size, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, size, dtype=np.uint64).astype(np.uint32)
    edge = np.array([0, M - 1, M], dtype=np.uint32)
    a[:9] = np.repeat(edge, 3)
    b[:9] = np.tile(edge, 3)
    return a, b


_RING_OPS = {
    "add": (lambda a, b: (a + b) % M, 2),
    "sub": (lambda a, b: (a - b) % M, 2),
    "mul": (lambda a, b: (a * b) % M, 2),
    "neg": (lambda a: (-a) % M, 1),
    "div2": (lambda a: (a * pow(2, -1, M)) % M, 1),
}


@pytest.mark.parametrize("op", list(_RING_OPS))
def test_ring_ops_vs_bigint_and_jax(op):
    a, b = _ring_inputs(np.random.default_rng(11))
    want_fn, arity = _RING_OPS[op]
    args = (a, b)[:arity]
    got = getattr(TR, "ring_" + op)(*(_t(v).to(torch.int64) for v in args))
    assert int(got.min()) >= 0 and int(got.max()) <= M
    jgot = np.asarray(jax.jit(getattr(JR, "ring_" + op))(
        *(jnp.asarray(v) for v in args)))
    np.testing.assert_array_equal(got.numpy(), jgot.astype(np.int64))
    norm = TR.ring_normalize(got).numpy().astype(object)
    np.testing.assert_array_equal(
        norm, want_fn(*(v.astype(object) for v in args)))


def test_ring_residue_is_independent_of_operation_order():
    """Exact ring arithmetic: every order gives the same normalised
    residue.  Only the representation of zero may differ before
    ``ring_normalize``: 1 + (2^32 - 2) is 0xFFFFFFFF, 1 - 1 is 0."""
    i64 = torch.int64
    one, m1 = torch.tensor([1], dtype=i64), torch.tensor([M - 1], dtype=i64)
    assert int(TR.ring_add(one, m1)) == M
    assert int(TR.ring_sub(one, TR.ring_neg(m1))) == 0
    rng = np.random.default_rng(12)
    a, b = (_t(v).to(i64) for v in _ring_inputs(rng))
    c = _t(rng.integers(0, 1 << 32, a.shape[0], dtype=np.uint64)
           .astype(np.uint32)).to(i64)
    for left, right in (
            (TR.ring_add(TR.ring_add(a, b), c),
             TR.ring_add(a, TR.ring_add(c, b))),
            (TR.ring_mul(TR.ring_mul(a, b), c),
             TR.ring_mul(a, TR.ring_mul(c, b))),
            (TR.ring_sub(a, b), TR.ring_add(a, TR.ring_neg(b))),
            (TR.ring_mul(TR.ring_add(a, b), c),
             TR.ring_add(TR.ring_mul(a, c), TR.ring_mul(b, c)))):
        assert torch.equal(TR.ring_normalize(left), TR.ring_normalize(right))
    # two base products, two operation orders, one residue
    x, y = (_t(rng.integers(0, 1 << 32, (3, 64), dtype=np.uint64)
               .astype(np.uint32)) for _ in range(2))
    assert torch.equal(TN.nussbaumer_negacyclic_ring(x, y, "karatsuba"),
                       TN.nussbaumer_negacyclic_ring(x, y, "schoolbook"))


@pytest.mark.parametrize("n", [1 << e for e in range(2, 14)])
def test_plan_equals_jax(n):
    assert TN.nussbaumer_plan(n) == JN.nussbaumer_plan(n)


def _ring_operands(rng, n):
    x = rng.integers(0, 1 << 32, (3, n), dtype=np.uint64).astype(np.uint32)
    y = rng.integers(0, 1 << 32, (3, n), dtype=np.uint64).astype(np.uint32)
    x[1, :] = M
    y[1, :] = M
    x[2] = rng.integers(0, 1000, n)
    y[2] = rng.integers(0, 1000, n)
    return x, y


def _ring_oracle(x, y):
    n = len(x)
    out = [0] * n
    for i in range(n):
        for j in range(n):
            p = int(x[i]) * int(y[j])
            if i + j < n:
                out[i + j] += p
            else:
                out[i + j - n] -= p
    return np.array([v % M for v in out], dtype=np.uint32)


@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("n", [32, 64])
def test_ring_path_vs_jax(n, base):
    x, y = _ring_operands(np.random.default_rng(n), n)
    got = TN.nussbaumer_negacyclic_ring(_t(x), _t(y), base)
    assert got.dtype == torch.uint32
    # JAX's values before normalising: the port's are the same
    jraw = np.asarray(jax.jit(
        lambda a, b: JN._nussbaumer(a, b, JN._RING_ARITH, base))(x, y))
    raw = TN._nussbaumer(_t(x).to(torch.int64), _t(y).to(torch.int64),
                         TN._RING_ARITH, base)
    np.testing.assert_array_equal(raw.numpy(), jraw.astype(np.int64))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JR.ring_normalize(jraw)))
    for b in range(3):
        np.testing.assert_array_equal(got[b].numpy(),
                                      _ring_oracle(x[b], y[b]))


@pytest.mark.parametrize("base", BASES)
@pytest.mark.parametrize("n", [32, 64])
def test_modq_path_vs_jax(n, base):
    ps = JParamSet(name=f"nussbaumer-{n}", n=n, q=65537)
    rng = np.random.default_rng(100 + n)
    x = rng.integers(0, ps.q, (3, n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (3, n), dtype=np.uint32)
    x[1, :] = ps.q - 1
    y[1, :] = ps.q - 1
    got = TN.nussbaumer_negacyclic_modq(_t(x), _t(y), ps, base)
    want = np.asarray(jax.jit(
        lambda a, b: JN.nussbaumer_negacyclic_modq(a, b, ps, base))(x, y))
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(3):
        np.testing.assert_array_equal(
            got[b].numpy(), negacyclic_schoolbook(x[b], y[b], ps)
            .astype(np.uint32))


def test_polymul_fns_vs_jax():
    name = "smallprime"
    ps = get_params(name)
    rng = np.random.default_rng(21)
    x = rng.integers(0, ps.q, (4, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (4, ps.n), dtype=np.uint32)
    x[0, :] = ps.q - 1
    y[0, :] = ps.q - 1
    for base in BASES:
        got = TN.polymul_nussbaumer_q_fn(name, base)(_t(x), _t(y))
        want = np.asarray(JN.polymul_nussbaumer_q_fn(name, base)(x, y))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=base)
    # the ring path on operands its guard admits, some products negative
    c = TN.ring_exact_coeff_bound(ps.n)
    assert c == JN.ring_exact_coeff_bound(ps.n)
    xs = rng.integers(0, c + 1, (4, ps.n), dtype=np.uint32)
    ys = rng.integers(0, c + 1, (4, ps.n), dtype=np.uint32)
    xs[0, :] = c
    ys[0, :] = c
    xs[1] = 0
    ys[1] = 0
    xs[1, 1], ys[1, ps.n - 1] = 2, 7          # x y = -14 at X^0
    got = TN.polymul_nussbaumer_fn(name, max_coeff=c)(_t(xs), _t(ys))
    want = np.asarray(JN.polymul_nussbaumer_fn(name, max_coeff=c)(xs, ys))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), TP.polymul_negacyclic(_t(xs), _t(ys), name).numpy())
    assert int(got[1, 0]) == ps.q - 14


def test_forced_chunking_equals_one_chunk():
    ps = get_params("smallprime")
    rng = np.random.default_rng(22)
    x, y = (_t(rng.integers(0, ps.q, (7, ps.n), dtype=np.uint32))
            for _ in range(2))
    for fn in (TN.polymul_nussbaumer_q_fn(ps.name),
               TN.polymul_nussbaumer_q_fn(ps.name, "schoolbook")):
        whole = fn(x, y)
        assert torch.equal(fn(x, y, chunk=2), whole)   # 3 chunks + 1 row
        assert torch.equal(fn(x.reshape(7, 1, ps.n), y.reshape(7, 1, ps.n),
                              chunk=3), whole.reshape(7, 1, ps.n))
    ring = TN.polymul_nussbaumer_fn(ps.name, max_coeff=50)
    xs, ys = (_t(rng.integers(0, 51, (7, ps.n), dtype=np.uint32))
              for _ in range(2))
    assert torch.equal(ring(xs, ys, chunk=2), ring(xs, ys))
    with pytest.raises(ValueError, match="chunk"):
        TN.polymul_nussbaumer_q_fn(ps.name)(x, y, chunk=0)
    assert TN.default_chunk(1024) == 4096


def test_ring_guard_raises_as_jax():
    for n in (32, 512, 1024, 2048):
        assert TN.ring_exact_coeff_bound(n) == JN.ring_exact_coeff_bound(n)
    limit = TN.ring_exact_coeff_bound(1024)
    for fns in (TN.polymul_nussbaumer_fn, JN.polymul_nussbaumer_fn):
        with pytest.raises(ValueError, match="exact only"):
            fns("qtesla-iii-speed")
        with pytest.raises(ValueError, match="exact only"):
            fns("qtesla-iii-speed", max_coeff=limit + 1)
        fns("qtesla-iii-speed", max_coeff=limit)
    with pytest.raises(ValueError, match="unknown base"):
        TN.polymul_nussbaumer_q_fn("smallprime", "toom")
    x = torch.zeros((1, 32), dtype=torch.uint32)
    with pytest.raises(ValueError, match="operands on"):
        TN.polymul_nussbaumer_q_fn("smallprime")(
            x, torch.zeros((1, 32), dtype=torch.uint32, device="meta"))
    with pytest.raises(TypeError, match="uint32"):
        TN.polymul_nussbaumer_q_fn("smallprime")(x.to(torch.int64), x)


def test_algo_nussbaumer_through_the_models_api():
    name = "smallprime"
    ps = get_params(name)
    rng = np.random.default_rng(23)
    x, y = (_t(rng.integers(0, ps.q, (3, ps.n), dtype=np.uint32))
            for _ in range(2))
    want = TP.polymul_negacyclic(x, y, name)
    assert "nussbaumer" in TP.ALGORITHMS
    assert torch.equal(TP.polymul_negacyclic(x, y, ps, algo="nussbaumer"),
                       want)
    assert torch.equal(TP.polymul_fn(name, "nussbaumer")(x, y), want)
    assert torch.equal(TP.NegacyclicPolymul(name)(x, y, algo="nussbaumer"),
                       want)


def _q3_operands():
    ps = get_params("qtesla-iii-speed")
    rng = np.random.default_rng(24)
    x = rng.integers(0, ps.q, (2, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (2, ps.n), dtype=np.uint32)
    x[1, :] = ps.q - 1
    y[1, :] = ps.q - 1
    return ps, x, y


def test_qtesla_iii_canary():
    """qtesla-iii-speed in the default tier, torch only: the oracle and the
    merged path."""
    ps, x, y = _q3_operands()
    z = TP.polymul_negacyclic(_t(x), _t(y), ps.name, algo="nussbaumer")
    assert torch.equal(z, TP.polymul_negacyclic(_t(x), _t(y), ps.name))
    np.testing.assert_array_equal(
        z[0].numpy(), polymul_negacyclic_oracle(x[0], y[0], ps)
        .astype(np.uint32))
    c = TN.ring_exact_coeff_bound(ps.n)
    xs, ys = x % (c + 1), y % (c + 1)
    assert torch.equal(
        TN.polymul_nussbaumer_fn(ps.name, max_coeff=c)(_t(xs), _t(ys)),
        TP.polymul_negacyclic(_t(xs), _t(ys), ps.name))


@pytest.mark.slow
@pytest.mark.parametrize("base", BASES)
def test_qtesla_iii_vs_jax(base):
    """Slow: JAX's q-III Nussbaumer takes long to compile on the CPU (its
    own q-III test is slow too)."""
    ps, x, y = _q3_operands()
    got = TN.polymul_nussbaumer_q_fn(ps.name, base)(_t(x), _t(y))
    want = np.asarray(JN.polymul_nussbaumer_q_fn(ps.name, base)(x, y))
    np.testing.assert_array_equal(got.numpy(), want)
    c = TN.ring_exact_coeff_bound(ps.n)
    xs, ys = x % (c + 1), y % (c + 1)
    np.testing.assert_array_equal(
        TN.polymul_nussbaumer_fn(ps.name, max_coeff=c)(_t(xs), _t(ys))
        .numpy(),
        np.asarray(JN.polymul_nussbaumer_fn(ps.name, max_coeff=c)(xs, ys)))
