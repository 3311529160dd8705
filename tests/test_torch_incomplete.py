"""The port's incomplete (Kyber-shaped) NTT (``qtesla_tpu_torch/ops/
incomplete.py``) against the JAX package's ``qtesla_tpu/ops/incomplete.py``.

- the tables (``zs``, ``zs_inv``, ``gammas``, ``half_inv``) equal JAX's;
- the polymul, the forward transform and the round trip bit for bit
  against JAX at (256, 3329) and (in ``slow``) (512, 7681), random and
  all-(q-1) operands, and against the big-int oracle;
- the wrong-modulus errors, and a composite q raising ``ValueError``
  naming "prime" (the port checks before its generator search; JAX is not
  called with one, its search need not end);
- the tables follow the operands' device;
- ``slow``: the twin of JAX's 9-prime registration fuzz.

Tolerance: none (exact residues).  Inputs are made with numpy from a
seed."""

import types

import jax
import numpy as np
import pytest
import torch

from qtesla_tpu.ops import incomplete as JI
from qtesla_tpu_torch.ops import incomplete as TI
from qtesla_tpu_torch.oracle import negacyclic_schoolbook
from qtesla_tpu_torch.params import _is_prime

SHAPES = [(256, 3329),                                    # ML-KEM
          pytest.param(512, 7681, marks=pytest.mark.slow)]   # NewHope


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _oracle(x, y, n, q):
    return negacyclic_schoolbook(x, y, types.SimpleNamespace(n=n, q=q)
                                 ).astype(np.uint32)


@pytest.mark.parametrize("n,q", [(64, 193)] + SHAPES)
def test_tables_equal_jax(n, q):
    got, want = TI.incomplete_params(n, q), JI.incomplete_params(n, q)
    assert (got.g, got.zeta, got.L, got.half_inv) == (
        want.g, want.zeta, want.L, want.half_inv)
    for field in ("zs", "zs_inv"):
        for level, (a, b) in enumerate(zip(getattr(got, field),
                                           getattr(want, field))):
            np.testing.assert_array_equal(a, np.asarray(b),
                                          err_msg=f"{field}[{level}]")
    np.testing.assert_array_equal(got.gammas, np.asarray(want.gammas))


@pytest.mark.parametrize("n,q", SHAPES)
def test_polymul_and_round_trip_vs_jax(n, q):
    rng = np.random.default_rng(n + q)
    x = rng.integers(0, q, (3, n), dtype=np.uint32)
    y = rng.integers(0, q, (3, n), dtype=np.uint32)
    x[0, :] = q - 1
    y[0, :] = q - 1
    p, jp = TI.incomplete_params(n, q), JI.incomplete_params(n, q)
    z = TI.polymul_incomplete_fn(n, q)(_t(x), _t(y))
    assert z.dtype == torch.uint32
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(JI.polymul_incomplete_fn(n, q)(x, y)))
    for b in range(2):
        np.testing.assert_array_equal(z[b].numpy(), _oracle(x[b], y[b], n, q))
    X = TI.ntt_incomplete(_t(x), p)
    np.testing.assert_array_equal(
        X.numpy(), np.asarray(jax.jit(lambda a: JI.ntt_incomplete(a, jp))(x)))
    assert torch.equal(TI.intt_incomplete(X, p), _t(x))
    # basemul by the spectrum of 1 is the identity
    one = torch.zeros((3, n), dtype=torch.uint32)
    one[:, 0] = 1
    assert torch.equal(TI.basemul_incomplete(X, TI.ntt_incomplete(one, p),
                                             p), X)


def test_rejects_wrong_modulus():
    with pytest.raises(ValueError, match="mod n"):
        TI.incomplete_params(256, 3331)       # 3331 is not 1 mod 256
    with pytest.raises(ValueError, match="power of two"):
        TI.incomplete_params(96, 97)
    with pytest.raises(ValueError, match="2\\^30"):
        TI.incomplete_params(256, (1 << 30) + 257)
    with pytest.raises(ValueError, match="mod n"):
        JI.incomplete_params(256, 3331)       # as JAX's does


def test_composite_modulus_raises():
    """1025 = 25 * 41 is 1 mod 256: only the primality check stops it."""
    assert not _is_prime(1025) and (1025 - 1) % 256 == 0
    with pytest.raises(ValueError, match="prime"):
        TI.incomplete_params(256, 1025)
    with pytest.raises(ValueError, match="prime"):
        TI.polymul_incomplete_fn(64, 65 * 65)   # 4225 = 1 mod 64
    assert [m for m in range(2, 60) if _is_prime(m)] == [
        2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59]
    assert _is_prime(3329) and _is_prime(8404993)
    assert not _is_prime(8404993 * 3329) and not _is_prime(1)


def test_tables_follow_the_operands_device():
    n, q = 64, 193
    p = TI.incomplete_params(n, q)
    x = torch.zeros((2, n), dtype=torch.uint32, device="meta")
    z = TI.polymul_incomplete_fn(n, q)(x, x)
    assert z.device.type == "meta" and tuple(z.shape) == (2, n)
    assert p.on("meta")["gammas"].device.type == "meta"
    assert p.on("cpu")["zs"][0].device.type == "cpu"
    with pytest.raises(ValueError, match="differ"):
        TI.polymul_incomplete_fn(n, q)(x, torch.zeros((2, n),
                                                      dtype=torch.uint32))
    with pytest.raises(TypeError, match="uint32"):
        TI.ntt_incomplete(torch.zeros((2, n), dtype=torch.int64), p)


@pytest.mark.slow
def test_registration_space_fuzz():
    """Slow: nine (n, q), three primes q = 1 mod n but not mod 2n for each
    n in {64, 128, 256}, against the oracle (the twin of JAX's fuzz,
    tests/test_incomplete.py)."""
    rng = np.random.default_rng(97)
    checked = 0
    for n in (64, 128, 256):
        qs, k = [], 1
        while len(qs) < 3:
            q = k * n + 1
            if q > 3 * n and _is_prime(q):
                qs.append(q)
            k += 2
        for q in qs:
            assert (q - 1) % n == 0 and (q - 1) % (2 * n) != 0
            x = rng.integers(0, q, (2, n), dtype=np.uint32)
            y = rng.integers(0, q, (2, n), dtype=np.uint32)
            x[0, :] = q - 1
            y[0, :] = q - 1
            z = TI.polymul_incomplete_fn(n, q)(_t(x), _t(y)).numpy()
            for b in range(2):
                np.testing.assert_array_equal(z[b], _oracle(x[b], y[b], n, q),
                                              err_msg=f"(n={n}, q={q})")
            checked += 1
    assert checked == 9
