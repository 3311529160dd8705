"""The port's native oracle (``qtesla_tpu_torch/utils/native.py`` over its
own ``csrc/oracle.cpp``) against the JAX package's binding
(``qtesla_tpu/utils/native.py``) and the Python oracles, on seeded rows at
smallprime and one qtesla-iii-speed canary.

- ``negacyclic_schoolbook``, ``ntt_naive`` / ``intt_naive``,
  ``negacyclic_schoolbook_ring`` and ``polymul_ntt`` equal JAX's native
  functions and the Python oracles (the port's ``negacyclic_schoolbook``;
  JAX's ``ntt_naive`` and ring schoolbook, which the port's oracle module
  does not carry);
- the library is built into the build directory under a hash of its
  source, and nothing is written under ``csrc/``;
- with no compiler on PATH, ``native_available()`` is false and a call
  raises ``NativeOracleUnavailable`` naming g++.

Without ``g++`` every test here skips, saying so.  Tolerance: none."""

import shutil

import numpy as np
import pytest

from qtesla_tpu import oracle as JO
from qtesla_tpu.utils import native as JN
from qtesla_tpu_torch import oracle as TO
from qtesla_tpu_torch.params import get_params
from qtesla_tpu_torch.utils import native as N


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is absent: the native oracle cannot be built here")
    if not JN.native_available():
        pytest.skip("the JAX package's native oracle does not build here")


def _rows(name, count, seed):
    ps = get_params(name)
    rng = np.random.default_rng(seed)
    return ps, rng.integers(0, ps.q, (2, count, ps.n), dtype=np.uint32)


@pytest.mark.parametrize("name,count", [("smallprime", 5),
                                        ("qtesla-iii-speed", 1)])
def test_schoolbook_equals_jax_and_python(gxx, name, count):
    ps, (x, y) = _rows(name, count, 11)
    x[0, :4] = y[0, -4:] = ps.q - 1
    got = N.negacyclic_schoolbook(x, y, ps.q)
    assert got.dtype == np.uint32 and got.shape == x.shape
    np.testing.assert_array_equal(got, JN.negacyclic_schoolbook(x, y, ps.q))
    for b in range(count):
        np.testing.assert_array_equal(
            got[b].astype(np.uint64), TO.negacyclic_schoolbook(x[b], y[b], ps))
    np.testing.assert_array_equal(N.negacyclic_schoolbook(x[0], y[0], ps.q),
                                  got[0])


@pytest.mark.parametrize("name", ["smallprime", "qtesla-iii-speed"])
def test_ntt_naive_equals_jax_and_python(gxx, name):
    ps, (x, _) = _rows(name, 1, 12)
    X = N.ntt_naive(x[0], ps.q, ps.omega)
    np.testing.assert_array_equal(X, JN.ntt_naive(x[0], ps.q, ps.omega))
    if ps.n <= 64:
        np.testing.assert_array_equal(X.astype(np.uint64),
                                      JO.ntt_naive(x[0], ps))
    np.testing.assert_array_equal(N.intt_naive(X, ps.q, ps.omega), x[0])
    np.testing.assert_array_equal(N.intt_naive(X, ps.q, ps.omega),
                                  JN.intt_naive(X, ps.q, ps.omega))


def test_ring_schoolbook_equals_jax_and_python(gxx):
    rng = np.random.default_rng(13)
    x, y = (rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
            for _ in range(2))
    x[:3] = 0xFFFFFFFF
    got = N.negacyclic_schoolbook_ring(x, y)
    np.testing.assert_array_equal(got, JN.negacyclic_schoolbook_ring(x, y))
    np.testing.assert_array_equal(got.astype(np.uint64),
                                  JO.negacyclic_schoolbook_ring(x, y))


@pytest.mark.parametrize("name", ["smallprime", "qtesla-iii-speed"])
def test_polymul_ntt_equals_schoolbook_and_jax(gxx, name):
    ps, (x, y) = _rows(name, 1, 14)
    got = N.polymul_ntt(x[0], y[0], ps.q, ps.psi)
    np.testing.assert_array_equal(got, JN.polymul_ntt(x[0], y[0], ps.q,
                                                      ps.psi))
    np.testing.assert_array_equal(got, N.negacyclic_schoolbook(x, y, ps.q)[0])


def test_shape_mismatch_raises(gxx):
    with pytest.raises(ValueError, match="shapes differ"):
        N.negacyclic_schoolbook(np.zeros((2, 8)), np.zeros((1, 8)), 17)


def test_builds_into_the_build_dir_not_csrc(gxx, tmp_path, monkeypatch):
    before = sorted(p.name for p in N.SOURCE.parent.iterdir())
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path)
    N._lib.cache_clear()
    try:
        assert N.native_available()
        ps, (x, y) = _rows("smallprime", 2, 15)
        np.testing.assert_array_equal(N.negacyclic_schoolbook(x, y, ps.q),
                                      JN.negacyclic_schoolbook(x, y, ps.q))
    finally:
        N._lib.cache_clear()
    built = [p.name for p in tmp_path.iterdir()]
    assert len(built) == 1 and built[0].startswith("liboracle_")
    assert built[0].endswith(".so")
    assert sorted(p.name for p in N.SOURCE.parent.iterdir()) == before


def test_unavailable_without_a_compiler(tmp_path, monkeypatch):
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path / "build")
    N._lib.cache_clear()
    try:
        assert not N.native_available()
        with pytest.raises(N.NativeOracleUnavailable, match=r"g\+\+"):
            N.negacyclic_schoolbook(np.ones((1, 8)), np.ones((1, 8)), 17)
    finally:
        N._lib.cache_clear()
