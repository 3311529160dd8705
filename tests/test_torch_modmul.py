"""qtesla_tpu_torch.ops.modmul (int64 tensors holding uint32) against
qtesla_tpu.ops.modmul (jnp uint32), bit for bit, for every registered q,
including fast_reduce_2q and its sparse shift-add plan.

Tolerance: none; every value is an exact residue or uint32 word.  Inputs are
made with numpy from a seed and fed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtesla_tpu.ops import modmul as J
from qtesla_tpu.params import available_param_sets, get_params
from qtesla_tpu_torch.ops import modmul as T

SETS = available_param_sets()
U32_MAX = (1 << 32) - 1


def _edges(q: int, lazy_bound: int, rng, size=2048, extra=()):
    """0, 1, q-1, the top of the lazy range, random values below it."""
    fixed = [0, 1, q - 1, q, 2 * q - 1, lazy_bound - 1, *extra]
    fixed = [v for v in fixed if v < lazy_bound or v in extra]
    rand = rng.integers(0, lazy_bound, size=size, dtype=np.uint64)
    return np.concatenate([np.array(fixed, dtype=np.uint64),
                           rand]).astype(np.uint32)


def _torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int64))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def _jax(fn, *args, static=()):
    return np.asarray(jax.jit(fn, static_argnums=static)(*args))


@pytest.mark.parametrize("name", SETS)
def test_add_sub_mod(name):
    q = get_params(name).q
    rng = np.random.default_rng(1)
    a = _edges(q, q, rng)
    b = rng.permutation(a)
    for tfn, jfn in ((T.add_mod, J.add_mod), (T.sub_mod, J.sub_mod)):
        np.testing.assert_array_equal(
            _np(tfn(_torch(a), _torch(b), q)),
            _jax(jfn, jnp.asarray(a), jnp.asarray(b), q, static=(2,)))


@pytest.mark.parametrize("name", SETS)
def test_shoup_mulmod_lazy_and_canonical(name):
    """Any uint32 x, constant w < q: the lazy [0, 2q) value and the
    canonical value both equal the JAX functions'."""
    ps = get_params(name)
    q = ps.q
    rng = np.random.default_rng(2)
    x = _edges(q, 4 * q, rng, extra=(U32_MAX,))
    for w in (0, 1, q - 1, ps.r32, ps.n_inv, int(ps.psi_rev[1])):
        wsh = (w << 32) // q
        for tfn, jfn in ((T.shoup_mulmod_lazy, J.shoup_mulmod_lazy),
                         (T.shoup_mulmod, J.shoup_mulmod)):
            got = _np(tfn(_torch(x), w, wsh, q))
            want = _jax(jfn, jnp.asarray(x), jnp.uint32(w), jnp.uint32(wsh),
                        q, static=(3,))
            np.testing.assert_array_equal(got, want)
    assert int(T.shoup_mulmod_lazy(_torch(x), q - 1, ((q - 1) << 32) // q,
                                   q).max()) < 2 * q


@pytest.mark.parametrize("name", SETS)
def test_reduce_u32(name):
    ps = get_params(name)
    rng = np.random.default_rng(3)
    x = np.concatenate([_edges(ps.q, 4 * ps.q, rng, extra=(U32_MAX,)),
                        rng.integers(0, 1 << 32, 2048,
                                     dtype=np.uint64).astype(np.uint32)])
    got = _np(T.reduce_u32(_torch(x), ps.q, ps.one_shoup))
    want = _jax(J.reduce_u32, jnp.asarray(x), ps.q, ps.one_shoup,
                static=(1, 2))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, (x.astype(np.uint64) % ps.q))


@pytest.mark.parametrize("name", SETS)
def test_mulmod_barrett(name):
    """Exact for any uint32 operands: canonical, lazy [0, 4q) and full
    32-bit words including 2^32 - 1."""
    ps = get_params(name)
    q = ps.q
    rng = np.random.default_rng(4)
    x = _edges(q, 4 * q, rng, extra=(U32_MAX,))
    x = np.concatenate([x, rng.integers(0, 1 << 32, 2048,
                                        dtype=np.uint64).astype(np.uint32)])
    y = rng.permutation(x)
    y[:3] = U32_MAX
    consts = (q, ps.r32, ps.r32_shoup, ps.one_shoup)
    got = _np(T.mulmod_barrett(_torch(x), _torch(y), *consts))
    want = _jax(J.mulmod_barrett, jnp.asarray(x), jnp.asarray(y), *consts,
                static=(2, 3, 4, 5))
    np.testing.assert_array_equal(got, want)
    exact = (x.astype(object) * y.astype(object)) % q
    np.testing.assert_array_equal(got, exact.astype(np.uint32))


@pytest.mark.parametrize("name", SETS)
def test_fast_reduce_2q(name):
    """sparse_reduce_plan equals JAX's, and fast_reduce_2q is bit-equal to
    JAX's (sparse shift-add or sloppy-Shoup route) on random uint32, 0 and
    2^32 - 1, landing in [0, 2q)."""
    ps = get_params(name)
    q = ps.q
    assert T.sparse_reduce_plan(q) == J.sparse_reduce_plan(q)
    rng = np.random.default_rng(5)
    x = np.concatenate([np.array([0, 1, q - 1, q, 2 * q - 1, U32_MAX],
                                 dtype=np.uint32),
                        rng.integers(0, 1 << 32, 4096,
                                     dtype=np.uint64).astype(np.uint32)])
    got = _np(T.fast_reduce_2q(_torch(x), q, ps.one_shoup))
    want = _jax(J.fast_reduce_2q, jnp.asarray(x), q, ps.one_shoup,
                static=(1, 2))
    np.testing.assert_array_equal(got, want)
    assert int(got.max()) < 2 * q
    np.testing.assert_array_equal(got % q, x.astype(np.uint64) % q)

