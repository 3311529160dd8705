"""The port's one-device mesh forms (``qtesla_tpu_torch/parallel/
ulysses.py``, ``parallel/sharded.py``) against the JAX package's mesh forms
(``qtesla_tpu/parallel/ulysses.py``, ``parallel/sharded.py``) on the
8-device CPU mesh (``tests/conftest.py``).

- Ulysses and fixed-operand Ulysses at k in {2, 4, 8} against JAX's on
  ``make_mesh(data=1, model=k)``, and a ragged batch (B = 5, k = 4), which
  both pad to a multiple of k;
- the exchanges against ``lax.all_to_all`` on the mesh;
- the dispatcher's choice (``sp_strategy``) and its outputs against JAX's
  ``polymul_sp_fn``;
- the data-parallel forms against JAX's ``polymul_dp_fn("merged")`` /
  ``polymul_fixed_dp_fn("merged")`` on an 8-way data mesh, on a ragged
  batch against JAX's on the batch padded;
- the plain-torch four-step (``local="jnp"``): its spectrum against JAX's
  ``ntt_fourstep_sharded_fn``, its round trip, and its polymul against
  JAX's ``local="jnp"`` at k in {2, 4, 8};
- operands on another device raise.

All at smallprime (the four-step at k = 8, which needs n1 >= 8, at
toy-7681: n = 64); ``slow`` adds qtesla-i.  Tolerance: none (exact
residues).  Inputs are made with numpy from a seed."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as JP_

from qtesla_tpu import parallel as JPAR
from qtesla_tpu.params import register_param_set as jregister
from qtesla_tpu_torch import register_param_set
from qtesla_tpu_torch.models import polymul as TP
from qtesla_tpu_torch.parallel import make_mesh
from qtesla_tpu_torch.parallel import sharded as TSH
from qtesla_tpu_torch.parallel import ulysses as TU

SMALL = ("smallprime", 32, 65537)
TOY = ("toy-7681", 64, 7681)         # JAX's tests register it too
KS = [2, 4, 8]


@functools.lru_cache(maxsize=None)
def _set(name):
    if name == TOY[0]:
        register_param_set(*TOY)
        jregister(*TOY)
    return {SMALL[0]: SMALL, TOY[0]: TOY, "qtesla-i": (
        "qtesla-i", 512, 4205569)}[name][1:]


def _data(name, B, seed):
    n, q = _set(name)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, q, (B, n), dtype=np.uint32)
    y = rng.integers(0, q, (B, n), dtype=np.uint32)
    x[0, :] = q - 1
    y[0, :] = q - 1
    return x, y


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _meshes(k, data=1):
    return JPAR.make_mesh(data=data, model=k), make_mesh(model=k,
                                                          device="cpu")


@pytest.mark.parametrize("k", KS)
def test_ulysses_vs_jax(k):
    jm, tm = _meshes(k)
    x, y = _data("smallprime", 8, k)
    got = TU.polymul_ulysses_fn("smallprime", tm)(_t(x), _t(y))
    want = np.asarray(JPAR.polymul_ulysses_fn("smallprime", jm)(x, y))
    np.testing.assert_array_equal(got.numpy(), want)
    # any single-device pipeline name: the fused kernel's twin here
    assert torch.equal(TU.polymul_ulysses_fn("smallprime", tm, "fused")(
        _t(x), _t(y)), got)


@pytest.mark.parametrize("k", KS)
def test_fixed_ulysses_vs_jax(k):
    jm, tm = _meshes(k)
    x, a = _data("smallprime", 8, 10 + k)
    prep, mul = TU.polymul_fixed_ulysses_fn("smallprime", tm)
    jprep, jmul = JPAR.polymul_fixed_ulysses_fn("smallprime", jm)
    A = prep(_t(a[1]))
    np.testing.assert_array_equal(A.numpy(), np.asarray(jprep(a[1])))
    np.testing.assert_array_equal(mul(_t(x), A).numpy(),
                                  np.asarray(jmul(x, jprep(a[1]))))
    for local in ("fused", "mxu"):
        fprep, fmul = TU.polymul_fixed_ulysses_fn("smallprime", tm, local)
        assert torch.equal(fmul(_t(x), fprep(_t(a[1]))), mul(_t(x), A))


def test_ragged_batch_is_padded():
    jm, tm = _meshes(4)
    x, y = _data("smallprime", 5, 20)
    got = TU.polymul_ulysses_fn("smallprime", tm)(_t(x), _t(y))
    assert tuple(got.shape) == (5, 32)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JPAR.polymul_ulysses_fn("smallprime", jm)(
            x, y)))
    prep, mul = TU.polymul_fixed_ulysses_fn("smallprime", tm)
    jprep, jmul = JPAR.polymul_fixed_ulysses_fn("smallprime", jm)
    np.testing.assert_array_equal(mul(_t(x), prep(_t(y[0]))).numpy(),
                                  np.asarray(jmul(x, jprep(y[0]))))
    assert torch.equal(got, TP.polymul_negacyclic(_t(x), _t(y), "smallprime"))


@pytest.mark.parametrize("k", [2, 4])
def test_exchanges_equal_all_to_all(k):
    """``_a2a_to_rows`` / ``_a2a_to_positions`` and the four-step's
    ``_a2a_fwd`` / ``_a2a_inv`` against ``lax.all_to_all`` on the mesh."""
    jm = JPAR.make_mesh(data=1, model=k)
    rng = np.random.default_rng(30 + k)
    pos = rng.integers(0, 1 << 31, (k, 2 * k, 6), dtype=np.uint32)

    def a2a(split, concat, spec):
        return jax.jit(jax.shard_map(
            lambda v: lax.all_to_all(v, "model", split_axis=split,
                                     concat_axis=concat, tiled=True),
            mesh=jm, in_specs=spec, out_specs=spec))

    # shard d of the model axis is block d of the leading axis
    rows = np.asarray(a2a(1, 2, JP_("model"))(pos.reshape(k, 2 * k, 6)))
    got = TU._a2a_to_rows(_t(pos))
    np.testing.assert_array_equal(got.numpy(), rows.reshape(k, 2, 6 * k))
    assert torch.equal(TU._a2a_to_positions(got), _t(pos))
    coef = rng.integers(0, 1 << 31, (k, 3, 2 * k, 4), dtype=np.uint32)
    spec = np.asarray(a2a(2, 3, JP_("model"))(coef))
    got = TSH._a2a_fwd(_t(coef))
    np.testing.assert_array_equal(got.numpy(), spec.reshape(k, 3, 2, 4 * k))
    assert torch.equal(TSH._a2a_inv(got), _t(coef))


def test_dispatcher_choice():
    cpu = functools.partial(make_mesh, device="cpu")
    assert TU.sp_strategy(cpu(model=1), 1) == "dp"
    assert TU.sp_strategy(cpu(model=4)) == "ulysses"
    assert TU.sp_strategy(cpu(model=4), 4) == "ulysses"
    assert TU.sp_strategy(cpu(model=4), 3) == "fourstep"
    jm, tm = _meshes(4)
    x, y = _data("smallprime", 8, 40)
    want = TP.polymul_negacyclic(_t(x), _t(y), "smallprime")
    for hint, rows in ((8, 8), (None, 8), (2, 2)):
        got = TU.polymul_sp_fn("smallprime", tm, batch_hint=hint)(
            _t(x[:rows]), _t(y[:rows]))
        assert torch.equal(got, want[:rows]), hint
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            JPAR.polymul_sp_fn("smallprime", jm, batch_hint=hint)(
                x[:rows], y[:rows])))
    assert torch.equal(TU.polymul_sp_fn("smallprime", cpu(model=1))(
        _t(x), _t(y)), want)


def test_dp_forms_vs_jax():
    jm = JPAR.make_mesh(data=8, model=1)
    tm = make_mesh(device="cpu")
    x, y = _data("smallprime", 8, 50)
    got = TSH.polymul_dp_fn("smallprime", tm)(_t(x), _t(y))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JPAR.polymul_dp_fn("smallprime", jm)(x, y)))
    for algo in ("fused", "mxu"):
        assert torch.equal(TSH.polymul_dp_fn("smallprime", tm, algo)(
            _t(x), _t(y)), got)
    # a ragged batch against JAX's on the batch padded to 8 rows
    got5 = TSH.polymul_dp_fn("smallprime", tm)(_t(x[:5]), _t(y[:5]))
    assert torch.equal(got5, got[:5])
    prep, mul = TSH.polymul_fixed_dp_fn("smallprime", tm, "merged")
    jprep, jmul = JPAR.polymul_fixed_dp_fn("smallprime", jm, "merged")
    A = prep(_t(y[:1]))
    np.testing.assert_array_equal(A.numpy(), np.asarray(jprep(y[:1])))
    want = np.asarray(jmul(x, jprep(y[:1])[0]))
    np.testing.assert_array_equal(mul(_t(x[:5]), A[0]).numpy(), want[:5])
    for algo in ("mxu", "fused"):
        prep, mul = TSH.polymul_fixed_dp_fn("smallprime", tm, algo)
        np.testing.assert_array_equal(mul(_t(x), prep(_t(y[:1]))).numpy(),
                                      want, err_msg=algo)


def _fourstep_cases():
    return [("smallprime", 2), ("smallprime", 4), (TOY[0], 8),
            pytest.param("qtesla-i", 8, marks=pytest.mark.slow)]


@pytest.mark.parametrize("name,k", _fourstep_cases())
def test_plain_fourstep_vs_jax(name, k):
    jm, tm = _meshes(k)
    x, y = _data(name, 8, 60 + k)
    spec = TSH.ntt_fourstep_sharded_fn(name, tm)(_t(x))
    n1, n2 = TSH._build(name, tm, None).dims
    assert tuple(spec.shape) == (8, n1, n2)
    np.testing.assert_array_equal(
        spec.numpy(), np.asarray(JPAR.ntt_fourstep_sharded_fn(name, jm)(x)))
    assert torch.equal(TSH.intt_fourstep_sharded_fn(name, tm)(spec), _t(x))
    got = TSH.polymul_fourstep_sharded_fn(name, tm, local="jnp")(_t(x),
                                                                  _t(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        JPAR.polymul_fourstep_sharded_fn(name, jm, local="jnp")(x, y)))
    assert torch.equal(got, TP.polymul_negacyclic(_t(x), _t(y), name))


def test_plain_fourstep_unweighted_and_ragged():
    jm, tm = _meshes(2)
    x, y = _data("smallprime", 8, 70)
    np.testing.assert_array_equal(
        TSH.ntt_fourstep_sharded_fn("smallprime", tm, with_weighting=False)(
            _t(x)).numpy(),
        np.asarray(JPAR.ntt_fourstep_sharded_fn(
            "smallprime", jm, with_weighting=False)(x)))
    fn = TSH.polymul_fourstep_sharded_fn("smallprime", tm, local="jnp")
    assert torch.equal(fn(_t(x[:3]), _t(y[:3])), fn(_t(x), _t(y))[:3])
    with pytest.raises(ValueError, match="divide"):
        TSH.polymul_fourstep_sharded_fn("smallprime", make_mesh(
            model=8, device="cpu"), local="jnp")


def test_operands_on_another_device_raise():
    tm = make_mesh(model=4, device="cpu")
    meta = torch.zeros((4, 32), dtype=torch.uint32, device="meta")
    cpu = torch.zeros((4, 32), dtype=torch.uint32)
    for fn in (TU.polymul_ulysses_fn("smallprime", tm),
               TSH.polymul_dp_fn("smallprime", tm),
               TSH.polymul_fourstep_sharded_fn("smallprime", tm,
                                               local="jnp")):
        with pytest.raises(ValueError, match="mesh on"):
            fn(meta, meta)
        with pytest.raises(ValueError, match="mesh on"):
            fn(cpu, meta)
    with pytest.raises(ValueError, match="mesh on"):
        TU.polymul_fixed_ulysses_fn("smallprime", tm)[1](meta, cpu[0])
    with pytest.raises(ValueError, match="mesh on"):
        TSH.ntt_fourstep_sharded_fn("smallprime", tm)(meta)
    with pytest.raises(ValueError, match="mesh on"):
        TSH.polymul_fixed_dp_fn("smallprime", tm)[0](meta[:1])
    on_card = make_mesh(model=2)
    with pytest.raises(ValueError, match="mesh on"):
        TU.polymul_ulysses_fn("smallprime", on_card)(cpu, cpu)


@pytest.mark.slow
@pytest.mark.parametrize("k", [2, 8])
def test_qtesla_i_forms_vs_jax(k):
    """Slow: the Ulysses pair and the dispatcher at qtesla-i (n = 512)."""
    jm, tm = _meshes(k)
    x, y = _data("qtesla-i", 8, 80 + k)
    np.testing.assert_array_equal(
        TU.polymul_ulysses_fn("qtesla-i", tm)(_t(x), _t(y)).numpy(),
        np.asarray(JPAR.polymul_ulysses_fn("qtesla-i", jm)(x, y)))
    prep, mul = TU.polymul_fixed_ulysses_fn("qtesla-i", tm)
    jprep, jmul = JPAR.polymul_fixed_ulysses_fn("qtesla-i", jm)
    np.testing.assert_array_equal(mul(_t(x), prep(_t(y[0]))).numpy(),
                                  np.asarray(jmul(x, jprep(y[0]))))
    got = TU.polymul_sp_fn("qtesla-i", tm, batch_hint=1)(_t(x[:1]),
                                                         _t(y[:1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(JPAR.polymul_sp_fn(
        "qtesla-i", jm, batch_hint=1)(x[:1], y[:1])))
