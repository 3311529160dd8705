"""The port's folded fixed-operand path (B9) against the JAX package.

- plan: ``fixed_fold_plan`` (and ``from_jax_fold_plan``) equals JAX's
  ``fixed_fold_plan`` field by field on all 5 sets;
- tables: ``fixed_fold_tables``, built from the diagonal blocks only, equals
  JAX's for a random spectrum and the all-0 and all-(q-1) diagonals, and
  ``from_jax_fold_tables`` carries JAX's arrays across unchanged;
- the B9 twin (what the wrapper runs on CPU tensors) equals JAX's
  ``polymul_fixed_folded_mxu_fn`` kernel in interpret mode at smallprime,
  and JAX's merged product with the broadcast constant at qtesla-iii-speed;
- ``models.polymul_fixed_fn(name, "mxu-folded")`` on CPU tensors.

Tolerance: none (integer equality).  Inputs are made with numpy from a seed
and fed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtesla_tpu.models import polymul as JP
from qtesla_tpu.ops import ntt as JN
from qtesla_tpu.ops import ntt_mxu as JM
from qtesla_tpu.ops import tables as JT
from qtesla_tpu.params import get_params
from qtesla_tpu_torch.models import polymul as TP
from qtesla_tpu_torch.ops import mxu_tables as MT
from qtesla_tpu_torch.ops import ntt_mxu as TM

DIAGONALS = ("random", "zero", "q-1")
SETS = ("smallprime", "qtesla-i", "qtesla-iii-speed", "qtesla-p-i",
        "qtesla-p-iii")


def _spectrum(name, kind, seed=41):
    ps = get_params(name)
    if kind == "zero":
        return np.zeros(ps.n, dtype=np.uint32)
    if kind == "q-1":
        return np.full(ps.n, ps.q - 1, dtype=np.uint32)
    rng = np.random.default_rng(seed)
    return rng.integers(0, ps.q, ps.n, dtype=np.uint32)


@pytest.mark.parametrize("name", ["smallprime", "qtesla-i",
                                  "qtesla-iii-speed", "qtesla-p-i",
                                  "qtesla-p-iii"])
def test_fold_plan_matches_jax(name):
    jfp = JM.fixed_fold_plan(name)
    mine = MT.fixed_fold_plan(name)
    assert MT.from_jax_fold_plan(jfp) == mine
    for f in MT.FixedFoldPlan.__dataclass_fields__:
        assert getattr(mine, f) == getattr(jfp, f), f
    # the kernel's range: 4 classes, 6 planes, class sums below 2^24
    assert mine.Dout == MT.get_mxu_tables(name).D <= 4
    assert mine.Din <= 6 and max(mine.bounds) < 1 << 24


def test_inv_blocks_are_the_matrix_diagonal():
    mt = MT.get_mxu_tables("qtesla-i")
    s_hi, bw = mt.logn - mt.Lr, mt.bw
    full = MT._inv_matrix(mt.tbl, s_hi)
    blocks = MT._inv_blocks(mt.tbl, s_hi, bw)
    assert blocks.shape == (mt.nb, bw, bw) and blocks.dtype == np.int64
    for b in range(mt.nb):
        np.testing.assert_array_equal(
            blocks[b], full[b * bw:(b + 1) * bw, b * bw:(b + 1) * bw])
    with pytest.raises(ValueError, match="not local"):
        MT._inv_blocks(mt.tbl, s_hi + 1, bw)


@pytest.mark.parametrize("kind", DIAGONALS)
@pytest.mark.parametrize("name", ["smallprime", "qtesla-iii-speed"])
def test_fold_tables_match_jax(name, kind):
    spec = _spectrum(name, kind)
    W, c = MT.fixed_fold_tables(name, spec)
    jW, jc = JM.fixed_fold_tables(name, spec)
    jW, jc = MT.from_jax_fold_tables(jW, jc)
    assert W.dtype == np.int8 and c.dtype == np.uint32
    np.testing.assert_array_equal(W, jW)
    np.testing.assert_array_equal(c, jc)


def test_fold_tables_reject_bad_input():
    with pytest.raises(ValueError, match="spectrum must be"):
        MT.fixed_fold_tables("smallprime", np.zeros(16, dtype=np.uint32))
    W, c = MT.fixed_fold_tables("smallprime", _spectrum("smallprime", "zero"))
    with pytest.raises(ValueError, match="int8"):
        MT.from_jax_fold_tables(W.astype(np.int32), c)
    with pytest.raises(ValueError, match="int8"):
        MT.from_jax_fold_tables(W, c[:, :, :4])
    rW, rc = MT.from_jax_fold_tables(W, c)
    assert rW is not W and np.array_equal(rW, W) and np.array_equal(rc, c)


def test_fold_operand_is_the_kernel_layout():
    """The operand is W' as the stream kernel's stages (what B9's producer
    copies) and the const rows; ``staged_tables`` reads the stages back as
    the output-major tables, zero past the planes."""
    mt = MT.get_mxu_tables("qtesla-i")
    spec = _spectrum("qtesla-i", "random")
    op = TM.fold_operand(torch.from_numpy(spec), mt)
    W, c = MT.fixed_fold_tables("qtesla-i", spec)
    nb, din, bw, dbw = W.shape
    np.testing.assert_array_equal(op.stages.numpy(), MT._stages(W))
    assert tuple(op.stages.shape) == (nb * MT.stream_stages(din, bw),
                                      MT.STAGE_DEPTH * dbw)
    T = TM.staged_tables(op.stages, nb, bw, dbw // bw).numpy()
    np.testing.assert_array_equal(
        T[..., :din * bw], W.transpose(0, 3, 1, 2).reshape(nb, dbw, din * bw))
    assert not T[..., din * bw:].any()
    np.testing.assert_array_equal(op.c.numpy(), c[:, 0])
    assert op.stages.is_contiguous() and op.c.dtype == torch.uint32


@pytest.mark.parametrize("name", SETS)
def test_fold_operand_stages_round_trip(name):
    """On every set B9's staged operand unstages to ``fold_tables``' W'
    exactly, with zero depth padding, and its forward half is the front of
    B5's stream: nothing of the forward tables is copied per constant."""
    mt = MT.get_mxu_tables(name)
    fp = MT.fold_plan(mt)
    spec = _spectrum(name, "random")
    W, c = MT.fold_tables(mt, fp, spec)
    op = TM.fold_operand(torch.from_numpy(spec), mt)
    st = op.stages.numpy()
    np.testing.assert_array_equal(
        MT._unstages(st, mt.nb, fp.Din, mt.bw, fp.Dout), W)
    assert np.count_nonzero(st) == np.count_nonzero(W)
    stream = MT.stream_tables(mt)
    nf = mt.nb * MT.stream_stages(mt.Df, mt.bw)
    np.testing.assert_array_equal(stream[:nf], MT._stages(mt.wf))
    assert st.shape[1] == stream.shape[1]


def _x(name, batch, worst, seed=42):
    ps = get_params(name)
    if worst:
        return np.full((batch, ps.n), ps.q - 1, dtype=np.uint32)
    rng = np.random.default_rng(seed)
    return rng.integers(0, ps.q, (batch, ps.n), dtype=np.uint32)


@pytest.mark.parametrize("kind", DIAGONALS)
@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
def test_twin_matches_pallas_interpret(worst, kind):
    name = "smallprime"
    x = _x(name, 3, worst)
    if kind == "random":
        a = _x(name, 1, False, seed=43)
        spec = np.array(JM.ntt_mxu_fn(name, interpret=True)(a))[0]
    else:
        spec = _spectrum(name, kind)
    ref = np.asarray(JM.polymul_fixed_folded_mxu_fn(name, interpret=True)(
        x, *JM.fixed_fold_tables(name, spec)))
    mt = MT.get_mxu_tables(name)
    op = TM.fold_operand(torch.from_numpy(spec), mt)
    got = TM.polymul_fixed_folded_mxu_fn(name)(torch.from_numpy(x), op)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kind", DIAGONALS)
def test_twin_matches_jax_merged_real_set(kind):
    """qtesla-iii-speed canary: x times the constant with spectrum d, against
    JAX's merged intt(ntt(x) * d)."""
    name = "qtesla-iii-speed"
    ps = get_params(name)
    x = _x(name, 3, False)
    x[0] = ps.q - 1
    spec = _spectrum(name, kind)
    tbl = JT.get_tables(name)
    want = np.asarray(jax.jit(lambda v: JN.intt_inv_merged(
        JN.pointwise_mul(JN.ntt_fwd_merged(v, tbl), jnp.asarray(spec), tbl),
        tbl))(jnp.asarray(x)))
    mt = MT.get_mxu_tables(name)
    op = TM.fold_operand(torch.from_numpy(spec), mt)
    got = TM.polymul_fixed_folded_mxu(torch.from_numpy(x), op, mt)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["smallprime", "qtesla-iii-speed"])
def test_models_mxu_folded_pair(name):
    """prepare (B6 forward, host tables) and multiply (B9) through
    ``polymul_fixed_fn``, against JAX's fixed pair and the two-operand
    product with the constant broadcast."""
    ps = get_params(name)
    x = _x(name, 4, False, seed=44)
    a = _x(name, 1, False, seed=45)
    prep, mul = TP.polymul_fixed_fn(name, "mxu-folded")
    op = prep(torch.from_numpy(a[0]))
    assert isinstance(op, TM.FoldedOperand)
    z = mul(torch.from_numpy(x), op)
    jprep, jmul = JP.polymul_fixed_fn(name, "merged")
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(jmul(jnp.asarray(x), jprep(jnp.asarray(a)))))
    np.testing.assert_array_equal(
        z.numpy(), TP.polymul_negacyclic(
            torch.from_numpy(x), torch.from_numpy(np.repeat(a, 4, axis=0)),
            ps).numpy())
    # the wrapper checks the operand against the plan
    with pytest.raises(ValueError, match="folded operand"):
        mul(torch.from_numpy(x), TM.FoldedOperand(op.stages[:, :-1], op.c))
