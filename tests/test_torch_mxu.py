"""The port's MXU path (``ops/mxu_tables.py``, ``ops/ntt_mxu.py``) against
the JAX package.

- tables: ``get_mxu_tables`` (planned from the port's registry) and
  ``from_jax_mxu_tables`` equal JAX ``get_mxu_tables`` field by field;
- the block recombination identity: the twin's digit product plus
  ``const + group_bias`` equals the stage matrix product mod q;
- the plain twins of B5-B8 (what the wrappers run on CPU tensors) equal the
  JAX Pallas kernels run in interpret mode, at smallprime and at a
  registered (512, 12289) set (Lr = 2, D = 2), and the JAX merged pipeline
  on every set with random, all-(q-1) and the JAX tests' adversarial
  operands;
- ``models``: ``algo="mxu"`` and the default fixed-operand pair;
- B5's table stream (``stream_tables``): expanded back it is the dense
  forward and inverse tables on every set, and each stage holds the bytes
  the kernel's MMA warps read where they read them.

Tolerance: none (integer equality).  Inputs are made with numpy from a seed
and fed to both sides."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qtesla_tpu import params as JPARAMS
from qtesla_tpu.models import polymul as JP
from qtesla_tpu.ops import ntt as JN
from qtesla_tpu.ops import ntt_mxu as JM
from qtesla_tpu.ops import tables as JT
from qtesla_tpu.params import get_params
from qtesla_tpu_torch import params as TPARAMS
from qtesla_tpu_torch.models import polymul as TP
from qtesla_tpu_torch.ops import mxu_tables as MT
from qtesla_tpu_torch.ops import ntt_mxu as TM

SETS = ["smallprime", "qtesla-i", "qtesla-iii-speed", "qtesla-p-i",
        "qtesla-p-iii"]
SMALL = ("mxu-test-512", 512, 12289)
KINDS = ("polymul", "polymul_fixed", "ntt", "intt")


@pytest.fixture
def small_set():
    """Registers the (512, 12289) set in both packages' registries for one
    test and removes it again."""
    name, n, q = SMALL
    for reg in (JPARAMS, TPARAMS):
        reg.register_param_set(name, n, q)
    yield name
    for reg in (JPARAMS, TPARAMS):
        del reg.PARAM_SETS[name]
        reg.get_params.cache_clear()


def _assert_tables_equal(got, want):
    for f in MT._FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, (f, g, w)


@pytest.mark.parametrize("name", [
    "smallprime", "qtesla-i", "qtesla-iii-speed",
    pytest.param("qtesla-p-i", marks=pytest.mark.slow),
    pytest.param("qtesla-p-iii", marks=pytest.mark.slow)])
def test_mxu_tables_match_jax(name):
    jmt = JM.get_mxu_tables(name)
    mine = MT.get_mxu_tables(name)
    via_jax = MT.from_jax_mxu_tables(jmt)
    for t in (mine, via_jax):
        _assert_tables_equal(t, jmt)
        assert (t.group_bias_f, t.group_bias_i) == (mine.group_bias_f,
                                                   mine.group_bias_i)
    q = mine.q
    assert mine.group_bias_f == sum(
        JM._group_bound(jmt.bounds_f, j0, ln) * pow(2, 8 * j0, q)
        for j0, ln in jmt.groups_f) % q
    assert MT.pointwise_bound(q) == JM.pointwise_bound(q)
    for groups, bounds in ((jmt.groups_f, jmt.bounds_f),
                           (jmt.groups_i, jmt.bounds_i)):
        assert MT._recombine_bound(groups, bounds, q) == \
            JM._recombine_bound(groups, bounds, q)


def test_mxu_tables_of_registered_set(small_set):
    _assert_tables_equal(MT.get_mxu_tables(small_set),
                         JM.get_mxu_tables(small_set))
    mt = MT.get_mxu_tables(small_set)
    assert (mt.Lr, mt.D, mt.Di) == (2, 2, 2)


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("name", ["smallprime", "qtesla-i"])
def test_block_recombination_is_the_stage_matrix(name, direction):
    """const + group_bias + sum_j c_j 2^{8j} == v @ M_b^T (mod q) at 0, at
    the split's bound - 1 and at random inputs below it."""
    mt = MT.get_mxu_tables(name)
    q, n, bw = mt.q, mt.n, mt.bw
    if direction == "forward":
        M = MT._fwd_matrix(mt.tbl, mt.Lr)
        bound, args = mt.fwd_bound, ("wf", "constf", mt.group_bias_f,
                                     mt.fwd_off, mt.Df, mt.fwd_base)
    else:
        M = MT._inv_matrix(mt.tbl, mt.logn - mt.Lr)
        bound, args = mt.pw_bound, ("wi", "consti", mt.group_bias_i,
                                    mt.inv_off, mt.Di, mt.inv_base)
    rng = np.random.default_rng(7)
    v = rng.integers(0, bound, (4, n), dtype=np.int64)
    v[0], v[1] = 0, bound - 1
    tabs = TM.host_tables(mt)
    got = TM._block_matmul(torch.from_numpy(v), getattr(tabs, args[0]),
                           getattr(tabs, args[1]), *args[2:], mt).numpy()
    want = (v.astype(object) @ M.T.astype(object)) % q
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert bw == min(128, n)


def _operands(name, batch, kind, seed=31):
    ps = get_params(name)
    q, n = ps.q, ps.n
    rng = np.random.default_rng(seed)
    if kind == "random":
        x = rng.integers(0, q, (2, batch, n), dtype=np.uint32)
    elif kind == "worst":
        x = np.full((2, batch, n), q - 1, dtype=np.uint32)
    else:                   # tests/test_mxu.py's adversarial operands
        x = np.full((2, batch, n), q - 1, dtype=np.uint32)
        x[0, 1 % batch, ::2] = 0
        x[1, 2 % batch, 1::2] = 0
        x[0, -1] = np.arange(n, dtype=np.uint32) % q
    return x[0], x[1]


def _lazy(name, batch, worst, seed=32):
    """Inverse-transform inputs below the MXU plan's pw_bound."""
    bound = MT.get_mxu_tables(name).pw_bound
    if worst:
        return np.full((batch, get_params(name).n), bound - 1,
                       dtype=np.uint32)
    rng = np.random.default_rng(seed)
    return rng.integers(0, bound, (batch, get_params(name).n),
                        dtype=np.uint32)


def _both(kind, name, x, y, lazy):
    """(port twin, JAX interpret-mode kernel) outputs as numpy uint32."""
    t = torch.from_numpy
    if kind == "polymul":
        mine = TM.polymul_mxu_fn(name)(t(x), t(y))
        ref = JM.polymul_mxu_fn(name, interpret=True)(x, y)
    elif kind == "polymul_fixed":
        spec = np.array(JM.ntt_mxu_fn(name, interpret=True)(y[:1]))
        mine = TM.polymul_fixed_mxu_fn(name)(t(x), t(spec))
        ref = JM.polymul_fixed_mxu_fn(name, interpret=True)(x, spec)
    elif kind == "ntt":
        mine = TM.ntt_mxu_fn(name)(t(x))
        ref = JM.ntt_mxu_fn(name, interpret=True)(x)
    else:
        mine = TM.intt_mxu_fn(name)(t(lazy))
        ref = JM.intt_mxu_fn(name, interpret=True)(lazy)
    assert mine.dtype == torch.uint32
    return mine.numpy(), np.asarray(ref)


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_twins_match_pallas_interpret(kind, batch, worst):
    name = "smallprime"
    x, y = _operands(name, batch, "worst" if worst else "random")
    mine, ref = _both(kind, name, x, y, _lazy(name, batch, worst))
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.parametrize("kind", KINDS)
def test_twins_match_pallas_interpret_registered_set(small_set, kind):
    x, y = _operands(small_set, 3, "random")
    x[0] = get_params(small_set).q - 1
    lazy = _lazy(small_set, 3, False)
    lazy[0] = MT.get_mxu_tables(small_set).pw_bound - 1
    mine, ref = _both(kind, small_set, x, y, lazy)
    np.testing.assert_array_equal(mine, ref)


@pytest.mark.slow
@pytest.mark.parametrize("kind", KINDS)
def test_twins_match_pallas_interpret_real_set(kind):
    name = "qtesla-iii-speed"
    x, y = _operands(name, 3, "random")
    mine, ref = _both(kind, name, x, y, _lazy(name, 3, False))
    np.testing.assert_array_equal(mine, ref)


_MERGED_KINDS = ("random", "worst", "adversarial")


@functools.lru_cache(maxsize=None)
def _merged_refs(name):
    """JAX merged products and spectra of every kind's 3-row operands,
    stacked so that one compiled call serves a parameter set."""
    ps = get_params(name)
    tbl = JT.get_tables(name)
    xy = [_operands(name, 3, kind) for kind in _MERGED_KINDS]
    x = np.concatenate([a for a, _ in xy])
    y = np.concatenate([b for _, b in xy])
    yb = np.concatenate([np.broadcast_to(b[:1], b.shape) for _, b in xy])
    pm = JP.polymul_fn(name, "merged")
    fwd = jax.jit(functools.partial(JN.ntt_fwd_merged, tbl=tbl))
    z, zf, X = (np.asarray(v).reshape(len(_MERGED_KINDS), 3, ps.n)
                for v in (pm(x, y), pm(x, yb), fwd(jnp.asarray(x))))
    return {kind: (z[i], zf[i], X[i]) for i, kind in enumerate(_MERGED_KINDS)}


@pytest.mark.parametrize("kind", _MERGED_KINDS)
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("name", SETS)
def test_twins_match_jax_merged(name, batch, kind):
    x, y = _operands(name, 3, kind)
    z, zf, X = (v[:batch] for v in _merged_refs(name)[kind])
    x, y = x[:batch], y[:batch]
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_array_equal(TM.polymul_mxu_fn(name)(xt, yt).numpy(), z)
    Xt = TM.ntt_mxu_fn(name)(xt)
    np.testing.assert_array_equal(Xt.numpy(), X)
    np.testing.assert_array_equal(TM.intt_mxu_fn(name)(Xt).numpy(), x)
    spec = TM.ntt_mxu_fn(name)(yt[:1])
    np.testing.assert_array_equal(
        TM.polymul_fixed_mxu_fn(name)(xt, spec).numpy(), zf)


@pytest.mark.parametrize("name", ["smallprime", "qtesla-iii-speed"])
def test_models_mxu_match_jax(name):
    """polymul_negacyclic / NegacyclicPolymul / ntt / intt with algo="mxu",
    and the default fixed-operand pair (B6 prepare, B8 multiply), against
    the JAX package: its merged pipeline and, at smallprime, its own
    default pair's kernels in interpret mode."""
    ps = get_params(name)
    x, y = _operands(name, 4, "random", seed=33)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    want = np.asarray(JP.polymul_negacyclic(jnp.asarray(x), jnp.asarray(y),
                                            ps))
    np.testing.assert_array_equal(
        TP.polymul_negacyclic(xt, yt, ps, algo="mxu").numpy(), want)
    np.testing.assert_array_equal(
        TP.NegacyclicPolymul(name)(xt, yt, algo="mxu").numpy(), want)
    X = TP.ntt(xt, ps, "mxu")
    np.testing.assert_array_equal(X.numpy(), TP.ntt(xt, ps).numpy())
    np.testing.assert_array_equal(TP.intt(X, ps, "mxu").numpy(), x)

    prep, mul = TP.polymul_fixed_fn(name)
    assert prep.func is TM.ntt_mxu and mul.func is TM.polymul_fixed_mxu
    A = prep(yt[:1])
    z = mul(xt, A)
    jprep, jmul = JP.polymul_fixed_fn(name, "merged")
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(jmul(jnp.asarray(x), jprep(jnp.asarray(y[:1])))))
    if name == "smallprime":
        jA = np.asarray(JM.ntt_mxu_fn(name, interpret=True)(y[:1]))
        np.testing.assert_array_equal(A.numpy(), jA)
        np.testing.assert_array_equal(
            z.numpy(),
            np.asarray(JM.polymul_fixed_mxu_fn(name, interpret=True)(x, jA)))


def test_leading_axes_and_tables_on_module():
    """Leading batch axes pass through, and NegacyclicPolymul holds the
    kernel-layout tables as buffers."""
    name = "smallprime"
    ps = get_params(name)
    x, y = _operands(name, 6, "random", seed=34)
    xt = torch.from_numpy(x).reshape(2, 3, ps.n)
    yt = torch.from_numpy(y).reshape(2, 3, ps.n)
    z = TM.polymul_mxu_fn(name)(xt, yt)
    assert tuple(z.shape) == (2, 3, ps.n)
    np.testing.assert_array_equal(
        z.reshape(6, ps.n).numpy(),
        TM.polymul_mxu_fn(name)(torch.from_numpy(x),
                                torch.from_numpy(y)).numpy())
    mod = TP.NegacyclicPolymul(name)
    bufs = dict(mod.named_buffers())
    mt = MT.get_mxu_tables(name)
    host = TM.host_tables(mt)
    for field, t in zip(("wf", "constf", "wi", "consti"), host.tensors()):
        assert torch.equal(bufs["mxu_" + field], t)
    # wf is MxuTables.wf with the output axis first
    np.testing.assert_array_equal(
        host.wf.numpy(),
        mt.wf.transpose(0, 3, 1, 2).reshape(mt.nb, mt.D * mt.bw, -1))


# ----------------------------------------------------------------------
# B5's table stream.
# ----------------------------------------------------------------------

def _check_stream(mt):
    st = MT.stream_tables(mt)
    Cf, Ci = (MT.stream_stages(d, mt.bw) for d in (mt.Df, mt.Di))
    assert st.dtype == np.int8
    assert st.shape == (mt.nb * (Cf + Ci), MT.STAGE_DEPTH * mt.bw * mt.D)
    wf, wi = MT.expand_stream(st, mt)
    np.testing.assert_array_equal(wf, mt.wf)
    np.testing.assert_array_equal(wi, mt.wi)
    host = TM.host_tables(mt)
    np.testing.assert_array_equal(host.stream.numpy(), st)
    # stage (b, c) as the kernel reads it: lane 4g + t of warp lt takes 16
    # bytes for class j at ((lt * D + j) * 32 + lane) * 16, bytes 8t .. 8t+7
    # of the two 32-deep steps of table row j*bw + 8lt + g
    for part, w, C, first in ((0, host.wf, Cf, 0), (1, host.wi, Ci,
                                                   mt.nb * Cf)):
        K = w.shape[-1]
        T = np.zeros((mt.nb, mt.D * mt.bw, C * MT.STAGE_DEPTH), np.int8)
        T[..., :K] = w.numpy()
        for b, c in ((0, 0), (mt.nb - 1, C - 1)):
            stage = st[first + b * C + c]
            for lt, j, g, t, step in ((0, 0, 0, 0, 0), (mt.bw // 8 - 1,
                                                        mt.D - 1, 7, 3, 1),
                                      (1, mt.D // 2, 5, 2, 1)):
                lane = 4 * g + t
                at = ((lt * mt.D + j) * 32 + lane) * 16 + 8 * step
                col = c * MT.STAGE_DEPTH + 32 * step + 8 * t
                np.testing.assert_array_equal(
                    stage[at:at + 8], T[b, j * mt.bw + 8 * lt + g,
                                        col:col + 8], err_msg=(part, b, c))
    return st


@pytest.mark.parametrize("name", SETS)
def test_stream_tables_expand_to_dense(name):
    """Expanded back, B5's stream equals ``wf`` and ``wi`` on every set;
    the host tables carry it; the stages lie where the MMA warps read."""
    _check_stream(MT.get_mxu_tables(name))


def test_stream_tables_of_registered_set(small_set):
    """Two digit classes (q = 12289): the stream and B5's plan hold."""
    mt = MT.get_mxu_tables(small_set)
    assert mt.D == 2
    _check_stream(mt)
    plan = TM.stream_plan(mt)
    assert (plan.d, plan.stages_f, plan.stages_i) == (
        2, MT.stream_stages(mt.Df, mt.bw), MT.stream_stages(mt.Di, mt.bw))


def test_expand_stream_refuses_nonzero_padding():
    """smallprime pads 96 table columns (3 planes of 32 lanes) to two
    64-deep stages: a nonzero byte there is refused."""
    mt = MT.get_mxu_tables("smallprime")
    assert (mt.bw, mt.Df) == (32, 3)
    st = MT.stream_tables(mt)
    lt_j_lane, step = 5, 1          # the second step of a lane: columns 96..
    st[MT.stream_stages(mt.Df, mt.bw) - 1, lt_j_lane * 16 + 8 * step] = 1
    with pytest.raises(ValueError, match="padding"):
        MT.expand_stream(st, mt)
