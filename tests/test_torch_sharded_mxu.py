"""The port's sequence-parallel (four-step) digit-matmul path
(``parallel/sharded_mxu_tables.py``, ``parallel/sharded_mxu.py``,
``parallel/sharded.py``, ``parallel/mesh.py``) against the JAX package's
``qtesla_tpu/parallel/sharded_mxu.py``.

- planner: ``fourstep_mxu_plans`` and ``from_jax_fourstep_plans`` equal
  JAX's field by field (layout, K1, K2f, K2i, k1map, the roll schedule and
  every digit plan p1, p2f, p2i, p3, p2x, p3x);
- the twins of B11, B12 and B16 (what the wrappers run on CPU tensors) equal
  the JAX Pallas segment kernels in interpret mode, with that shard's table
  slice, mod q (the JAX kernels hand lazy values on; the port's are
  canonical);
- ``a2a_fwd`` / ``a2a_inv`` equal ``lax.all_to_all`` under ``jax.shard_map``
  on the 8-device CPU mesh;
- the whole path equals JAX ``polymul_fourstep_mxu_fn`` on a (data 2,
  model 4) mesh in interpret mode, the port's merged path and the big-int
  oracle, random and all-(q-1), at B in {1, 3, 8};
- the entry points: ``polymul_fourstep_sharded_fn`` (its ``local="jnp"``
  plain-torch four-step too), ``local_pipeline_fn``, ``make_mesh``.

Tolerance: none (exact residues).  Inputs are made with numpy from a
seed."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as JP_

from qtesla_tpu.parallel import make_mesh as jmake_mesh
from qtesla_tpu.parallel import sharded_mxu as JS
from qtesla_tpu.params import get_params
from qtesla_tpu_torch import polymul_negacyclic_oracle
from qtesla_tpu_torch.models import polymul_negacyclic
from qtesla_tpu_torch.parallel import make_mesh
from qtesla_tpu_torch.parallel import sharded as TSH
from qtesla_tpu_torch.parallel import sharded_mxu as S
from qtesla_tpu_torch.parallel import sharded_mxu_tables as ST


def _n1(name):
    return 1 << (get_params(name).logn // 2)


def _eq(got, want, what):
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, (what, got, want)


def _assert_plans_equal(got, want):
    for f in ST._LAYOUT_FIELDS + ST._PLAN_FIELDS:
        _eq(getattr(got, f), getattr(want, f), f)
    for f in ST._ROLL_FIELDS:
        _eq(getattr(got.rolls, f), getattr(want.rolls, f), "rolls." + f)
    for p in ("p1", "p2f", "p2i", "p3", "p3x"):
        for f in ST.DIGIT_FIELDS:
            _eq(getattr(getattr(got, p), f), getattr(getattr(want, p), f),
                f"{p}.{f}")
    for f in ST.FOLD_FIELDS:
        _eq(getattr(got.p2x, f), getattr(want.p2x, f), "p2x." + f)


@pytest.mark.parametrize("name,k", [
    ("qtesla-iii-speed", 2), ("qtesla-iii-speed", 4), ("qtesla-iii-speed", 8),
    ("smallprime", 2), ("qtesla-p-iii", 4)])
def test_plans_match_jax(name, k):
    jplans = JS.fourstep_mxu_plans(name, _n1(name), k)
    mine = ST.fourstep_mxu_plans(name, _n1(name), k)
    _assert_plans_equal(mine, jplans)
    via = ST.from_jax_fourstep_plans(jplans)
    _assert_plans_equal(via, jplans)
    assert (via.t1.n, via.ps.q) == (mine.t1.n, mine.ps.q)
    np.testing.assert_array_equal(S.host_tables(via).w1.numpy(),
                                  S.host_tables(mine).w1.numpy())


def test_plan_shapes_and_rejections():
    p = ST.fourstep_mxu_plans("qtesla-iii-speed", 32, 4)
    assert (p.nloc, p.TW, p.A, p.Bk, p.Lr) == (256, 128, 2, 16, 1)
    assert (p.p1.din, p.p2f.din, p.p2i.din, p.p3.din) == (3, 4, 3, 4)
    assert ST.fourstep_mxu_plans("smallprime", 4, 4).TW == 8
    for n1, k, match in ((32, 64, "divide"), (4, 2, "exceeds"),
                         (24, 2, "power of two")):
        with pytest.raises(ValueError, match=match):
            ST.fourstep_mxu_plans("qtesla-iii-speed", n1, k)


def test_kernel_layout_of_tables():
    """The kernel tables are the plans' W with the output axis first,
    zero-padded to a depth that is a multiple of 32 (TW = 8 here)."""
    plans = ST.fourstep_mxu_plans("smallprime", 4, 4)
    tabs = S.host_tables(plans)
    W = plans.p1.W                          # (k, A, din, TW, D*TW)
    k, A, din, TW, DTW = W.shape
    assert tuple(tabs.w1.shape) == (k, A, DTW, 32) and din * TW == 24
    np.testing.assert_array_equal(
        tabs.w1.numpy()[..., :din * TW],
        W.transpose(0, 1, 4, 2, 3).reshape(k, A, DTW, din * TW))
    assert not tabs.w1.numpy()[..., din * TW:].any()
    np.testing.assert_array_equal(tabs.c2f.numpy(), plans.p2f.const[0])
    np.testing.assert_array_equal(tabs.tw.numpy(), plans.t1.packed)


# ----------------------------------------------------------------------
# Segments against the interpret-mode Pallas kernels.
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_segs(name, k):
    plans = JS.fourstep_mxu_plans(name, _n1(name), k)
    return plans, tuple(f(plans, 256, True) for f in (
        JS._make_seg1, JS._make_seg2, JS._make_seg3))


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("name,k", [("smallprime", 2),
                                    ("qtesla-iii-speed", 4)])
def test_segment_twins_match_pallas_interpret(name, k, worst):
    jplans, (jseg1, jseg2, jseg3) = _jax_segs(name, k)
    plans = ST.fourstep_mxu_plans(name, _n1(name), k)
    q, nloc = plans.q, plans.nloc
    rng = np.random.default_rng(51)
    x, y = rng.integers(0, q, (2, 3, nloc), dtype=np.uint32)
    if worst:
        x[:], y[:] = q - 1, q - 1
    xt, yt = torch.from_numpy(x)[None], torch.from_numpy(y)[None]
    for d in range(k):
        sl = slice(d, d + 1)
        p1, p2f, p2i, p3 = jplans.p1, jplans.p2f, jplans.p2i, jplans.p3
        pairs = [
            (S.seg1_plain(xt, plans, first=d),
             jseg1(x, p1.W[sl], p1.const[sl])),
            (S.seg2_plain(xt, yt, plans, first=d),
             jseg2(x, y, p2f.W, p2f.const, p2i.W[sl], p2i.const[sl])),
            (S.seg3_plain(xt, plans, first=d),
             jseg3(x, p3.W[sl], p3.const[sl])),
        ]
        for i, (got, want) in enumerate(pairs, 1):
            got = got[0].numpy()
            assert got.dtype == np.uint32 and int(got.max()) < q
            np.testing.assert_array_equal(got, np.asarray(want) % q,
                                          err_msg=f"seg{i} shard {d}")
        # the wrappers run the twins on CPU tensors
        assert torch.equal(S.sp_seg1(xt, plans, first=d), pairs[0][0])


# ----------------------------------------------------------------------
# Exchanges against lax.all_to_all.
# ----------------------------------------------------------------------

def test_exchanges_match_all_to_all():
    name = "qtesla-iii-speed"
    plans = ST.fourstep_mxu_plans(name, 32, 4)
    n1, n2, n, B = plans.n1, plans.n2, plans.n, 4
    mesh = jmake_mesh(data=2, model=4)
    coeff, spect = JP_("data", None, "model"), JP_("data", "model", None)
    fwd = jax.jit(jax.shard_map(
        lambda v: lax.all_to_all(v, "model", split_axis=1, concat_axis=2,
                                 tiled=True),
        mesh=mesh, in_specs=coeff, out_specs=spect))
    inv = jax.jit(jax.shard_map(
        lambda v: lax.all_to_all(v, "model", split_axis=2, concat_axis=1,
                                 tiled=True),
        mesh=mesh, in_specs=spect, out_specs=coeff))
    rng = np.random.default_rng(52)
    x = rng.integers(0, 1 << 32, (B, n), dtype=np.uint32)
    got = S.a2a_fwd(S.to_shards(torch.from_numpy(x), plans), plans)
    got = got.reshape(4, B, plans.n1k, n2).permute(1, 0, 2, 3).reshape(
        B, n1, n2)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(fwd(x.reshape(B, n1, n2))))
    spec = rng.integers(0, 1 << 32, (B, n1, n2), dtype=np.uint32)
    stacked = torch.from_numpy(spec).reshape(B, 4, plans.n1k, n2).permute(
        1, 0, 2, 3).reshape(4, B, plans.nloc).contiguous()
    got = S.from_shards(S.a2a_inv(stacked, plans), plans)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(inv(spec)).reshape(B, n))
    xt = torch.from_numpy(x)
    assert torch.equal(S.from_shards(S.to_shards(xt, plans), plans), xt)
    v = S.to_shards(xt, plans)
    assert torch.equal(S.a2a_inv(S.a2a_fwd(v, plans), plans), v)


# ----------------------------------------------------------------------
# The whole path.
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_path(name, kind, n1=None, data=2, model=4):
    """JAX's SP polymul of 8 numpy-seeded rows on the CPU mesh, interpret
    mode: (x, y, z)."""
    ps = get_params(name)
    rng = np.random.default_rng(53)
    x, y = rng.integers(0, ps.q, (2, 8, ps.n), dtype=np.uint32)
    if kind == "worst":
        x[:], y[:] = ps.q - 1, ps.q - 1
    fn = JS.polymul_fourstep_mxu_fn(name, jmake_mesh(data=data, model=model),
                                    n1, interpret=True)
    return x, y, np.asarray(fn(x, y))


@pytest.mark.parametrize("kind", ["random", "worst"])
@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("name", ["smallprime", "qtesla-iii-speed"])
def test_path_matches_jax_mesh(name, batch, kind):
    if name == "smallprime":
        x, y, z = _jax_path(name, kind, data=4, model=2)
        k = 2
    else:
        x, y, z = _jax_path(name, kind)
        k = 4
    x, y, z = x[:batch], y[:batch], z[:batch]
    ps = get_params(name)
    fn = S.polymul_fourstep_mxu_fn(name, make_mesh(model=k, device="cpu"))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = fn(xt, yt)
    assert got.dtype == torch.uint32 and tuple(got.shape) == (batch, ps.n)
    np.testing.assert_array_equal(got.numpy(), z)
    np.testing.assert_array_equal(got.numpy(),
                                  polymul_negacyclic(xt, yt, name).numpy())
    plans = ST.fourstep_mxu_plans(name, _n1(name), k)
    assert torch.equal(S.polymul_fourstep_mxu_plain(xt, yt, plans), got)
    if batch == 3:
        for r in (0, 2):
            np.testing.assert_array_equal(
                got[r].numpy(),
                polymul_negacyclic_oracle(x[r], y[r], ps).astype(np.uint32))


def test_entry_points():
    name = "qtesla-iii-speed"
    ps = get_params(name)
    rng = np.random.default_rng(54)
    x, y = (torch.from_numpy(v) for v in rng.integers(0, ps.q, (2, 2, ps.n),
                                                       dtype=np.uint32))
    want = polymul_negacyclic(x, y, name)
    cpu4 = make_mesh(model=4, device="cpu")
    for local in ("auto", "mxu"):
        assert torch.equal(TSH.polymul_fourstep_sharded_fn(
            name, cpu4, local=local)(x, y), want)
    # a model axis of 1 is the single-transform digit-matmul polymul (B5)
    one = TSH.polymul_fourstep_sharded_fn(name, make_mesh(device="cpu"))
    assert torch.equal(one(x, y), want)
    # the plain-torch four-step (local="jnp") runs and is bit-exact
    assert torch.equal(TSH.polymul_fourstep_sharded_fn(
        name, cpu4, local="jnp")(x, y), want)
    with pytest.raises(ValueError, match="unknown local"):
        TSH.polymul_fourstep_sharded_fn(name, cpu4, local="xla")
    with pytest.raises(ValueError, match="divide"):
        TSH.polymul_fourstep_sharded_fn(name, make_mesh(model=64,
                                                        device="cpu"))
    with pytest.raises(ValueError, match="init_distributed"):
        make_mesh(data=2, model=4)
    mesh = make_mesh(model=4)
    assert (mesh.data, mesh.model) == (1, 4)
    assert mesh.device == torch.device("cuda")
    # the twiddle tables of the planner equal JAX's
    from qtesla_tpu.parallel.sharded import _fourstep_tables as jtables
    for f, want_t in jtables(name, 32).items():
        np.testing.assert_array_equal(TSH._fourstep_tables(name, 32)[f],
                                      want_t, err_msg=f)


def test_local_pipeline_is_one_shard_of_the_segments():
    name = "qtesla-iii-speed"
    pipe, plans = S.local_pipeline_fn(name, 4)
    rng = np.random.default_rng(55)
    x, y = (torch.from_numpy(v) for v in rng.integers(
        0, plans.q, (2, 3, plans.nloc), dtype=np.uint32))
    got = pipe(x, y)
    assert tuple(got.shape) == (3, plans.nloc)
    vx, vy = (S.seg1_plain(t[None], plans, first=1) for t in (x, y))
    want = S.seg3_plain(S.seg2_plain(vx, vy, plans, first=1), plans,
                        first=1)[0]
    assert torch.equal(got, want)
    # device_index past the axis takes the last shard, as in JAX
    pipe8, plans8 = S.local_pipeline_fn(name, 2, device_index=5)
    xs = x[:, :plans8.nloc // 2].repeat(1, 2).contiguous()
    vx = S.seg1_plain(xs[None], plans8, first=1)
    assert torch.equal(pipe8(xs, xs), S.seg3_plain(
        S.seg2_plain(vx, vx, plans8, first=1), plans8, first=1)[0])


@pytest.mark.slow
@pytest.mark.parametrize("name,n1,data,model", [
    ("qtesla-iii-speed", None, 1, 8), ("qtesla-p-iii", None, 2, 4),
    ("qtesla-iii-speed", 64, 2, 4)])
def test_path_matches_jax_mesh_slow_tier(name, n1, data, model):
    """k = 8, the p-III set (lazy forward plan, D = 4) and n1 = 64."""
    x, y, z = _jax_path(name, "random", n1, data, model)
    fn = S.polymul_fourstep_mxu_fn(name, make_mesh(model=model,
                                                   device="cpu"), n1)
    got = fn(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, z)
