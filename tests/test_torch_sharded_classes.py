"""The port's class-sum boundary of the sequence-parallel path
(``parallel/sharded_classes.py``, ``class_boundary_plan`` in
``parallel/sharded_mxu_tables.py``) against the JAX package's
``qtesla_tpu/parallel/sharded_mxu.py`` (l.887-1147).

- ``class_boundary_plan`` and ``from_jax_class_boundary_plan`` equal JAX's
  plan field by field, for all 5 sets (the p-sets' four classes included:
  the planner builds them, the kernels refuse them);
- B17's twin equals JAX's ``_make_seg1_classes`` in interpret mode bit for
  bit: at each set's own n both kernels split canonical values, so the raw
  class sums agree exactly;
- B18's twin, fed JAX's own B17 output, equals JAX's interpret-mode
  ``_make_seg2_classes`` mod q (JAX's output may be lazy);
- ``a2a_fwd_classes`` equals JAX's ``a2a_fwd_c``, ``lax.all_to_all`` under
  ``jax.shard_map`` on the CPU mesh;
- the whole path equals JAX's ``polymul_fourstep_mxu_classes_fn`` on the
  (data 2, model 4) CPU mesh in interpret mode at B in {1, 3, 8}, the
  port's SP path and the big-int oracle;
- the p-sets raise when the path is built; the wrappers raise on bad
  input; ``local_pipeline_classes_fn`` is one shard of the segments.

Tolerance: none (exact integers).  Inputs are made with numpy from a seed.
"""

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
from qtesla_tpu_torch.models import (local_pipeline_classes_fn,
                                     polymul_fourstep_mxu_classes_fn,
                                     polymul_negacyclic)
from qtesla_tpu_torch.parallel import make_mesh
from qtesla_tpu_torch.parallel import sharded_classes as C
from qtesla_tpu_torch.parallel import sharded_mxu as S
from qtesla_tpu_torch.parallel import sharded_mxu_tables as ST


def _n1(name):
    return 1 << (get_params(name).logn // 2)


def _plans(name, k):
    return (ST.fourstep_mxu_plans(name, _n1(name), k),
            ST.class_boundary_plan(name, _n1(name), k))


# ----------------------------------------------------------------------
# The plan.
# ----------------------------------------------------------------------

def _assert_class_plans_equal(got, want):
    for f in ST.CLASS_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, (f, g, w)
    assert len(got.W) == len(want.W) == want.Dout
    for g, w in zip(got.W, want.W):
        w = np.asarray(w)
        assert g.dtype == w.dtype == np.int8 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _check_class_plan(name, k):
    jcp = JS.class_boundary_plan(name, _n1(name), k)
    _assert_class_plans_equal(ST.class_boundary_plan(name, _n1(name), k), jcp)
    _assert_class_plans_equal(ST.from_jax_class_boundary_plan(jcp), jcp)


@pytest.mark.parametrize("name,k", [("smallprime", 2), ("smallprime", 4),
                                    ("qtesla-i", 8), ("qtesla-iii-speed", 4),
                                    ("qtesla-p-i", 4)])
def test_class_plan_matches_jax(name, k):
    _check_class_plan(name, k)


@pytest.mark.slow
@pytest.mark.parametrize("name,k", [("qtesla-i", 2), ("qtesla-i", 4),
                                    ("qtesla-iii-speed", 2),
                                    ("qtesla-iii-speed", 8),
                                    ("qtesla-p-i", 2), ("qtesla-p-iii", 4)])
def test_class_plan_matches_jax_slow_tier(name, k):
    """The other model axes and p-III: slow because JAX's planner takes
    5-10 s for each in object ints."""
    _check_class_plan(name, k)


def test_class_plan_layout_and_rejections():
    """The kernel tables are the class tables stacked along the plane axis
    with the output axis first (TW = 8, 8 planes: depth 64); JAX's plan
    carries across only with one int8 table per class."""
    plans, cp = _plans("smallprime", 4)
    w2c, c2c = C.host_class_tables(cp)
    W = np.concatenate(cp.W, axis=0)                 # (8, TW, D*TW)
    assert W.shape == (8, 8, 24) and tuple(w2c.shape) == (24, 64)
    np.testing.assert_array_equal(w2c.numpy(),
                                  W.transpose(2, 0, 1).reshape(24, 64))
    np.testing.assert_array_equal(c2c.numpy(), cp.const[:, :, 0])
    jcp = JS.class_boundary_plan("smallprime", 4, 4)
    bad = type("Plan", (), {f: getattr(jcp, f) for f in ST.CLASS_FIELDS})
    bad.W = [np.asarray(w).astype(np.int16) for w in jcp.W]
    with pytest.raises(ValueError, match="int8"):
        ST.from_jax_class_boundary_plan(bad)
    bad.W = [np.asarray(w) for w in jcp.W[:-1]]
    with pytest.raises(ValueError, match="int8"):
        ST.from_jax_class_boundary_plan(bad)


# ----------------------------------------------------------------------
# Segments against the interpret-mode Pallas kernels.
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_class_segs(name, k):
    plans = JS.fourstep_mxu_plans(name, _n1(name), k)
    cp = JS.class_boundary_plan(name, _n1(name), k)
    return plans, cp, (JS._make_seg1_classes(plans, cp, 256, True),
                       JS._make_seg2_classes(plans, cp, 256, True))


@pytest.mark.parametrize("worst", [False, True], ids=["random", "worst"])
@pytest.mark.parametrize("name,k", [("smallprime", 2),
                                    ("qtesla-iii-speed", 4)])
def test_class_segment_twins_match_pallas_interpret(name, k, worst):
    jplans, jcp, (jseg1c, jseg2c) = _jax_class_segs(name, k)
    plans, cp = _plans(name, k)
    assert not jplans.rolls.fwd_lazy         # canonical hand-off: bit exact
    q, nloc, D = plans.q, plans.nloc, cp.Dout
    rng = np.random.default_rng(71)
    x, y = rng.integers(0, q, (2, 3, nloc), dtype=np.uint32)
    if worst:
        x[:], y[:] = q - 1, q - 1
    xt, yt = torch.from_numpy(x)[None], torch.from_numpy(y)[None]
    for d in range(k):
        sl = slice(d, d + 1)
        ux, uy = (np.asarray(jseg1c(v, jplans.p1.W[sl])) for v in (x, y))
        got = C.seg1_classes_plain(xt, plans, cp, first=d)
        assert got.dtype == torch.uint32 and got.shape == (1, 3, D * nloc)
        np.testing.assert_array_equal(got[0].numpy(), ux,
                                      err_msg=f"B17 shard {d}")
        assert torch.equal(C.sp_seg1_classes(xt, plans, cp, first=d), got)
        # B18 on JAX's own B17 output: the state carried across
        want = np.asarray(jseg2c(ux, uy, *jcp.W, jcp.const[sl],
                                 jplans.p2i.W[sl], jplans.p2i.const[sl]))
        uxt, uyt = (torch.from_numpy(u.copy())[None] for u in (ux, uy))
        got = C.seg2_classes_plain(uxt, uyt, plans, cp, first=d)
        assert got.dtype == torch.uint32
        assert int(got.to(torch.int64).max()) < q
        np.testing.assert_array_equal(got[0].numpy(), want % q,
                                      err_msg=f"B18 shard {d}")
        assert torch.equal(C.sp_seg2_classes(uxt, uyt, plans, cp, first=d),
                           got)


def test_class_exchange_matches_all_to_all():
    name = "qtesla-iii-speed"
    plans, cp = _plans(name, 4)
    n1, n2k, n1k, D, B = plans.n1, plans.n2k, plans.n1k, cp.Dout, 4
    mesh = jmake_mesh(data=2, model=4)
    spec = JP_("data", None, None, "model")
    fwd = jax.jit(jax.shard_map(
        lambda v: lax.all_to_all(v, "model", split_axis=2, concat_axis=3,
                                 tiled=True),
        mesh=mesh, in_specs=spec, out_specs=JP_("data", None, "model", None)))
    rng = np.random.default_rng(72)
    # (B, D, n1, n2): shard d holds lanes [d*n2k, (d+1)*n2k) of each class
    v = rng.integers(0, 1 << 32, (B, D, n1, plans.n2), dtype=np.uint32)
    want = np.asarray(fwd(v))                       # (B, D, n1, n2)
    stacked = torch.from_numpy(v).reshape(B, D, n1, 4, n2k).permute(
        3, 0, 1, 2, 4).reshape(4, B, D * plans.nloc).contiguous()
    got = C.a2a_fwd_classes(stacked, plans, D)
    got = got.reshape(4, B, D, n1k, plans.n2).permute(1, 2, 0, 3, 4)
    np.testing.assert_array_equal(got.reshape(B, D, n1, plans.n2).numpy(),
                                  want)


# ----------------------------------------------------------------------
# The whole path.
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_class_path(name, kind, data=2, model=4):
    """JAX's class-boundary SP product of 8 numpy-seeded rows on the CPU
    mesh, interpret mode: (x, y, z)."""
    ps = get_params(name)
    rng = np.random.default_rng(73)
    x, y = rng.integers(0, ps.q, (2, 8, ps.n), dtype=np.uint32)
    if kind == "worst":
        x[:], y[:] = ps.q - 1, ps.q - 1
    fn = JS.polymul_fourstep_mxu_classes_fn(
        name, jmake_mesh(data=data, model=model), interpret=True)
    return x, y, np.asarray(fn(x, y))


@pytest.mark.parametrize("kind", ["random", "worst"])
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_class_path_matches_jax_mesh(batch, kind):
    name, k = "qtesla-iii-speed", 4
    x, y, z = _jax_class_path(name, kind)
    x, y, z = x[:batch], y[:batch], z[:batch]
    ps = get_params(name)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    cpu4 = make_mesh(model=k, device="cpu")
    got = polymul_fourstep_mxu_classes_fn(name, cpu4)(xt, yt)
    assert got.dtype == torch.uint32 and tuple(got.shape) == (batch, ps.n)
    np.testing.assert_array_equal(got.numpy(), z)
    assert torch.equal(S.polymul_fourstep_mxu_fn(name, cpu4)(xt, yt), got)
    plans, cp = _plans(name, k)
    assert torch.equal(
        C.polymul_fourstep_mxu_classes_plain(xt, yt, plans, cp), got)
    if batch == 3:
        for r in (0, 2):
            np.testing.assert_array_equal(
                got[r].numpy(),
                polymul_negacyclic_oracle(x[r], y[r], ps).astype(np.uint32))


@pytest.mark.parametrize("name,k", [("smallprime", 2), ("smallprime", 4),
                                    ("qtesla-i", 8), ("qtesla-iii-speed", 2)])
def test_class_path_matches_merged_and_oracle(name, k):
    """Other sets and model axes (k = 8: no wide stage; k = 2 at q-III:
    10 batch rows a B18 block), batched over two leading axes, against the
    merged path and two oracle rows."""
    ps = get_params(name)
    rng = np.random.default_rng(74)
    x, y = (torch.from_numpy(v) for v in rng.integers(
        0, ps.q, (2, 2, 2, ps.n), dtype=np.uint32))
    want = polymul_negacyclic(x, y, name)
    got = polymul_fourstep_mxu_classes_fn(
        name, make_mesh(model=k, device="cpu"))(x, y)
    assert got.shape == x.shape and torch.equal(got, want)
    for r in (0, 1):
        np.testing.assert_array_equal(
            want[r, 1].numpy(), polymul_negacyclic_oracle(
                x[r, 1].numpy(), y[r, 1].numpy(), ps).astype(np.uint32))


@pytest.mark.parametrize("name", ["qtesla-p-i", "qtesla-p-iii"])
def test_four_class_sets_raise_when_built(name):
    mesh = make_mesh(model=4, device="cpu")
    with pytest.raises(ValueError, match="Dout <= 3"):
        polymul_fourstep_mxu_classes_fn(name, mesh)
    with pytest.raises(ValueError, match="Dout <= 3"):
        local_pipeline_classes_fn(name, 4)


def test_class_plan_for_rejects_plans_outside_the_kernels():
    plans, cp = _plans("smallprime", 2)
    fields = dict(cp.__dict__)
    for bad, match in (({"bounds": (1 << 24,) + cp.bounds[1:]}, "range"),
                       ({"dins": (7,) + cp.dins[1:]}, "range"),
                       ({"Dout": 4}, "Dout <= 3")):
        with pytest.raises(ValueError, match=match):
            C.plan_for(plans, ST.ClassPlan(**{**fields, **bad}),
                       "sp_seg2_classes")
    plan = C.plan_for(plans, cp, "sp_seg2_classes")
    # 8 planes of the 8-lane n2-block: one compact depth of 64
    assert (plan.din1, plan.c1.kp, list(plan.cdin)) == (8, 64, [3, 3, 2])
    # 8 rows of x and 8 of y a warp; B17's plan carries the class biases
    assert plan.rows == 16
    assert list(C.plan_for(plans, cp, "sp_seg1_classes").cls_b) == cp.cls_b


def test_class_wrappers_reject_bad_input():
    plans, cp = _plans("smallprime", 2)
    k, nloc, D = plans.k, plans.nloc, cp.Dout
    rng = np.random.default_rng(75)
    x = torch.from_numpy(rng.integers(0, plans.q, (k, 3, nloc),
                                      dtype=np.uint32))
    u = C.sp_seg1_classes(x, plans, cp)
    assert tuple(u.shape) == (k, 3, D * nloc)
    with pytest.raises(ValueError, match=f"n={D * nloc}"):
        C.sp_seg2_classes(x, x, plans, cp)
    with pytest.raises(ValueError, match=f"n={nloc}"):
        C.sp_seg1_classes(u, plans, cp)
    with pytest.raises(TypeError, match="uint32"):
        C.sp_seg2_classes(u.to(torch.int64), u, plans, cp)
    with pytest.raises(ValueError, match="shards on"):
        C.sp_seg2_classes(u, u[:, :2].contiguous(), plans, cp)
    with pytest.raises(ValueError, match="model axis"):
        C.sp_seg1_classes(x, plans, cp, first=1)
    with pytest.raises(ValueError, match="shards"):
        C.sp_seg1_classes(x[0], plans, cp)
    tabs = C.class_device_tables(plans, cp, torch.device("cpu"))
    for bad in (C.ClassDeviceTables(tabs.sp, tabs.w2c[:, :-32].contiguous(),
                                    tabs.c2c, tabs.w2cc),
                C.ClassDeviceTables(tabs.sp, tabs.w2c, tabs.c2c[:1],
                                    tabs.w2cc),
                C.ClassDeviceTables(tabs.sp, tabs.w2c, tabs.c2c,
                                    tabs.w2cc[:, :-32].contiguous())):
        with pytest.raises(ValueError, match="class tables"):
            C.sp_seg2_classes(u, u, plans, cp, tabs=bad)
    bad = C.ClassDeviceTables(S.host_tables(ST.fourstep_mxu_plans(
        "smallprime", 4, 4)), tabs.w2c, tabs.c2c, tabs.w2cc)
    with pytest.raises(ValueError, match="SP tables"):
        C.sp_seg1_classes(x, plans, cp, tabs=bad)
    fn = polymul_fourstep_mxu_classes_fn("smallprime", make_mesh(model=2))
    with pytest.raises(ValueError, match="mesh on cuda"):
        fn(x[0], x[1])
    rows = x.reshape(3, 2 * nloc)
    with pytest.raises(ValueError, match="differ"):
        polymul_fourstep_mxu_classes_fn("smallprime", make_mesh(
            model=2, device="cpu"))(rows, rows[:2])
    with pytest.raises(ValueError, match="divide"):
        polymul_fourstep_mxu_classes_fn("smallprime",
                                        make_mesh(model=16, device="cpu"))


def test_local_pipeline_classes_is_one_shard_of_the_segments():
    name = "qtesla-iii-speed"
    pipe, plans, cp = local_pipeline_classes_fn(name, 4)
    assert cp is ST.class_boundary_plan(name, 32, 4)
    rng = np.random.default_rng(76)
    x, y = (torch.from_numpy(v) for v in rng.integers(
        0, plans.q, (2, 3, plans.nloc), dtype=np.uint32))
    got = pipe(x, y)
    assert tuple(got.shape) == (3, plans.nloc)
    ux, uy = (C.seg1_classes_plain(t[None], plans, cp, first=1)
              for t in (x, y))
    w = C.seg2_classes_plain(ux, uy, plans, cp, first=1)
    assert torch.equal(got, S.seg3_plain(w, plans, first=1)[0])
    # device_index past the axis takes the last shard, as in JAX
    pipe2, plans2, cp2 = local_pipeline_classes_fn(name, 2, device_index=5)
    xs = x[:, :plans2.nloc // 2].repeat(1, 2).contiguous()
    ux = C.seg1_classes_plain(xs[None], plans2, cp2, first=1)
    w = C.seg2_classes_plain(ux, ux, plans2, cp2, first=1)
    assert torch.equal(pipe2(xs, xs), S.seg3_plain(w, plans2, first=1)[0])
