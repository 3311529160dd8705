"""Contract of the port's device dispatch and kernel wrappers.

- ``qtesla_tpu_torch`` imports and runs its CPU slice without jax.
- The wrappers (fused B1-B4, digit-matmul B5-B9, pairings B10, the
  sequence-parallel segments B11-B16 and its class boundary B17-B18) raise
  on
  a wrong dtype, a wrong n, a non-contiguous tensor, an unsupported device
  and an unsupported algo; nothing is built at import and a missing nvcc
  raises instead of falling back.  Editing a header changes the build's
  hash.  Every algo name dispatches, ``nussbaumer`` too; an unknown name
  raises.
- CPU tensors run the plain versions: no kernel's launch count moves.
- Tests marked ``cuda`` compare each kernel with its plain version on the
  card; without one they skip.  The cases take the five shipped sets, n =
  8192 and the two q30 sets (q = 1073479681, n = 1024 and 8192), the
  last three registered by an autouse fixture.  On a GPU host run them with
  ``python -m pytest tests/test_torch_device.py -m cuda --noconftest -q``
  (``--noconftest`` because tests/conftest.py imports jax).

This file imports no jax.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qtesla_tpu_torch import (get_params, polymul_negacyclic_oracle,
                              register_param_set)
from qtesla_tpu_torch.models import polymul as TP
from qtesla_tpu_torch.ops import ntt_fused as F
from qtesla_tpu_torch.ops import ntt_mxu as M
from qtesla_tpu_torch.ops import ntt_mxu_split as MS
from qtesla_tpu_torch.ops import ntt_pairings as P
from qtesla_tpu_torch.ops.mxu_tables import (FixedFoldPlan, fold_plan,
                                             get_mxu_tables)
from qtesla_tpu_torch.ops import passes as PS
from qtesla_tpu_torch.ops.passes import PassPlan, schedule
from qtesla_tpu_torch.ops.tables import get_tables
from qtesla_tpu_torch.parallel import make_mesh
from qtesla_tpu_torch.parallel import sharded_classes as C
from qtesla_tpu_torch.parallel import sharded_mxu as S
from qtesla_tpu_torch.parallel import sp_column_split as SC
from qtesla_tpu_torch.parallel.sharded_mxu_tables import (class_boundary_plan,
                                                         fourstep_fold_tables,
                                                         fourstep_mxu_plans)
from qtesla_tpu_torch.utils import build

REPO = Path(__file__).resolve().parent.parent
# n = 8192: B1 needs 64 KB of shared memory per block (opt-in above 48 KB)
WIDE = ("qtesla-iii-speed-n8192", 8192, 8404993)
# q = 2^30 - 2^18 + 1: 4q is 1,048,572 below 2^32, the tightest lazy ranges
# the kernels take; four digit classes, so the class path refuses it
Q30 = ("q30-n1024", 1024, 1073479681)
Q30_WIDE = ("q30-n8192", 8192, 1073479681)
SETS = ["smallprime", "qtesla-i", "qtesla-iii-speed", "qtesla-p-i",
        "qtesla-p-iii", Q30[0]]
# the n = 8192 sets, which run the SP kernels at k = 4 alone
WIDE_SETS = [WIDE[0], Q30_WIDE[0]]
# the sets of four digit classes: building the class path raises
FOUR_CLASS_SETS = ("qtesla-p-i", "qtesla-p-iii", Q30[0], Q30_WIDE[0])


@pytest.fixture(autouse=True)
def runtime_sets():
    """Registers the sets beyond the shipped five in the port's registry."""
    for entry in (WIDE, Q30, Q30_WIDE):
        register_param_set(*entry)

_CPU_SLICE = """
import sys
import numpy as np, torch
from qtesla_tpu_torch import get_params, polymul_negacyclic_oracle
from qtesla_tpu_torch.models import (NegacyclicPolymul, intt, ntt,
                                     polymul_fixed_fn, polymul_negacyclic)
ps = get_params("smallprime")
rng = np.random.default_rng(0)
x, y = (torch.from_numpy(rng.integers(0, ps.q, (3, ps.n), dtype=np.uint32))
        for _ in range(2))
z = polymul_negacyclic(x, y, ps, algo="fused")
assert (z == polymul_negacyclic(x, y, ps)).all()
assert (z == NegacyclicPolymul(ps)(x, y, "fused")).all()
want = polymul_negacyclic_oracle(x[0].numpy(), y[0].numpy(), ps)
assert (z[0].numpy() == want.astype(np.uint32)).all()
assert (intt(ntt(x, ps, "fused"), ps, "fused") == x).all()
prep, mul = polymul_fixed_fn(ps.name, "fused")
mul(x, prep(y[:1]))
assert (polymul_negacyclic(x, y, ps, algo="mxu") == z).all()
assert (intt(ntt(x, ps, "mxu"), ps, "mxu") == x).all()
prep, mul = polymul_fixed_fn(ps.name)
assert (mul(x, prep(y[:1])) == polymul_fixed_fn(ps.name, "fused")[1](
    x, prep(y[:1]))).all()
from qtesla_tpu_torch import make_mesh, polymul_fourstep_mxu_fn
sp = polymul_fourstep_mxu_fn(ps.name, make_mesh(model=2, device="cpu"))
assert (sp(x, y) == z).all()
from qtesla_tpu_torch import polymul_fourstep_mxu_classes_fn
cls = polymul_fourstep_mxu_classes_fn(ps.name, make_mesh(model=2,
                                                         device="cpu"))
assert (cls(x, y) == z).all()
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert not [m for m in sys.modules if m.split(".")[0] == "qtesla_tpu"]
print("ok")
"""


def test_cpu_slice_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _CPU_SLICE], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _u32(rows, n, seed=0, q=65537):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, q, (rows, n), dtype=np.uint32))


def test_wrappers_reject_bad_input():
    tbl = get_tables("smallprime")
    n = tbl.n
    x = _u32(2, n)
    with pytest.raises(TypeError, match="uint32"):
        F.polymul_fused(x.to(torch.int64), x, tbl)
    with pytest.raises(TypeError, match="uint32"):
        F.ntt_fused(x.to(torch.int32), tbl)
    with pytest.raises(ValueError, match="n=32"):
        F.intt_fused(_u32(2, 2 * n), tbl)
    with pytest.raises(ValueError, match="n=32"):
        TP.polymul_negacyclic(_u32(2, 16), _u32(2, 16), "smallprime",
                              algo="fused")
    with pytest.raises(ValueError, match="contiguous"):
        F.polymul_fused(_u32(2, 2 * n)[:, ::2], x, tbl)
    with pytest.raises(ValueError, match="shapes differ"):
        F.polymul_fused(x, _u32(3, n), tbl)
    with pytest.raises(ValueError, match="spectrum"):
        F.polymul_fixed_fused(x, _u32(2, n), tbl)
    meta = torch.empty((2, n), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="device"):
        F.polymul_fused(meta, meta, tbl)
    with pytest.raises(ValueError, match="twiddles"):
        F.ntt_fused(x, tbl, tw=torch.zeros((4, n), dtype=torch.int64))


@pytest.mark.parametrize("algo", ["nussbaumer"])
def test_unported_algos_raise_not_implemented(algo):
    """The algos that once raised NotImplementedError (``nussbaumer``, the
    last) now run on CPU tensors, bit for bit equal to the oracle and the
    merged product; an unknown name still raises."""
    ps = get_params("smallprime")
    x, y = _u32(3, 32, 7), _u32(3, 32, 8)
    x[0], y[0] = ps.q - 1, ps.q - 1
    z = TP.polymul_negacyclic(x, y, "smallprime", algo=algo)
    assert z.dtype == torch.uint32
    assert torch.equal(z, TP.polymul_negacyclic(x, y, "smallprime"))
    assert torch.equal(TP.polymul_fn("smallprime", algo)(x, y), z)
    for b in range(3):
        np.testing.assert_array_equal(
            z[b].numpy(), polymul_negacyclic_oracle(x[b].numpy(),
                                                    y[b].numpy(), ps)
            .astype(np.uint32))
    with pytest.raises(ValueError, match="unknown algo"):
        TP.polymul_fn("smallprime", algo + "-nope")


_PAIRING_NAMES = ["gs_ct", "ct_ct", "gs_gs", "ct_gs", "stockham"]


@pytest.mark.parametrize("algo", _PAIRING_NAMES + ["four_step", "matrix"]
                         + [p + "_kernel" for p in _PAIRING_NAMES]
                         + ["mxu-folded"])
def test_ported_algos_dispatch(algo):
    """Each algo ported in the third slice runs on CPU tensors and equals
    the merged product."""
    x, y = _u32(2, 32, 5), _u32(2, 32, 6)
    want = TP.polymul_negacyclic(x, y, "smallprime")
    if algo == "mxu-folded":
        prep, mul = TP.polymul_fixed_fn("smallprime", algo)
        assert mul.func is M.polymul_fixed_folded_mxu
        z = mul(x, prep(y[0]))
        want = TP.polymul_negacyclic(x, y[:1].expand(2, 32).contiguous(),
                                     "smallprime")
    else:
        assert algo in TP.ALGORITHMS
        z = TP.polymul_negacyclic(x, y, "smallprime", algo=algo)
    assert z.dtype == torch.uint32
    assert torch.equal(z, want)


def test_empty_and_unbatched_inputs():
    """B = 0 and a bare (n,) row keep their shapes."""
    tbl = get_tables("smallprime")
    n = tbl.n
    empty = torch.empty((0, n), dtype=torch.uint32)
    assert tuple(F.polymul_fused(empty, empty, tbl).shape) == (0, n)
    assert tuple(F.intt_fused(F.ntt_fused(empty, tbl), tbl).shape) == (0, n)
    x, y = _u32(2, n, 3), _u32(2, n, 4)
    np.testing.assert_array_equal(F.polymul_fused(x[0], y[0], tbl).numpy(),
                                  F.polymul_fused(x, y, tbl)[0].numpy())


def test_mxu_wrappers_reject_bad_input():
    mt = get_mxu_tables("smallprime")
    n = mt.n
    x = _u32(2, n)
    with pytest.raises(TypeError, match="uint32"):
        M.polymul_mxu(x.to(torch.int64), x, mt)
    with pytest.raises(TypeError, match="uint32"):
        M.ntt_mxu(x.to(torch.int32), mt)
    with pytest.raises(ValueError, match="n=32"):
        M.intt_mxu(_u32(2, 2 * n), mt)
    with pytest.raises(ValueError, match="n=32"):
        TP.polymul_negacyclic(_u32(2, 16), _u32(2, 16), "smallprime",
                              algo="mxu")
    with pytest.raises(ValueError, match="contiguous"):
        M.polymul_mxu(_u32(2, 2 * n)[:, ::2], x, mt)
    with pytest.raises(ValueError, match="shapes differ"):
        M.polymul_mxu(x, _u32(3, n), mt)
    with pytest.raises(ValueError, match="spectrum"):
        M.polymul_fixed_mxu(x, _u32(2, n), mt)
    meta = torch.empty((2, n), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="device"):
        M.polymul_mxu(meta, meta, mt)
    tabs = M.host_tables(mt)
    bad = M.MxuDeviceTables(tabs.wf.to(torch.int32), *tabs.tensors()[1:])
    with pytest.raises(ValueError, match="MXU tables"):
        M.ntt_mxu(x, mt, tabs=bad)


def test_cpu_runs_launch_no_kernel():
    assert set(F.KERNELS) == {"polymul_fused", "polymul_fixed_fused",
                              "ntt_fused", "intt_fused"}
    assert set(M.KERNELS) == {"polymul_mxu", "polymul_fixed_mxu", "ntt_mxu",
                              "intt_mxu", "polymul_fixed_folded_mxu"}
    assert set(P.KERNELS) == {f"polymul_pairing_{p}" for p in _PAIRING_NAMES}
    assert set(S.KERNELS) == {"sp_seg1", "sp_seg2", "sp_seg2_fixed",
                              "sp_seg2_fwd", "sp_seg2_folded", "sp_seg3"}
    assert set(C.KERNELS) == {"sp_seg1_classes", "sp_seg2_classes"}
    kernels = [*F.KERNELS.values(), *M.KERNELS.values(), *P.KERNELS.values(),
               *S.KERNELS.values(), *C.KERNELS.values()]
    for k in kernels:
        k.launches = 0
    tbl = get_tables("smallprime")
    mt = get_mxu_tables("smallprime")
    x, y = _u32(3, tbl.n, 1), _u32(3, tbl.n, 2)
    F.polymul_fused(x, y, tbl)
    F.polymul_fixed_fused(x, F.ntt_fused(y[:1], tbl), tbl)
    F.intt_fused(F.ntt_fused(x, tbl), tbl)
    TP.NegacyclicPolymul("smallprime")(x, y, "fused")
    M.polymul_mxu(x, y, mt)
    M.polymul_fixed_mxu(x, M.ntt_mxu(y[:1], mt), mt)
    M.intt_mxu(M.ntt_mxu(x, mt), mt)
    TP.NegacyclicPolymul("smallprime")(x, y, "mxu")
    prep, mul = TP.polymul_fixed_fn("smallprime")
    mul(x, prep(y[:1]))
    prep, mul = TP.polymul_fixed_fn("smallprime", "mxu-folded")
    mul(x, prep(y[:1]))
    for p in _PAIRING_NAMES:
        TP.polymul_negacyclic(x, y, "smallprime", algo=p + "_kernel")
        TP.NegacyclicPolymul("smallprime")(x, y, p + "_kernel")
    S.polymul_fourstep_mxu_fn("smallprime", make_mesh(model=2, device="cpu"))(
        x, y)
    pipe, plans = S.local_pipeline_fn("smallprime", 2)
    pipe(x[:, :plans.nloc].contiguous(), y[:, :plans.nloc].contiguous())
    cpu2 = make_mesh(model=2, device="cpu")
    prep, mul = S.polymul_fixed_fourstep_mxu_fn("smallprime", cpu2)
    mul(x, prep(y[0]))
    prep, mul = S.polymul_fixed_folded_fourstep_mxu_fn("smallprime", cpu2)
    mul(x, *prep(y[0]))
    C.polymul_fourstep_mxu_classes_fn("smallprime", cpu2)(x, y)
    pipe, plans, _ = C.local_pipeline_classes_fn("smallprime", 2)
    pipe(x[:, :plans.nloc].contiguous(), y[:, :plans.nloc].contiguous())
    assert all(k.launches == 0 for k in kernels)


def test_mxu_plan_matches_kernel_limits():
    """The C plan carries the planner's values; every registered set fits
    the kernels' limits (at most 4 classes, 6 planes, 32 rows a block)."""
    for name in SETS:
        mt = get_mxu_tables(name)
        for ops in (1, 2):
            plan = M.plan_for(mt, ops)
            assert plan.rows % ops == 0 and 0 < plan.rows <= 32
            assert plan.rows * mt.n * 4 <= 128 * 1024
            assert (plan.n, plan.lr, plan.d, plan.df, plan.di) == (
                mt.n, mt.Lr, mt.D, mt.Df, mt.Di)
            assert list(plan.pw)[:mt.D] == [pow(2, 8 * j, mt.q)
                                           for j in range(mt.D)]
    assert M.block_rows(8192, 2) == 4 and M.block_rows(1024, 2) == 32


@pytest.mark.parametrize("mode", ["product", "folded", "fixed", "ntt",
                                  "intt"],
                         ids=["B5", "B9", "B8", "B6", "B7"])
@pytest.mark.parametrize("name", SETS)
def test_stream_plan_matches_kernel_limits(name, mode):
    """The stream kernel's plans: B5's is ``plan_for(mt, 2)``, B9's
    ``fold_plan_for(mt, fold_plan(mt))`` (x rows alone, the fold plan's
    inverse split), B8's, B6's and B7's ``plan_for(mt, 1)``, field by
    field, each with the stage counts (B6 none of the inverse, B7 none of
    the forward) and the deepest ring of stages that fits beside the rows
    and the planes the mode holds; every plan passes every check of the
    launcher."""
    mt = get_mxu_tables(name)
    fp = fold_plan(mt)
    base, di = {"product": (M.plan_for(mt, 2), mt.Di),
                "folded": (M.fold_plan_for(mt, fp), fp.Din),
                "fixed": (M.plan_for(mt, 1), mt.Di),
                "ntt": (M.plan_for(mt, 1), mt.Di),
                "intt": (M.plan_for(mt, 1), mt.Di)}[mode]
    plan = M.stream_plan(mt, mode, fp if mode == "folded" else None)
    for f, _ in M.MxuPlan._fields_:
        got, want = getattr(plan, f), getattr(base, f)
        if f in ("pw", "pw_sh"):
            got, want = list(got), list(want)
        assert got == want, f
    # the forward and inverse planes the block holds
    held_f = 0 if mode == "intt" else mt.Df
    held = 0 if mode == "ntt" else di
    assert plan.stages_f == -(-held_f * mt.bw // 64)
    assert plan.stages_i == -(-held * mt.bw // 64)
    smem = [M.stream_smem(mt, plan.rows, r, held, held_f) + 1024
            for r in (plan.ring, plan.ring + 1)]
    assert 2 <= plan.ring <= 8 and smem[0] <= 233472
    assert plan.ring == 8 or smem[1] > 233472
    # the launcher's checks
    assert 1 <= plan.rows <= 16 or plan.rows == 32
    assert mode != "product" or plan.rows % 2 == 0
    assert 1 <= plan.d <= 4 and 32 <= plan.bw <= 128 and plan.bw % 32 == 0
    assert plan.n == 1 << plan.logn == plan.nb * plan.bw
    assert plan.n >> plan.lr == plan.bw
    for din, lb in ((plan.df, plan.fwd_lb), (plan.di, plan.inv_lb)):
        assert (lb == 8 and 1 <= din <= 4) or (lb == 7 and 1 <= din <= 6)
    if name == "qtesla-iii-speed":
        assert (plan.rows, plan.ring, plan.stages_f, plan.stages_i) == (
            32, 3, 0 if mode == "intt" else 8,
            {"product": 6, "folded": 8, "fixed": 6, "ntt": 0,
             "intt": 6}[mode])
        assert plan.inv_lb == (7 if mode == "folded" else 8)


def test_stream_plan_refuses_what_the_kernel_refuses(monkeypatch):
    """A split the kernel's packed split cannot take (5 planes of base 256,
    or a base other than 128 and 256), a lane block wider than 128 and
    rows that fill neither one MMA tile of x's and y's rows nor two (18 to
    30) raise before any launch, in every mode; so do a mode the kernel
    does not have and a fold plan given to a mode other than B9's."""
    import copy

    mt = get_mxu_tables("qtesla-iii-speed")
    own = ("product", "fixed", "ntt", "intt")  # the modes under mt's split
    for field, value in (("Df", 5), ("Di", 5), ("fwd_base", 512),
                         ("inv_base", 64)):
        bad = copy.copy(mt)
        setattr(bad, field, value)
        for mode in own:
            with pytest.raises(ValueError, match="split"):
                M.stream_plan(bad, mode)
    bad = copy.copy(mt)
    bad.bw, bad.nb, bad.Lr = 256, mt.nb // 2, mt.Lr - 1
    for mode in own:
        with pytest.raises(ValueError, match="range"):
            M.stream_plan(bad, mode)
    # B9's plan: the fold plan's inverse split (base 128 at this set), 7
    # planes of base 128, 5 of base 256 or a base of 64 are refused
    fp = fold_plan(mt)
    fields = {f: getattr(fp, f) for f in FixedFoldPlan.__dataclass_fields__}
    for bad_fp in ({"Din": 5, "base": 256}, {"base": 64}):
        with pytest.raises(ValueError, match="split"):
            M.stream_plan(mt, "folded", FixedFoldPlan(**{**fields, **bad_fp}))
    with pytest.raises(ValueError, match="range"):
        M.stream_plan(mt, "folded", FixedFoldPlan(**{**fields, "Din": 7}))
    with pytest.raises(ValueError, match="stream mode"):
        M.stream_plan(mt, "inverse")
    with pytest.raises(ValueError, match="no fold plan"):
        M.stream_plan(mt, "fixed", fp)
    for rows in (18, 24, 30):
        monkeypatch.setattr(M, "block_rows", lambda n, ops, rows=rows: rows)
        for mode in own:
            with pytest.raises(ValueError, match="range"):
                M.stream_plan(copy.copy(mt), mode)
        with pytest.raises(ValueError, match="range"):
            M.stream_plan(copy.copy(mt), "folded", fp)


@pytest.mark.parametrize("name", SETS)
def test_fold_plan_matches_kernel_limits(name):
    """The folded kernel's plan carries the fold plan's inverse split and
    the forward of the MXU plan; every registered set fits."""
    mt = get_mxu_tables(name)
    fp = fold_plan(mt)
    plan, base = M.fold_plan_for(mt, fp), M.plan_for(mt, 1)
    assert (plan.di, plan.inv_lb) == (fp.Din, fp.base.bit_length() - 1)
    assert plan.inv_add == (sum((fp.base // 2) * fp.base ** i
                                for i in range(fp.Din - 1)) - fp.off) % 2**32
    for f in ("n", "rows", "d", "df", "fwd_lb", "fwd_add", "kbf", "q"):
        assert getattr(plan, f) == getattr(base, f), f
    assert fp.Din <= 6 and max(fp.bounds) < 1 << 24 and fp.Dout == mt.D


def test_fold_plan_for_rejects_plans_outside_the_kernel():
    mt = get_mxu_tables("qtesla-iii-speed")
    fp = fold_plan(mt)
    fields = {f: getattr(fp, f) for f in FixedFoldPlan.__dataclass_fields__}
    for bad in ({"Din": 7}, {"Dout": mt.D + 1},
                {"bounds": (1 << 24,) + fp.bounds[1:]}):
        with pytest.raises(ValueError, match="range"):
            M.fold_plan_for(mt, FixedFoldPlan(**{**fields, **bad}))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    build.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.load_library()
    finally:
        build.load_library.cache_clear()
    assert not (tmp_path / "build").exists()


def test_build_flags_target_hopper():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert [p.name for p in build._sources()] == [
        "modq.cuh", "mxu_block.cuh", "mxu_compact.cuh", "ntt_fused.cu",
        "ntt_mxu.cu", "ntt_mxu_split.cu", "ntt_pairings.cu",
        "ntt_pairings_cluster.cu",
        "pairing_pass.cuh", "pass_stages.cuh", "pass_sweeps.cu",
        "seg2_compact.cuh", "sharded_classes.cu", "sharded_mxu.cu",
        "sp_column_split.cu"]
    src = {mod: (build.CSRC_DIR / mod.CUDA_SOURCE.rsplit("/", 1)[1])
           .read_text() for mod in (F, M, P, S, C)}
    # the pass kernels' sweep form: one launcher for all nine kinds, a
    # launch a call (x, y, z, two scratch rows, twiddles, batch, n, logn,
    # the set's constants, &plan, the launch's number, stream)
    assert set(build.LAUNCHERS) == {k.symbol
                                    for mod in (F, M, MS, P, S, C, SC)
                                    for k in mod.KERNELS.values()} | {
        "qt_pass_sweep"}
    sweep = build.LAUNCHERS["qt_pass_sweep"]
    assert len(sweep) == 16 and sweep[-3:] == [sweep[0], ctypes.c_int,
                                               sweep[0]]
    assert 'extern "C" int qt_pass_sweep(' in (
        build.CSRC_DIR / "pass_sweeps.cu").read_text()
    # the pass kernels' launchers (the five pairings, B1-B4) take the plan
    # before the stream
    passes = build.LAUNCHERS["qt_polymul_fused"]
    assert len(passes) == 13 and passes[-2:] == [passes[0]] * 2
    for k in P.KERNELS.values():
        assert k.replaces == "qtesla_tpu/ops/ntt_pairings_pallas.py:160"
        assert f"QT_PAIRING_LAUNCHER({k.symbol}," in src[P]
        assert build.LAUNCHERS[k.symbol] == passes
    assert "stk_stages" not in src[P] and " pairing_kernel" not in src[P]
    assert "polymul_fused_kernel" not in src[F]
    assert "polymul_fixed_fused_kernel" not in src[F]
    assert "fwd_stages" not in src[F]
    # B2 and B3 run the pass kernel of one transform; their block-a-row
    # bodies and the macro launcher went
    assert "intt_fused_kernel" not in src[F] and "inv_stages" not in src[F]
    assert "ntt_fused_kernel" not in src[F] and "QT_LAUNCHER" not in src[F]
    assert "transform_pass_kernel_for<false>(" in src[F]
    assert "transform_pass_kernel_for<true>(" in src[F]
    for k in F.KERNELS.values():
        assert k.replaces.startswith("qtesla_tpu/ops/ntt_pallas.py:")
        assert f'extern "C" int {k.symbol}(' in src[F]
        assert build.LAUNCHERS[k.symbol] == passes
        assert k.smem_rows == 0
    # B5 and B9 have launchers of their own, written out
    for k in M.KERNELS.values():
        assert (f"QT_MXU_LAUNCHER({k.symbol}," in src[M]
                or f'extern "C" int {k.symbol}(' in src[M])
        assert k.replaces.startswith("qtesla_tpu/ops/ntt_mxu.py:")
        assert len(build.LAUNCHERS[k.symbol]) == 11
    assert 'extern "C" int qt_polymul_mxu(' in src[M]
    assert 'extern "C" int qt_polymul_fixed_folded_mxu(' in src[M]
    # every SP kernel and the class kernels have launchers of their own,
    # written out; B12-B15 and B18 share one kernel body, B11, B16 and B17
    # another; the dense sp_kernel and its macro launcher went with B14's
    # move, and the dense block matmul with them
    assert 'extern "C" int qt_sp_seg2(' in src[S]
    assert "qt::seg2::launch<qt::seg2::kPair>(" in src[S]
    assert "qt::seg2::launch<qt::seg2::kSpectrum>(" in src[S]
    assert "qt::seg2::launch<qt::seg2::kFolded>(" in src[S]
    assert "qt::seg2::launch<qt::seg2::kForward>(" in src[S]
    assert "kSeg2Folded" not in src[S] and "kSeg2Fwd" not in src[S]
    assert "sp_kernel" not in src[S] and "QT_SP_LAUNCHER" not in src[S]
    assert "block_matmul" not in (build.CSRC_DIR / "mxu_block.cuh").read_text()
    assert "qt::seg2::launch<qt::seg2::kClassPlanes>(" in src[C]
    assert "launch_column_compact<kColumnClasses>(" in src[S]
    assert "qt::launch_seg1_classes(" in src[C]
    assert "classes_kernel" not in src[C] and "kSeg2Fixed" not in src[S]
    for k in S.KERNELS.values():
        assert f'extern "C" int {k.symbol}(' in src[S]
        assert k.replaces.startswith("qtesla_tpu/parallel/sharded_mxu.py:")
        assert len(build.LAUNCHERS[k.symbol]) == 12
    for k in C.KERNELS.values():
        assert f'extern "C" int {k.symbol}(' in src[C]
        assert k.replaces.startswith("qtesla_tpu/parallel/sharded_mxu.py:")
        assert build.LAUNCHERS[k.symbol] == build.LAUNCHERS["qt_sp_seg1"]
    # the C structs and the ctypes ones name the same fields in one order;
    # SpCompactPlan is SpPlan (its base in C) and what follows, and
    # MxuStreamPlan MxuPlan and what follows
    src["compact"] = (build.CSRC_DIR / "mxu_compact.cuh").read_text()
    src["seg2"] = (build.CSRC_DIR / "seg2_compact.cuh").read_text()
    src["passes"] = (build.CSRC_DIR / "pass_stages.cuh").read_text()
    for mod, struct, head, skip in (
            ("passes", PassPlan, "struct PassPlan {", 0),
            (M, M.MxuPlan, "struct MxuPlan {", 0),
            (M, M.MxuStreamPlan, "struct MxuStreamPlan : MxuPlan {",
             len(M.MxuPlan._fields_)),
            (S, S.SpPlan, "struct SpPlan {", 0),
            ("seg2", S.SpClassPlan, "struct SpClassPlan {", 0),
            ("compact", S.CompactDims, "struct CompactDims {", 0),
            (S, S.SpCompactPlan, "struct SpCompactPlan : SpPlan {",
             len(S.SpPlan._fields_))):
        body = src[mod].split(head)[1].split("};")[0]
        c_fields = []
        for decl in filter(None, (d.strip() for d in body.split(";"))):
            names = decl.split(None, 1)[1]
            c_fields += [f.strip().split("[")[0] for f in names.split(",")]
        assert c_fields == [f for f, _ in struct._fields_][skip:]


def test_header_edit_changes_digest(tmp_path):
    """Editing a .cuh header changes the library's hash, so a build never
    reuses a library made from an older header."""
    for src in build._sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    before = build._digest(build._sources(tmp_path))
    header = tmp_path / "modq.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build._digest(build._sources(tmp_path)) != before
    assert header in build._sources(tmp_path)


def test_phase_ablation_patches_apply(tmp_path):
    """Every anchor of ``utils/phase_ablation.py`` is found once in the CUDA
    sources, in a copy, the streaming kernel of B5-B9 (its guards before
    and inside the code its modes share), the column body of
    B11, B16 and B17 and the row segment kernel of B12, B13 and B18
    included; a copy whose row segment kernel lies in sharded_classes.cu
    (the tree before B12 took it) is patched there, B13's dense pointwise
    product where a copy still has it and the stream kernel's forward wide
    stages as they read before B7 took the kernel; a copy without the
    compact header (a tree before B11 and B18 were redesigned) is
    refused."""
    import shutil

    from qtesla_tpu_torch.utils import phase_ablation as PA
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    before = {p.name: p.read_text() for p in csrc.iterdir()}
    assert PA.patch_sources(csrc) == ["mxu_compact.cuh", "ntt_mxu.cu",
                                      "seg2_compact.cuh", "sharded_mxu.cu"]
    text = (csrc / "seg2_compact.cuh").read_text()
    assert "(QT_ABL < 3 ? 0 : ca.kp)" in text and "QT_ABL < 2 ? 1" in text
    # the dense building blocks are gone from mxu_block.cuh: nothing of it
    # is patched
    assert (csrc / "mxu_block.cuh").read_text() == before["mxu_block.cuh"]
    text = (csrc / "mxu_compact.cuh").read_text()
    assert text != before["mxu_compact.cuh"]
    for cond in ("QT_ABL < 2", "QT_ABL == 3", "QT_ABL < 5"):
        assert f"#if {cond}" in text, ("mxu_compact.cuh", cond)
    text = (csrc / "ntt_mxu.cu").read_text()
    for cond in ("QT_ABL >= 1", "QT_ABL >= 2", "QT_ABL == 3", "QT_ABL < 4"):
        assert f"#if {cond}" in text, ("ntt_mxu.cu", cond)
    assert "(mma_warp && QT_ABL >= 3)" in text
    # the guards sit in what the stream kernel's five modes share: its
    # forward wide stages before the modes branch (B7 skips them), the split
    # and products of stream_matmul that B6's, B7's and B8's passes call;
    # no dense kernel is left in the file (B7 ran the last one until it
    # moved)
    kernel = text.split("polymul_stream_kernel(const uint32_t*")[1].split(
        "bool valid_split(")[0]
    wide = kernel.index("#if QT_ABL >= 1\n            if constexpr (MODE != "
                        "kIntt)\n                wide_stages<false>")
    for mode in ("MODE == kFolded || MODE == kFixed", "MODE == kNtt"):
        assert kernel.index(mode) > wide, mode
    assert "stream_matmul<D, 2, kFwd>" in kernel
    assert kernel.count("stream_matmul<D, 2, kStore>(data, tb, p.stages_f") == 1
    assert "#if QT_ABL >= 2\n        split_packed<Team>" in text
    assert "#if QT_ABL >= 1\n" + PA._S_INV_WIDE in text
    assert "block_matmul(" not in text and "launch_intt(" not in text
    # B11's (and B17's) and B16's wide stages; B13 in the row kernel: its
    # pointwise product, p2i split and second product
    text = (csrc / "sharded_mxu.cu").read_text()
    assert text.count("#if QT_ABL >= 1") == 2
    text = (csrc / "seg2_compact.cuh").read_text()
    assert text.count("QT_ABL") == 7
    assert "zf[e][c] = static_cast<int32_t>(v + a);" in text
    assert "k2 < (QT_ABL < 3 ? 0 : cb.kp);" in text
    assert "QT_ABL" not in "".join(before.values())
    # the row segment kernel where the tree before B12 took it kept it, and
    # the dense B13 beside it
    for name, text in before.items():
        (csrc / name).write_text(text)
    (csrc / "sharded_mxu.cu").write_text(before["sharded_mxu.cu"]
                                         + PA._SEG2_POINTWISE)
    (csrc / "sharded_classes.cu").write_text(
        before["sharded_classes.cu"] + before["seg2_compact.cuh"])
    (csrc / "seg2_compact.cuh").unlink()
    # and the stream kernel's forward wide stages as they read before B7
    # took the kernel, and the dense building blocks mxu_block.cuh held
    # before B14 took the row segment kernel
    (csrc / "ntt_mxu.cu").write_text(before["ntt_mxu.cu"].replace(
        PA._S_FWD_WIDE, PA._S_FWD_WIDE_B6).replace(PA._S_INV_WIDE,
                                                   PA._S_INV_WIDE_B6))
    (csrc / "mxu_block.cuh").write_text(
        before["mxu_block.cuh"] + PA._DENSE_SPLIT + PA._DENSE_MMA
        + PA._DENSE_LOAD + PA._DENSE_RECOMBINE)
    patched = PA.patch_sources(csrc)
    assert "sharded_classes.cu" in patched and "mxu_block.cuh" in patched
    text = (csrc / "mxu_block.cuh").read_text()
    for cond in ("QT_ABL < 2", "QT_ABL >= 3", "QT_ABL == 3", "QT_ABL < 5"):
        assert f"#if {cond}" in text, ("mxu_block.cuh", cond)
    assert (csrc / "sharded_mxu.cu").read_text().count(
        "#if QT_ABL >= 1") == 3
    for anchor in (PA._S_FWD_WIDE_B6, PA._S_INV_WIDE_B6):
        assert ("#if QT_ABL >= 1\n" + anchor in
                (csrc / "ntt_mxu.cu").read_text())
    (csrc / "mxu_compact.cuh").unlink()
    with pytest.raises(RuntimeError, match="anchor found"):
        PA.patch_sources(csrc)


def test_sass_diff_matches_stream_modes_across_trees(monkeypatch, capsys):
    """``utils/sass_diff.py`` names the stream kernel's instantiations
    alike whether the mode is a bool (B5 and B9 before B6 and B8 joined
    them) or an int, and B1's pass kernel alike before and after B4 joined
    it (an operand count of 2) and before and after the cluster form (its
    block form the bool 0, a cluster 1), and prints the kernels an older tree
    compiled (B8's ``mxu_kernel<1>``, B6's ``mxu_kernel<2>``, B7's
    ``mxu_kernel<3>``, B4's ``polymul_fixed_fused_kernel``) beside the
    instantiations that run their work now."""
    from qtesla_tpu_torch.utils import sass_diff as SD
    prefix = "_ZN43_GLOBAL__N__9d88d42b_10_ntt_mxu_cu_bc5b174f"
    stream = "21polymul_stream_kernel"
    passes = "19polymul_pass_kernel"
    for mangled, name in (
            (stream + "ILi4ELb1EEEvPKj", "polymul_stream_kernel<4,1>"),
            (stream + "ILi4ELi1EEEvPKj", "polymul_stream_kernel<4,1>"),
            (stream + "ILi2ELi3EEEvPKj", "polymul_stream_kernel<2,3>"),
            (stream + "ILi3ELi4EEEvPKj", "polymul_stream_kernel<3,4>"),
            ("10mxu_kernelILi3EEEvPKjPj", "mxu_kernel<3>"),
            # B1 before B4 joined its kernel, then B1 and B4, then their
            # block forms and a cluster form
            (passes + "ILi32ELi2ELi10EEEvPKj",
             "polymul_pass_kernel<32,2,10,2,0>"),
            (passes + "ILi32ELi2ELi10ELi2EEEvPKj",
             "polymul_pass_kernel<32,2,10,2,0>"),
            (passes + "ILi32ELi2ELi10ELi1EEEvPKj",
             "polymul_pass_kernel<32,2,10,1,0>"),
            (passes + "ILi32ELi2ELi10ELi1ELb0EEEvPKj",
             "polymul_pass_kernel<32,2,10,1,0>"),
            (passes + "ILi32ELi4ELi0ELi2ELb1EEEvPKj",
             "polymul_pass_kernel<32,4,0,2,1>"),
            ("26polymul_fixed_fused_kernelPKjS1_Pj",
             "polymul_fixed_fused_kernel")):
        assert SD._name(SD._KERNEL.search(prefix + mangled)) == name
    old = {"mxu_kernel<1>": ["IMAD"] * 5, "mxu_kernel<2>": ["IMAD"] * 4,
           "mxu_kernel<3>": ["HMMA"] * 3,
           "polymul_stream_kernel<3,0>": ["IMAD"] * 2,
           "polymul_fixed_fused_kernel": ["BAR"] * 9,
           "polymul_pass_kernel<32,2,10,2,0>": ["IMAD"] * 4}
    new = {"polymul_stream_kernel<3,0>": ["IMAD"] * 2,
           "polymul_stream_kernel<3,2>": ["IMAD"] * 7,
           "polymul_stream_kernel<4,2>": ["IMAD"] * 8,
           "polymul_stream_kernel<3,3>": ["IMAD"] * 6,
           "polymul_stream_kernel<3,4>": ["IMAD"] * 5,
           "polymul_pass_kernel<32,2,10,2,0>": ["IMAD"] * 4,
           "polymul_pass_kernel<32,2,10,1,0>": ["IMAD"] * 3,
           "polymul_pass_kernel<32,3,0,1,1>": ["IMAD"] * 9}
    monkeypatch.setattr(SD, "_library", lambda tree: tree.name)
    monkeypatch.setattr(SD, "kernel_sass",
                        lambda lib: old if lib == "old" else new)
    assert SD.main(["old", "new"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "mxu_kernel<3>: old 3, new 0; {'HMMA': -3}" in out
    assert "polymul_stream_kernel<3,0>: old 2, new 2" in out
    assert "polymul_pass_kernel<32,2,10,2,0>: old 4, new 4" in out
    assert ("B8: old mxu_kernel<1> 5, new polymul_stream_kernel<3,2> 7, "
            "polymul_stream_kernel<4,2> 8") in out
    assert "B6: old mxu_kernel<2> 4, new polymul_stream_kernel<3,3> 6" in out
    assert "B7: old mxu_kernel<3> 3, new polymul_stream_kernel<3,4> 5" in out
    assert ("B4: old polymul_fixed_fused_kernel 9, new "
            "polymul_pass_kernel<32,2,10,1,0> 3") in out
    assert not any(line.startswith("B9:") for line in out)


def test_sass_diff_names_b2_and_b14_across_trees(monkeypatch, capsys):
    """``utils/sass_diff.py`` names B2's pass kernel
    ``transform_pass_kernel<1,..>`` (a tree's before the cluster form as
    its block form, ``<1,..,0>``) and B14's row kernel
    ``seg2_compact_kernel<4,..>``, and prints the kernels the tree before
    they moved compiled for them (``ntt_fused_kernel``,
    ``sp_kernel<4,threads>``) beside those instantiations."""
    from qtesla_tpu_torch.utils import sass_diff as SD
    prefix = "_ZN43_GLOBAL__N__9d88d42b_10_ntt_fused_cu_bc5b174f"
    for mangled, name in (
            ("21transform_pass_kernelILb1ELi32ELi2ELi10EEEvPKj",
             "transform_pass_kernel<1,32,2,10,0>"),
            ("21transform_pass_kernelILb1ELi32ELi4ELi0ELb1EEEvPKj",
             "transform_pass_kernel<1,32,4,0,1>"),
            ("19seg2_compact_kernelILi4ELb1ELi3ELb1EEEvPKj",
             "seg2_compact_kernel<4,1,3,1>"),
            ("9sp_kernelILi4ELi128EEEvPKj", "sp_kernel<4,128>"),
            ("16ntt_fused_kernelPKjS1_Pj", "ntt_fused_kernel")):
        assert SD._name(SD._KERNEL.search(prefix + mangled)) == name
    old = {"ntt_fused_kernel": ["BAR"] * 9, "sp_kernel<4,128>": ["HMMA"] * 7,
           "transform_pass_kernel<0,32,2,10,0>": ["IMAD"] * 2}
    new = {"transform_pass_kernel<0,32,2,10,0>": ["IMAD"] * 2,
           "transform_pass_kernel<1,32,2,10,0>": ["IMAD"] * 3,
           "transform_pass_kernel<1,32,3,0,0>": ["IMAD"] * 4,
           "seg2_compact_kernel<4,1,3,1>": ["IMMA"] * 5}
    monkeypatch.setattr(SD, "_library", lambda tree: tree.name)
    monkeypatch.setattr(SD, "kernel_sass",
                        lambda lib: old if lib == "old" else new)
    assert SD.main(["old", "new"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "transform_pass_kernel<0,32,2,10,0>: old 2, new 2" in out
    assert ("B2: old ntt_fused_kernel 9, new transform_pass_kernel<1,32,2,10,0> "
            "3, transform_pass_kernel<1,32,3,0,0> 4") in out
    assert ("B14: old sp_kernel<4,128> 7, new seg2_compact_kernel<4,1,3,1> 5"
            in out)


# every set with each model axis its four-step split takes
SP_CASES = [(name, k) for name in SETS for k in (2, 4, 8)
            if not (name == "smallprime" and k == 8)]


@pytest.mark.parametrize("name,k", SP_CASES)
def test_sp_plan_matches_kernel_limits(name, k):
    """Every SP plan fits the segment kernels: at most 4 classes and 6
    planes, class bounds below 2^24, tiles of 8..128 lanes, depths padded
    to 32, and seg2's rows split evenly between x and y; the fixed (B13),
    forward (B14), folded (B15) and p3x segments too."""
    plans = fourstep_mxu_plans(name, 1 << (get_tables(name).logn // 2), k)
    assert set(S.SEGMENTS) == set(S.KERNELS) | {"sp_seg3 p3x"}
    for seg, digit in (("sp_seg1", [plans.p1]),
                       ("sp_seg2", [plans.p2f, plans.p2i]),
                       ("sp_seg3", [plans.p3]),
                       ("sp_seg2_fixed", [plans.p2f, plans.p2i]),
                       ("sp_seg2_fwd", [plans.p2f]),
                       ("sp_seg2_folded", [plans.p2x]),
                       ("sp_seg3 p3x", [plans.p3x])):
        plan = S.plan_for(plans, seg)
        assert plan.rows % (2 if seg == "sp_seg2" else 1) == 0
        assert 0 < plan.rows <= 32 and plan.rows * plans.nloc * 4 <= 128 << 10
        assert (plan.nloc, plan.tw, plan.a, plan.lr) == (
            plans.nloc, plans.TW, plans.A, plans.Lr)
        assert (1 << plan.logm) << plan.llanes == plans.nloc
        for i, p in enumerate(digit, 1):
            din, kp = getattr(plan, f"din{i}"), getattr(plan, f"kp{i}")
            assert din == p.din <= 6 and kp % 32 == 0
            assert din * plans.TW <= kp < din * plans.TW + 32
            assert max(p.bounds) < 1 << 24
        if len(digit) == 1:
            assert (plan.din2, plan.kp2) == (0, 0)
    assert 8 <= plans.TW <= 128


# every set of at most 3 digit classes with each model axis its split takes,
# and n = 8192 at k = 4
CLASS_CASES = [(name, k) for name, k in SP_CASES
               if name not in FOUR_CLASS_SETS] + [(WIDE[0], 4)]


@pytest.mark.parametrize("name,k", CLASS_CASES)
def test_class_plan_matches_kernel_limits(name, k):
    """Every class plan fits B17 and B18: at most 3 classes, B18's class
    bounds below 2^24 and at most 18 planes; each of its warps 8 + 8 rows of
    one n2-block, the two compact depths padded to 32, the tables in shared
    memory where they leave room for 8 warps' planes, and at least one warp
    fitting a block either way; B17 takes B11's compact plan (p1's split,
    K1's blocks) with the rows and route that leave room for its staged
    class sums (D planes of rows of TW + 2 words) and p1's class
    bounds."""
    n1 = 1 << (get_tables(name).logn // 2)
    plans = fourstep_mxu_plans(name, n1, k)
    cp = class_boundary_plan(name, n1, k)
    p1 = C.plan_for(plans, cp, "sp_seg1_classes")
    p2 = C.plan_for(plans, cp, "sp_seg2_classes")
    TW, D = plans.TW, cp.Dout
    assert D == plans.p1.W.shape[-1] // TW <= 3 and max(cp.bounds) < 1 << 24
    assert isinstance(p1, S.SpCompactPlan)
    p11 = S.seg1_compact_plan(plans)
    for f, _ in S.SpCompactPlan._fields_:
        got, want = getattr(p1, f), getattr(p11, f)
        if f in ("c1", "c2"):
            got, want = ([getattr(c, g) for g, _ in S.CompactDims._fields_]
                         for c in (got, want))
        if f in ("pw", "pw_sh", "cls_b"):
            got, want = list(got), list(want)
        if f == "cls_b":
            assert got[:D] == cp.cls_b == list(plans.p1.bounds)
            assert want == [0] * 3
        elif f not in ("rows", "smem_tables"):
            assert got == want, f
    # two row buffers, the staged class sums, a tile's planes, the tables
    c = p1.c1
    assert p1.d == D <= 3 and 0 < p1.rows <= 32

    def smem(rows, tables):
        return (2 * rows * plans.nloc * 4 + D * rows * (TW + 2) * 4
                + -(-rows // 16) * 16 * S.planes_stride(TW >> c.ls, c.kp)
                + tables * plans.A * D * TW * c.kp)

    assert smem(p1.rows, p1.smem_tables) + 1024 <= 233472
    assert p1.smem_tables == (name != WIDE[0])
    if (name, k) == ("qtesla-iii-speed", 4):
        # one block of 32 rows: two of 16 leave no room for the staging
        assert (p1.rows, p1.smem_tables, 1 << c.ls, c.kp) == (32, 1, 16, 64)
        assert 2 * (smem(16, 1) + 1024) > 233472
    assert p2.rows == 2 * C.WARP_ROWS == 16
    assert list(p2.cdin)[:D] == list(cp.dins) and p2.din1 == sum(cp.dins)
    assert p2.din1 <= 18 and (p2.kp1, p2.kp2) == (0, 0)
    s = max(plans.n2, 8)
    assert (1 << p2.c1.ls, 1 << p2.c2.ls) == (s, s) and TW % s == 0
    assert (p2.c1.llam, p2.c2.llam) == (0, 0) and 1 << p2.c1.lbk == TW
    assert (p2.c1.lq, p2.c2.lq) == (0, 0)
    for din, kp in ((p2.din1, p2.c1.kp), (plans.p2i.din, p2.c2.kp)):
        assert kp % 32 == 0 and din * s <= kp < din * s + 32
    assert p2.din2 == plans.p2i.din
    tables = D * s * (S.table_stride(p2.c1.kp) + S.table_stride(p2.c2.kp))
    warp = 16 * S.planes_stride(1, p2.c1.kp) + 8 * S.planes_stride(
        1, p2.c2.kp)
    assert p2.smem_tables == (name != WIDE[0])
    shared = 2 * s * 4 + p2.smem_tables * tables
    assert shared + (8 if p2.smem_tables else 1) * warp + 1024 <= 233472


@pytest.mark.parametrize("name,k", SP_CASES + [(w, 4) for w in WIDE_SETS])
def test_seg1_compact_plan_matches_kernel_limits(name, k):
    """B11's compact plan: the dense plan's split, blocks of max(Bk, 8)
    lanes in lambda-major order, the depth padded to 32, rows and route
    within a block's shared memory; the tables sit in shared memory at every
    shape but those whose shard tables pass 150 KiB."""
    plans = fourstep_mxu_plans(name, 1 << (get_tables(name).logn // 2), k)
    dense, plan = S.plan_for(plans, "sp_seg1"), S.seg1_compact_plan(plans)
    for f, _ in S.SpPlan._fields_:
        if f not in ("rows", "pw", "pw_sh"):
            assert getattr(plan, f) == getattr(dense, f), f
    s, kp = 1 << plan.c1.ls, plan.c1.kp
    assert s == min(plans.TW, max(plans.Bk, 8))
    assert (1 << plan.c1.llam, 1 << plan.c1.lbk) == (plans.n2k, plans.Bk)
    assert kp % 32 == 0 and plan.din1 * s <= kp < plan.din1 * s + 32
    tables = plans.A * plan.d * plans.TW * kp
    assert tuple(S.host_tables(plans).w1c.shape[1:]) == (
        plans.A, plans.TW // s, plan.d * s, kp)
    assert plan.smem_tables == (name not in WIDE_SETS
                                and (name, k) != ("qtesla-p-iii", 2))
    assert 0 < plan.rows <= 32
    smem = ((2 * plan.rows + 1) * plans.nloc * 4
            + -(-plan.rows // 16) * 16 * S.planes_stride(plans.TW // s, kp)
            + plan.smem_tables * tables)
    assert smem + 1024 <= 233472


@pytest.mark.parametrize("name,k", SP_CASES + [(w, 4) for w in WIDE_SETS])
def test_seg3_compact_plan_matches_kernel_limits(name, k):
    """B16's compact plans, p3 and p3x: the dense plan's split, K3's blocks
    in the layout of K1 (max(Bk, 8) lanes, lambda-major), the depth padded
    to 32, rows and route within a block's shared memory, and the same
    rows and route as B11 wherever the depth is B11's."""
    plans = fourstep_mxu_plans(name, 1 << (get_tables(name).logn // 2), k)
    tabs = S.host_tables(plans)
    p11 = S.seg1_compact_plan(plans)
    for folded, seg, w3c in ((False, "sp_seg3", tabs.w3c),
                             (True, "sp_seg3 p3x", tabs.w3xc)):
        dense, plan = S.plan_for(plans, seg), S.seg3_compact_plan(plans,
                                                                  folded)
        for f, _ in S.SpPlan._fields_:
            if f not in ("rows", "pw", "pw_sh"):
                assert getattr(plan, f) == getattr(dense, f), (seg, f)
        s, kp = 1 << plan.c1.ls, plan.c1.kp
        assert s == min(plans.TW, max(plans.Bk, 8))
        assert (plan.c1.ls, plan.c1.llam, plan.c1.lbk, plan.c1.lq) == (
            p11.c1.ls, p11.c1.llam, p11.c1.lbk, p11.c1.lq)
        assert plan.c1.lq == plan.c1.ls - 2
        assert kp % 32 == 0 and plan.din1 * s <= kp < plan.din1 * s + 32
        assert plan.din1 <= 4 if plan.lb1 == 8 else plan.din1 <= 6
        assert tuple(w3c.shape[1:]) == (plans.A, plans.TW // s, plan.d * s,
                                         kp)
        assert 0 < plan.rows <= 32
        tables = plans.A * plan.d * plans.TW * kp
        smem = ((2 * plan.rows + 1) * plans.nloc * 4
                + -(-plan.rows // 16) * 16 * S.planes_stride(plans.TW // s,
                                                             kp)
                + plan.smem_tables * tables)
        assert smem + 1024 <= 233472
        if kp == p11.c1.kp:
            assert (plan.rows, plan.smem_tables) == (p11.rows,
                                                     p11.smem_tables)
    if (name, k) == ("qtesla-iii-speed", 4):
        p16 = S.seg3_compact_plan(plans)
        assert (p16.rows, p16.smem_tables, 1 << p16.c1.ls, p16.c1.kp) == (
            16, 1, 16, 64)
        assert S.plan_for(plans, "sp_seg3").kp1 == 512


@pytest.mark.parametrize("name,k", SP_CASES + [(w, 4) for w in WIDE_SETS])
def test_seg2_compact_plan_matches_kernel_limits(name, k):
    """B12's plan: the dense plan's fields but its depths, one input plane
    split under p2f (4 planes of base 256: the byte permutes), each warp
    two units of 8 + 8 rows of one n2-block, K2f's and K2i's blocks of max(n2, 8) lanes
    in row order, the depths padded to 32, the tables in shared memory where
    they leave room for 8 warps' planes (everywhere but qtesla-p-iii, whose
    two-unit warps leave room for 5, and n = 8192), at least one warp
    fitting a block either way, and the classes the kernel's slots take (at
    most 4)."""
    plans = fourstep_mxu_plans(name, 1 << (get_tables(name).logn // 2), k)
    dense, plan = S.plan_for(plans, "sp_seg2"), S.seg2_compact_plan(plans)
    for f, _ in S.SpPlan._fields_:
        if f not in ("rows", "kp1", "kp2", "pw", "pw_sh"):
            assert getattr(plan, f) == getattr(dense, f), f
    assert list(plan.pw) == list(dense.pw)
    # two units of 8 rows of x and of y a warp
    assert (plan.rows, plan.kp1, plan.kp2) == (4 * S.WARP_ROWS, 0, 0)
    assert 1 <= plan.d <= 4 and plan.din1 == plans.p2f.din
    assert (list(plan.cdin), list(plan.clb), list(plan.cadd)) == (
        [plan.din1, 0, 0], [plan.lb1, 0, 0], [plan.add1, 0, 0])
    assert plan.lb1 == 8 and plan.din1 <= 4 and not hasattr(plan, "cls_b")
    s = max(plans.n2, 8)
    assert (1 << plan.c1.ls, 1 << plan.c2.ls) == (s, s) and plans.TW % s == 0
    for c in (plan.c1, plan.c2):
        assert (c.llam, c.lq, 1 << c.lbk) == (0, 0, plans.TW)
    for din, kp in ((plan.din1, plan.c1.kp), (plan.din2, plan.c2.kp)):
        assert kp % 32 == 0 and din * s <= kp < din * s + 32
    tabs = S.host_tables(plans)
    assert tuple(tabs.w2fc.shape) == (plans.TW // s, plan.d * s, plan.c1.kp)
    assert tuple(tabs.w2ic.shape[2:]) == (plans.TW // s, plan.d * s,
                                          plan.c2.kp)
    tables = plan.d * s * (S.table_stride(plan.c1.kp)
                           + S.table_stride(plan.c2.kp))
    # the planes of 16 + 16 rows and of 16 product rows
    warp = (32 * S.planes_stride(1, plan.c1.kp)
            + 16 * S.planes_stride(1, plan.c2.kp))
    assert plan.smem_tables == (2 * s * 4 + tables + 8 * warp + 1024
                                <= 233472)
    assert plan.smem_tables == (name not in WIDE_SETS + ["qtesla-p-iii"])
    shared = 2 * s * 4 + plan.smem_tables * tables
    assert shared + (8 if plan.smem_tables else 1) * warp + 1024 <= 233472
    if (name, k) == ("qtesla-iii-speed", 4):
        assert (s, plan.c1.kp, plan.c2.kp) == (32, 128, 96)
        assert (dense.kp1, dense.kp2) == (512, 384)


@pytest.mark.parametrize("name,k", SP_CASES + [(w, 4) for w in WIDE_SETS])
def test_seg2_fixed_compact_plan_matches_kernel_limits(name, k):
    """B13's plan: B12's split, layouts and depths over the same compact K2f
    and K2i, each warp 32 rows of x (two units' rows, each a product row),
    the spectrum's lanes beside the two const rows, the tables in shared
    memory where they leave room for 8 warps' planes (everywhere but
    qtesla-p-iii and n = 8192, and at qtesla-iii-speed, k = 4), at least one
    warp fitting a block either way, and at most the kernel's 4 slots."""
    plans = fourstep_mxu_plans(name, 1 << (get_tables(name).logn // 2), k)
    dense = S.plan_for(plans, "sp_seg2_fixed")
    plan, p12 = S.seg2_fixed_compact_plan(plans), S.seg2_compact_plan(plans)
    for f, _ in S.SpClassPlan._fields_:
        got, want = getattr(plan, f), getattr(p12, f)
        if f in ("c1", "c2"):
            got, want = ([getattr(c, g) for g, _ in S.CompactDims._fields_]
                         for c in (got, want))
        elif f in ("pw", "pw_sh", "cdin", "clb", "cadd"):
            got, want = list(got), list(want)
        if f != "smem_tables":
            assert got == want, f
    for f, _ in S.SpPlan._fields_:
        if f not in ("rows", "kp1", "kp2", "pw", "pw_sh"):
            assert getattr(plan, f) == getattr(dense, f), f
    assert (plan.rows, plan.kp1, plan.kp2) == (4 * S.WARP_ROWS, 0, 0)
    assert 1 <= plan.d <= 4 and plan.lb1 == 8 and plan.din1 <= 4
    s = 1 << plan.c1.ls
    tables = plan.d * s * (S.table_stride(plan.c1.kp)
                           + S.table_stride(plan.c2.kp))
    # the planes of 32 rows of x and of 32 product rows
    warp = 32 * (S.planes_stride(1, plan.c1.kp)
                 + S.planes_stride(1, plan.c2.kp))
    const = 3 * s * 4
    assert plan.smem_tables == (const + tables + 8 * warp + 1024 <= 233472)
    assert plan.smem_tables == (name not in WIDE_SETS + ["qtesla-p-iii"])
    shared = const + plan.smem_tables * tables
    assert shared + (8 if plan.smem_tables else 1) * warp + 1024 <= 233472
    if (name, k) == ("qtesla-iii-speed", 4):
        assert (s, plan.c1.kp, plan.c2.kp, plan.smem_tables) == (32, 128, 96,
                                                                 1)


@pytest.mark.parametrize("name,k", SP_CASES + [(w, 4) for w in WIDE_SETS])
def test_seg2_folded_compact_plan_matches_kernel_limits(name, k):
    """B15's plan: the dense plan's fields but its depths, one input plane
    split under p2x, each warp 32 rows of x through one product against the
    constant's block of F (blocks of max(n2, 8) lanes in row order, the
    depth padded to 32), one const row, no second split (din2 0, c2 all 0),
    the table in shared memory where it leaves room for 8 warps' planes
    (everywhere but n = 8192), at least one warp fitting a block either way,
    and at most the kernel's 4 slots; the compact operand has the blocks'
    shape the kernel indexes."""
    plans = fourstep_mxu_plans(name, 1 << (get_tables(name).logn // 2), k)
    dense = S.plan_for(plans, "sp_seg2_folded")
    plan = S.seg2_folded_compact_plan(plans)
    for f, _ in S.SpPlan._fields_:
        if f not in ("rows", "kp1", "kp2", "pw", "pw_sh"):
            assert getattr(plan, f) == getattr(dense, f), f
    assert list(plan.pw) == list(dense.pw)
    assert (plan.rows, plan.kp1, plan.kp2) == (4 * S.WARP_ROWS, 0, 0)
    assert 1 <= plan.d <= 4 and plan.d == plans.p2x.Dout
    assert plan.din1 == plans.p2x.din and plan.lb1 == 8
    assert (plan.din2, plan.lb2, plan.add2) == (0, 0, 0)
    assert (list(plan.cdin), list(plan.clb), list(plan.cadd)) == (
        [plan.din1, 0, 0], [plan.lb1, 0, 0], [plan.add1, 0, 0])
    assert [getattr(plan.c2, f) for f, _ in S.CompactDims._fields_] == [0] * 5
    s = 1 << plan.c1.ls
    assert s == min(plans.TW, max(plans.n2, 8))
    assert (plan.c1.llam, plan.c1.lq, 1 << plan.c1.lbk) == (0, 0, plans.TW)
    assert plan.c1.kp % 32 == 0 and plan.din1 * s <= plan.c1.kp < (
        plan.din1 * s + 32)
    table = plan.d * s * S.table_stride(plan.c1.kp)
    warp = 32 * S.planes_stride(1, plan.c1.kp)
    const = s * 4
    assert plan.smem_tables == (const + table + 8 * warp + 1024 <= 233472)
    assert plan.smem_tables == (name not in WIDE_SETS)
    assert const + plan.smem_tables * table + (
        8 if plan.smem_tables else 1) * warp + 1024 <= 233472
    W, c = fourstep_fold_tables(plans, np.zeros(plans.n, dtype=np.uint32))
    fold = S.fold_sp_operand(W, c, plans, "cpu")
    assert tuple(fold.w.shape) == (k, plans.A, plans.TW // s, plan.d * s,
                                   plan.c1.kp)
    assert tuple(fold.c.shape) == (k, plans.A, plans.TW)
    if (name, k) == ("qtesla-iii-speed", 4):
        assert (s, plan.c1.kp, plan.d, dense.kp1) == (32, 96, 3, 384)
        assert table == 9216


@pytest.mark.parametrize("name,k", SP_CASES + [(w, 4) for w in WIDE_SETS])
def test_seg2_fwd_compact_plan_matches_kernel_limits(name, k):
    """B14's plan: the dense plan's fields but its depths, one input plane
    split under p2f, each warp 32 rows of x through one product against
    K2f's block (B12's compact first table ``tabs.w2fc`` and its split and
    depth), one const row, no second split (din2 0, c2 all 0), the table in
    shared memory where it leaves room for 8 warps' planes (everywhere but
    n = 8192), at least one warp fitting a block either way, and at most
    the kernel's 4 slots."""
    plans = fourstep_mxu_plans(name, 1 << (get_tables(name).logn // 2), k)
    dense = S.plan_for(plans, "sp_seg2_fwd")
    plan, p12 = S.seg2_fwd_compact_plan(plans), S.seg2_compact_plan(plans)
    for f, _ in S.SpPlan._fields_:
        if f not in ("rows", "kp1", "kp2", "pw", "pw_sh"):
            assert getattr(plan, f) == getattr(dense, f), f
    assert list(plan.pw) == list(dense.pw)
    assert (plan.rows, plan.kp1, plan.kp2) == (4 * S.WARP_ROWS, 0, 0)
    # B12's first product: its split, layout and depth
    for f in ("d", "din1", "lb1", "add1", "kb1"):
        assert getattr(plan, f) == getattr(p12, f), f
    assert 1 <= plan.d <= 4 and plan.din1 == plans.p2f.din
    assert bytes(plan.c1) == bytes(p12.c1)
    assert (plan.din2, plan.lb2, plan.add2, plan.kb2) == (0, 0, 0, 0)
    assert (list(plan.cdin), list(plan.clb), list(plan.cadd)) == (
        [plan.din1, 0, 0], [plan.lb1, 0, 0], [plan.add1, 0, 0])
    assert [getattr(plan.c2, f) for f, _ in S.CompactDims._fields_] == [0] * 5
    s = 1 << plan.c1.ls
    table = plan.d * s * S.table_stride(plan.c1.kp)
    warp = 32 * S.planes_stride(1, plan.c1.kp)
    const = s * 4
    assert plan.smem_tables == (const + table + 8 * warp + 1024 <= 233472)
    assert plan.smem_tables == (name not in WIDE_SETS)
    assert const + plan.smem_tables * table + (
        8 if plan.smem_tables else 1) * warp + 1024 <= 233472
    assert tuple(S.host_tables(plans).w2fc.shape) == (plans.TW // s,
                                                      plan.d * s, plan.c1.kp)
    if (name, k) == ("qtesla-iii-speed", 4):
        assert (s, plan.c1.kp, plan.d, dense.kp1) == (32, 128, 3, 512)
        # the block's 12 KiB of K2f, rows padded to 160 bytes
        assert table == 15360 and plan.d * s * plan.c1.kp == 12288


def test_sp_wrappers_reject_bad_input():
    plans = fourstep_mxu_plans("smallprime", 4, 2)
    nloc = plans.nloc
    x = _u32(2 * 3, nloc).reshape(2, 3, nloc)
    with pytest.raises(TypeError, match="uint32"):
        S.sp_seg1(x.to(torch.int64), plans)
    with pytest.raises(ValueError, match=f"n={nloc}"):
        S.sp_seg3(_u32(6, 2 * nloc).reshape(2, 3, 2 * nloc), plans)
    with pytest.raises(ValueError, match="shards"):
        S.sp_seg1(x[0], plans)
    with pytest.raises(ValueError, match="model axis"):
        S.sp_seg1(x, plans, first=1)
    with pytest.raises(ValueError, match="shards on"):
        S.sp_seg2(x, x[:, :2].contiguous(), plans)
    meta = torch.empty((2, 3, nloc), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="device"):
        S.sp_seg1(meta, plans)
    tabs = S.host_tables(plans)
    bad = S.SpDeviceTables(tabs.w1.to(torch.int32), *tabs.tensors()[1:])
    with pytest.raises(ValueError, match="SP tables"):
        S.sp_seg1(x, plans, tabs=bad)
    fn = S.polymul_fourstep_mxu_fn("smallprime", make_mesh(model=2))
    with pytest.raises(ValueError, match="mesh on cuda"):
        fn(_u32(2, 32), _u32(2, 32))
    with pytest.raises(ValueError, match="differ"):
        S.polymul_fourstep_mxu_fn("smallprime", make_mesh(
            model=2, device="cpu"))(_u32(2, 32), _u32(3, 32))


# ----------------------------------------------------------------------
# On the card.
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS + WIDE_SETS)
def test_kernels_match_plain_on_card(cuda_device, name):
    tbl = get_tables(name)
    q, n = tbl.q, tbl.n
    rng = np.random.default_rng(21)
    for batch in (1, 3, 64):
        xy = rng.integers(0, q, (2, batch, n), dtype=np.uint32)
        xy[0, 0] = q - 1
        lazy = rng.integers(0, 2 * q, (batch, n), dtype=np.uint32)
        x, y, lazy = (torch.from_numpy(v).to(cuda_device)
                      for v in (xy[0], xy[1], lazy))
        spec = F.ntt_plain(y[:1], tbl)
        before = {k: v.launches for k, v in F.KERNELS.items()}
        pairs = [
            (F.polymul_fused(x, y, tbl), F.polymul_plain(x, y, tbl)),
            (F.polymul_fixed_fused(x, spec, tbl),
             F.polymul_fixed_plain(x, spec, tbl)),
            (F.ntt_fused(x, tbl), F.ntt_plain(x, tbl)),
            (F.intt_fused(lazy, tbl), F.intt_plain(lazy, tbl)),
        ]
        torch.cuda.synchronize()
        for got, want in pairs:
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          want.cpu().numpy())
        assert all(v.launches == before[k] + 1
                   for k, v in F.KERNELS.items())
    # B1's register passes over many blocks, rows of 0 and q - 1 in both
    xy = rng.integers(0, q, (2, 9000, n), dtype=np.uint32)
    xy[:, 0], xy[:, 1], xy[0, 2], xy[1, 3] = 0, q - 1, 0, q - 1
    x, y = (torch.from_numpy(v).to(cuda_device) for v in xy)
    np.testing.assert_array_equal(F.polymul_fused(x, y, tbl).cpu().numpy(),
                                  F.polymul_plain(x, y, tbl).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS + WIDE_SETS)
def test_mxu_kernels_match_plain_on_card(cuda_device, name):
    """B5-B8 against their twins; B7 takes inputs below pw_bound; B5, B6, B8
    and B9 also at 9000 rows, so that every persistent block walks several
    row groups through the ring of table stages, with rows of q - 1 and B8
    against a spectrum that holds q - 1 and one that is all q - 1."""
    mt = get_mxu_tables(name)
    q, n = mt.q, mt.n
    rng = np.random.default_rng(22)
    xy = rng.integers(0, q, (2, 9000, n), dtype=np.uint32)
    xy[0, ::97] = q - 1
    xy = torch.from_numpy(xy).to(cuda_device)
    spec = M.ntt_mxu_plain(xy[1, :1], mt).cpu().numpy()
    spec[0, ::5] = q - 1
    for sp in (spec, np.full((1, n), q - 1, dtype=np.uint32)):
        sp = torch.from_numpy(sp).to(cuda_device)
        want = M.polymul_fixed_mxu_plain(xy[0], sp, mt)
        before = M.KERNELS["polymul_fixed_mxu"].launches
        got = M.polymul_fixed_mxu(xy[0], sp, mt)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
        assert M.KERNELS["polymul_fixed_mxu"].launches == before + 1
    want = M.ntt_mxu_plain(xy[0], mt)
    before = M.KERNELS["ntt_mxu"].launches
    got = M.ntt_mxu(xy[0], mt)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert M.KERNELS["ntt_mxu"].launches == before + 1
    want = M.polymul_mxu_plain(xy[0], xy[1], mt)
    before = M.KERNELS["polymul_mxu"].launches
    got = M.polymul_mxu(xy[0], xy[1], mt)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert M.KERNELS["polymul_mxu"].launches == before + 1
    op = M.fold_operand(M.ntt_mxu_plain(xy[1, :1], mt), mt)
    want = M.polymul_fixed_folded_mxu_plain(xy[0], op, mt)
    before = M.KERNELS["polymul_fixed_folded_mxu"].launches
    got = M.polymul_fixed_folded_mxu(xy[0], op, mt)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert M.KERNELS["polymul_fixed_folded_mxu"].launches == before + 1
    for batch in (1, 3, 64):
        xy = rng.integers(0, q, (2, batch, n), dtype=np.uint32)
        xy[0, 0] = q - 1
        lazy = rng.integers(0, mt.pw_bound, (batch, n), dtype=np.uint32)
        lazy[0] = mt.pw_bound - 1
        x, y, lazy = (torch.from_numpy(v).to(cuda_device)
                      for v in (xy[0], xy[1], lazy))
        spec = M.ntt_mxu_plain(y[:1], mt)
        before = {k: v.launches for k, v in M.KERNELS.items()}
        pairs = [
            (M.polymul_mxu(x, y, mt), M.polymul_mxu_plain(x, y, mt)),
            (M.polymul_fixed_mxu(x, spec, mt),
             M.polymul_fixed_mxu_plain(x, spec, mt)),
            (M.ntt_mxu(x, mt), M.ntt_mxu_plain(x, mt)),
            (M.intt_mxu(lazy, mt), M.intt_mxu_plain(lazy, mt)),
        ]
        torch.cuda.synchronize()
        for got, want in pairs:
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          want.cpu().numpy())
        assert all(M.KERNELS[k].launches == before[k] + 1
                   for k in ("polymul_mxu", "polymul_fixed_mxu", "ntt_mxu",
                             "intt_mxu"))


# B5-B9's split form (ops/ntt_mxu_split.py): (name, n, q), the rings past
# one block's reach at q = 786433 and at the 30-bit prime
SPLIT_RINGS = (("split-n32768", 32768, 786433),
               ("q30-n65536", 65536, 1073479681))


@pytest.mark.cuda
@pytest.mark.parametrize("ring", SPLIT_RINGS, ids=lambda r: r[0])
def test_mxu_split_kernels_match_plain_on_card(cuda_device, ring):
    """B5-B9 in the split form against their twins at B in {1, 3, 64},
    row 0 all q - 1 (B7: pw_bound - 1), the constant all q - 1 in B8 and
    B9; each call launches its mode's split kernel once and B2's and B3's
    sweeps as ``split_launches`` says; intt(ntt(x)) == x."""
    register_param_set(*ring)
    mt = get_mxu_tables(ring[0])
    q, n = mt.q, mt.n
    rng = np.random.default_rng(23)
    counters = F.KERNELS | MS.KERNELS
    for batch in (1, 3, 64):
        xy = rng.integers(0, q, (2, batch, n), dtype=np.uint32)
        xy[:, 0] = q - 1
        lazy = rng.integers(0, mt.pw_bound, (batch, n), dtype=np.uint32)
        lazy[0] = mt.pw_bound - 1
        x, y, lz = (torch.from_numpy(v).to(cuda_device)
                    for v in (xy[0], xy[1], lazy))
        spec = torch.from_numpy(np.full((1, n), q - 1, dtype=np.uint32)).to(
            cuda_device)
        op = M.fold_operand(spec, mt)
        for mode, kern, plain, args in (
                ("product", M.polymul_mxu, M.polymul_mxu_plain, (x, y)),
                ("fixed", M.polymul_fixed_mxu, M.polymul_fixed_mxu_plain,
                 (x, spec)),
                ("folded", M.polymul_fixed_folded_mxu,
                 M.polymul_fixed_folded_mxu_plain, (x, op)),
                ("ntt", M.ntt_mxu, M.ntt_mxu_plain, (x,)),
                ("intt", M.intt_mxu, M.intt_mxu_plain, (lz,))):
            want = plain(*args, mt)
            before = {k: v.launches for k, v in counters.items()}
            got = kern(*args, mt)
            torch.cuda.synchronize()
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          want.cpu().numpy())
            moved = {k: v.launches - before[k] for k, v in counters.items()
                     if v.launches != before[k]}
            assert moved == {k: v for k, v in
                             MS.split_launches(n, mode).items() if v}
        assert torch.equal(M.intt_mxu(M.ntt_mxu(x, mt), mt), x)


# the column segments' split form (parallel/sp_column_split.py): (name, n,
# q, k), shard rows past one block's reach (nloc = 32768)
SP_SPLIT_RINGS = (("sp-split-n65536", 65536, 786433, 2),
                  ("sp-split-n131072", 131072, 786433, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("ring", SP_SPLIT_RINGS, ids=lambda r: r[0])
def test_sp_split_kernels_match_plain_on_card(cuda_device, ring):
    """B11, B16 (p3 and p3x) and B17 in their split form at n1 = n / 128
    against their compact twins at B in {1, 3, 37}, row 0 all q - 1: each
    call launches B2's (B16: B3's) sweeps and its tile kernel once, as
    ``split_launches`` says; the tile kernel alone equals its plain
    version."""
    from qtesla_tpu_torch.parallel.distributed import sp_n1
    name, n, q, k = ring
    register_param_set(name, n, q)
    plans = fourstep_mxu_plans(name, sp_n1(n), k)
    cp = class_boundary_plan(name, sp_n1(n), k)
    assert S.column_split(plans) and plans.nloc == 32768
    tabs = S.device_tables(plans, cuda_device)
    ctabs = C.class_device_tables(plans, cp, cuda_device)
    counters = F.KERNELS | SC.KERNELS
    rng = np.random.default_rng(24)
    sl = slice(0, k)
    for batch in (1, 3, 37):
        x = rng.integers(0, q, (k, batch, plans.nloc), dtype=np.uint32)
        x[:, 0] = q - 1
        x = torch.from_numpy(x).to(cuda_device)
        for seg, kern, plain in (
                ("sp_seg1", lambda t: S.sp_seg1(t, plans, tabs),
                 lambda t: S.seg1_compact_plain(t, plans, tabs)),
                ("sp_seg3", lambda t: S.sp_seg3(t, plans, tabs),
                 lambda t: S.seg3_compact_plain(t, plans, tabs)),
                ("sp_seg3", lambda t: S.sp_seg3(t, plans, tabs, folded=True),
                 lambda t: S.seg3_compact_plain(t, plans, tabs,
                                                folded=True)),
                ("sp_seg1_classes",
                 lambda t: C.sp_seg1_classes(t, plans, cp, ctabs),
                 lambda t: C.seg1_classes_compact_plain(t, plans, cp,
                                                        ctabs))):
            want = plain(x)
            before = {kk: v.launches for kk, v in counters.items()}
            got = kern(x)
            torch.cuda.synchronize()
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          want.cpu().numpy(), err_msg=seg)
            moved = {kk: v.launches - before[kk]
                     for kk, v in counters.items()
                     if v.launches != before[kk]}
            assert moved == SC.split_launches(plans, seg), seg
        v = SC.column_sweeps(x, plans, inverse=False)
        for seg in ("sp_seg1", "sp_seg3", "sp_seg3 p3x"):
            np.testing.assert_array_equal(
                SC.products(v, plans, tabs, sl, seg).cpu().numpy(),
                SC.products_plain(v, plans, tabs, sl, seg).cpu().numpy())
        np.testing.assert_array_equal(
            C.split_class_sums(v, plans, cp, ctabs, sl).cpu().numpy(),
            C.split_class_sums_plain(v, plans, cp, ctabs, sl).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS + WIDE_SETS)
def test_folded_and_pairing_kernels_match_plain_on_card(cuda_device, name):
    """B9 against its twin and B8, for a random, an all-0 and an all-(q-1)
    diagonal; each B10 pairing against its twin and B1."""
    tbl = get_tables(name)
    mt = get_mxu_tables(name)
    q, n = tbl.q, tbl.n
    rng = np.random.default_rng(23)
    kernels = [M.KERNELS["polymul_fixed_folded_mxu"], *P.KERNELS.values()]
    for batch in (1, 3, 64):
        xy = rng.integers(0, q, (2, batch, n), dtype=np.uint32)
        xy[0, 0] = q - 1
        x, y = (torch.from_numpy(v).to(cuda_device) for v in xy)
        before = [k.launches for k in kernels]
        pairs = []
        for spec in (M.ntt_mxu_plain(y[:1], mt),
                     torch.zeros(n, dtype=torch.uint32, device=cuda_device),
                     torch.full((n,), q - 1, dtype=torch.int64,
                                device=cuda_device).to(torch.uint32)):
            op = M.fold_operand(spec, mt)
            got = M.polymul_fixed_folded_mxu(x, op, mt)
            pairs += [(got, M.polymul_fixed_folded_mxu_plain(x, op, mt)),
                      (got, M.polymul_fixed_mxu(x, spec, mt))]
        ref = F.polymul_fused(x, y, tbl)
        for p in _PAIRING_NAMES:
            got = P.polymul_pairing(x, y, tbl, p)
            pairs += [(got, P.polymul_pairing_plain(x, y, tbl, p)),
                      (got, ref)]
        torch.cuda.synchronize()
        for got, want in pairs:
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          want.cpu().numpy())
        assert [k.launches - b for k, b in zip(kernels, before)] == \
            [3] + [1] * len(P.KERNELS)
    # the five pass kernels over many blocks, with rows of 0 and of q - 1
    # in both operands
    xy = rng.integers(0, q, (2, 9000, n), dtype=np.uint32)
    xy[:, 0], xy[:, 1], xy[0, 2], xy[1, 3] = 0, q - 1, 0, q - 1
    x, y = (torch.from_numpy(v).to(cuda_device) for v in xy)
    ref = F.polymul_fused(x, y, tbl)
    for p in P.PAIRINGS:
        got = P.polymul_pairing(x, y, tbl, p)
        for want in (P.polymul_pairing_plain(x, y, tbl, p), ref):
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          want.cpu().numpy())


# every length the pass plans take, q prime and 1 mod 2n; n = 8192 at the
# qtesla-iii-speed prime
_PASS_LENGTHS = [(2, 5), (4, 17), (8, 17), (16, 97), (32, 193), (64, 257),
                 (128, 257), (256, 7681), (512, 12289), (1024, 12289),
                 (2048, 12289), (4096, 40961), (8192, 8404993),
                 (16384, 786433)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,q", _PASS_LENGTHS)
def test_pass_kernels_at_other_lengths_on_card(cuda_device, n, q):
    """The five pairings' pass kernels and B1's at every length from 2 to
    16384 (R = n below 32, two passes of fewer than 32 threads a row, three
    passes of up to 512 threads) against their twins and B1's plain
    version, with rows of q - 1 in both operands."""
    name = f"pairing-n{n}"
    register_param_set(name, n, q)
    tbl = get_tables(name)
    rng = np.random.default_rng(n)
    xy = rng.integers(0, q, (2, 300, n), dtype=np.uint32)
    xy[:, 0], xy[0, 1], xy[1, 2] = q - 1, q - 1, q - 1
    x, y = (torch.from_numpy(v).to(cuda_device) for v in xy)
    ref = F.polymul_plain(x, y, tbl)
    np.testing.assert_array_equal(F.polymul_fused(x, y, tbl).cpu().numpy(),
                                  ref.cpu().numpy())
    for p in P.PAIRINGS:
        got = P.polymul_pairing(x, y, tbl, p)
        for want in (P.polymul_pairing_plain(x, y, tbl, p), ref):
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          want.cpu().numpy())


# lengths whose rows span a thread-block cluster: B1, B4 and the pairings
# at 32768-131072 (2, 4, 8 blocks), B2 and B3 at 65536-262144 (2, 4, 8)
_CLUSTER_LENGTHS = [(32768, 786433), (32768, 1073479681), (65536, 786433),
                    (65536, 1073479681), (131072, 786433), (262144, 7340033)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,q", _CLUSTER_LENGTHS)
def test_pass_kernels_in_a_cluster_on_card(cuda_device, n, q):
    """B1, B4, B2, B3 and the five pairings where a row spans a cluster of
    blocks, against their plain versions on 64 rows (3 at 262144, where
    only B2 and B3 have a plan), rows of q - 1 (B3: 2q - 1); one launch a
    call."""
    name = f"cluster-n{n}-q{q}"
    register_param_set(name, n, q)
    tbl = get_tables(name)
    rows = 3 if n > 131072 else 64
    rng = np.random.default_rng(n + q)
    xy = rng.integers(0, q, (2, rows, n), dtype=np.uint32)
    xy[:, 0] = q - 1
    lazy = rng.integers(0, 2 * q, (rows, n), dtype=np.uint32)
    lazy[0] = 2 * q - 1
    x, y, lazy = (torch.from_numpy(v).to(cuda_device)
                  for v in (xy[0], xy[1], lazy))

    def same(kname, got, want):
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy(),
                                      err_msg=f"{kname} n={n} q={q}")

    before = {k: v.launches for k, v in {**F.KERNELS, **P.KERNELS}.items()}
    same("B2", F.ntt_fused(x, tbl), F.ntt_plain(x, tbl))
    same("B3", F.intt_fused(lazy, tbl), F.intt_plain(lazy, tbl))
    calls = {"ntt_fused": 1, "intt_fused": 1}
    if n <= 131072:
        ref = F.polymul_plain(x, y, tbl)
        same("B1", F.polymul_fused(x, y, tbl), ref)
        spec = F.ntt_plain(y[:1], tbl)
        same("B4", F.polymul_fixed_fused(x, spec, tbl),
             F.polymul_fixed_plain(x, spec, tbl))
        for p in P.PAIRINGS:
            same(p, P.polymul_pairing(x, y, tbl, p), ref)
        calls |= {"polymul_fused": 1, "polymul_fixed_fused": 1,
                  **{f"polymul_pairing_{p}": 1 for p in P.PAIRINGS}}
    torch.cuda.synchronize()
    after = {k: v.launches for k, v in {**F.KERNELS, **P.KERNELS}.items()}
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == calls


@pytest.mark.cuda
def test_cluster_launchers_refuse_plans_they_cannot_run(cuda_device):
    """A cluster plan's launcher returns cudaErrorInvalidValue, and the
    wrapper raises, for a cross mask other than the exchanges' own, a
    cluster that is not a power of two up to 8 or does not hold the row
    in blocks of the kernel's threads, two rows a cluster, or too little
    shared memory a block; nothing is launched or counted."""
    n, q = 32768, 786433
    name = f"cluster-n{n}-q{q}"
    register_param_set(name, n, q)
    tbl = get_tables(name)
    x = torch.zeros((3, n), dtype=torch.uint32, device=cuda_device)
    tw = F._prepare(tbl, None, x)
    ptw = P.pairing_twiddles(tbl, cuda_device)

    def changed(plan, **fields):
        out = PassPlan.from_buffer_copy(plan)
        for f, v in fields.items():
            setattr(out, f, v)
        return out

    cases = [(F.KERNELS["polymul_fused"], tw, F.fused_pass_plan(n)),
             (F.KERNELS["polymul_fixed_fused"], tw, F.fixed_pass_plan(n)),
             (P.KERNELS["polymul_pairing_stockham"], ptw,
              P.pairing_pass_plan(n, "stockham"))]
    for kernel, table, plan in cases:
        assert plan.cluster == 2
        for fields in ({"cross": plan.cross ^ 2}, {"cross": 0},
                       {"cluster": 3}, {"cluster": 4}, {"cluster": 16},
                       {"cluster": 1}, {"rows": 2},
                       {"row_stride": plan.row_stride // 2}):
            before = kernel.launches
            with pytest.raises(RuntimeError, match="launch failed"):
                F._launch(kernel, tbl, table, x,
                          x if kernel.name != "polymul_fixed_fused"
                          else x[0], changed(plan, **fields))
            assert kernel.launches == before
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("n,q", [(2, 16417), (8, 16417), (16, 16417),
                                 (8, 1073479681), (16, 1073479681)])
def test_mxu_kernels_below_32_lanes_on_card(cuda_device, n, q):
    """B5-B9 at n <= 16, lane packed (32 / n rows a row of 32 lanes), on
    5 and 300 rows (batches that fill no whole packed row too), random and
    all q - 1 (B7 all pw_bound - 1), against their twins."""
    name = f"small-mxu-n{n}-q{q}"
    register_param_set(name, n, q)
    mt = get_mxu_tables(name)
    tbl = get_tables(name)
    rng = np.random.default_rng(n + q)
    for rows in (5, 300):
        for kind in ("random", "worst"):
            if kind == "random":
                xy = rng.integers(0, q, (2, rows, n), dtype=np.uint32)
                pw = rng.integers(0, mt.pw_bound, (rows, n), dtype=np.uint32)
            else:
                xy = np.full((2, rows, n), q - 1, dtype=np.uint32)
                pw = np.full((rows, n), mt.pw_bound - 1, dtype=np.uint32)
            x, y, pw = (torch.from_numpy(v).to(cuda_device)
                        for v in (xy[0], xy[1], pw))
            spec = F.ntt_plain(y[:1], tbl)
            op = M.fold_operand(spec, mt)
            for got, want in (
                    (M.polymul_mxu(x, y, mt), M.polymul_mxu_plain(x, y, mt)),
                    (M.ntt_mxu(x, mt), M.ntt_mxu_plain(x, mt)),
                    (M.intt_mxu(pw, mt), M.intt_mxu_plain(pw, mt)),
                    (M.polymul_fixed_mxu(x, spec, mt),
                     M.polymul_fixed_mxu_plain(x, spec, mt)),
                    (M.polymul_fixed_folded_mxu(x, op, mt),
                     M.polymul_fixed_folded_mxu_plain(x, op, mt))):
                np.testing.assert_array_equal(got.cpu().numpy(),
                                              want.cpu().numpy(),
                                              err_msg=f"{name} {rows} {kind}")


def _split(plan, n, sizes, fwd_up, inv_up, stockham=False):
    """``plan`` with the stages of n split as ``sizes``."""
    plan = PassPlan.from_buffer_copy(plan)
    plan.passes = len(sizes)
    L = n.bit_length() - 1
    for side, up in (("fwd", fwd_up), ("inv", inv_up)):
        for i, row in enumerate(schedule(L, 5, sizes, up, stockham)):
            for f, v in zip(("lo", "hi", "b"), row):
                getattr(plan, f"{side}_{f}")[i] = v
    return plan


@pytest.mark.cuda
def test_pass_kernels_under_another_split_on_card(cuda_device):
    """qtesla-i's stages split 4 + 5 (the planners make 5 + 4; Stockham's
    2 + 2 + 5, its planner 4 + 5), and B1's also 2 + 2 + 5: the launchers
    run any schedule their checks accept."""
    tbl = get_tables("qtesla-i")
    tw = P.pairing_twiddles(tbl, cuda_device)
    rng = np.random.default_rng(25)
    x, y = (torch.from_numpy(v).to(cuda_device) for v in rng.integers(
        0, tbl.q, (2, 300, tbl.n), dtype=np.uint32))
    for p, (fwd, inv) in P.PAIRINGS.items():
        stk = p == "stockham"
        plan = _split(P.pairing_pass_plan(512, p), 512,
                      [2, 2, 5] if stk else [4, 5], fwd == "dit",
                      inv == "dit", stk)
        got = F._launch(P.KERNELS[f"polymul_pairing_{p}"], tbl, tw, x, y,
                        plan)
        np.testing.assert_array_equal(
            got.cpu().numpy(), P.polymul_pairing_plain(x, y, tbl, p).cpu()
            .numpy())
    ftw = F._prepare(tbl, None, x)
    for sizes in ([4, 5], [2, 2, 5]):
        plan = _split(F.fused_pass_plan(512), 512, sizes, False, True)
        got = F._launch(F.KERNELS["polymul_fused"], tbl, ftw, x, y, plan)
        np.testing.assert_array_equal(
            got.cpu().numpy(), F.polymul_plain(x, y, tbl).cpu().numpy())


@pytest.mark.cuda
def test_pass_launchers_refuse_plans_they_cannot_run(cuda_device):
    """A pass kernel's launcher (the five pairings, B1) returns
    cudaErrorInvalidValue for a plan it cannot run (radix, threads, rows,
    block size, passes, a stage outside its window, a gap between passes, a
    first window other than where the load or the product leaves the row,
    too little or too much shared memory; Stockham also a window other than
    its own), and the wrapper raises it: nothing is launched, nothing
    counted."""
    tbl = get_tables("qtesla-iii-speed")
    tw = P.pairing_twiddles(tbl, cuda_device)
    x = torch.zeros((3, tbl.n), dtype=torch.uint32, device=cuda_device)

    def changed(plan, **fields):
        out = type(plan).from_buffer_copy(plan)
        for f, v in fields.items():
            if isinstance(v, tuple):
                getattr(out, f)[v[0]] = v[1]
            else:
                setattr(out, f, v)
        return out

    cases = [(P.KERNELS[f"polymul_pairing_{p}"], tw,
              P.pairing_pass_plan(tbl.n, p)) for p in P.PAIRINGS]
    cases.append((F.KERNELS["polymul_fused"], F._prepare(tbl, None, x),
                  F.fused_pass_plan(tbl.n)))
    for kernel, table, plan in cases:
        for fields in ({"radix": 16}, {"radix": 64}, {"threads": 64},
                       {"rows": 0}, {"rows": 9}, {"rows": 16},
                       {"passes": 3}, {"passes": 1}, {"fwd_b": (0, 3)},
                       {"fwd_b": (1, 2)}, {"inv_b": (0, 6)},
                       {"fwd_lo": (1, 6)}, {"inv_hi": (1, 9)},
                       {"row_stride": 2000}, {"row_stride": 1 << 20}):
            before = kernel.launches
            with pytest.raises(RuntimeError, match="launch failed"):
                F._launch(kernel, tbl, table, x, x, changed(plan, **fields))
            assert kernel.launches == before
        # the plan as made launches
        F._launch(kernel, tbl, table, x, x, plan)
        assert kernel.launches == before + 1
    # Stockham refuses qtesla-i split 2 + 2 + 5 under the cyclic windows
    # (its middle pass's window would not end at its widest stage), which
    # gs_gs runs
    tbl = get_tables("qtesla-i")
    tw = P.pairing_twiddles(tbl, cuda_device)
    x = torch.zeros((3, tbl.n), dtype=torch.uint32, device=cuda_device)
    plan = _split(P.pairing_pass_plan(512, "stockham"), 512, [2, 2, 5],
                  False, False)
    kernel = P.KERNELS["polymul_pairing_stockham"]
    with pytest.raises(RuntimeError, match="launch failed"):
        F._launch(kernel, tbl, tw, x, x, plan)
    F._launch(P.KERNELS["polymul_pairing_gs_gs"], tbl, tw, x, x, plan)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS + WIDE_SETS)
def test_b4_b7_match_plain_on_card(cuda_device, name):
    """B4 (B1's register passes with one operand) and B7 (the stream
    kernel's inverse mode) against their twins at B in {1, 3, 64, 9000}
    (at 9000 every persistent B7 block walks several row groups): B4 on x
    with rows of q - 1 against a spectrum that holds q - 1, the all-(q-1)
    one and one not 16-byte aligned; B7 on lazy rows below pw_bound, some
    at pw_bound - 1.  Each call launches its kernel once."""
    tbl = get_tables(name)
    mt = get_mxu_tables(name)
    q, n = tbl.q, tbl.n
    rng = np.random.default_rng(26)
    b4, b7 = F.KERNELS["polymul_fixed_fused"], M.KERNELS["intt_mxu"]
    for batch in (1, 3, 64, 9000):
        x = rng.integers(0, q, (batch, n), dtype=np.uint32)
        x[::97] = q - 1
        spec = rng.integers(0, q, n + 1, dtype=np.uint32)
        spec[::5] = q - 1
        lazy = rng.integers(0, mt.pw_bound, (batch, n), dtype=np.uint32)
        lazy[::89] = mt.pw_bound - 1
        x, spec, lazy = (torch.from_numpy(v).to(cuda_device)
                         for v in (x, spec, lazy))
        full = torch.full((n,), q - 1, dtype=torch.int64,
                          device=cuda_device).to(torch.uint32)
        for sp in (spec[:n], full, spec[1:]):
            before = b4.launches
            got = F.polymul_fixed_fused(x, sp, tbl)
            torch.cuda.synchronize()
            np.testing.assert_array_equal(
                got.cpu().numpy(),
                F.polymul_fixed_plain(x, sp, tbl).cpu().numpy(),
                err_msg=f"B4 B={batch}")
            assert b4.launches == before + 1
        before = b7.launches
        got = M.intt_mxu(lazy, mt)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(
            got.cpu().numpy(), M.intt_mxu_plain(lazy, mt).cpu().numpy(),
            err_msg=f"B7 B={batch}")
        assert b7.launches == before + 1


@pytest.mark.cuda
def test_b4_b7_launchers_refuse_plans_they_cannot_run(cuda_device):
    """B7's launcher returns cudaErrorInvalidValue for a plan with forward
    stages (B8's), the wrong inverse stages, a ring of one stage or one too
    deep for shared memory, or rows that fill no MMA tile; B4's for a plan
    whose rows hold less shared memory than one operand's exchange, or
    that is not B1's schedule (radix, passes, threads, rows, windows).  The
    wrappers raise, nothing is counted, and the plans as made (B4 also
    under B1's plan, which holds room for two operands) launch."""
    tbl = get_tables("qtesla-iii-speed")
    mt = get_mxu_tables("qtesla-iii-speed")
    x = torch.zeros((3, tbl.n), dtype=torch.uint32, device=cuda_device)
    tabs, tw = M._prepare(mt, None, None, x)

    def changed(plan, **fields):
        out = type(plan).from_buffer_copy(plan)
        for f, v in fields.items():
            if isinstance(v, tuple):
                getattr(out, f)[v[0]] = v[1]
            else:
                setattr(out, f, v)
        return out

    b7, plan = M.KERNELS["intt_mxu"], M.stream_plan(mt, "intt")
    assert (plan.stages_f, plan.stages_i, plan.ring) == (0, 6, 3)
    for fields in ({"stages_f": 8}, {"stages_i": 5}, {"stages_i": 0},
                   {"ring": 1}, {"ring": 4}, {"rows": 24}):
        before = b7.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            M._launch(b7, mt, changed(plan, **fields), tw, x, None,
                      wf=tabs.stream, cf=None, ci=tabs.consti)
        assert b7.launches == before
    M._launch(b7, mt, plan, tw, x, None, wf=tabs.stream, cf=None,
              ci=tabs.consti)
    assert b7.launches == before + 1

    b4, plan = F.KERNELS["polymul_fixed_fused"], F.fixed_pass_plan(tbl.n)
    ftw = F._prepare(tbl, None, x)
    spec = torch.zeros(tbl.n, dtype=torch.uint32, device=cuda_device)
    assert plan.row_stride == 1056
    for fields in ({"row_stride": 1055}, {"row_stride": 0},
                   {"radix": 16}, {"passes": 3}, {"passes": 1},
                   {"threads": 64}, {"rows": 0}, {"rows": 9},
                   {"fwd_b": (1, 2)}, {"inv_b": (0, 6)}):
        before = b4.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            F._launch(b4, tbl, ftw, x, spec, changed(plan, **fields))
        assert b4.launches == before
    for good in (plan, F.fused_pass_plan(tbl.n)):
        got = F._launch(b4, tbl, ftw, x, spec, good)
        np.testing.assert_array_equal(got.cpu().numpy(), 0)
    assert b4.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS + WIDE_SETS)
def test_b3_b15_match_plain_on_card(cuda_device, name):
    """B3 (B4's inverse passes alone) and B15 (the row segment kernel's
    folded mode over F's nonzero blocks) against their twins at B in {1, 3,
    64, 9000}: B3 on rows below 2q with rows of 2q - 1, also from an input
    that is not 16-byte aligned; B15 at every model axis the set's split
    takes (k = 4 at n = 8192) on x with rows of q - 1 against a constant
    whose spectrum holds q - 1, against the twin over its compact blocks and
    the dense one.  Each call launches its kernel once."""
    tbl = get_tables(name)
    q, n = tbl.q, tbl.n
    rng = np.random.default_rng(27)
    b3, b15 = F.KERNELS["intt_fused"], S.KERNELS["sp_seg2_folded"]
    folds = []
    for k in (2, 4, 8):
        try:
            plans = fourstep_mxu_plans(name, 1 << (tbl.logn // 2), k)
        except ValueError:
            continue
        spec = rng.integers(0, q, (k, plans.nloc), dtype=np.uint32)
        spec[:, ::3] = q - 1
        folds.append((plans, S.fold_sp_operand(
            *fourstep_fold_tables(plans, spec), plans, cuda_device)))
    assert folds
    for batch in (1, 3, 64, 9000):
        lazy = rng.integers(0, 2 * q, (batch + 1, n), dtype=np.uint32)
        lazy[::89] = 2 * q - 1
        lazy = torch.from_numpy(lazy).to(cuda_device)
        shifted = lazy.reshape(-1)[1:1 + batch * n].reshape(batch, n)
        assert shifted.data_ptr() % 16
        for X in (lazy[:batch], shifted):
            before = b3.launches
            got = F.intt_fused(X, tbl)
            torch.cuda.synchronize()
            np.testing.assert_array_equal(
                got.cpu().numpy(), F.intt_plain(X, tbl).cpu().numpy(),
                err_msg=f"B3 B={batch}")
            assert b3.launches == before + 1
        for plans, fold in folds:
            x = rng.integers(0, q, (plans.k, batch, plans.nloc),
                             dtype=np.uint32)
            x[:, ::97] = q - 1
            x = torch.from_numpy(x).to(cuda_device)
            before = b15.launches
            got = S.sp_seg2_folded(x, fold, plans)
            torch.cuda.synchronize()
            assert b15.launches == before + 1
            for want in (S.seg2_folded_compact_plain(x, fold, plans),
                         S.seg2_folded_plain(x, fold, plans)):
                np.testing.assert_array_equal(
                    got.cpu().numpy(), want.cpu().numpy(),
                    err_msg=f"B15 k={plans.k} B={batch}")


@pytest.mark.cuda
@pytest.mark.parametrize("n,q", _PASS_LENGTHS + [(32768, 786433)])
def test_b3_at_every_length_on_card(cuda_device, n, q):
    """B3 at every length from 2 to 32768, the largest its plans take (1024
    threads a row in three passes), the lengths the block-a-row kernel took,
    on 300 rows below 2q with rows of 2q - 1."""
    name = f"b3-n{n}"
    register_param_set(name, n, q)
    tbl = get_tables(name)
    rng = np.random.default_rng(n)
    X = rng.integers(0, 2 * q, (300, n), dtype=np.uint32)
    X[0], X[7] = 2 * q - 1, 2 * q - 1
    X = torch.from_numpy(X).to(cuda_device)
    np.testing.assert_array_equal(F.intt_fused(X, tbl).cpu().numpy(),
                                  F.intt_plain(X, tbl).cpu().numpy())


@pytest.mark.cuda
def test_b3_b15_launchers_refuse_plans_they_cannot_run(cuda_device):
    """B3's launcher returns cudaErrorInvalidValue for a plan with forward
    passes (B1's), forward fields set, a first window other than [0, r),
    a gap between passes, another radix, threads, rows or pass count, or
    too little shared memory a row; B15's for rows other than 32, a second
    split or K2i layout, more than 4 classes, an input split outside the
    kernel's, or a depth that is not the blocks'.  The wrappers raise,
    nothing is counted, and the plans as made launch."""
    tbl = get_tables("qtesla-iii-speed")
    x = torch.zeros((3, tbl.n), dtype=torch.uint32, device=cuda_device)
    tw = F._prepare(tbl, None, x)

    def changed(plan, **fields):
        out = type(plan).from_buffer_copy(plan)
        for f, v in fields.items():
            obj, _, name = f.rpartition(".")
            if obj:
                setattr(getattr(out, obj), name, v)
            elif isinstance(v, tuple):
                getattr(out, name)[v[0]] = v[1]
            else:
                setattr(out, name, v)
        return out

    b3, plan = F.KERNELS["intt_fused"], F.intt_pass_plan(tbl.n)
    assert (plan.radix, plan.threads, plan.rows, plan.passes,
            plan.row_stride) == (32, 32, 8, 2, 1056)
    bad = [changed(plan, **f) for f in (
        {"fwd_hi": (0, 5)}, {"fwd_b": (1, 5)}, {"inv_b": (0, 5)},
        {"inv_lo": (1, 6)}, {"radix": 16}, {"threads": 64}, {"rows": 0},
        {"rows": 9}, {"passes": 3}, {"passes": 1}, {"row_stride": 1055})]
    for p in bad + [F.fused_pass_plan(tbl.n)]:
        before = b3.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            F._launch(b3, tbl, tw, x, None, p)
        assert b3.launches == before
    F._launch(b3, tbl, tw, x, None, plan)
    assert b3.launches == before + 1

    plans = fourstep_mxu_plans("qtesla-iii-speed", 32, 4)
    fold = S.fold_sp_operand(*fourstep_fold_tables(
        plans, np.zeros(plans.n, dtype=np.uint32)), plans, cuda_device)
    xs = torch.zeros((4, 3, plans.nloc), dtype=torch.uint32,
                     device=cuda_device)
    b15, plan = S.KERNELS["sp_seg2_folded"], S.seg2_folded_compact_plan(plans)
    tables = (fold.w, fold.c, None, None, None)
    for f in ({"rows": 16}, {"rows": 48}, {"d": 5}, {"cdin": (0, 7)},
              {"din2": 3}, {"lb2": 8}, {"c2.kp": 96}, {"c2.ls": 5},
              {"c1.kp": 100}, {"c1.ls": 2}):
        before = b15.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            S._run_kernel(b15, changed(plan, **f), tables, xs, None,
                          plans.nloc)
        assert b15.launches == before
    got = S._run_kernel(b15, plan, tables, xs, None, plans.nloc)
    assert b15.launches == before + 1
    np.testing.assert_array_equal(
        got.cpu().numpy(), S.seg2_folded_compact_plain(xs, fold,
                                                       plans).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS + WIDE_SETS)
def test_b2_b14_match_plain_on_card(cuda_device, name):
    """B2 (B4's forward passes alone) and B14 (the row segment kernel's
    forward mode over K2f's nonzero blocks) against their twins at B in {1,
    3, 64, 9000}: B2 on x with rows of 0 and of q - 1 against ``ntt_plain``
    (and its pass twin up to 3 rows), and through B3 back to x; B14 at every
    model axis the set's split takes (k = 4 at n = 8192) on x with rows of
    q - 1, on all shards and on one, against the twin over its compact
    blocks and the dense one.  Each call launches its kernel once."""
    tbl = get_tables(name)
    q, n = tbl.q, tbl.n
    rng = np.random.default_rng(28)
    b2, b14 = F.KERNELS["ntt_fused"], S.KERNELS["sp_seg2_fwd"]
    splits = []
    for k in ((4,) if name in WIDE_SETS else (2, 4, 8)):
        try:
            splits.append(fourstep_mxu_plans(name, 1 << (tbl.logn // 2), k))
        except ValueError:
            continue
    assert splits
    for batch in (1, 3, 64, 9000):
        x = rng.integers(0, q, (batch, n), dtype=np.uint32)
        x[::97], x[1::89] = q - 1, 0
        x = torch.from_numpy(x).to(cuda_device)
        before = b2.launches
        got = F.ntt_fused(x, tbl)
        torch.cuda.synchronize()
        assert b2.launches == before + 1
        np.testing.assert_array_equal(
            got.cpu().numpy(), F.ntt_plain(x, tbl).cpu().numpy(),
            err_msg=f"B2 B={batch}")
        if batch <= 3:
            np.testing.assert_array_equal(
                got.cpu().numpy(), F.ntt_passes_plain(x.cpu(), tbl).numpy())
        np.testing.assert_array_equal(F.intt_fused(got, tbl).cpu().numpy(),
                                      x.cpu().numpy())
        for plans in splits:
            xs = rng.integers(0, q, (plans.k, batch, plans.nloc),
                              dtype=np.uint32)
            xs[:, ::97] = q - 1
            xs = torch.from_numpy(xs).to(cuda_device)
            d = plans.k // 2
            before = b14.launches
            got = S.sp_seg2_fwd(xs, plans)
            one = S.sp_seg2_fwd(xs[d:d + 1].contiguous(), plans, first=d)
            torch.cuda.synchronize()
            assert b14.launches == before + 2
            want = S.seg2_fwd_plain(xs, plans)
            for g, w in ((got, want),
                         (got, S.seg2_fwd_compact_plain(xs, plans)),
                         (one, want[d:d + 1])):
                np.testing.assert_array_equal(
                    g.cpu().numpy(), w.cpu().numpy(),
                    err_msg=f"B14 k={plans.k} B={batch}")


@pytest.mark.cuda
@pytest.mark.parametrize("n,q", _PASS_LENGTHS + [(32768, 786433)])
def test_b2_at_every_length_on_card(cuda_device, n, q):
    """B2 at every length from 2 to 32768, the largest its plans take (1024
    threads a row in three passes), the lengths the block-a-row kernel took,
    on 300 rows with rows of 0 and of q - 1, against ``ntt_plain`` and
    through B3 back to x."""
    name = f"b2-n{n}"
    register_param_set(name, n, q)
    tbl = get_tables(name)
    rng = np.random.default_rng(n)
    x = rng.integers(0, q, (300, n), dtype=np.uint32)
    x[0], x[7], x[299] = q - 1, 0, q - 1
    x = torch.from_numpy(x).to(cuda_device)
    got = F.ntt_fused(x, tbl)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  F.ntt_plain(x, tbl).cpu().numpy())
    np.testing.assert_array_equal(F.intt_fused(got, tbl).cpu().numpy(),
                                  x.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS + WIDE_SETS)
def test_b14_through_both_sp_prepares_on_card(cuda_device, name):
    """The fixed and the folded SP prepare each launch B14 once, on their
    constant's one row a shard, at every model axis the set's split takes
    (k = 4 at n = 8192): the spectrum the fixed prepare returns equals the
    dense twin's (``seg2_fwd_plain`` after B11's twin and the exchange), and
    the folded operand is the one built on the host from that spectrum."""
    tbl = get_tables(name)
    q, n = tbl.q, tbl.n
    rng = np.random.default_rng(29)
    b14 = S.KERNELS["sp_seg2_fwd"]
    for k in ((4,) if name in WIDE_SETS else (2, 4, 8)):
        try:
            plans = fourstep_mxu_plans(name, 1 << (tbl.logn // 2), k)
        except ValueError:
            continue
        mesh = make_mesh(model=k)
        a = rng.integers(0, q, n, dtype=np.uint32)
        a[::7] = q - 1
        a = torch.from_numpy(a).to(cuda_device)
        want = S.seg2_fwd_plain(S.a2a_fwd(S.seg1_plain(
            S.to_shards(a[None], plans), plans), plans), plans).reshape(n)
        before = b14.launches
        spec = S.polymul_fixed_fourstep_mxu_fn(name, mesh)[0](a)
        torch.cuda.synchronize()
        assert b14.launches == before + 1
        np.testing.assert_array_equal(spec.cpu().numpy(), want.cpu().numpy(),
                                      err_msg=f"fixed prepare k={k}")
        op = S.polymul_fixed_folded_fourstep_mxu_fn(name, mesh)[0](a)
        assert b14.launches == before + 2
        ref = S.fold_sp_operand(*fourstep_fold_tables(
            plans, want.cpu().numpy()), plans, cuda_device)
        for got, w in zip(op, ref):
            assert torch.equal(got, w), f"folded prepare k={k}"


@pytest.mark.cuda
def test_b2_b14_launchers_refuse_plans_they_cannot_run(cuda_device):
    """B2's launcher returns cudaErrorInvalidValue for a plan with inverse
    fields set, B1's plan (both transforms, two operands' shared memory),
    B3's (the inverse alone), a first window other than the load's, a last
    window other than [0, r), a gap between passes, another radix, threads,
    rows or pass count, or too little shared memory a row; B14's for rows
    other than 32, a second split or K2i layout (also B12's and B13's
    plans), more than 4 classes, an input split outside the kernel's, or a
    depth that is not the blocks'.  The wrappers raise, nothing is counted,
    and the plans as made launch."""
    tbl = get_tables("qtesla-iii-speed")
    x = torch.zeros((3, tbl.n), dtype=torch.uint32, device=cuda_device)
    tw = F._prepare(tbl, None, x)

    def changed(plan, **fields):
        out = type(plan).from_buffer_copy(plan)
        for f, v in fields.items():
            obj, _, name = f.rpartition(".")
            if obj:
                setattr(getattr(out, obj), name, v)
            elif isinstance(v, tuple):
                getattr(out, name)[v[0]] = v[1]
            else:
                setattr(out, name, v)
        return out

    b2, plan = F.KERNELS["ntt_fused"], F.ntt_pass_plan(tbl.n)
    assert (plan.radix, plan.threads, plan.rows, plan.passes,
            plan.row_stride) == (32, 32, 8, 2, 1056)
    bad = [changed(plan, **f) for f in (
        {"inv_hi": (0, 5)}, {"inv_b": (1, 5)}, {"inv_lo": (0, 1)},
        {"fwd_b": (0, 0)}, {"fwd_b": (1, 2)}, {"fwd_lo": (1, 1)},
        {"radix": 16}, {"threads": 64}, {"rows": 0}, {"rows": 9},
        {"passes": 3}, {"passes": 1}, {"row_stride": 1055})]
    for p in bad + [F.fused_pass_plan(tbl.n), F.intt_pass_plan(tbl.n)]:
        before = b2.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            F._launch(b2, tbl, tw, x, None, p)
        assert b2.launches == before
    got = F._launch(b2, tbl, tw, x, None, plan)
    assert b2.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), 0)

    plans = fourstep_mxu_plans("qtesla-iii-speed", 32, 4)
    tabs = S.device_tables(plans, cuda_device)
    rng = np.random.default_rng(30)
    xs = torch.from_numpy(rng.integers(0, plans.q, (4, 3, plans.nloc),
                                       dtype=np.uint32)).to(cuda_device)
    b14, plan = S.KERNELS["sp_seg2_fwd"], S.seg2_fwd_compact_plan(plans)
    tables = (tabs.w2fc, tabs.c2f, None, None, None)
    bad = [changed(plan, **f) for f in (
        {"rows": 16}, {"rows": 48}, {"d": 5}, {"cdin": (0, 7)},
        {"din2": 3}, {"lb2": 8}, {"c2.kp": 96}, {"c2.ls": 5},
        {"c1.kp": 100}, {"c1.ls": 2})]
    for p in bad + [S.seg2_compact_plan(plans),
                    S.seg2_fixed_compact_plan(plans)]:
        before = b14.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            S._run_kernel(b14, p, tables, xs, None, plans.nloc)
        assert b14.launches == before
    got = S._run_kernel(b14, plan, tables, xs, None, plans.nloc)
    assert b14.launches == before + 1
    np.testing.assert_array_equal(
        got.cpu().numpy(), S.seg2_fwd_compact_plain(xs, plans).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS + WIDE_SETS)
def test_sp_kernels_match_plain_on_card(cuda_device, name):
    """B11, B12 and B16 against their twins for every model axis the set's
    split takes, one launch each per call, over all shards and over one
    shard of the middle; the whole path equals B1."""
    tbl = get_tables(name)
    q, n = tbl.q, tbl.n
    rng = np.random.default_rng(24)
    for k in (2, 4, 8):
        try:
            plans = fourstep_mxu_plans(name, 1 << (tbl.logn // 2), k)
        except ValueError:
            continue
        for batch in (1, 3, 64):
            xy = rng.integers(0, q, (2, k, batch, plans.nloc),
                              dtype=np.uint32)
            xy[0, :, 0] = q - 1
            x, y = (torch.from_numpy(v).to(cuda_device) for v in xy)
            before = {s: v.launches for s, v in S.KERNELS.items()}
            pairs = [(S.sp_seg1(x, plans), S.seg1_plain(x, plans)),
                     (S.sp_seg2(x, y, plans), S.seg2_plain(x, y, plans)),
                     (S.sp_seg3(x, plans), S.seg3_plain(x, plans))]
            d = k // 2
            one = x[d:d + 1].contiguous()
            pairs.append((S.sp_seg1(one, plans, first=d),
                          S.seg1_plain(one, plans, first=d)))
            torch.cuda.synchronize()
            for got, want in pairs:
                np.testing.assert_array_equal(got.cpu().numpy(),
                                              want.cpu().numpy())
            assert {s: v.launches - before[s]
                    for s, v in S.KERNELS.items()} == {
                "sp_seg1": 2, "sp_seg2": 1, "sp_seg2_fixed": 0,
                "sp_seg2_fwd": 0, "sp_seg2_folded": 0, "sp_seg3": 1}
            xy = torch.from_numpy(rng.integers(0, q, (2, batch, n),
                                               dtype=np.uint32)).to(
                cuda_device)
            z = S.polymul_fourstep_mxu_fn(name, make_mesh(model=k))(xy[0],
                                                                     xy[1])
            np.testing.assert_array_equal(
                z.cpu().numpy(), F.polymul_fused(xy[0], xy[1], tbl).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS + WIDE_SETS)
def test_sp_fixed_kernels_match_plain_on_card(cuda_device, name):
    """B13, B14, B15 and B16 under p3x against their twins for every model
    axis the set's split takes, B13 and B15 for a random, an all-0 and an
    all-(q-1) spectrum; both fixed paths equal B4 and each other."""
    tbl = get_tables(name)
    q, n = tbl.q, tbl.n
    rng = np.random.default_rng(25)
    for k in (2, 4, 8):
        try:
            plans = fourstep_mxu_plans(name, 1 << (tbl.logn // 2), k)
        except ValueError:
            continue
        mesh = make_mesh(model=k)
        spectra = [torch.from_numpy(v).to(cuda_device) for v in (
            rng.integers(0, q, (k, plans.nloc), dtype=np.uint32),
            np.zeros((k, plans.nloc), dtype=np.uint32),
            np.full((k, plans.nloc), q - 1, dtype=np.uint32))]
        folds = [S.fold_sp_operand(*fourstep_fold_tables(
            plans, s.cpu().numpy()), plans, cuda_device) for s in spectra]
        for batch in (1, 3, 64):
            x = rng.integers(0, q, (k, batch, plans.nloc), dtype=np.uint32)
            x[:, 0] = q - 1
            x = torch.from_numpy(x).to(cuda_device)
            before = {s: v.launches for s, v in S.KERNELS.items()}
            pairs = [(S.sp_seg2_fwd(x, plans), S.seg2_fwd_plain(x, plans)),
                     (S.sp_seg3(x, plans, folded=True),
                      S.seg3_plain(x, plans, folded=True))]
            for spec, fold in zip(spectra, folds):
                pairs += [(S.sp_seg2_fixed(x, spec, plans),
                           S.seg2_fixed_plain(x, spec, plans)),
                          (S.sp_seg2_folded(x, fold, plans),
                           S.seg2_folded_plain(x, fold, plans))]
            torch.cuda.synchronize()
            for got, want in pairs:
                np.testing.assert_array_equal(got.cpu().numpy(),
                                              want.cpu().numpy())
            assert {s: v.launches - before[s]
                    for s, v in S.KERNELS.items()} == {
                "sp_seg1": 0, "sp_seg2": 0, "sp_seg2_fixed": 3,
                "sp_seg2_fwd": 1, "sp_seg2_folded": 3, "sp_seg3": 1}
            xs = torch.from_numpy(rng.integers(0, q, (2, batch, n),
                                               dtype=np.uint32)).to(
                cuda_device)
            a = xs[1, 0].contiguous()
            want = F.polymul_fixed_fused(xs[0], F.ntt_fused(a[None], tbl), tbl)
            prep, mul = S.polymul_fixed_fourstep_mxu_fn(name, mesh)
            z = mul(xs[0], prep(a))
            prep, mul = S.polymul_fixed_folded_fourstep_mxu_fn(name, mesh)
            zx = mul(xs[0], *prep(a))
            for got in (z, zx):
                np.testing.assert_array_equal(got.cpu().numpy(),
                                              want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n in SETS if n not in FOUR_CLASS_SETS]
                         + [WIDE[0]])
def test_sp_class_kernels_match_plain_on_card(cuda_device, name):
    """B17 and B18 against their twins for every model axis the set's split
    takes, one launch each per call, B18 on B17's own output; the class
    path equals B1 and the SP path."""
    tbl = get_tables(name)
    q, n = tbl.q, tbl.n
    rng = np.random.default_rng(26)
    for k in (2, 4, 8):
        try:
            plans = fourstep_mxu_plans(name, 1 << (tbl.logn // 2), k)
        except ValueError:
            continue
        cp = class_boundary_plan(name, plans.n1, k)
        for batch in (1, 3, 64):
            x = rng.integers(0, q, (k, batch, plans.nloc), dtype=np.uint32)
            x[:, 0] = q - 1
            x = torch.from_numpy(x).to(cuda_device)
            before = {s: v.launches for s, v in C.KERNELS.items()}
            u = C.sp_seg1_classes(x, plans, cp)
            pairs = [(u, C.seg1_classes_plain(x, plans, cp)),
                     (C.sp_seg2_classes(u, u.flip(1).contiguous(), plans,
                                        cp),
                      C.seg2_classes_plain(u, u.flip(1).contiguous(), plans,
                                           cp))]
            torch.cuda.synchronize()
            for got, want in pairs:
                np.testing.assert_array_equal(got.cpu().numpy(),
                                              want.cpu().numpy())
            assert {s: v.launches - before[s]
                    for s, v in C.KERNELS.items()} == {
                "sp_seg1_classes": 1, "sp_seg2_classes": 1}
            xy = torch.from_numpy(rng.integers(0, q, (2, batch, n),
                                               dtype=np.uint32)).to(
                cuda_device)
            mesh = make_mesh(model=k)
            z = C.polymul_fourstep_mxu_classes_fn(name, mesh)(xy[0], xy[1])
            for want in (F.polymul_fused(xy[0], xy[1], tbl),
                         S.polymul_fourstep_mxu_fn(name, mesh)(xy[0], xy[1])):
                np.testing.assert_array_equal(z.cpu().numpy(),
                                              want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS + WIDE_SETS)
def test_compact_kernels_match_plain_on_card(cuda_device, name):
    """B11, B16 (under p3 and p3x), B12, B13, B17 and B18 (the kernels
    over the tables' nonzero blocks) against the twins that read the same
    compact tables and against the dense twins, for every model axis the
    set's split takes (n = 8192 at k = 4); batches of 1, 3 and 64 rows and
    one long enough that every persistent block walks over several row
    groups (through both of its buffers), on all shards and on one; B13
    against a canonical spectrum and one of uint32 values up to
    2^32 - 1."""
    tbl = get_tables(name)
    q = tbl.q
    rng = np.random.default_rng(27)
    for k in ((4,) if name in WIDE_SETS else (2, 4, 8)):
        try:
            plans = fourstep_mxu_plans(name, 1 << (tbl.logn // 2), k)
        except ValueError:
            continue
        cp = (None if name in FOUR_CLASS_SETS
              else class_boundary_plan(name, plans.n1, k))
        d = k // 2
        for batch in (1, 3, 64, 9000):
            x = rng.integers(0, q, (k, batch, plans.nloc), dtype=np.uint32)
            x[:, 0] = q - 1
            x = torch.from_numpy(x).to(cuda_device)
            one = x[d:d + 1].contiguous()
            want = S.seg1_plain(x, plans)
            pairs = [(S.sp_seg1(x, plans), want),
                     (S.seg1_compact_plain(x, plans), want),
                     (S.sp_seg1(one, plans, first=d), want[d:d + 1])]
            for folded in (False, True):
                want = S.seg3_plain(x, plans, folded=folded)
                pairs += [
                    (S.sp_seg3(x, plans, folded=folded), want),
                    (S.seg3_compact_plain(x, plans, folded=folded), want),
                    (S.sp_seg3(one, plans, first=d, folded=folded),
                     want[d:d + 1])]
            y = x.flip(1).contiguous()
            want = S.seg2_plain(x, y, plans)
            pairs += [(S.sp_seg2(x, y, plans), want),
                      (S.seg2_compact_plain(x, y, plans), want),
                      (S.sp_seg2(one, y[d:d + 1].contiguous(), plans,
                                 first=d), want[d:d + 1])]
            full = rng.integers(0, 1 << 32, (k, plans.nloc), dtype=np.uint32)
            full[:, ::7] = 0xFFFFFFFF
            for spec in (rng.integers(0, q, (k, plans.nloc),
                                      dtype=np.uint32), full):
                spec = torch.from_numpy(spec).to(cuda_device)
                want = S.seg2_fixed_plain(x, spec, plans)
                pairs += [(S.sp_seg2_fixed(x, spec, plans), want),
                          (S.seg2_fixed_compact_plain(x, spec, plans), want),
                          (S.sp_seg2_fixed(one, spec, plans, first=d),
                           want[d:d + 1])]
            if cp is not None:
                want = C.seg1_classes_plain(x, plans, cp)
                pairs += [(C.sp_seg1_classes(x, plans, cp), want),
                          (C.seg1_classes_compact_plain(x, plans, cp), want),
                          (C.sp_seg1_classes(one, plans, cp, first=d),
                           want[d:d + 1])]
                u = C.seg1_classes_plain(x, plans, cp)
                v = u.flip(1).contiguous()
                want = C.seg2_classes_plain(u, v, plans, cp)
                pairs += [
                    (C.sp_seg2_classes(u, v, plans, cp), want),
                    (C.seg2_classes_compact_plain(u, v, plans, cp), want),
                    (C.sp_seg2_classes(u[d:d + 1].contiguous(),
                                       v[d:d + 1].contiguous(), plans, cp,
                                       first=d), want[d:d + 1])]
            torch.cuda.synchronize()
            for got, want in pairs:
                np.testing.assert_array_equal(got.cpu().numpy(),
                                              want.cpu().numpy())


@pytest.mark.cuda
def test_compact_launchers_refuse_plans_outside_their_range(cuda_device):
    """B13's and B17's launchers return an error for a plan outside their
    kernel's range (rows, units, slots, splits, depths, B17's lane pairs),
    and the wrapper raises it: nothing is launched, nothing counted."""
    plans = fourstep_mxu_plans("qtesla-iii-speed", 32, 4)
    cp = class_boundary_plan("qtesla-iii-speed", 32, 4)
    tabs = S.device_tables(plans, cuda_device)
    x = torch.from_numpy(np.zeros((4, 3, plans.nloc), dtype=np.uint32)).to(
        cuda_device)
    spec = x[:, 0].contiguous()

    def changed(plan, **fields):
        out = type(plan).from_buffer_copy(plan)
        for f, v in fields.items():
            obj, _, name = f.rpartition(".")
            if obj:
                setattr(getattr(out, obj), name, v)
            elif name in ("cdin", "clb", "cls_b"):
                getattr(out, name)[0] = v
            else:
                setattr(out, name, v)
        return out

    b13 = S.seg2_fixed_compact_plan(plans)
    b17 = C.plan_for(plans, cp, "sp_seg1_classes")
    cases = [(S.KERNELS["sp_seg2_fixed"], changed(b13, **f),
              (tabs.w2fc, tabs.c2f, tabs.w2ic, tabs.c2i, None), spec,
              plans.nloc)
             for f in ({"rows": 16}, {"rows": 48}, {"d": 5}, {"cdin": 7},
                       {"c1.kp": 100}, {"c2.kp": 64}, {"c2.ls": 4})]
    cases += [(C.KERNELS["sp_seg1_classes"], changed(b17, **f),
               (tabs.w1c, None, None, None, tabs.tw), None,
               cp.Dout * plans.nloc)
              for f in ({"rows": 0}, {"rows": 33}, {"d": 4}, {"c1.ls": 2},
                        {"c1.lq": 3}, {"c1.kp": 32}, {"lb1": 6})]
    for kernel, plan, tables, b, width in cases:
        before = kernel.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            S._run_kernel(kernel, plan, tables, x, b, width)
        assert kernel.launches == before
    # the plans as made launch
    S._run_kernel(S.KERNELS["sp_seg2_fixed"], b13, cases[0][2], x, spec,
                  plans.nloc)
    S._run_kernel(C.KERNELS["sp_seg1_classes"], b17, cases[-1][2], x, None,
                  cp.Dout * plans.nloc)
    torch.cuda.synchronize()


# the sweep form's rings (csrc/pass_sweeps.cu): the largest prime the
# registry takes at each n
SWEEP_RINGS = {1 << 18: 1056440321, 1 << 20: 1012924417, 1 << 25: 469762049}


def _sweep_call(kind, tbl, x, y, lazy, spec, plan, on_card):
    """``kind``'s wrapper under ``plan`` on the card (``on_card``) or its
    CPU twin under the same plan."""
    if kind == "B1":
        return (F.polymul_fused(x, y, tbl, plan=plan) if on_card else
                F.polymul_fused_passes_plain(x, y, tbl, plan))
    if kind == "B4":
        return (F.polymul_fixed_fused(x, spec, tbl, plan=plan) if on_card
                else F.polymul_fixed_fused_passes_plain(x, spec, tbl, plan))
    if kind == "B2":
        return (F.ntt_fused(x, tbl, plan=plan) if on_card else
                F.ntt_passes_plain(x, tbl, plan))
    if kind == "B3":
        return (F.intt_fused(lazy, tbl, plan=plan) if on_card else
                F.intt_passes_plain(lazy, tbl, plan))
    return (P.polymul_pairing(x, y, tbl, kind, plan=plan) if on_card else
            P.polymul_pairing_passes_plain(x, y, tbl, kind, plan))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(PS.SWEEP_KINDS))
def test_sweep_form_matches_its_twin_on_card(cuda_device, kind):
    """The sweep form of each kind (``passes.sweep_plan``; B2 and B3 at
    2^18 too, where their cluster form runs by default) against its CPU
    twin under the same plan at n = 2^18, B in {1, 3}, and 2^20, B = 1,
    with a row of q - 1 (B3: 2q - 1; B4 against a spectrum holding q - 1);
    at 2^25, B = 1, against the plain version on the card and the closed
    form of the all-(q - 1) row (B1, B4 and the pairings: z_k = 2k + 2 -
    n; B3 takes B2's output back to x).  Each call adds its plan's
    launches to the kernel's count."""
    kernel = {"B1": F.KERNELS["polymul_fused"],
              "B4": F.KERNELS["polymul_fixed_fused"],
              "B2": F.KERNELS["ntt_fused"],
              "B3": F.KERNELS["intt_fused"]}.get(
        kind, P.KERNELS.get(f"polymul_pairing_{kind}"))
    for n, q in SWEEP_RINGS.items():
        name = f"sweep-n{n}"
        register_param_set(name, n, q)
        tbl = get_tables(name)
        plan = PS.sweep_plan(n, kind)
        rng = np.random.default_rng(n)
        rows = 3 if n == 1 << 18 else 1
        x, y = rng.integers(0, q, (2, rows, n), dtype=np.uint32)
        x[0], y[0] = q - 1, q - 1
        lazy = rng.integers(0, 2 * q, (rows, n), dtype=np.uint32)
        lazy[0] = 2 * q - 1
        spec = rng.integers(0, q, n, dtype=np.uint32)
        spec[::5] = q - 1
        cpu = [torch.from_numpy(v) for v in (x, y, lazy, spec)]
        dev = [v.to(cuda_device) for v in cpu]
        for B in ((1, 3) if rows == 3 else (1,)):
            before = kernel.launches
            got = _sweep_call(kind, tbl, *(v[:B] if v.dim() == 2 else v
                                           for v in dev), plan, True)
            torch.cuda.synchronize()
            assert kernel.launches == before + plan.sweeps
            if n < 1 << 25:
                want = _sweep_call(kind, tbl, *(v[:B] if v.dim() == 2 else v
                                                for v in cpu), plan, False)
                np.testing.assert_array_equal(got.cpu().numpy(),
                                              want.numpy())
                continue
            xs, ys, ls, sp = dev
            want = {"B1": lambda: F.polymul_plain(xs, ys, tbl),
                    "B4": lambda: F.polymul_fixed_plain(xs, sp, tbl),
                    "B2": lambda: F.ntt_plain(xs, tbl),
                    "B3": lambda: F.intt_plain(ls, tbl)}.get(
                kind, lambda: P.polymul_pairing_plain(xs, ys, tbl, kind))()
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          want.cpu().numpy())
            k = torch.arange(n, device=cuda_device)
            if kind == "B3":
                back = F.intt_fused(F.ntt_fused(xs, tbl, plan=PS.sweep_plan(
                    n, "B2")), tbl, plan=plan)
                assert torch.equal(back, xs)
            elif kind not in ("B2", "B4"):
                assert torch.equal(got[0].to(torch.int64),
                                   (2 * k + 2 - n) % q)


@pytest.mark.cuda
def test_sweep_launcher_refuses_plans_it_cannot_run(cuda_device):
    """``qt_pass_sweep`` returns cudaErrorInvalidValue for a plan other
    than the one its checks restate (a window, a column, the tiles, the
    threads, the shared memory, a Stockham map, the launches a call, the
    kind): the wrapper raises, nothing is counted; the plan as made runs
    and counts its launches."""
    n, q = 1 << 18, SWEEP_RINGS[1 << 18]
    register_param_set("sweep-n262144", n, q)
    tbl = get_tables("sweep-n262144")
    x = torch.zeros((2, n), dtype=torch.uint32, device=cuda_device)
    kernel = F.KERNELS["polymul_fused"]
    plan = PS.sweep_plan(n, "B1")
    tw = F._prepare(tbl, None, x)
    bad = []
    for field, i, delta in (("hi", 0, -1), ("lo", 1, 1), ("cb", 0, 1),
                            ("cols", 2, -1), ("tiles", 1, 1),
                            ("threads", 0, -32), ("smem", 1, 4),
                            ("ld", 1, 1), ("ops", 0, 1), ("split", 1, 1)):
        p = PS.SweepPlan.from_buffer_copy(plan)
        getattr(p, field)[i] += delta
        bad.append(p)
    for field, value in (("sweeps", 2), ("kind", 8), ("logn", 17),
                         ("windows", 3)):
        p = PS.SweepPlan.from_buffer_copy(plan)
        setattr(p, field, value)
        bad.append(p)
    for p in bad:
        before = kernel.launches
        with pytest.raises(RuntimeError, match="qt_pass_sweep"):
            F._launch_sweeps(kernel, tbl, tw, x, x, p, 2)
        assert kernel.launches == before
    before = kernel.launches
    F._launch_sweeps(kernel, tbl, tw, x, x, plan, 2)
    assert kernel.launches == before + 3
