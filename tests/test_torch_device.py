"""Contract of the port's device dispatch and kernel wrappers.

- ``qtesla_tpu_torch`` imports and runs its CPU slice without jax.
- The wrappers (fused B1-B4, digit-matmul B5-B9 and pairings B10) raise on
  a wrong dtype, a wrong n, a non-contiguous tensor, an unsupported device
  and an unsupported algo; nothing is built at import and a missing nvcc
  raises instead of falling back.  Editing a header changes the build's
  hash.  Every ported algo name dispatches; only ``nussbaumer`` raises
  ``NotImplementedError``.
- CPU tensors run the plain versions: no kernel's launch count moves.
- Tests marked ``cuda`` compare each kernel with its plain version on the
  card; without one they skip.  On a GPU host run them with
  ``python -m pytest tests/test_torch_device.py -m cuda --noconftest -q``
  (``--noconftest`` because tests/conftest.py imports jax).

This file imports no jax.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qtesla_tpu_torch import register_param_set
from qtesla_tpu_torch.models import polymul as TP
from qtesla_tpu_torch.ops import ntt_fused as F
from qtesla_tpu_torch.ops import ntt_mxu as M
from qtesla_tpu_torch.ops import ntt_pairings as P
from qtesla_tpu_torch.ops.mxu_tables import (FixedFoldPlan, fold_plan,
                                             get_mxu_tables)
from qtesla_tpu_torch.ops.tables import get_tables
from qtesla_tpu_torch.utils import build

REPO = Path(__file__).resolve().parent.parent
SETS = ["smallprime", "qtesla-i", "qtesla-iii-speed", "qtesla-p-i",
        "qtesla-p-iii"]
# n = 8192: B1 needs 64 KB of shared memory per block (opt-in above 48 KB)
WIDE = ("qtesla-iii-speed-n8192", 8192, 8404993)

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
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
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
    x = _u32(1, 32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TP.polymul_negacyclic(x, x, "smallprime", algo=algo)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TP.polymul_fn("smallprime", algo)
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
    kernels = [*F.KERNELS.values(), *M.KERNELS.values(), *P.KERNELS.values()]
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
        "modq.cuh", "ntt_fused.cu", "ntt_mxu.cu", "ntt_pairings.cu"]
    src = {mod: (build.CSRC_DIR / mod.CUDA_SOURCE.rsplit("/", 1)[1])
           .read_text() for mod in (F, M, P)}
    assert set(build.LAUNCHERS) == {k.symbol for mod in (F, M, P)
                                    for k in mod.KERNELS.values()}
    for k in P.KERNELS.values():
        assert f"QT_PAIRING_LAUNCHER({k.symbol}," in src[P]
        assert k.replaces == "qtesla_tpu/ops/ntt_pairings_pallas.py:160"
        assert build.LAUNCHERS[k.symbol] == build.LAUNCHERS["qt_polymul_fused"]
    for k in F.KERNELS.values():
        assert f"QT_LAUNCHER({k.symbol}," in src[F]
        assert k.replaces.startswith("qtesla_tpu/ops/ntt_pallas.py:")
        assert len(build.LAUNCHERS[k.symbol]) == 12
    for k in M.KERNELS.values():
        assert f"QT_MXU_LAUNCHER({k.symbol}," in src[M]
        assert k.replaces.startswith("qtesla_tpu/ops/ntt_mxu.py:")
        assert len(build.LAUNCHERS[k.symbol]) == 11
    # the C struct and the ctypes one name the same fields in one order
    body = src[M].split("struct MxuPlan {")[1].split("};")[0]
    c_fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        names = decl.split(None, 1)[1]
        c_fields += [f.strip().split("[")[0] for f in names.split(",")]
    assert c_fields == [f for f, _ in M.MxuPlan._fields_]


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


# ----------------------------------------------------------------------
# On the card.
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS + [WIDE[0]])
def test_kernels_match_plain_on_card(cuda_device, name):
    if name == WIDE[0]:
        register_param_set(*WIDE)
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


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS + [WIDE[0]])
def test_mxu_kernels_match_plain_on_card(cuda_device, name):
    """B5-B8 against their twins; B7 takes inputs below pw_bound."""
    if name == WIDE[0]:
        register_param_set(*WIDE)
    mt = get_mxu_tables(name)
    q, n = mt.q, mt.n
    rng = np.random.default_rng(22)
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


@pytest.mark.cuda
@pytest.mark.parametrize("name", SETS + [WIDE[0]])
def test_folded_and_pairing_kernels_match_plain_on_card(cuda_device, name):
    """B9 against its twin and B8, for a random, an all-0 and an all-(q-1)
    diagonal; each B10 pairing against its twin and B1."""
    if name == WIDE[0]:
        register_param_set(*WIDE)
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
