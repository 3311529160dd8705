"""The split form of the MXU kernels B5-B9: rows past one block's reach.

From n = ``ntt_mxu.SPLIT_FROM`` (32768) a row of B5's x and y no longer
fits the stream kernel's block (``ntt_mxu.block_rows``), so every call of
``polymul_mxu``, ``polymul_fixed_mxu``, ``polymul_fixed_folded_mxu``,
``ntt_mxu`` and ``intt_mxu`` runs in three steps, each on the rows in device
memory:

1. the forward's wide stages (index bits from log2(bw) = 7 up, the merged-psi
   CT stages of distance >= bw) as B2's sweep launches under
   ``passes.sweep_plan(n, "B2", low=7)`` (``csrc/pass_sweeps.cu``), on x
   (B5: on y too); they end canonical, inside every forward split's bound;
2. one launch of the split kernel (``csrc/ntt_mxu_split.cu``, this module's
   ``KERNELS``): a block takes one lane block of ``rows`` batch rows,
   splits it into digit planes, multiplies them by int8 ``mma.sync``
   against that lane block's forward stages of the table stream
   (``MxuDeviceTables.stream``), recombines, takes the pointwise product
   (B5: with y's lanes, B8: with the spectrum's; B9 none), splits again and
   runs the inverse's products (B9: against the constant's stages) and
   recombination.  B6 stops after the forward, B7 starts at the inverse;
3. the inverse's wide stages (B3's sweeps under ``sweep_plan(n, "B3",
   low=7)``, n^{-1} in the last), canonical out.

B6 runs steps 1-2, B7 steps 2-3.  Grouping rows by lane block is the point:
each block's tables are read once per ``rows`` rows, not once per row.
Launches: B2's and B3's sweeps count on ``ntt_fused.KERNELS["ntt_fused"]``
and ``["intt_fused"]``, the product launch on its mode's entry here.

The plain versions: on the card the ``ntt_mxu`` twins (whole-ring int64
torch, the tables read from the stream); on the CPU the split form's own
model (``run`` with CPU tensors): B2's and B3's sweeps through
``passes.SweepModel`` (their lazy ranges asserted), the block products as
the twins take them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import ntt as N
from . import ntt_fused as F
from . import ntt_mxu as M
from .mxu_tables import FixedFoldPlan, MxuTables, fold_plan, stream_stages
from .ntt_fused import Kernel
from .passes import sweep_plan

__all__ = ["KERNELS", "KERNEL_OF", "CUDA_SOURCE", "MODES", "LOW",
           "MxuSplitPlan", "split_plan", "split_launches", "split_smem",
           "products", "products_plain", "run"]

CUDA_SOURCE = "qtesla_tpu_torch/csrc/ntt_mxu_split.cu"

# mode -> the split kernel's registry entry; the order of its SplitMode
MODES = ("product", "folded", "fixed", "ntt", "intt")
KERNELS: dict[str, Kernel] = {k.name: k for k in (
    Kernel("polymul_mxu_split", "qt_polymul_mxu_split",
           "qtesla_tpu/ops/ntt_mxu.py:982", 0),
    Kernel("polymul_fixed_folded_mxu_split",
           "qt_polymul_fixed_folded_mxu_split",
           "qtesla_tpu/ops/ntt_mxu.py:1210", 0),
    Kernel("polymul_fixed_mxu_split", "qt_polymul_fixed_mxu_split",
           "qtesla_tpu/ops/ntt_mxu.py:1012", 0),
    Kernel("ntt_mxu_split", "qt_ntt_mxu_split",
           "qtesla_tpu/ops/ntt_mxu.py:1041", 0),
    Kernel("intt_mxu_split", "qt_intt_mxu_split",
           "qtesla_tpu/ops/ntt_mxu.py:1061", 0),
)}
KERNEL_OF = dict(zip(MODES, KERNELS))

# batch rows a block takes of one lane block: four 16-row MMA tiles
# against each table fragment (B5: two of x's rows and two of y's)
_TILE_ROWS = 64
_BW = 128                  # the lane block the kernel takes
LOW = _BW.bit_length() - 1  # the wide stages' lowest index bit
_PLANES_PAD = 16           # bytes after each row of digit planes


class MxuSplitPlan(ctypes.Structure):
    """The split kernel's run-time plan: ``ntt_mxu.MxuPlan``'s fields
    (``rows``: x rows a block), then the stages of a lane block's forward
    and inverse tables in the stream (B9: the constant's) and the mode;
    field for field the ``MxuSplitPlan`` struct of
    ``csrc/ntt_mxu_split.cu``."""

    _fields_ = M.MxuPlan._fields_ + [(f, ctypes.c_int32) for f in (
        "stages_f", "stages_i", "mode")]


@functools.lru_cache(maxsize=None)
def split_plan(mt: MxuTables, mode: str = "product",
               fp: FixedFoldPlan | None = None) -> MxuSplitPlan:
    """The split kernel's plan for one of ``MODES`` (B9's under the fold
    plan ``fp``, ``fold_plan(mt)`` unless given): 32 x rows a block for
    B5 (and 32 of y), 64 for the others.  Raises where the kernel cannot
    take it: a lane block other than 128 (n < 256: no wide stage either),
    more than 4 classes, a split other than at most 4 planes of base 256
    or 6 of base 128."""
    if mode not in MODES:
        raise ValueError(f"split mode {mode!r}: not one of {MODES}")
    if mt.bw != _BW or mt.Lr < 1:
        raise ValueError(f"n={mt.n}: the split form takes n >= 256 (lane "
                         f"blocks of {_BW} and a wide stage)")
    if mode == "folded":
        fp = fold_plan(mt) if fp is None else fp
        if fp.Dout != mt.D or max(fp.bounds) >= M._CLASS_BIAS:
            raise ValueError(f"{mt.tbl.ps.name}: fold plan (Dout="
                             f"{fp.Dout}) outside the split kernel's range")
        di, base, off, gb = fp.Din, fp.base, fp.off, M._group_bias(
            fp.groups, fp.bounds, mt.q)
    elif fp is not None:
        raise ValueError(f"split mode {mode!r} takes no fold plan")
    else:
        di, base, off, gb = mt.Di, mt.inv_base, mt.inv_off, mt.group_bias_i
    for din, b in ((mt.Df, mt.fwd_base), (di, base)):
        if b not in (128, 256) or din > (4 if b == 256 else 6):
            raise ValueError(f"{mt.tbl.ps.name}: {din} planes of base {b} "
                             f"are outside the split kernel's split")
    rows = _TILE_ROWS // 2 if mode == "product" else _TILE_ROWS
    plan = M._make_plan(mt, 2 if mode == "product" else 1, di, base, off, gb,
                        rows=rows)
    fields = {f: getattr(plan, f) for f, _ in M.MxuPlan._fields_}
    return MxuSplitPlan(**fields, stages_f=stream_stages(mt.Df, mt.bw),
                        stages_i=stream_stages(di, mt.bw),
                        mode=MODES.index(mode))


def split_smem(plan: MxuSplitPlan) -> int:
    """Shared memory of one block (``csrc/ntt_mxu_split.cu`` computes the
    same): its rows of one lane block (B5: x's and y's) and their digit
    planes."""
    rows = 2 * plan.rows if plan.mode == 0 else plan.rows
    ks = max(plan.stages_f, plan.stages_i) * M.STAGE_DEPTH + _PLANES_PAD
    return rows * (plan.bw * 4 + ks)


def split_launches(n: int, mode: str) -> dict:
    """Launches one split call of ``mode`` at row length ``n`` makes: B2's
    sweeps on each operand through the forward, the product launch, B3's
    sweeps after the inverse."""
    fwd, inv = (sweep_plan(n, kind, low=LOW) for kind in ("B2", "B3"))
    ops = {"product": 2, "intt": 0}.get(mode, 1)
    return {"ntt_fused": ops * fwd.sweeps, KERNEL_OF[mode]: 1,
            "intt_fused": 0 if mode == "ntt" else inv.sweeps}


# ----------------------------------------------------------------------
# The call: kernels for CUDA tensors, the model for CPU tensors.
# ----------------------------------------------------------------------

_I64, _U32 = torch.int64, torch.uint32


def _wide_fwd(x: torch.Tensor, mt: MxuTables, tw) -> torch.Tensor:
    """The forward's wide stages on (B, n) rows: canonical out (uint32 on
    the card, int64 in the model)."""
    plan = sweep_plan(mt.n, "B2", low=LOW)
    if x.is_cuda:
        return F._launch_sweeps(F.KERNELS["ntt_fused"], mt.tbl, tw, x, None,
                                plan, 1)
    return F._sweeps_plain("B2", [x.to(_I64)], mt.tbl, plan)


def _wide_inv(z: torch.Tensor, mt: MxuTables, tw) -> torch.Tensor:
    """The inverse's wide stages on (B, n) canonical rows; canonical
    out."""
    plan = sweep_plan(mt.n, "B3", low=LOW)
    if z.is_cuda:
        return F._launch_sweeps(F.KERNELS["intt_fused"], mt.tbl, tw, z, None,
                                plan, 1)
    return F._sweeps_plain("B3", [z.to(_I64)], mt.tbl, plan)


def products(mode: str, mt: MxuTables, tabs, tw, a, b=None, op=None):
    """Step 2 on (B, n) rows ``a`` (after the forward's wide stages; B7:
    below pw_bound), ``b`` y's (B5) or the spectrum (B8), ``op`` B9's folded
    operand: the split kernel, one launch, on CUDA tensors;
    ``products_plain`` on CPU ones."""
    if not a.is_cuda:
        return products_plain(mode, mt, tabs, a, b, op)
    fp = fold_plan(mt) if mode == "folded" else None
    return M._launch(KERNELS[KERNEL_OF[mode]], mt, split_plan(mt, mode, fp), tw,
                     a, b, wf=tabs.stream, cf=tabs.constf,
                     wi=None if op is None else op.stages,
                     ci=tabs.consti if op is None else op.c)


def products_plain(mode: str, mt: MxuTables, tabs, a, b=None, op=None):
    """The split kernel's plain version, on any device: the twins' block
    products (``ntt_mxu._fwd_block``, ``_inv_block``, ``_folded_block``,
    int64 and float64 torch), the pointwise product between; canonical
    int64 out."""
    if mode == "intt":
        return M._inv_block(a, mt, tabs)
    X = M._fwd_block(a.to(_I64), mt, tabs)
    if mode == "ntt":
        return X
    if mode == "folded":
        return M._folded_block(X, op, mt)
    other = M._fwd_block(b.to(_I64), mt, tabs) if mode == "product" \
        else b.to(_I64).reshape(1, mt.n)
    return M._inv_block(N.pointwise_mul(X, other, mt.tbl), mt, tabs)


def run(mode: str, mt: MxuTables, tabs, tw, x, other=None) -> torch.Tensor:
    """One split call of ``mode`` (``MODES``) on (B..., n) operands that
    ``ntt_mxu``'s wrapper has checked: ``other`` is y (product), the
    spectrum (fixed) or the folded operand (folded)."""
    split_plan(mt, mode)
    n = mt.n
    rows = x.reshape(-1, n)
    if rows.shape[0] == 0:
        return torch.empty_like(x)
    b = op = None
    if mode == "product":
        b = _wide_fwd(other.reshape(-1, n), mt, tw)
    elif mode == "fixed":
        b = other.reshape(n)
    elif mode == "folded":
        op = other
    a = rows if mode == "intt" else _wide_fwd(rows, mt, tw)
    z = products(mode, mt, tabs, tw, a, b, op)
    if mode != "ntt":
        z = _wide_inv(z, mt, tw)
    return z.to(_U32).reshape(x.shape)
