"""The split form of the column segments B11, B16 and B17: rows past one
block's reach.

``column_compact_kernel`` (``csrc/sharded_mxu.cu``) holds two rows of a
shard and its const rows in a block's shared memory.  From nloc = 32768
(n = 65536 at k = 2, 131072 at k <= 4, every k <= 8 at 2^18 and 2^20, with
the split ``distributed.sp_n1``) not one row fits
(``sharded_mxu.column_split``), and ``sp_seg1``, ``sp_seg3`` and
``sharded_classes.sp_seg1_classes`` run in two steps, each on the shards in
device memory:

1. the column transform's Lr wide stages.  The n1-point merged-psi stages
   of j1-distance >= Bk pair whole TW-lane tiles of the flat row (j1 * n2k
   + lambda): they are a transform's stages on the row's index bits from
   log2(TW) up, with the n1-point table's twiddles (``_SweepRing``).  So
   they run as B2's sweep launches (``passes.sweep_plan(nloc, "B2",
   low=log2(TW))``, ``csrc/pass_sweeps.cu``), and B16's inverse ones,
   n1^{-1} in the last, as B3's; both end canonical, inside every split's
   bound (p1 covers ``rolls.fwd_bound`` >= q);
2. one launch of the tile kernel (``csrc/sp_column_split.cu``, this
   module's ``KERNELS``): block (walker, tile t, shard d) takes tile t of
   ``SPLIT_ROWS`` batch rows at a time, the tile's compact tables (K1's,
   K3's under p3 or p3x) and const row once in shared memory, and runs
   ``mxu_compact.cuh``'s split, ``mma.sync`` products and recombination
   (B17: its raw class sums, staged and copied out).  Grouping rows by tile
   reads a tile's tables once per block, not once per row.

B11 runs 1 then 2, B16 2 then 1 (inverse sweeps), B17 1 then 2.  Launches:
the sweeps count on ``ntt_fused.KERNELS["ntt_fused"]`` (B2) and
``["intt_fused"]`` (B3), the tile launch on its entry here
(``split_launches``).

The plain versions: on CPU tensors the split form's own model
(``column_sweeps`` through ``passes.SweepModel``, lazy ranges asserted, then
the compact products of ``sharded_mxu``); on the card the compact twins
(``seg1_compact_plain``, ``seg3_compact_plain``,
``seg1_classes_compact_plain``) are what the kernels are held against.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import ntt_fused as F
from ..ops.ntt_fused import Kernel
from ..ops.passes import sweep_plan
from .sharded_mxu import (_I64, _STAGE_PAD, _U32, SEGMENTS, SpCompactPlan,
                          SpDeviceTables, SpPlan, _compact_dims,
                          _compact_product, _run_kernel, plan_for,
                          planes_stride)
from .sharded_mxu_tables import SpPlans, compact_layout

__all__ = ["KERNELS", "CUDA_SOURCE", "SPLIT_ROWS", "column_split_plan",
           "split_smem", "column_sweep_plan", "column_sweeps",
           "split_launches", "products", "products_plain", "seg1_split",
           "seg3_split"]

CUDA_SOURCE = "qtesla_tpu_torch/csrc/sp_column_split.cu"

_JAX = "qtesla_tpu/parallel/sharded_mxu.py"
# ``smem_rows``: operand rows per batch row a block holds
KERNELS: dict[str, Kernel] = {k.name: k for k in (
    Kernel("sp_seg1_split", "qt_sp_seg1_split", f"{_JAX}:481", 1),
    Kernel("sp_seg3_split", "qt_sp_seg3_split", f"{_JAX}:622", 1),
    Kernel("sp_seg1_classes_split", "qt_sp_seg1_classes_split",
           f"{_JAX}:972", 1),
)}

# batch rows a block of the tile kernel takes at a time: two MMA tiles
SPLIT_ROWS = 32


@functools.lru_cache(maxsize=None)
def column_split_plan(plans: SpPlans, seg: str = "sp_seg1") -> SpCompactPlan:
    """The split form's tile kernel plan of B11 or B16 (``seg`` "sp_seg1",
    "sp_seg3" or "sp_seg3 p3x"; B17 takes B11's with its class biases):
    ``plan_for(plans, seg)`` with the compact layout of K1 (K3),
    ``SPLIT_ROWS`` rows a block and the tile's tables in shared memory."""
    sp = plan_for(plans, seg)
    fields = {f: getattr(sp, f) for f, _ in SpPlan._fields_}
    fields.update(rows=SPLIT_ROWS, smem_tables=1,
                  c1=_compact_dims(compact_layout(plans, "columns"),
                                   getattr(plans, SEGMENTS[seg][0]).din))
    return SpCompactPlan(**fields)


def split_smem(plan: SpCompactPlan, class_sums: bool = False) -> int:
    """Shared memory of one tile kernel block (``csrc/sp_column_split.cu``
    computes the same): two row buffers of one tile, its const row (B17: its
    staged class sums), its planes and its tables."""
    tw, rows, kp = plan.tw, plan.rows, plan.c1.kp
    staged = plan.d * rows * (tw + _STAGE_PAD) if class_sums else tw
    return (4 * (2 * rows * tw + staged)
            + -(-rows // 16) * 16 * planes_stride(tw >> plan.c1.ls, kp)
            + plan.d * tw * kp)


class _SweepRing:
    """A shard row as the sweep kernels see it: a transform of nloc points
    whose index bits from log2(TW) up are the n1-point column transform's
    wide stages (j1's bits, above the lane bits), with the n1-point
    twiddles at the rows' heads of a (4, nloc) table: stage k of the row
    reads entry 2^(L-1-k) + (m >> (k+1)) < A <= n1, the n1-point table's
    own entry for that stage and block (csrc/mxu_block.cuh fwd_wide)."""

    def __init__(self, plans: SpPlans):
        self.n, self.q, self.ps = plans.nloc, plans.q, plans.ps
        self.logn = plans.nloc.bit_length() - 1
        self.packed = np.zeros((4, plans.nloc), dtype=np.uint32)
        self.packed[:, :plans.n1] = plans.t1.packed


@functools.lru_cache(maxsize=None)
def _sweep_ring(plans: SpPlans) -> _SweepRing:
    return _SweepRing(plans)


@functools.lru_cache(maxsize=None)
def _sweep_twiddles(plans: SpPlans, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_sweep_ring(plans).packed).to(device)


def column_sweep_plan(plans: SpPlans, inverse: bool = False):
    """B2's (B3's with ``inverse``) sweep plan of the split form's wide
    stages over a shard row, the index bits from log2(TW) up; None at Lr =
    0 (one tile a row: no wide stage)."""
    if plans.Lr == 0:
        return None
    return sweep_plan(plans.nloc, "B3" if inverse else "B2",
                      low=plans.TW.bit_length() - 1)


def column_sweeps(v: torch.Tensor, plans: SpPlans,
                  inverse: bool) -> torch.Tensor:
    """The Lr forward (``inverse``: inverse, n1^{-1} in the last) wide
    stages of canonical shards (S, B, nloc) as sweep launches, counted on
    B2's (B3's) entry, on CUDA tensors; their model
    (``passes.SweepModel``, lazy ranges asserted) on CPU ones, int64 out;
    canonical out."""
    plan = column_sweep_plan(plans, inverse)
    if plan is None:
        return v if v.is_cuda else v.to(_I64)
    rows = v.reshape(-1, plans.nloc)
    if v.is_cuda:
        out = F._launch_sweeps(F.KERNELS["intt_fused" if inverse
                                         else "ntt_fused"], _sweep_ring(plans),
                               _sweep_twiddles(plans, v.device), rows, None,
                               plan, 1)
    else:
        out = F._sweeps_plain("B3" if inverse else "B2", [rows.to(_I64)],
                              _sweep_ring(plans), plan)
    return out.reshape(v.shape)


def split_launches(plans: SpPlans, seg: str = "sp_seg1") -> dict:
    """Launches one split call of B11 ("sp_seg1"), B16 ("sp_seg3") or B17
    ("sp_seg1_classes") makes: its sweeps on B2's or B3's entry, its tile
    kernel once."""
    inverse = seg == "sp_seg3"
    plan = column_sweep_plan(plans, inverse)
    return {"intt_fused" if inverse else "ntt_fused":
            plan.sweeps if plan else 0, f"{seg}_split": 1}


# each split segment's tables, const rows and digit plan, and its kernel
_SEGMENT = {"sp_seg1": ("w1c", "c1", "p1", "sp_seg1_split"),
            "sp_seg3": ("w3c", "c3", "p3", "sp_seg3_split"),
            "sp_seg3 p3x": ("w3xc", "c3x", "p3x", "sp_seg3_split")}


def products(v, plans: SpPlans, tabs: SpDeviceTables, sl,
             seg: str = "sp_seg1"):
    """Step 2 of B11 or B16 (``seg`` "sp_seg1", "sp_seg3" or "sp_seg3
    p3x") on shards v (S, B, nloc), shard s with shard sl.start + s's
    tables: the tile kernel, one launch, on CUDA tensors (uint32 out);
    ``products_plain`` on CPU ones (int64 out)."""
    if not v.is_cuda:
        return products_plain(v, plans, tabs, sl, seg)
    w, c, _, kernel = _SEGMENT[seg]
    return _run_kernel(KERNELS[kernel], column_split_plan(plans, seg),
                       (getattr(tabs, w)[sl], getattr(tabs, c)[sl], None,
                        None, None), v, None, plans.nloc)


def products_plain(v, plans: SpPlans, tabs: SpDeviceTables, sl,
                   seg: str = "sp_seg1"):
    """The tile kernel's plain version, on any device: the compact
    products of ``sharded_mxu`` (int64 and float64 torch); canonical int64
    out."""
    w, c, p, _ = _SEGMENT[seg]
    return _compact_product(v.to(_I64), getattr(tabs, w)[sl],
                            getattr(tabs, c)[sl], getattr(plans, p), plans,
                            "columns")


def seg1_split(x, plans: SpPlans, tabs: SpDeviceTables, sl):
    """B11's split form: the sweeps, then the tile kernel."""
    return products(column_sweeps(x, plans, inverse=False), plans, tabs,
                    sl).to(_U32)


def seg3_split(w, plans: SpPlans, tabs: SpDeviceTables, sl, folded: bool):
    """B16's split form: the tile kernel, then the inverse sweeps."""
    z = products(w, plans, tabs, sl, "sp_seg3 p3x" if folded else "sp_seg3")
    return column_sweeps(z, plans, inverse=True).to(_U32)
