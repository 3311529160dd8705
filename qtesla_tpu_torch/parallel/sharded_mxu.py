"""Sequence-parallel (SP) digit-matmul polymul: segment kernels B11-B16,
hand-written CUDA for Hopper, with their plain PyTorch twins.

Counterpart of the kernels and the assembly of
``qtesla_tpu/parallel/sharded_mxu.py``:

- ``sp_seg1``  B11, replaces ``_make_seg1`` (sharded_mxu.py:481): the wide
  stages of the n1-point column transform, then K1 per (shard, tile);
- ``sp_seg2``  B12, replaces ``_make_seg2`` (l.520, ``_seg2_block`` l.502):
  the shared row transform K2f on x and y, the Barrett pointwise product,
  then K2i per (shard, tile), over K2f's and K2i's nonzero blocks alone
  (``w2fc``, ``w2ic``) in the kernel body B18 runs too;
- ``sp_seg2_fixed``  B13, replaces ``_make_seg2_fixed`` (l.533): B12 with y
  the constant's stored spectrum, one row per shard, in the same kernel
  body over the same compact tables;
- ``sp_seg2_fwd``  B14, replaces ``_make_seg2_fwd_only`` (l.548): K2f only,
  the last step of a constant's spectrum, over K2f's nonzero blocks alone
  (``w2fc``) in the kernel body of B12, B13 and B15, one product as B15's;
- ``sp_seg2_folded``  B15, replaces ``_make_seg2_folded`` (l.563): one
  product per (shard, tile) against the constant's folded tables
  F = K2f diag(A^) K2i under the plan p2x, over F's nonzero blocks alone
  (the operand holds them: ``FoldedSpOperand.w``), in the kernel body of
  B12 and B13;
- ``sp_seg3``  B16, replaces ``_make_seg3`` (l.622): K3 per (shard, tile),
  then the inverse wide stages with n1^{-1}; ``folded=True`` takes the plan
  p3x, as the folded path does.  B11 and B16 multiply only the nonzero
  blocks of K1 and K3 (``w1c``, ``w3c``, ``w3xc``), in one kernel body;
  from nloc = 32768, where not one row fits that body's block
  (``column_split``), they run their split form
  (``parallel/sp_column_split.py``: the wide stages as B2's and B3's
  sweeps, then a tile kernel); ``split=`` forces either form;
- ``a2a_fwd`` / ``a2a_inv``: the exchanges between them;
- the entry points ``polymul_fourstep_mxu_fn(name, mesh, n1, chunks)``
  (l.828; ``chunks`` as ``_build``'s l.693-719),
  ``local_pipeline_fn(name, k)`` (l.839), the fixed-operand pairs
  ``polymul_fixed_fourstep_mxu_fn`` (l.876) and
  ``polymul_fixed_folded_fourstep_mxu_fn`` (l.1150), and
  ``local_fixed_pipeline_fn``, one shard's work of either fixed path (as
  ``qtesla_tpu/utils/timing.py:349-450`` builds it).

On a stacked mesh the model axis lives on one device.  The k shards of a
call are the leading axis of one tensor: shard d of x (B, n) is
``x.reshape(B, n1, n2)[:, :, d*n2k:(d+1)*n2k]`` (flat index j1*n2k +
lambda), and the stacked layout is (k, B, nloc).  JAX's three
``lax.all_to_all`` calls become permutations of that axis: ``a2a_fwd`` maps
(k, B, n1, n2k) to (k, B, n1k, n2) with out[d', b, i, s*n2k + l] =
in[s, b, d'*n1k + i, l], which is ``all_to_all(split_axis=1,
concat_axis=2, tiled=True)``, and ``a2a_inv`` is its inverse.  Spectral
rows stay in the merged forward's position order (``plans.k1map``), as in
JAX.  A kernel launch covers the shards it is given.  On a mesh across ranks
(``distributed.make_global_mesh``) each rank holds one shard, (B, nloc) in
the "sp" layout, launches the same kernels on it with ``first`` its model
index (the shard whose tables it uses), and the exchanges are
``distributed.all_to_all`` over the model group: split_axis 1 and
concat_axis 2 of (B, n1, n2k) forward, 2 and 1 of (B, n1k, n2) back, as
JAX's ``a2a_fwd`` / ``a2a_inv`` (l.681-687).  A constant's per-shard
operands (its spectrum rows, its folded tables) then hold the rank's own
shard alone.

Dispatch is on the input's device, as in ``ops/ntt_mxu.py``: a CUDA tensor
launches the kernel of ``csrc/sharded_mxu.cu`` (or raises), a CPU tensor
runs the twin, anything else raises.  Each launch adds one to its kernel's
count in ``KERNELS``.  The twins compute in int64, with the port's merged
stages along j1 (``ops/ntt.py``) and float64 digit products
(``ops/ntt_mxu.py::digit_product``); every output is canonical.

A constant's spectrum is device-major, (n,) with shard d's row at
[d*nloc, (d+1)*nloc), or (k, nloc): what JAX's fixed ``prepare`` returns
(l.765-778), there lazy, here canonical.  The kernels take either, or the
(S, nloc) rows of the S shards they are given alone (a rank's own row;
``sharded_mxu_tables.rank_spectrum`` takes it from JAX's).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops import ntt as N
from ..ops.modmul import mulmod_barrett
from ..ops.mxu_tables import _group_bias, _split_bias
from ..ops.ntt_fused import Kernel, _check
from ..ops.ntt_mxu import (_check_shapes, _digit_planes, block_rows,
                           digit_product, recombine)
from ..ops.tables import get_tables
from .distributed import Pending, all_to_all
from .mesh import on_mesh
from .sharded_mxu_tables import (CompactLayout, SpPlans, compact_depth,
                                 compact_layout, compact_tables,
                                 expand_compact, fourstep_fold_blocks,
                                 fourstep_mxu_plans)

__all__ = ["KERNELS", "SpDeviceTables", "SpPlan", "FoldedSpOperand",
           "host_tables", "device_tables", "fold_sp_operand",
           "dense_folded_tables", "plan_for",
           "sp_seg1", "sp_seg2", "sp_seg2_fixed", "sp_seg2_fwd",
           "sp_seg2_folded", "sp_seg3", "seg1_plain", "seg1_compact_plain",
           "compact_class_sums", "CompactDims", "SpCompactPlan",
           "seg1_compact_plan", "seg3_compact_plan", "seg3_compact_plain",
           "compact_route", "seg2_plain", "seg2_compact_plain",
           "SpClassPlan", "seg2_compact_plan", "row_compact_fields",
           "table_stride", "seg2_fixed_compact_plan",
           "seg2_folded_compact_plan", "seg2_fwd_compact_plan", "WARP_ROWS",
           "seg2_fixed_plain", "seg2_fixed_compact_plain", "seg2_fwd_plain",
           "seg2_fwd_compact_plain",
           "seg2_folded_plain", "seg2_folded_compact_plain",
           "seg3_plain", "a2a_fwd", "a2a_inv", "to_shards", "from_shards",
           "polymul_fourstep_mxu", "polymul_fourstep_mxu_plain",
           "polymul_fourstep_mxu_fn", "local_pipeline_fn",
           "fixed_spectrum", "polymul_fixed_fourstep_mxu",
           "polymul_fixed_fourstep_mxu_plain",
           "polymul_fixed_folded_fourstep_mxu",
           "polymul_fixed_folded_fourstep_mxu_plain",
           "polymul_fixed_fourstep_mxu_fn",
           "polymul_fixed_folded_fourstep_mxu_fn", "local_fixed_pipeline_fn",
           "chunk_count", "column_split", "fold_sp_blocks"]

CUDA_SOURCE = "qtesla_tpu_torch/csrc/sharded_mxu.cu"

_JAX = "qtesla_tpu/parallel/sharded_mxu.py"
# ``smem_rows``: operand rows per batch row held in shared memory
KERNELS: dict[str, Kernel] = {k.name: k for k in (
    Kernel("sp_seg1", "qt_sp_seg1", f"{_JAX}:481", 1),
    Kernel("sp_seg2", "qt_sp_seg2", f"{_JAX}:520", 2),
    Kernel("sp_seg2_fixed", "qt_sp_seg2_fixed", f"{_JAX}:533", 1),
    Kernel("sp_seg2_fwd", "qt_sp_seg2_fwd", f"{_JAX}:548", 1),
    Kernel("sp_seg2_folded", "qt_sp_seg2_folded", f"{_JAX}:563", 1),
    Kernel("sp_seg3", "qt_sp_seg3", f"{_JAX}:622", 1),
)}

_CLASS_BIAS = 1 << 24      # the kernel adds it to each class sum c_j
_I64, _U32 = torch.int64, torch.uint32


# ----------------------------------------------------------------------
# Tables on the device.
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class SpDeviceTables:
    """The SP plans' digit tables in the kernels' layout, on one device.

    ``w1``, ``w2i``, ``w3``, ``w3x`` int8 (k, A, D*TW, kp): tile t of shard
    d maps output lane o of class j (row j*TW + o) from plane i, input lane
    l (column i*TW + l), zero past din*TW; ``w2f`` int8 (D*TW, kp), the one
    shared row table; ``c1``, ``c2i``, ``c3``, ``c3x`` uint32 (k, A, TW) and
    ``c2f`` (TW,) the const rows; ``tw`` the n1-point packed twiddles (4,
    n1).  ``w3x``/``c3x`` are K3 under p3x, the folded path's plan.
    ``w1c`` int8 (k, A, nblk, D*s, kp), ``w2ic``, ``w3c`` and ``w3xc`` are
    K1's, K2i's and K3's (under p3 and p3x) nonzero blocks alone
    (``compact_tables``: lambda-major blocks of Bk lanes for K1 and K3, the
    n2-blocks for K2i), what B11, B12, B18 and B16 multiply, and ``w2fc``
    int8 (nblk, D*s, kp) K2f's, the n2-blocks of the one shared row table,
    what B12, B13 and B14 multiply; B17 shares ``w1c`` with B11; the dense
    ``w2f``, ``w1``, ``w2i``, ``w3`` and ``w3x`` serve the twins alone and
    are None past n = ``DENSE_MAX_N``, where the twins read the compact
    blocks."""

    w1: torch.Tensor | None
    c1: torch.Tensor
    w2f: torch.Tensor | None
    c2f: torch.Tensor
    w2i: torch.Tensor | None
    c2i: torch.Tensor
    w3: torch.Tensor | None
    c3: torch.Tensor
    tw: torch.Tensor
    w3x: torch.Tensor | None
    c3x: torch.Tensor
    w1c: torch.Tensor
    w2ic: torch.Tensor
    w3c: torch.Tensor
    w3xc: torch.Tensor
    w2fc: torch.Tensor

    def tensors(self):
        return (self.w1, self.c1, self.w2f, self.c2f, self.w2i, self.c2i,
                self.w3, self.c3, self.tw, self.w3x, self.c3x, self.w1c,
                self.w2ic, self.w3c, self.w3xc, self.w2fc)


def _depth(din: int, TW: int) -> int:
    """A plan's table depth: din*TW rounded up to a multiple of 32."""
    return -(-din * TW // 32) * 32


def _kernel_layout(W: np.ndarray) -> torch.Tensor:
    """(..., din, TW, D*TW) input-major digit tables -> (..., D*TW, kp),
    output axis first, zero-padded to the kernel's depth."""
    *lead, din, TW, dtw = W.shape
    out = np.zeros((*lead, dtw, _depth(din, TW)), dtype=np.int8)
    out[..., :din * TW] = np.moveaxis(W, -1, -3).reshape(*lead, dtw,
                                                          din * TW)
    return torch.from_numpy(out)


def _const_rows(c: np.ndarray) -> torch.Tensor:
    """(..., 1, TW) const rows -> (..., TW), in new storage."""
    return torch.from_numpy(c[..., 0, :].copy())


# float64 bytes of tables a compact twin's product takes at once
_TWIN_BYTES = 1 << 30

# the largest ring whose dense tables (the dense twins' alone) are built:
# every shipped set and n = 8192 (75 MB a table at n = 65536); past it the
# twins read the compact blocks, as the kernels do
DENSE_MAX_N = 8192


def _dense(plans: SpPlans) -> bool:
    return plans.n <= DENSE_MAX_N


def _tables_on(plans: SpPlans, device: torch.device) -> SpDeviceTables:
    """The kernel-layout tables on ``device``: the compact blocks as the
    plan holds them (a plan made on ``device`` lends them), the dense
    tables (which the twins alone read) up to n = ``DENSE_MAX_N`` and None
    past it."""
    dense = _dense(plans)

    def lay_out(p):
        return _kernel_layout(p.W) if dense else None

    tabs = (lay_out(plans.p1), _const_rows(plans.p1.const),
            lay_out(plans.p2f), _const_rows(plans.p2f.const),
            lay_out(plans.p2i), _const_rows(plans.p2i.const),
            lay_out(plans.p3), _const_rows(plans.p3.const),
            torch.from_numpy(plans.t1.packed.copy()),
            lay_out(plans.p3x), _const_rows(plans.p3x.const),
            *(getattr(plans, p).Wc for p in ("p1", "p2i", "p3", "p3x",
                                             "p2f")))
    return SpDeviceTables(*(None if t is None else t.to(device)
                            for t in tabs))


def host_tables(plans: SpPlans) -> SpDeviceTables:
    """``_tables_on(plans)`` on the CPU: the dense tables and const rows in
    new storage, the compact blocks of a CPU plan as it holds them."""
    return _tables_on(plans, torch.device("cpu"))


@functools.lru_cache(maxsize=None)
def device_tables(plans: SpPlans, device: torch.device) -> SpDeviceTables:
    """``_tables_on(plans, device)``, made once per device."""
    return _tables_on(plans, torch.device(device))


class FoldedSpOperand(NamedTuple):
    """One constant's folded segment-2 tables in the kernel's layout, on one
    device: ``w`` int8 (k, A, nblk, D*s, kp), the nonzero blocks of
    ``fourstep_fold_tables``'s W (F is block-diagonal over the n2-blocks of
    a tile, as K2i is: ``compact_tables`` under the "rows" layout), what B15
    multiplies, and ``c`` uint32 (k, A, TW), its const rows.  A tuple, so
    that ``multiply(x, *prepare(a))`` reads as in JAX."""

    w: torch.Tensor
    c: torch.Tensor


def fold_sp_operand(W: np.ndarray, c: np.ndarray, plans: SpPlans,
                    device) -> FoldedSpOperand:
    """The operand of a (W, const) pair of ``fourstep_fold_tables`` (or of
    JAX's, through ``from_jax_fourstep_fold_tables``) on ``device``: W's
    nonzero blocks under ``plans``' "rows" layout, once per constant.
    Raises if W is not block-diagonal over the n2-blocks."""
    return FoldedSpOperand(
        torch.from_numpy(compact_tables(W, compact_layout(plans, "rows")))
        .to(device), _const_rows(c).to(device))


def fold_sp_blocks(Wc: torch.Tensor, c: torch.Tensor,
                   device) -> FoldedSpOperand:
    """The operand of a (Wc, const) pair of ``fourstep_fold_blocks`` on
    ``device``: its nonzero blocks as they are, once per constant."""
    return FoldedSpOperand(Wc.to(device), c[..., 0, :].clone().to(device))


def dense_folded_tables(fold: FoldedSpOperand, plans: SpPlans) -> torch.Tensor:
    """The dense tables int8 (k, A, D*TW, kp) of a folded operand, W with
    the output axis first (``expand_compact``), on the operand's device:
    what ``seg2_folded_plain`` multiplies."""
    W = expand_compact(fold.w.cpu().numpy(), compact_layout(plans, "rows"),
                       plans.p2x.din)
    return _kernel_layout(W).to(fold.w.device)


# the slots of SpDeviceTables.tensors() that hold the dense tables
_DENSE_SLOTS = (0, 2, 4, 6, 9)


def _check_tables(tabs: SpDeviceTables, plans: SpPlans, like) -> None:
    k, A, TW, D = plans.k, plans.A, plans.TW, plans.D
    i8, u32 = torch.int8, torch.uint32
    kp = {p: _depth(getattr(plans, p).din, TW)
          for p in ("p1", "p2f", "p2i", "p3", "p3x")}
    want = ((i8, (k, A, D * TW, kp["p1"])), (u32, (k, A, TW)),
            (i8, (D * TW, kp["p2f"])), (u32, (TW,)),
            (i8, (k, A, D * TW, kp["p2i"])), (u32, (k, A, TW)),
            (i8, (k, A, D * TW, kp["p3"])), (u32, (k, A, TW)),
            (u32, (4, plans.n1)),
            (i8, (k, A, D * TW, kp["p3x"])), (u32, (k, A, TW)),
            (i8, (k, A, *_compact_shape(plans, "columns", D,
                                        plans.p1.din))),
            (i8, (k, A, *_compact_shape(plans, "rows", D, plans.p2i.din))),
            (i8, (k, A, *_compact_shape(plans, "columns", D, plans.p3.din))),
            (i8, (k, A, *_compact_shape(plans, "columns", D,
                                        plans.p3x.din))),
            (i8, _compact_shape(plans, "rows", D, plans.p2f.din)))
    # past DENSE_MAX_N the dense slots hold None (``host_tables``)
    _check_shapes("SP tables", tabs.tensors(), want, like,
                  () if _dense(plans) else _DENSE_SLOTS)


def _compact_shape(plans: SpPlans, kind: str, D: int, din: int) -> tuple:
    """(nblk, D*s, kp) of one tile's compact tables."""
    lay = compact_layout(plans, kind)
    return lay.nblk, D * lay.s, compact_depth(din, lay.s)


def _shard_rows(t: torch.Tensor, plans: SpPlans, sl, what: str):
    """Shards sl's part of a per-shard operand (k or S rows on dim 0): t[sl]
    where it holds every shard's part, t where it holds the S shards' own
    (a rank's)."""
    S = sl.stop - sl.start
    if t.shape[0] == plans.k:
        return t[sl]
    if t.shape[0] == S:
        return t
    raise ValueError(f"{what} must hold {plans.k} shards or the {S} given, "
                     f"got {tuple(t.shape)}")


def _check_folded(fold, plans: SpPlans, like, sl) -> None:
    A, TW, p = plans.A, plans.TW, plans.p2x
    S = sl.stop - sl.start
    rows = S if fold.w.dim() and fold.w.shape[0] == S else plans.k
    _check_shapes("folded SP operand", tuple(fold),
                  ((torch.int8, (rows, A, *_compact_shape(
                      plans, "rows", p.Dout, p.din))),
                   (torch.uint32, (rows, A, TW))), like)


# ----------------------------------------------------------------------
# Plain versions (int64; float64 for the digit products).
# ----------------------------------------------------------------------

def _product(v: torch.Tensor, w: torch.Tensor, c: torch.Tensor, p,
             plans: SpPlans) -> torch.Tensor:
    """(S, R, nloc) values below plan p's split bound through per-(shard,
    tile) tables w (S or 1, A or 1, D*TW, kp) and rows c; canonical."""
    S, R = v.shape[:2]
    out = digit_product(v.reshape(S, R, plans.A, plans.TW), w, c,
                        _group_bias(p.groups, p.bounds, plans.q), p.off,
                        p.din, p.base, plans.q, w.shape[-2] // plans.TW)
    return out.reshape(S, R, plans.nloc)


def _along_j1(v: torch.Tensor, plans: SpPlans, fn) -> torch.Tensor:
    """fn applied to the n1-point transform along j1 of (S, R, nloc)."""
    S, R = v.shape[:2]
    v = v.reshape(S, R, plans.n1, plans.n2k).transpose(-1, -2)
    return fn(v).transpose(-1, -2).reshape(S, R, plans.nloc)


def _tabs(tabs, plans: SpPlans, like) -> SpDeviceTables:
    return tabs if tabs is not None else device_tables(plans, like.device)


def _wide_stages(x, plans: SpPlans, tabs: SpDeviceTables) -> torch.Tensor:
    """The Lr wide stages of the column transform of canonical (S, B,
    nloc); canonical int64."""
    tw = tabs.tw.to(_I64)
    return _along_j1(x.to(_I64), plans, lambda t: N.ntt_fwd_merged(
        t, plans.t1, tw, s_hi=plans.Lr))


def seg1_plain(x, plans: SpPlans, tabs=None, first: int = 0):
    """B11's twin: (S, B, nloc) canonical -> (S, B, nloc) canonical, shard
    s using shard first + s's tables."""
    tabs = _tabs(tabs, plans, x)
    if tabs.w1 is None:
        return seg1_compact_plain(x, plans, tabs, first)
    sl = slice(first, first + x.shape[0])
    return _product(_wide_stages(x, plans, tabs), tabs.w1[sl], tabs.c1[sl],
                    plans.p1, plans).to(_U32)


def compact_class_sums(planes: torch.Tensor, wc: torch.Tensor,
                       lay: CompactLayout, D: int) -> torch.Tensor:
    """``ops/ntt_mxu.py::class_sums`` over the tables' nonzero blocks alone:
    (S, R, A, K'*TW) int64 digit planes, plane-major, against compact tables
    wc int8 (S or 1, A or 1, nblk, D*s, kp); the class sums (S, R, A, D, TW)
    by lane.  Each block multiplies its own s positions of every plane."""
    S, R, A, width = planes.shape
    TW, s, nblk = lay.TW, lay.s, lay.nblk
    kin = width // TW
    lane, pos, korder = (torch.from_numpy(a).to(planes.device)
                         for a in (lay.lane, lay.pos, lay.korder))
    # (S, A, nblk, R, K'*s) @ (S, A, nblk, K'*s, D*s), each block's positions
    # in its table's depth order
    P = planes.reshape(S, R, A, kin, TW)[..., lane].reshape(
        S, R, A, kin, nblk, s)[..., korder].permute(
        0, 2, 4, 1, 3, 5).reshape(S, A, nblk, R, kin * s)
    # a chunk of tiles at a time, so that no float64 copy of the tables
    # passes _TWIN_BYTES (K2i's blocks are 9.5 GB at n = 2^22)
    tiles = wc.shape[-4] if wc.ndim >= 4 else 1
    per_tile = 8 * wc[..., :kin * s].numel() // tiles
    step = max(1, min(A, _TWIN_BYTES // per_tile))
    parts = []
    for a0 in range(0, A, step):
        w = (wc[..., a0:a0 + step, :, :, :kin * s] if tiles > 1
             else wc[..., :kin * s])
        parts.append(torch.matmul(
            P[:, a0:a0 + step].to(torch.float64),
            w.to(torch.float64).transpose(-1, -2)).to(_I64))
    c = torch.cat(parts, dim=1).reshape(S, A, nblk, R, D, s).permute(
        0, 3, 1, 4, 2, 5)
    return c.reshape(S, R, A, D, TW)[..., pos]


def _compact_product(v: torch.Tensor, wc: torch.Tensor, c: torch.Tensor, p,
                     plans: SpPlans, kind: str) -> torch.Tensor:
    """``_product`` against the compact tables wc of ``kind``."""
    S, R = v.shape[:2]
    D = wc.shape[-2] // compact_layout(plans, kind).s
    planes = _digit_planes(v.reshape(S, R, plans.A, plans.TW), p.off, p.din,
                           p.base)
    out = recombine(compact_class_sums(planes, wc,
                                       compact_layout(plans, kind), D), c,
                    _group_bias(p.groups, p.bounds, plans.q), plans.q)
    return out.reshape(S, R, plans.nloc)


def seg1_compact_plain(x, plans: SpPlans, tabs=None, first: int = 0):
    """``seg1_plain`` reading the compact K1 (``tabs.w1c``): what B11
    multiplies.  The dense twin past ``DENSE_MAX_N``, the tests and the chip
    check use it."""
    tabs = _tabs(tabs, plans, x)
    sl = slice(first, first + x.shape[0])
    return _compact_product(_wide_stages(x, plans, tabs), tabs.w1c[sl],
                            tabs.c1[sl], plans.p1, plans, "columns").to(_U32)


def _column_inv(v, plans: SpPlans, tabs: SpDeviceTables) -> torch.Tensor:
    """The Lr inverse wide stages along j1 (n1^{-1} in the last) of
    canonical int64 (S, B, nloc); canonical uint32."""
    tw = tabs.tw.to(_I64)
    L1 = plans.n1.bit_length() - 1
    return _along_j1(v, plans, lambda t: N.intt_inv_merged(
        t, plans.t1, tw, s_lo=L1 - plans.Lr)).to(_U32)


def seg3_compact_plain(w, plans: SpPlans, tabs=None, first: int = 0,
                       folded: bool = False):
    """``seg3_plain`` reading the compact K3 (``tabs.w3c``, under p3x
    ``tabs.w3xc``): what B16 multiplies.  The dense twin past
    ``DENSE_MAX_N``, the tests and the chip check use it."""
    tabs = _tabs(tabs, plans, w)
    sl = slice(first, first + w.shape[0])
    w3c, c3, p3 = ((tabs.w3xc, tabs.c3x, plans.p3x) if folded
                   else (tabs.w3c, tabs.c3, plans.p3))
    return _column_inv(_compact_product(w.to(_I64), w3c[sl], c3[sl], p3,
                                        plans, "columns"), plans, tabs)


def _rows_inv_compact(Z, plans: SpPlans, tabs: SpDeviceTables,
                      sl) -> torch.Tensor:
    """``_rows_inv`` reading the compact K2i (``tabs.w2ic``)."""
    return _compact_product(Z, tabs.w2ic[sl], tabs.c2i[sl], plans.p2i, plans,
                            "rows").to(_U32)


def _rows_fwd(x, plans: SpPlans, tabs: SpDeviceTables) -> torch.Tensor:
    """The shared row transform K2f of (S, B, nloc); canonical int64."""
    return _product(x.to(_I64), tabs.w2f[None, None], tabs.c2f[None, None],
                    plans.p2f, plans)


def _rows_fwd_compact(x, plans: SpPlans,
                      tabs: SpDeviceTables) -> torch.Tensor:
    """``_rows_fwd`` reading the compact K2f (``tabs.w2fc``)."""
    return _compact_product(x.to(_I64), tabs.w2fc[None, None],
                            tabs.c2f[None, None], plans.p2f, plans, "rows")


def _rows_inv(Z, plans: SpPlans, tabs: SpDeviceTables, sl) -> torch.Tensor:
    """Shards sl's inverse row transforms K2i of (S, B, nloc) values below
    p2i's split bound; canonical uint32."""
    return _product(Z, tabs.w2i[sl], tabs.c2i[sl], plans.p2i, plans).to(_U32)


def _pointwise(X, Y, plans: SpPlans) -> torch.Tensor:
    ps = plans.ps
    return mulmod_barrett(X, Y, ps.q, ps.r32, ps.r32_shoup, ps.one_shoup)


def seg2_plain(x, y, plans: SpPlans, tabs=None, first: int = 0):
    """B12's twin: the row segment of x and y (S, B, nloc), canonical."""
    tabs = _tabs(tabs, plans, x)
    if tabs.w2f is None:
        return seg2_compact_plain(x, y, plans, tabs, first)
    sl = slice(first, first + x.shape[0])
    Z = _pointwise(_rows_fwd(x, plans, tabs), _rows_fwd(y, plans, tabs), plans)
    return _rows_inv(Z, plans, tabs, sl)


def seg2_compact_plain(x, y, plans: SpPlans, tabs=None, first: int = 0):
    """``seg2_plain`` reading the compact K2f and K2i (``tabs.w2fc``,
    ``tabs.w2ic``): what B12 multiplies.  The dense twin past
    ``DENSE_MAX_N``, the tests and the chip check use it."""
    tabs = _tabs(tabs, plans, x)
    sl = slice(first, first + x.shape[0])
    X, Y = (_rows_fwd_compact(t, plans, tabs) for t in (x, y))
    return _rows_inv_compact(_pointwise(X, Y, plans), plans, tabs, sl)


def _spectrum_plain(aspec, plans: SpPlans, sl) -> torch.Tensor:
    """Rows sl of a device-major spectrum (or the shards' own rows) as int64
    (S, 1, nloc)."""
    return _shard_rows(aspec.reshape(-1, plans.nloc), plans, sl,
                       "spectrum")[:, None].to(_I64)


def seg2_fixed_plain(x, aspec, plans: SpPlans, tabs=None, first: int = 0):
    """B13's twin: the row segment of x (S, B, nloc) against the stored
    spectrum ``aspec`` ((k, nloc) or (n,), any uint32: the Barrett product
    is exact for every value, so JAX's lazy spectrum serves too), shard s
    against row first + s; canonical."""
    tabs = _tabs(tabs, plans, x)
    if tabs.w2f is None:
        return seg2_fixed_compact_plain(x, aspec, plans, tabs, first)
    sl = slice(first, first + x.shape[0])
    return _rows_inv(_pointwise(_rows_fwd(x, plans, tabs),
                                _spectrum_plain(aspec, plans, sl), plans),
                     plans, tabs, sl)


def seg2_fixed_compact_plain(x, aspec, plans: SpPlans, tabs=None,
                             first: int = 0):
    """``seg2_fixed_plain`` reading the compact K2f and K2i (``tabs.w2fc``,
    ``tabs.w2ic``): what B13 multiplies.  The dense twin past
    ``DENSE_MAX_N`` and the tests use it."""
    tabs = _tabs(tabs, plans, x)
    sl = slice(first, first + x.shape[0])
    X = _rows_fwd_compact(x, plans, tabs)
    return _rows_inv_compact(
        _pointwise(X, _spectrum_plain(aspec, plans, sl), plans), plans, tabs,
        sl)


def seg2_fwd_plain(x, plans: SpPlans, tabs=None, first: int = 0):
    """B14's twin: the forward rows K2f of (S, B, nloc), canonical (JAX
    stores them lazy).  The table is shared, so ``first`` only names the
    shards."""
    tabs = _tabs(tabs, plans, x)
    if tabs.w2f is None:
        return seg2_fwd_compact_plain(x, plans, tabs, first)
    return _rows_fwd(x, plans, tabs).to(_U32)


def seg2_fwd_compact_plain(x, plans: SpPlans, tabs=None, first: int = 0):
    """``seg2_fwd_plain`` reading the compact K2f (``tabs.w2fc``): what B14
    multiplies.  The dense twin past ``DENSE_MAX_N``, the tests and the chip
    check use it."""
    return _rows_fwd_compact(x, plans, _tabs(tabs, plans, x)).to(_U32)


def seg2_folded_plain(x, fold: FoldedSpOperand, plans: SpPlans,
                      first: int = 0):
    """B15's twin: shards first + s of (S, B, nloc) through the constant's
    folded tables under p2x, dense (``dense_folded_tables``); canonical.
    JAX's kernel canonicalises its input first when p2x.canon (l.574-576)
    and reduces after the product when p2x.needs_reduce; the input here is
    B11's canonical output and the recombination is canonical, so nothing
    replays either.  Past ``DENSE_MAX_N`` it reads the compact blocks
    (``seg2_folded_compact_plain``)."""
    if not _dense(plans):
        return seg2_folded_compact_plain(x, fold, plans, first)
    sl = slice(first, first + x.shape[0])
    return _product(x.to(_I64), _shard_rows(dense_folded_tables(fold, plans),
                                            plans, sl, "folded SP operand"),
                    _shard_rows(fold.c, plans, sl, "folded SP operand"),
                    plans.p2x, plans).to(_U32)


def seg2_folded_compact_plain(x, fold: FoldedSpOperand, plans: SpPlans,
                              first: int = 0):
    """``seg2_folded_plain`` over the operand's compact blocks as they are
    (``fold.w``): what B15 multiplies.  The dense twin past ``DENSE_MAX_N``,
    the tests and the chip check use it."""
    sl = slice(first, first + x.shape[0])
    w, c = (_shard_rows(t, plans, sl, "folded SP operand") for t in fold)
    return _compact_product(x.to(_I64), w, c, plans.p2x, plans,
                            "rows").to(_U32)


def seg3_plain(w, plans: SpPlans, tabs=None, first: int = 0,
               folded: bool = False):
    """B16's twin: the inverse column segment of (S, B, nloc), canonical;
    ``folded`` takes K3 under p3x, the folded path's plan."""
    tabs = _tabs(tabs, plans, w)
    if tabs.w3 is None:
        return seg3_compact_plain(w, plans, tabs, first, folded)
    sl = slice(first, first + w.shape[0])
    w3, c3, p3 = ((tabs.w3x, tabs.c3x, plans.p3x) if folded
                  else (tabs.w3, tabs.c3, plans.p3))
    return _column_inv(_product(w.to(_I64), w3[sl], c3[sl], p3, plans), plans,
                       tabs)


# ----------------------------------------------------------------------
# Layouts.
# ----------------------------------------------------------------------

def _permute(v: torch.Tensor, shape, dims, out_shape) -> torch.Tensor:
    """A copy of uint32 v viewed as ``shape``, permuted by ``dims``, as
    ``out_shape`` (through int32 storage: torch has few uint32 kernels)."""
    return v.view(torch.int32).reshape(shape).permute(dims).reshape(
        out_shape).view(_U32)


def to_shards(x: torch.Tensor, plans: SpPlans) -> torch.Tensor:
    """(B, n) -> the stacked coefficient shards (k, B, nloc)."""
    B = x.shape[0]
    return _permute(x, (B, plans.n1, plans.k, plans.n2k), (2, 0, 1, 3),
                    (plans.k, B, plans.nloc))


def from_shards(z: torch.Tensor, plans: SpPlans) -> torch.Tensor:
    """The stacked coefficient shards (k, B, nloc) -> (B, n)."""
    B = z.shape[1]
    return _permute(z, (plans.k, B, plans.n1, plans.n2k), (1, 2, 0, 3),
                    (B, plans.n))


def a2a_fwd(v: torch.Tensor, plans: SpPlans) -> torch.Tensor:
    """Coefficient shards (k, B, n1, n2k) -> spectral shards (k, B, n1k,
    n2), each flat as (k, B, nloc)."""
    k, B = v.shape[:2]
    return _permute(v, (k, B, k, plans.n1k, plans.n2k), (2, 1, 3, 0, 4),
                    (k, B, plans.nloc))


def a2a_inv(v: torch.Tensor, plans: SpPlans) -> torch.Tensor:
    """The inverse of ``a2a_fwd``."""
    k, B = v.shape[:2]
    return _permute(v, (k, B, plans.n1k, k, plans.n2k), (3, 1, 0, 2, 4),
                    (k, B, plans.nloc))


# ----------------------------------------------------------------------
# Kernel launch.
# ----------------------------------------------------------------------

class SpPlan(ctypes.Structure):
    """The plan values the kernels take at run time; field for field the
    ``SpPlan`` struct of ``csrc/sharded_mxu.cu``."""

    _fields_ = [(f, ctypes.c_int32) for f in (
        "nloc", "lnloc", "tw", "a", "lr", "logm", "llanes", "d", "rows")] + [
        (f, ctypes.c_uint32) for f in ("q", "r32", "r32_sh", "one_sh")] + [
        ("pw", ctypes.c_uint32 * 4), ("pw_sh", ctypes.c_uint32 * 4)] + [
        (f, t) for i in (1, 2) for f, t in (
            (f"din{i}", ctypes.c_int32), (f"lb{i}", ctypes.c_int32),
            (f"kp{i}", ctypes.c_int32), (f"add{i}", ctypes.c_uint32),
            (f"kb{i}", ctypes.c_uint32))]


def _digit_fields(p, q: int, bias: int, TW: int, i: int) -> dict:
    return {f"din{i}": p.din, f"lb{i}": p.base.bit_length() - 1,
            f"kp{i}": _depth(p.din, TW),
            f"add{i}": (_split_bias(p.din, p.base) - p.off) % (1 << 32),
            f"kb{i}": (_group_bias(p.groups, p.bounds, q) - bias) % q}


# each segment kernel's digit plans (digit plan 1, then 2), by its name in
# ``KERNELS``; "sp_seg3 p3x" is B16 under the folded path's plan
SEGMENTS = {"sp_seg1": ("p1",), "sp_seg2": ("p2f", "p2i"),
            "sp_seg2_fixed": ("p2f", "p2i"), "sp_seg2_fwd": ("p2f",),
            "sp_seg2_folded": ("p2x",), "sp_seg3": ("p3",),
            "sp_seg3 p3x": ("p3x",)}


@functools.lru_cache(maxsize=None)
def plan_for(plans: SpPlans, seg: str) -> SpPlan:
    """The run-time plan of segment ``seg`` (a key of ``SEGMENTS``).  A plan
    outside the kernels' range (more than 4 classes or 6 planes, a class
    bound of 2^24, a tile below 8 lanes) raises."""
    q, TW = plans.q, plans.TW
    digit = tuple(getattr(plans, p) for p in SEGMENTS[seg])
    D = plans.D
    if (D > 4 or max(p.din for p in digit) > 6 or TW < 8
            or max(max(p.bounds) for p in digit) >= _CLASS_BIAS):
        raise ValueError(f"{plans.name}: SP plan (D={D}, din="
                         f"{[p.din for p in digit]}, TW={TW}) is outside the "
                         f"kernels' range")
    # the dense kernels' rows a block; the compact plans set their own
    rows = block_rows(plans.nloc, KERNELS[seg.split()[0]].smem_rows)
    pw = [pow(2, 8 * j, q) for j in range(D)] + [0] * (4 - D)
    bias = _CLASS_BIAS * sum(pw)
    ps = plans.ps
    fields = {f"{f}{i}": 0 for i in (1, 2)
              for f in ("din", "lb", "kp", "add", "kb")}
    for i, p in enumerate(digit, 1):
        fields.update(_digit_fields(p, q, bias, TW, i))
    return SpPlan(
        nloc=plans.nloc, lnloc=plans.nloc.bit_length() - 1, tw=TW,
        a=plans.A, lr=plans.Lr, logm=plans.n1.bit_length() - 1,
        llanes=plans.n2k.bit_length() - 1, d=D, rows=rows, q=q, r32=ps.r32,
        r32_sh=ps.r32_shoup, one_sh=ps.one_shoup,
        pw=(ctypes.c_uint32 * 4)(*pw),
        pw_sh=(ctypes.c_uint32 * 4)(*((w << 32) // q for w in pw)),
        **fields)


# The compact kernels' shared memory (csrc/sharded_mxu.cu and
# sharded_classes.cu compute the same sizes): what one SM has, and what the
# runtime keeps of each block.
_SM_SHARED, _BLOCK_RESERVE = 233472, 1024


class CompactDims(ctypes.Structure):
    """The compact layout of one kind of tables, as the kernels take it:
    blocks of 2^ls lanes, the lane permutation's llam and lbk and the depth
    order's lq (``CompactLayout``), the depth kp of a block; field for field
    the ``CompactDims`` struct of ``csrc/mxu_compact.cuh``."""

    _fields_ = [(f, ctypes.c_int32)
                for f in ("ls", "llam", "lbk", "lq", "kp")]


_COMPACT_FIELDS = [("c1", CompactDims), ("c2", CompactDims),
                   ("smem_tables", ctypes.c_int32)]


class SpCompactPlan(ctypes.Structure):
    """B11's, B16's and B17's run-time plan: ``SpPlan``'s fields, then the
    compact layout ``c1`` of the tables (``c2`` unused), whether the shard's
    tables are held in shared memory (1) or read from L2 (0) and the bias
    B17 adds to each class sum (``cls_b``, 0 for B11 and B16); field for
    field the ``SpCompactPlan`` struct of ``csrc/sharded_mxu.cu``."""

    _fields_ = SpPlan._fields_ + _COMPACT_FIELDS + [
        ("cls_b", ctypes.c_uint32 * 3)]


def _compact_dims(lay: CompactLayout, planes: int) -> CompactDims:
    return CompactDims(ls=lay.ls, llam=lay.llam, lbk=lay.lbk, lq=lay.lq,
                       kp=compact_depth(planes, lay.s))


def planes_stride(nblk: int, kp: int) -> int:
    """Bytes between two rows of block-major digit planes: nblk blocks of
    kp + 8 bytes, padded to 32 mod 64 so that the MMA's row loads spread
    over the banks (``compact_row_stride`` of csrc/mxu_compact.cuh)."""
    ks = nblk * (kp + 8)
    return ks + (96 - ks % 64) % 64


def table_stride(kp: int) -> int:
    """Bytes between two rows of a compact table the row segment kernel
    holds in shared memory: kp rounded up to 32 mod 64, so that a table
    fragment load spreads over the banks (``compact_table_stride`` of
    csrc/mxu_compact.cuh)."""
    return kp + (96 - kp % 64) % 64


def _route(smem_of) -> tuple[int, int] | None:
    """``compact_route``'s pick, or None where no row fits."""
    def fits(rows, tables, blocks):
        return (blocks * (smem_of(rows, tables) + _BLOCK_RESERVE)
                <= _SM_SHARED)

    for tables in (1, 0):
        for blocks, rows in ((2, 16), (1, 32), (1, 16)):
            if fits(rows, tables, blocks):
                return rows, tables
    for rows in range(15, 0, -1):
        if fits(rows, 0, 1):
            return rows, 0
    return None


def compact_route(smem_of) -> tuple[int, int]:
    """(rows, smem_tables) of B11 or B16, whose block takes ``smem_of(rows,
    smem_tables)`` bytes.  In order: the tables in shared memory with two
    blocks an SM at 16 rows a buffer, then with one block at 32 or 16; the
    tables read from L2 the same way, then with as many rows as one block
    fits.  Raises where no row fits (``column_split`` then picks the split
    form)."""
    route = _route(smem_of)
    if route is None:
        raise ValueError("a row does not fit the kernels' shared memory")
    return route


@functools.lru_cache(maxsize=None)
def seg1_compact_plan(plans: SpPlans) -> SpCompactPlan:
    """B11's run-time plan: ``plan_for(plans, "sp_seg1")`` with the compact
    layout of K1, the rows a block holds in each of its two row buffers and
    where it reads the tables.  ``rows`` is 16 with two blocks an SM
    (qtesla-iii-speed, k = 4: 32 KiB of rows, 1 KiB of const rows, 9.5 KiB
    of planes and the shard's 48 KiB of tables), 32 where one block fits,
    fewer where rows are long (n = 8192)."""
    return _column_compact_plan(plans, "sp_seg1")


@functools.lru_cache(maxsize=None)
def seg3_compact_plan(plans: SpPlans, folded: bool = False) -> SpCompactPlan:
    """B16's run-time plan, the counterpart of ``seg1_compact_plan``:
    ``plan_for(plans, "sp_seg3")`` (``"sp_seg3 p3x"`` when ``folded``) with
    the compact layout of K3, which is kron(M, I_n2k) like K1, the rows of
    each row buffer and the route of the tables."""
    return _column_compact_plan(plans, "sp_seg3 p3x" if folded else "sp_seg3")


# words after each row of B17's staged class sums (csrc/sharded_mxu.cu
# kStagePad)
_STAGE_PAD = 2


def _column_smem_of(plans: SpPlans, seg: str, class_sums: bool):
    """The shared memory of one column_compact_kernel block of B11 or B16
    (``seg`` a key of ``SEGMENTS``; ``class_sums``: B17) as a function of
    its rows and route: two row buffers, the const rows (B17: a tile's D
    class planes of ``rows`` rows, TW + 2 words each), a tile's planes, the
    shard's tables."""
    lay = compact_layout(plans, "columns")
    kp = compact_depth(getattr(plans, SEGMENTS[seg][0]).din, lay.s)
    tables = plans.A * plans.D * plans.TW * kp

    def smem_of(rows, smem_tables):
        staged = (plans.D * rows * (plans.TW + _STAGE_PAD) if class_sums
                  else plans.nloc)
        return (2 * rows * plans.nloc * 4 + staged * 4
                + -(-rows // 16) * 16 * planes_stride(lay.nblk, kp)
                + smem_tables * tables)

    return smem_of


def _column_compact_plan(plans: SpPlans, seg: str,
                         class_sums: bool = False) -> SpCompactPlan:
    """The compact plan of a column segment (B11 or B16; ``seg`` a key of
    ``SEGMENTS``) over the "columns" layout of its one digit plan;
    ``class_sums``: B17's, whose block stages a tile's D class planes of
    ``rows`` rows (TW + 2 words each) where B11 keeps its const rows."""
    sp = plan_for(plans, seg)
    rows, smem_tables = compact_route(_column_smem_of(plans, seg,
                                                      class_sums))
    fields = {f: getattr(sp, f) for f, _ in SpPlan._fields_}
    fields.update(rows=rows, smem_tables=smem_tables,
                  c1=_compact_dims(compact_layout(plans, "columns"),
                                   getattr(plans, SEGMENTS[seg][0]).din))
    return SpCompactPlan(**fields)


# ----------------------------------------------------------------------
# The column segments' split form: rows past one block's reach.
# ----------------------------------------------------------------------

def column_split(plans: SpPlans, seg: str = "sp_seg1",
                 class_sums: bool = False) -> bool:
    """Whether the column segment ``seg`` (B11 "sp_seg1", B16 "sp_seg3" or
    "sp_seg3 p3x"; ``class_sums``: B17) runs its split form: where not one
    row of ``column_compact_kernel``'s two row buffers and const rows fits
    a block's shared memory (``compact_route``), from nloc = 32768
    (``parallel/sp_column_split.py``)."""
    return _route(_column_smem_of(plans, seg, class_sums)) is None


# batch rows of x and of y in one unit of the row segment kernel (B12,
# B18; seg2_compact.cuh's kWarpRows); a warp of B12 takes two units at once,
# one of B13 the rows of two units from x alone
WARP_ROWS = 8


class SpClassPlan(ctypes.Structure):
    """The run-time plan of the row segment kernel (B12-B15, B18); field
    for field the ``SpClassPlan`` struct of ``csrc/seg2_compact.cuh``:
    ``SpPlan``'s, then per input plane j the row segment's split (``cdin``,
    ``clb``, ``cadd``), then the compact layouts (``c1`` the first table,
    ``c2`` K2i) and where the kernel reads its tables."""

    _fields_ = SpPlan._fields_ + [
        (f, ctypes.c_int32 * 3) for f in ("cdin", "clb")] + [
        ("cadd", ctypes.c_uint32 * 3)] + _COMPACT_FIELDS


def row_compact_fields(plans: SpPlans, planes: int, D: int, units: int,
                       fixed: bool = False, one_product: bool = False) -> dict:
    """The row segment kernel's layout fields of a plan whose first product
    splits a value into ``planes`` planes: each warp of a block works on
    ``units`` units of 8 batch rows of x and of y at one n2-block of lanes
    (``rows`` 16 a unit: B12 takes two units at once, B18 one; ``fixed``,
    B13: the rows of ``units`` units from x alone, each a product row, and
    the spectrum's lanes beside the const rows; ``one_product``, B14 and
    B15: the rows of ``units`` units from x alone through one product, so
    no K2i, no p2i planes and one const row: ``c2`` all 0; the kernel's
    mode, not the layout, tells B15's table, the constant's F per shard,
    from B14's, K2f shared by every shard), the compact layouts of the
    first table (``c1``) and of K2i (``c2``), and the route: the block's
    tables sit in shared memory (rows ``table_stride`` apart) where they
    leave room for the planes of at least 8 warps, else they come through
    L2.  Raises where the planes of one warp do not fit a block, or for a
    plan both ``fixed`` and ``one_product``."""
    if fixed and one_product:
        raise ValueError("a row plan is fixed (B13) or one product (B14, "
                         "B15), not both")
    lay = compact_layout(plans, "rows")
    c1 = _compact_dims(lay, planes)
    c2 = CompactDims() if one_product else _compact_dims(lay, plans.p2i.din)
    const = (3 if fixed else 1 if one_product else 2) * lay.s * 4
    shared = const + D * lay.s * (
        table_stride(c1.kp) + (0 if one_product else table_stride(c2.kp)))
    rows = 2 * WARP_ROWS * units
    warp = (rows * planes_stride(1, c1.kp)
            + (0 if one_product else rows if fixed else rows // 2)
            * planes_stride(1, c2.kp))
    if const + warp + _BLOCK_RESERVE > _SM_SHARED:
        raise ValueError(f"{plans.name}: the planes of one warp ({warp} "
                         f"bytes) do not fit the kernel's shared memory")
    return dict(rows=rows, c1=c1, c2=c2, smem_tables=int(
        shared + 8 * warp + _BLOCK_RESERVE <= _SM_SHARED))


def _slots(ctype, values) -> ctypes.Array:
    return (ctype * 3)(*values)


@functools.lru_cache(maxsize=None)
def seg2_compact_plan(plans: SpPlans) -> SpClassPlan:
    """B12's run-time plan: ``plan_for(plans, "sp_seg2")`` (its dense
    depths kp1 and kp2 giving way to the compact ``c1.kp`` and ``c2.kp``),
    one input plane a value split under p2f (the first slot of ``cdin``,
    ``clb``, ``cadd``), and ``row_compact_fields``: two units, 16 + 16 rows
    a warp, K2f's and K2i's n2-blocks (at qtesla-iii-speed, k = 4, blocks
    of 32 lanes, depths 128 and 96 where the dense tables run 512 and
    384)."""
    return _row_plan(plans, "sp_seg2")


@functools.lru_cache(maxsize=None)
def seg2_fixed_compact_plan(plans: SpPlans) -> SpClassPlan:
    """B13's run-time plan: B12's over the same compact K2f and K2i, its
    warps 32 rows of x (two units' rows, each a product row: the second
    product's two m16 tiles share each table fragment) and the spectrum's
    lanes held beside the const rows."""
    return _row_plan(plans, "sp_seg2_fixed")


@functools.lru_cache(maxsize=None)
def seg2_folded_compact_plan(plans: SpPlans) -> SpClassPlan:
    """B15's run-time plan: ``plan_for(plans, "sp_seg2_folded")`` (one
    input plane split under p2x, its dense depth kp1 giving way to the
    compact ``c1.kp``; no second split) and ``row_compact_fields`` of a
    folded plan: 32 rows of x a warp through one product against the
    constant's block of F for its (shard, tile, n2-block), one const row,
    ``c2`` all 0 (at qtesla-iii-speed, k = 4, blocks of 32 lanes, depth 96
    where the dense F ran 384)."""
    return _row_plan(plans, "sp_seg2_folded")


@functools.lru_cache(maxsize=None)
def seg2_fwd_compact_plan(plans: SpPlans) -> SpClassPlan:
    """B14's run-time plan: ``plan_for(plans, "sp_seg2_fwd")`` (one input
    plane split under p2f, its dense depth kp1 giving way to the compact
    ``c1.kp``; no second split) and ``row_compact_fields`` of a forward
    plan: B15's layout, 32 rows of x a warp through one product against
    K2f's block of this n2-block's place in the tile (``tabs.w2fc``, as
    B12's first product), one const row, ``c2`` all 0 (at
    qtesla-iii-speed, k = 4, blocks of 32 lanes, depth 128 where the dense
    K2f ran 512)."""
    return _row_plan(plans, "sp_seg2_fwd")


def _row_plan(plans: SpPlans, seg: str) -> SpClassPlan:
    """The row segment kernel's plan of B12, B13, B14 or B15 (``seg`` a key
    of ``SEGMENTS``): two units a warp, one input plane split under p2f
    (B15: p2x)."""
    sp = plan_for(plans, seg)
    fields = {f: getattr(sp, f) for f, _ in SpPlan._fields_}
    fields.update(kp1=0, kp2=0, **row_compact_fields(
        plans, sp.din1, sp.d, 2, fixed=seg == "sp_seg2_fixed",
        one_product=seg in ("sp_seg2_folded", "sp_seg2_fwd")))
    return SpClassPlan(
        **fields, cdin=_slots(ctypes.c_int32, (sp.din1,)),
        clb=_slots(ctypes.c_int32, (sp.lb1,)),
        cadd=_slots(ctypes.c_uint32, (sp.add1,)))


def _run_kernel(kernel: Kernel, plan: ctypes.Structure, tables, a, b,
                  width: int) -> torch.Tensor:
    """Run ``kernel`` (an SP launcher's signature) under the run-time
    ``plan`` on CUDA shards a (S, B, ...) and b (or None) into a new
    (S, B, width) output."""
    from ..utils.build import load_library

    out = a.new_empty((*a.shape[:2], width))
    S, batch = a.shape[:2]
    if batch == 0 or S == 0:
        return out
    lib = load_library()
    ptr = [None if t is None else t.data_ptr() for t in tables]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = getattr(lib.cdll, kernel.symbol)(
            a.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), *ptr, batch, S, ctypes.addressof(plan), stream)
    if err != 0:
        raise RuntimeError(f"{kernel.symbol} launch failed: cudaError {err} "
                           f"({lib.error_string(err)})")
    kernel.launches += 1
    return out


def _aligned(what: str, t: torch.Tensor) -> None:
    if t.is_cuda and t.data_ptr() % 16:
        raise ValueError(f"{what}: the kernels need 16-byte aligned data")


def _shards(plans: SpPlans, first: int, *tensors,
            width: int | None = None) -> slice:
    """Check shards (S, B, width) of one shape and device, width nloc unless
    given; the slice of the model axis they hold."""
    width = width or plans.nloc
    for i, t in enumerate(tensors):
        _check(f"shards {i}", t, width)
        if t.dim() != 3:
            raise ValueError(f"shards {i}: expected (shards, B, {width}), "
                             f"got {tuple(t.shape)}")
        _aligned(f"shards {i}", t)
    a = tensors[0]
    for t in tensors[1:]:
        if t.device != a.device or t.shape != a.shape:
            raise ValueError(f"shards on {a.device} {tuple(a.shape)} and "
                             f"{t.device} {tuple(t.shape)}")
    if not 0 <= first or first + a.shape[0] > plans.k:
        raise ValueError(f"shards {first}..{first + a.shape[0] - 1} outside "
                         f"the model axis of {plans.k}")
    return slice(first, first + a.shape[0])


def _prepare(plans: SpPlans, tabs, first: int, *tensors):
    sl = _shards(plans, first, *tensors)
    tabs = _tabs(tabs, plans, tensors[0])
    _check_tables(tabs, plans, tensors[0])
    return tabs, sl


def _spectrum_rows(aspec, plans: SpPlans, like, sl) -> torch.Tensor:
    """Rows sl (S, nloc) of a device-major spectrum, (k, nloc) or (n,), or
    the S shards' own rows (S, nloc), uint32 on ``like``'s device."""
    if not isinstance(aspec, torch.Tensor) or aspec.dtype != _U32:
        raise TypeError(f"spectrum: expected a torch.uint32 tensor, got "
                        f"{getattr(aspec, 'dtype', type(aspec))}")
    S = sl.stop - sl.start
    if tuple(aspec.shape) not in ((plans.k, plans.nloc), (S, plans.nloc),
                                  (plans.n,)):
        raise ValueError(f"spectrum must be ({plans.k}, {plans.nloc}), "
                         f"({S}, {plans.nloc}) or ({plans.n},), got "
                         f"{tuple(aspec.shape)}")
    if aspec.device != like.device or not aspec.is_contiguous():
        raise ValueError(f"spectrum must be contiguous on {like.device}")
    _aligned("spectrum", aspec)
    return _shard_rows(aspec.reshape(-1, plans.nloc), plans, sl, "spectrum")


# ----------------------------------------------------------------------
# Wrappers: kernel for CUDA tensors, plain version for CPU tensors.
# ----------------------------------------------------------------------

def sp_seg1(x, plans: SpPlans, tabs=None, first: int = 0,
            split: bool | None = None) -> torch.Tensor:
    """B11: the column segment of canonical shards x (S, B, nloc), shard s
    using shard first + s's tables; canonical out.  Past one block's row
    (``column_split``) it runs the split form; ``split`` forces either form
    (the tests' means to compare them at small nloc)."""
    tabs, sl = _prepare(plans, tabs, first, x)
    if column_split(plans, "sp_seg1") if split is None else split:
        from .sp_column_split import seg1_split
        return seg1_split(x, plans, tabs, sl)
    if x.is_cuda:
        return _run_kernel(KERNELS["sp_seg1"], seg1_compact_plan(plans),
                           (tabs.w1c[sl], tabs.c1[sl], None, None, tabs.tw),
                           x, None, plans.nloc)
    return seg1_plain(x, plans, tabs, first)


def sp_seg2(x, y, plans: SpPlans, tabs=None,
            first: int = 0) -> torch.Tensor:
    """B12: the row segment (forward rows of x and y, pointwise product,
    inverse rows) of canonical spectral shards (S, B, nloc)."""
    tabs, sl = _prepare(plans, tabs, first, x, y)
    if x.is_cuda:
        return _run_kernel(KERNELS["sp_seg2"], seg2_compact_plan(plans),
                           (tabs.w2fc, tabs.c2f, tabs.w2ic[sl],
                            tabs.c2i[sl], None), x, y, plans.nloc)
    return seg2_plain(x, y, plans, tabs, first)


def sp_seg2_fixed(x, aspec, plans: SpPlans, tabs=None,
                  first: int = 0) -> torch.Tensor:
    """B13: the row segment of canonical spectral shards x (S, B, nloc)
    against a constant's stored spectrum ``aspec`` ((k, nloc) or (n,), any
    uint32), shard s against row first + s; canonical out."""
    tabs, sl = _prepare(plans, tabs, first, x)
    rows = _spectrum_rows(aspec, plans, x, sl)
    if x.is_cuda:
        return _run_kernel(KERNELS["sp_seg2_fixed"],
                           seg2_fixed_compact_plan(plans),
                           (tabs.w2fc, tabs.c2f, tabs.w2ic[sl],
                            tabs.c2i[sl], None), x, rows, plans.nloc)
    return seg2_fixed_plain(x, aspec, plans, tabs, first)


def sp_seg2_fwd(x, plans: SpPlans, tabs=None,
                first: int = 0) -> torch.Tensor:
    """B14: the forward rows K2f of canonical spectral shards (S, B, nloc);
    canonical out."""
    tabs, _ = _prepare(plans, tabs, first, x)
    if x.is_cuda:
        return _run_kernel(KERNELS["sp_seg2_fwd"],
                           seg2_fwd_compact_plan(plans),
                           (tabs.w2fc, tabs.c2f, None, None, None), x, None,
                           plans.nloc)
    return seg2_fwd_plain(x, plans, tabs, first)


def sp_seg2_folded(x, fold: FoldedSpOperand, plans: SpPlans,
                   first: int = 0) -> torch.Tensor:
    """B15: the folded row segment of canonical spectral shards x (S, B,
    nloc), shard s through the tables of shard first + s of ``fold``;
    canonical out."""
    sl = _shards(plans, first, x)
    _check_folded(fold, plans, x, sl)
    if x.is_cuda:
        for t in fold:
            _aligned("folded SP operand", t)
        w, c = (_shard_rows(t, plans, sl, "folded SP operand") for t in fold)
        return _run_kernel(KERNELS["sp_seg2_folded"],
                           seg2_folded_compact_plan(plans),
                           (w, c, None, None, None), x, None, plans.nloc)
    return seg2_folded_plain(x, fold, plans, first)


def sp_seg3(w, plans: SpPlans, tabs=None, first: int = 0,
            folded: bool = False, split: bool | None = None) -> torch.Tensor:
    """B16: the inverse column segment of canonical coefficient-layout
    shards (S, B, nloc); canonical out.  ``folded`` takes K3 under p3x, the
    folded path's plan.  Past one block's row it runs the split form;
    ``split`` forces either form, as ``sp_seg1``'s."""
    tabs, sl = _prepare(plans, tabs, first, w)
    seg = "sp_seg3 p3x" if folded else "sp_seg3"
    if column_split(plans, seg) if split is None else split:
        from .sp_column_split import seg3_split
        return seg3_split(w, plans, tabs, sl, folded)
    if w.is_cuda:
        w3c, c3 = (tabs.w3xc, tabs.c3x) if folded else (tabs.w3c, tabs.c3)
        return _run_kernel(KERNELS["sp_seg3"],
                           seg3_compact_plan(plans, folded),
                           (w3c[sl], c3[sl], None, None, tabs.tw), w, None,
                           plans.nloc)
    return seg3_plain(w, plans, tabs, first, folded)


# ----------------------------------------------------------------------
# The paths.
# ----------------------------------------------------------------------

def _operand(plans: SpPlans, what: str, t) -> torch.Tensor:
    _check(what, t, plans.n)
    return t.reshape(-1, plans.n)


def _operands(plans: SpPlans, x, y):
    x2, y2 = _operand(plans, "x", x), _operand(plans, "y", y)
    if x.shape != y.shape or x.device != y.device:
        raise ValueError(f"operands {tuple(x.shape)} on {x.device} and "
                         f"{tuple(y.shape)} on {y.device} differ")
    return x2, y2


def _spectral(x2, plans: SpPlans, tabs, seg1=None) -> torch.Tensor:
    """(B, n) -> spectral shards (k, B, nloc): seg1 (B11, or its twin) and
    the forward exchange."""
    seg1 = seg1 or sp_seg1
    return a2a_fwd(seg1(to_shards(x2, plans), plans, tabs), plans)


class Exchanges(NamedTuple):
    """The SP path's two exchanges of shards (S, B, nloc), each returning a
    ``Pending``: the stacked form's permutations ``a2a_fwd`` / ``a2a_inv``
    (done at once), or across ranks one ``all_to_all`` over the model group
    each, in flight until ``wait()``."""

    fwd: object
    inv: object


def exchanges(plans: SpPlans, mesh=None) -> Exchanges:
    """The exchanges of ``mesh`` (stacked where None)."""
    if mesh is None or not mesh.across_ranks:
        return Exchanges(lambda v: Pending.ready(a2a_fwd(v, plans)),
                         lambda v: Pending.ready(a2a_inv(v, plans)))
    group = mesh.model_group

    def across(shape, split, concat):
        def exchange(v):
            B = v.shape[1]
            return all_to_all(v.reshape(B, *shape), group, split, concat,
                              async_op=True).then(
                lambda t: t.reshape(1, B, plans.nloc))
        return exchange

    return Exchanges(across((plans.n1, plans.n2k), 1, 2),
                     across((plans.n1k, plans.n2), 2, 1))


def chunk_count(batch: int, chunks: int) -> int:
    """The parts a batch splits into: ``chunks`` where it divides the
    batch, else one (JAX's l.705)."""
    return chunks if chunks > 1 and batch % chunks == 0 else 1


def _polymul_chunks(xs, ys, plans: SpPlans, tabs, first: int,
                    ex: Exchanges) -> list:
    """z's coefficient shards of each chunk of x's and y's (lists of (S, Bc,
    nloc)), as JAX's ``local_polymul`` (l.693-719): B11 on every chunk's x
    and y, each chunk's forward exchanges issued as its B11s end; B12 on a
    chunk once its exchanges are in, its inverse exchange issued; B16 on a
    chunk once that is in.  Chunk i's exchange is in flight while chunk
    i+1's kernels run."""
    sent = [(ex.fwd(sp_seg1(xc, plans, tabs, first)),
             ex.fwd(sp_seg1(yc, plans, tabs, first)))
            for xc, yc in zip(xs, ys)]
    back = [ex.inv(sp_seg2(vx.wait(), vy.wait(), plans, tabs, first))
            for vx, vy in sent]
    return [sp_seg3(w.wait(), plans, tabs, first) for w in back]


def polymul_fourstep_mxu(x, y, plans: SpPlans, tabs=None,
                         chunks: int = 1) -> torch.Tensor:
    """z = x * y mod (X^n + 1) mod q over (B..., n) uint32 tensors, the
    transforms split over the model axis: seg1 on x and y (B11 twice), the
    forward exchange, seg2 (B12), the inverse exchange, seg3 (B16); the
    rows in ``chunk_count(B, chunks)`` chunks, each through its own
    launches."""
    x2, y2 = _operands(plans, x, y)
    tabs = _tabs(tabs, plans, x2)
    nch = chunk_count(x2.shape[0], chunks)
    xs, ys = ([to_shards(c, plans) for c in t.chunk(nch)] for t in (x2, y2))
    zs = [from_shards(z, plans) for z in _polymul_chunks(
        xs, ys, plans, tabs, 0, exchanges(plans))]
    return (zs[0] if nch == 1 else torch.cat(zs)).reshape(x.shape)


def polymul_fourstep_mxu_plain(x, y, plans: SpPlans,
                               tabs=None) -> torch.Tensor:
    """The whole SP path through the twins, on any device."""
    x2, y2 = _operands(plans, x, y)
    tabs = _tabs(tabs, plans, x2)
    vx, vy = (_spectral(t, plans, tabs, seg1_plain) for t in (x2, y2))
    w = a2a_inv(seg2_plain(vx, vy, plans, tabs), plans)
    return from_shards(seg3_plain(w, plans, tabs), plans).reshape(x.shape)


def fixed_spectrum(a, plans: SpPlans, tabs=None) -> torch.Tensor:
    """The device-major spectrum (n,) of a constant a (n values): B11 on its
    one row, the forward exchange and B14, as JAX's fixed ``prepare``
    (l.765-778); canonical."""
    a2 = _operand(plans, "a", a.reshape(-1))
    tabs = _tabs(tabs, plans, a2)
    return sp_seg2_fwd(_spectral(a2, plans, tabs), plans, tabs).reshape(
        plans.n)


def polymul_fixed_fourstep_mxu(x, aspec, plans: SpPlans,
                               tabs=None) -> torch.Tensor:
    """z = x * a over (B..., n) uint32 tensors, ``aspec`` the constant's
    device-major spectrum (``fixed_spectrum``, or JAX's lazy one): seg1 on x
    (B11), the forward exchange, seg2 against the spectrum (B13), the
    inverse exchange, seg3 (B16)."""
    x2 = _operand(plans, "x", x)
    tabs = _tabs(tabs, plans, x2)
    w = sp_seg2_fixed(_spectral(x2, plans, tabs), aspec, plans, tabs)
    return from_shards(sp_seg3(a2a_inv(w, plans), plans, tabs),
                       plans).reshape(x.shape)


def polymul_fixed_fourstep_mxu_plain(x, aspec, plans: SpPlans,
                                     tabs=None) -> torch.Tensor:
    """The fixed SP path through the twins, on any device."""
    x2 = _operand(plans, "x", x)
    tabs = _tabs(tabs, plans, x2)
    w = seg2_fixed_plain(_spectral(x2, plans, tabs, seg1_plain), aspec, plans,
                         tabs)
    return from_shards(seg3_plain(a2a_inv(w, plans), plans, tabs),
                       plans).reshape(x.shape)


def polymul_fixed_folded_fourstep_mxu(x, fold: FoldedSpOperand,
                                      plans: SpPlans,
                                      tabs=None) -> torch.Tensor:
    """z = x * a over (B..., n) uint32 tensors, ``fold`` the constant's
    folded operand: seg1 on x (B11), the forward exchange, one folded
    product (B15), the inverse exchange, seg3 under p3x (B16)."""
    x2 = _operand(plans, "x", x)
    tabs = _tabs(tabs, plans, x2)
    w = sp_seg2_folded(_spectral(x2, plans, tabs), fold, plans)
    return from_shards(sp_seg3(a2a_inv(w, plans), plans, tabs, folded=True),
                       plans).reshape(x.shape)


def polymul_fixed_folded_fourstep_mxu_plain(x, fold: FoldedSpOperand,
                                            plans: SpPlans,
                                            tabs=None) -> torch.Tensor:
    """The folded fixed SP path through the twins, on any device."""
    x2 = _operand(plans, "x", x)
    tabs = _tabs(tabs, plans, x2)
    w = seg2_folded_plain(_spectral(x2, plans, tabs, seg1_plain), fold, plans)
    return from_shards(seg3_plain(a2a_inv(w, plans), plans, tabs,
                                  folded=True), plans).reshape(x.shape)


def _default_n1(name: str) -> int:
    return 1 << (get_tables(name).logn // 2)


def _mesh_plans(name: str, mesh, n1: int | None, segments) -> SpPlans:
    """The plans of ``mesh``'s model axis; raises if a segment's plan is
    outside the kernels' range."""
    plans = fourstep_mxu_plans(name, n1 or _default_n1(name), mesh.model)
    for seg in segments:
        plan_for(plans, seg)
    return plans


def _rank_shards(plans: SpPlans, mesh, *shards) -> None:
    """Check a rank's shards: (B, nloc) each, one shape, on the mesh's
    device."""
    on_mesh(mesh, *shards)
    for i, t in enumerate(shards):
        _check(f"shard {i}", t, plans.nloc)
        if t.dim() != 2 or t.shape != shards[0].shape:
            raise ValueError(f"a rank's shards must be (B, {plans.nloc}) of "
                             f"one shape, got "
                             f"{[tuple(u.shape) for u in shards]}")


def _rank_spectral(xs, plans: SpPlans, tabs, d: int,
                   ex: Exchanges) -> torch.Tensor:
    """A rank's coefficient shard (B, nloc) -> its spectral shard (1, B,
    nloc): B11 and the forward exchange."""
    return ex.fwd(sp_seg1(xs[None], plans, tabs, d)).wait()


def polymul_fourstep_mxu_fn(name: str, mesh, n1: int | None = None,
                            chunks: int = 1):
    """(x, y) -> z, the transform split over the mesh's model axis of k
    shards (B11, B12, B16), the batch in ``chunk_count(B, chunks)`` chunks
    whose exchanges overlap the next chunk's kernels (JAX's ``chunks``).  On
    a stacked mesh x and y are (B..., n) tensors on its device; across
    ranks they are this rank's shards (B, nloc) in the "sp" layout
    (``distributed.global_batch``) and so is z.  A plan the kernels cannot
    take raises here."""
    plans = _mesh_plans(name, mesh, n1,
                        ("sp_seg1", "sp_seg2", "sp_seg3"))
    if not mesh.across_ranks:
        def polymul(x, y):
            on_mesh(mesh, x)
            return polymul_fourstep_mxu(x, y, plans, chunks=chunks)
        return polymul
    ex, d = exchanges(plans, mesh), mesh.model_index

    def polymul_rank(xs, ys):
        _rank_shards(plans, mesh, xs, ys)
        tabs = device_tables(plans, xs.device)
        nch = chunk_count(xs.shape[0], chunks)
        zs = _polymul_chunks([c[None] for c in xs.chunk(nch)],
                             [c[None] for c in ys.chunk(nch)], plans, tabs,
                             d, ex)
        return zs[0][0] if nch == 1 else torch.cat(zs, 1)[0]

    return polymul_rank


def polymul_fixed_fourstep_mxu_fn(name: str, mesh, n1: int | None = None):
    """(prepare, multiply) for products x * a with a constant a, the
    transforms split over the mesh's model axis: ``prepare(a)`` (n values)
    -> a's device-major spectrum (n,), B11 and B14, run once;
    ``multiply(x, aspec)`` (B..., n) -> (B..., n), B11, B13 and B16.
    ``aspec`` may also be JAX's prepared spectrum, its lazy values as a
    uint32 tensor.  Across ranks ``prepare`` returns this rank's row (1,
    nloc) and ``multiply`` takes and returns its shards (B, nloc)
    (``_rank_fixed_pair``).  A plan the kernels cannot take raises here."""
    plans = _mesh_plans(name, mesh, n1, ("sp_seg1", "sp_seg2_fwd",
                                             "sp_seg2_fixed", "sp_seg3"))
    seg2_fwd_compact_plan(plans)
    if mesh.across_ranks:
        return _rank_fixed_pair(plans, mesh, folded=False)

    def prepare(a):
        on_mesh(mesh, a)
        return fixed_spectrum(a, plans)

    def multiply(x, aspec):
        on_mesh(mesh, x)
        return polymul_fixed_fourstep_mxu(x, aspec, plans)

    return prepare, multiply


def _rank_fixed_pair(plans: SpPlans, mesh, folded: bool):
    """A rank's (prepare, multiply) of a fixed SP path.  ``prepare(a)``
    takes the whole constant (n values, on every rank) and returns this
    rank's part: its row (1, nloc) of the device-major spectrum (B11 on its
    columns, the forward exchange, B14), or with ``folded`` that row's
    folded tables' blocks (``fourstep_fold_blocks(..., first=d)``) as a
    one-shard ``FoldedSpOperand``.  ``multiply(x, part)`` (``multiply(x,
    *part)``
    when folded) takes this rank's shard (B, nloc) in the "sp" layout: B11,
    the forward exchange, B13 (or B15), the inverse exchange, B16 (under
    p3x when folded)."""
    ex, d = exchanges(plans, mesh), mesh.model_index

    def spectrum_row(a):
        on_mesh(mesh, a)
        a2 = _operand(plans, "a", a.reshape(-1))
        tabs = device_tables(plans, a2.device)
        v = ex.fwd(sp_seg1(to_shards(a2, plans)[d:d + 1], plans, tabs,
                           d)).wait()
        return sp_seg2_fwd(v, plans, tabs, d).reshape(1, plans.nloc)

    def multiply(xs, const):
        _rank_shards(plans, mesh, xs)
        tabs = device_tables(plans, xs.device)
        v = _rank_spectral(xs, plans, tabs, d, ex)
        w = (sp_seg2_folded(v, const, plans, d) if folded
             else sp_seg2_fixed(v, const, plans, tabs, d))
        return sp_seg3(ex.inv(w).wait(), plans, tabs, d, folded=folded)[0]

    if not folded:
        return spectrum_row, multiply

    def prepare_folded(a):
        return fold_sp_blocks(*fourstep_fold_blocks(
            plans, spectrum_row(a), first=d), mesh.device)

    return prepare_folded, lambda xs, w, c: multiply(
        xs, FoldedSpOperand(w, c))


def polymul_fixed_folded_fourstep_mxu_fn(name: str, mesh,
                                         n1: int | None = None):
    """(prepare, multiply) of the folded fixed SP path: ``prepare(a)`` runs
    B11 and B14 on a, builds its folded tables' nonzero blocks
    (``fourstep_fold_blocks``) on the spectrum's device and returns them on
    the mesh's device as a ``FoldedSpOperand`` (w compact, c);
    ``multiply(x, w, c)`` runs B11, one folded product (B15) and B16
    under p3x.  Called as ``multiply(x, *prepare(a))``, as in JAX; JAX's
    pair carries across as ``fold_sp_operand(
    *from_jax_fourstep_fold_tables(W, c), plans, device)``.  Across ranks
    ``prepare`` returns this rank's shard of the operand and ``multiply``
    takes and returns its shards (B, nloc) (``_rank_fixed_pair``)."""
    plans = _mesh_plans(name, mesh, n1, ("sp_seg1", "sp_seg2_fwd",
                                             "sp_seg2_folded", "sp_seg3 p3x"))
    seg2_fwd_compact_plan(plans)
    seg2_folded_compact_plan(plans)
    if mesh.across_ranks:
        return _rank_fixed_pair(plans, mesh, folded=True)

    def prepare(a):
        on_mesh(mesh, a)
        return fold_sp_blocks(*fourstep_fold_blocks(
            plans, fixed_spectrum(a, plans)), mesh.device)

    def multiply(x, w, c):
        on_mesh(mesh, x)
        return polymul_fixed_folded_fourstep_mxu(x, FoldedSpOperand(w, c),
                                                 plans)

    return prepare, multiply


def local_pipeline_fn(name: str, k: int, n1: int | None = None,
                      device_index: int = 1):
    """The local work of one shard in a model axis of k, without the
    exchanges: (x, y) (B, nloc) -> (B, nloc), seg1 on both operands, seg2,
    seg3 with shard min(device_index, k - 1)'s tables.  Returns
    (pipe, plans).  A k-shard group's throughput is B / t_local, so the SP
    cost per shard against a single-transform kernel is k * t_local /
    t_single."""
    plans = fourstep_mxu_plans(name, n1 or _default_n1(name), k)
    d = min(device_index, k - 1)

    def pipe(x, y):
        tabs = device_tables(plans, x.device)
        vx, vy = (sp_seg1(t[None], plans, tabs, first=d) for t in (x, y))
        w = sp_seg2(vx, vy, plans, tabs, first=d)
        return sp_seg3(w, plans, tabs, first=d)[0]

    return pipe, plans


def local_fixed_pipeline_fn(name: str, k: int, n1: int | None = None):
    """The local work of one shard of a fixed SP path, without the
    exchanges: pipe(x, const) (B, nloc) -> (B, nloc), seg1 on x, then B13
    against ``const``, a device-major spectrum ((k, nloc) or (n,)), or B15
    when ``const`` is a ``FoldedSpOperand``, then seg3 (under p3x after
    B15), with shard min(1, k - 1)'s tables, as
    ``qtesla_tpu/utils/timing.py:349-450`` builds them.  Returns (pipe,
    plans)."""
    plans = fourstep_mxu_plans(name, n1 or _default_n1(name), k)
    d = min(1, k - 1)

    def pipe(x, const):
        tabs = device_tables(plans, x.device)
        v = sp_seg1(x[None], plans, tabs, first=d)
        folded = isinstance(const, FoldedSpOperand)
        w = (sp_seg2_folded(v, const, plans, first=d) if folded
             else sp_seg2_fixed(v, const, plans, tabs, first=d))
        return sp_seg3(w, plans, tabs, first=d, folded=folded)[0]

    return pipe, plans
