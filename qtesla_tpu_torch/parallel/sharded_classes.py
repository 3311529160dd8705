"""The class-sum boundary of the sequence-parallel (SP) polymul: kernels B17
and B18, hand-written CUDA for Hopper, with their plain PyTorch twins.

Counterpart of the class-boundary half of
``qtesla_tpu/parallel/sharded_mxu.py`` (l.887-1147):

- ``sp_seg1_classes``  B17, replaces ``_make_seg1_classes`` (l.972): B11's
  wide stages, digit split and products against K1, without the
  recombination; class m's raw int32 sum c_m is stored as the uint32
  c_m + cls_b[m] at columns [m*nloc + t*TW, ...), so a shard row (nloc
  values) becomes Dout*nloc; from nloc = 32768 in B11's split form (B2's
  sweeps, then ``split_class_sums``: the tile kernel of
  ``csrc/sp_column_split.cu``);
- ``sp_seg2_classes``  B18, replaces ``_make_seg2_classes`` (l.1001): per
  tile and operand, each class plane j split into planes of its own
  (``class_boundary_plan``: din_j of base_j centred at cls_b[j]), one product
  over all of them against the 2^{8j}-scaled K2f tables, one recombination,
  then B12's Barrett pointwise product and K2i; canonical (S, B, nloc) out;
- ``a2a_fwd_classes``: JAX's ``a2a_fwd_c`` (l.1069) as a permutation of the
  stacked shard axis, carrying Dout planes a coefficient; across ranks
  (``distributed.make_global_mesh``) one ``distributed.all_to_all`` over the
  model group, split_axis 2 and concat_axis 3 of (B, Dout, n1, n2k), as
  JAX's, each rank running B17, B18 and B16 on its one shard with ``first``
  its model index;
- the entry points ``polymul_fourstep_mxu_classes_fn(name, mesh)`` (l.1046:
  B17 on x and y, the exchange, B18, the inverse exchange, B16) and
  ``local_pipeline_classes_fn(name, k)`` (l.1117, one shard's work without
  the exchanges).

The first exchange carries Dout times the bytes of the SP path's, and the
row segment splits sum_j din_j planes where B12 splits p2f's.  JAX built
the path to measure that trade; the port keeps it for the same reason.

The kernels take at most 3 classes, as JAX's entry point does (l.1090), and
class bounds below 2^24 (the recombination's bias): ``plan_for`` raises
otherwise, so the four-class p-sets cannot build the path.  B17's output
equals JAX's bit for bit where both hand segment 1's split the same values:
canonical there, which JAX's wide stages give at every registered set's own
n; where they hand on lazy values (n = 8192) the class sums differ and stay
congruent.  Dispatch, launch counts and the stacked (k, B, width) layout are
``sharded_mxu.py``'s.

B18 multiplies only the nonzero n2-blocks of its tables (``w2cc``, the one
diagonal block of the class tables, and ``SpDeviceTables.w2ic``), each warp
taking 8 rows of x and of y at one n2-block through the whole segment, in
the kernel body B12 and B13 run too (``csrc/seg2_compact.cuh``; its plan
type ``SpClassPlan`` and layout ``row_compact_fields`` live in
``sharded_mxu.py``); ``seg2_classes_compact_plain`` is the plain product
over the same tables.  B17 multiplies only K1's nonzero blocks
(``SpDeviceTables.w1c``) in B11's body (``csrc/sharded_mxu.cu``
``column_compact_kernel``, its plan an ``SpCompactPlan`` with the class
biases); ``seg1_classes_compact_plain`` is the plain product over them.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.mxu_tables import _group_bias, _split_bias
from ..ops.ntt_fused import Kernel
from ..ops.ntt_mxu import (_check_shapes, _digit_planes, class_sums,
                           recombine)
from .distributed import all_to_all
from .mesh import on_mesh
from .sharded_mxu import (_CLASS_BIAS, WARP_ROWS, SpClassPlan,
                          SpCompactPlan, SpDeviceTables, SpPlan,
                          _check_tables, _column_compact_plan, column_split,
                          _compact_shape, _const_rows, _default_n1, _depth,
                          _kernel_layout, _operands, _permute,
                          _pointwise, _rank_shards, _rows_inv,
                          _rows_inv_compact, _run_kernel, _shards, _slots,
                          _wide_stages, a2a_inv, compact_class_sums,
                          device_tables, exchanges, from_shards,
                          row_compact_fields, seg3_plain, sp_seg3,
                          to_shards)
from .sharded_mxu import plan_for as sp_plan_for
from .sharded_mxu_tables import (ClassPlan, SpPlans, class_boundary_plan,
                                 compact_layout, compact_tables,
                                 fourstep_mxu_plans)
from .sp_column_split import KERNELS as SPLIT_KERNELS
from .sp_column_split import column_split_plan, column_sweeps

__all__ = ["KERNELS", "ClassDeviceTables", "SpClassPlan", "WARP_ROWS",
           "host_class_tables", "host_compact_class_table",
           "class_device_tables", "plan_for",
           "sp_seg1_classes", "sp_seg2_classes", "seg1_classes_plain",
           "seg1_classes_compact_plain", "split_class_sums",
           "split_class_sums_plain", "seg2_classes_plain",
           "seg2_classes_compact_plain", "a2a_fwd_classes",
           "polymul_fourstep_mxu_classes",
           "polymul_fourstep_mxu_classes_plain",
           "polymul_fourstep_mxu_classes_fn", "local_pipeline_classes_fn"]

CUDA_SOURCE = "qtesla_tpu_torch/csrc/sharded_classes.cu"

_JAX = "qtesla_tpu/parallel/sharded_mxu.py"
# ``smem_rows``: operand rows per batch row held in shared memory
KERNELS: dict[str, Kernel] = {k.name: k for k in (
    Kernel("sp_seg1_classes", "qt_sp_seg1_classes", f"{_JAX}:972", 1),
    Kernel("sp_seg2_classes", "qt_sp_seg2_classes", f"{_JAX}:1001", 2),
)}

# the kernels' class slots (JAX's entry point takes as many, l.1090) and
# planes of one split
_MAX_CLASSES = 3
_MAX_PLANES = 6
_I64, _U32 = torch.int64, torch.uint32


# ----------------------------------------------------------------------
# Tables on the device.
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class ClassDeviceTables:
    """The class path's tables on one device: ``sp`` the SP tables (B17
    takes K1's nonzero blocks ``w1c`` and the twiddles, B18 K2i, B16 K3),
    ``w2c`` int8 (Dout*TW, kp),
    the class tables ``cp.W[j]`` stacked along the plane axis in the
    kernels' layout (one table for every shard and tile, as K2f is),
    ``c2c`` uint32 (k, A, TW) their const rows, and ``w2cc`` int8 (Dout*s,
    kp) the one n2-block of ``w2c`` that is not zero, which B18 multiplies
    (K2f is kron(I, R2): every diagonal block of a tile is the same)."""

    sp: SpDeviceTables
    w2c: torch.Tensor
    c2c: torch.Tensor
    w2cc: torch.Tensor


def host_class_tables(cp: ClassPlan) -> tuple:
    """(w2c, c2c) on the CPU, in new storage."""
    return (_kernel_layout(np.concatenate(cp.W, axis=0)),
            _const_rows(cp.const))


def host_compact_class_table(cp: ClassPlan, plans: SpPlans) -> torch.Tensor:
    """w2cc on the CPU, in new storage: the one diagonal block of the class
    tables.  Raises if they have an entry outside their n2-blocks or two
    blocks differ."""
    blocks = compact_tables(np.concatenate(cp.W, axis=0),
                            compact_layout(plans, "rows"))
    if (blocks != blocks[:1]).any():
        raise ValueError("the class tables' diagonal blocks differ")
    return torch.from_numpy(blocks[0].copy())


@functools.lru_cache(maxsize=None)
def class_device_tables(plans: SpPlans, cp: ClassPlan,
                        device: torch.device) -> ClassDeviceTables:
    """The class path's tables on ``device``, made once per device."""
    return ClassDeviceTables(device_tables(plans, device),
                             *(t.to(device) for t in (
                                 *host_class_tables(cp),
                                 host_compact_class_table(cp, plans))))


def _tabs(tabs, plans: SpPlans, cp: ClassPlan, like) -> ClassDeviceTables:
    return (tabs if tabs is not None
            else class_device_tables(plans, cp, like.device))


def _check_class_tables(tabs: ClassDeviceTables, plans: SpPlans,
                        cp: ClassPlan, like) -> None:
    _check_tables(tabs.sp, plans, like)
    TW = plans.TW
    _check_shapes("class tables", (tabs.w2c, tabs.c2c, tabs.w2cc),
                  ((torch.int8, (cp.Dout * TW, _depth(sum(cp.dins), TW))),
                   (torch.uint32, (plans.k, plans.A, TW)),
                   (torch.int8, _compact_shape(plans, "rows", cp.Dout,
                                               sum(cp.dins))[1:])), like)


# ----------------------------------------------------------------------
# Plain versions (int64; float64 for the digit products).
# ----------------------------------------------------------------------

def seg1_classes_plain(x, plans: SpPlans, cp: ClassPlan, tabs=None,
                       first: int = 0):
    """B17's twin: canonical shards (S, B, nloc) -> (S, B, Dout*nloc)
    uint32, class m of tile t at columns m*nloc + t*TW + o holding
    c_m + cls_b[m]; shard s uses shard first + s's tables (their compact
    blocks past the block form, where the dense K1 is not built)."""
    tabs = _tabs(tabs, plans, cp, x)
    return _seg1_classes(x, plans, cp, tabs, first,
                         compact=tabs.sp.w1 is None)


def seg1_classes_compact_plain(x, plans: SpPlans, cp: ClassPlan, tabs=None,
                               first: int = 0):
    """``seg1_classes_plain`` reading the compact K1 (``tabs.sp.w1c``): what
    B17 multiplies.  The dense twin past ``DENSE_MAX_N``, the tests and the
    chip check use it."""
    return _seg1_classes(x, plans, cp, tabs, first, compact=True)


def _seg1_classes(x, plans: SpPlans, cp: ClassPlan, tabs, first: int,
                  compact: bool) -> torch.Tensor:
    """B17's twin over the dense K1 or (``compact``) its nonzero
    blocks."""
    tabs = _tabs(tabs, plans, cp, x)
    v = _wide_stages(x, plans, tabs.sp)
    if compact:
        return split_class_sums_plain(v, plans, cp, tabs,
                                      slice(first, first + x.shape[0]))
    S, B = x.shape[:2]
    p = plans.p1
    planes = _digit_planes(v.reshape(S, B, plans.A, plans.TW), p.off, p.din,
                           p.base)
    return _biased(class_sums(planes, tabs.sp.w1[first:first + S], cp.Dout),
                   plans, cp)


def _biased(c: torch.Tensor, plans: SpPlans, cp: ClassPlan) -> torch.Tensor:
    """Class sums (S, B, A, D, TW) -> B17's output (S, B, Dout*nloc),
    class m biased by cls_b[m]."""
    S, B = c.shape[:2]
    c = c + torch.tensor(cp.cls_b, dtype=_I64, device=c.device)[:, None]
    return c.transpose(2, 3).reshape(S, B, cp.Dout * plans.nloc).to(_U32)


def split_class_sums(v, plans: SpPlans, cp: ClassPlan, tabs, sl):
    """B17's step after the wide stages, on shards v (S, B, nloc) below
    p1's split bound: the split form's tile kernel, one launch, on CUDA
    tensors (``sp_column_split``); ``split_class_sums_plain`` on CPU
    ones."""
    if not v.is_cuda:
        return split_class_sums_plain(v, plans, cp, tabs, sl)
    return _run_kernel(SPLIT_KERNELS["sp_seg1_classes_split"],
                       plan_for(plans, cp, "sp_seg1_classes_split"),
                       (tabs.sp.w1c[sl], None, None, None, None), v, None,
                       cp.Dout * plans.nloc)


def split_class_sums_plain(v, plans: SpPlans, cp: ClassPlan, tabs, sl):
    """The tile kernel's plain version of B17, on any device: the digit
    split and the products over K1's nonzero blocks (``tabs.sp.w1c``),
    biased class sums (S, B, Dout*nloc) uint32."""
    S, B = v.shape[:2]
    p = plans.p1
    planes = _digit_planes(v.to(_I64).reshape(S, B, plans.A, plans.TW),
                           p.off, p.din, p.base)
    return _biased(compact_class_sums(planes, tabs.sp.w1c[sl],
                                      compact_layout(plans, "columns"),
                                      cp.Dout), plans, cp)


def _class_rows_fwd(u, plans: SpPlans, cp: ClassPlan,
                    tabs: ClassDeviceTables, sl,
                    compact: bool = False) -> torch.Tensor:
    """K2f of class planes u (S, B, Dout*nloc): each plane j split on its
    own, one product over all of them (``compact``: over the one nonzero
    block ``w2cc``, at every n2-block), one recombination; canonical int64
    (S, B, nloc)."""
    S, B = u.shape[:2]
    v = u.to(_I64).reshape(S, B, cp.Dout, plans.A, plans.TW)
    planes = torch.cat([_digit_planes(v[:, :, j], cp.offs[j], cp.dins[j],
                                      cp.bases[j])
                        for j in range(cp.Dout)], dim=-1)
    if compact:
        lay = compact_layout(plans, "rows")
        c = compact_class_sums(
            planes, tabs.w2cc.expand(1, 1, lay.nblk, *tabs.w2cc.shape), lay,
            cp.Dout)
    else:
        c = class_sums(planes, tabs.w2c[None, None], cp.Dout)
    return recombine(c, tabs.c2c[sl], _group_bias(cp.groups, cp.bounds,
                                                  plans.q),
                     plans.q).reshape(S, B, plans.nloc)


def seg2_classes_plain(u, v, plans: SpPlans, cp: ClassPlan, tabs=None,
                       first: int = 0):
    """B18's twin: the row segment of the class planes of x and y (S, B,
    Dout*nloc), B17's output after ``a2a_fwd_classes``; canonical (S, B,
    nloc).  Past the block form it reads the compact tables, as
    ``seg2_classes_compact_plain``."""
    tabs = _tabs(tabs, plans, cp, u)
    if tabs.sp.w2i is None:
        return seg2_classes_compact_plain(u, v, plans, cp, tabs, first)
    sl = slice(first, first + u.shape[0])
    Z = _pointwise(_class_rows_fwd(u, plans, cp, tabs, sl),
                   _class_rows_fwd(v, plans, cp, tabs, sl), plans)
    return _rows_inv(Z, plans, tabs.sp, sl)


def seg2_classes_compact_plain(u, v, plans: SpPlans, cp: ClassPlan,
                               tabs=None, first: int = 0):
    """``seg2_classes_plain`` reading the compact tables (``tabs.w2cc``,
    ``tabs.sp.w2ic``): what B18 multiplies.  The dense twin past
    ``DENSE_MAX_N``, the tests and the chip check use it."""
    tabs = _tabs(tabs, plans, cp, u)
    sl = slice(first, first + u.shape[0])
    Z = _pointwise(_class_rows_fwd(u, plans, cp, tabs, sl, compact=True),
                   _class_rows_fwd(v, plans, cp, tabs, sl, compact=True),
                   plans)
    return _rows_inv_compact(Z, plans, tabs.sp, sl)


def a2a_fwd_classes(v: torch.Tensor, plans: SpPlans,
                    Dout: int) -> torch.Tensor:
    """Class planes of coefficient shards (k, B, Dout, n1, n2k) -> of
    spectral shards (k, B, Dout, n1k, n2), each flat as (k, B, Dout*nloc):
    out[d', b, m, i, s*n2k + l] = in[s, b, m, d'*n1k + i, l]."""
    k, B = v.shape[:2]
    return _permute(v, (k, B, Dout, k, plans.n1k, plans.n2k),
                    (3, 1, 2, 4, 0, 5), (k, B, Dout * plans.nloc))


# ----------------------------------------------------------------------
# Kernel launch.
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def plan_for(plans: SpPlans, cp: ClassPlan,
             seg: str) -> SpCompactPlan | SpClassPlan:
    """The run-time plan of kernel ``seg`` (a key of ``KERNELS``): B17's
    an ``SpCompactPlan``, B11's compact plan (p1's split, K1's blocks) with
    the rows and route that leave room for its staged class sums and with
    the class biases ``cls_b``; B18's an ``SpClassPlan``.  More than 3
    classes, a B18 class bound of 2^24, a class split deeper than the kernel
    takes, planes of one warp that do not fit B18's shared memory, or a plan
    outside B11's or B12's range (``sharded_mxu.plan_for``) raise."""
    q, D = plans.q, cp.Dout
    if D > _MAX_CLASSES:
        raise ValueError(f"{plans.name}: the class boundary takes Dout <= "
                         f"{_MAX_CLASSES} classes ({_JAX}:1090); this plan "
                         f"has Dout = {D}")
    if seg in ("sp_seg1_classes", "sp_seg1_classes_split"):
        # B17 is B11 with its raw class sums staged and stored, in the block
        # form or (its split form) B11's tile kernel's
        plan = (column_split_plan(plans, "sp_seg1")
                if seg == "sp_seg1_classes_split"
                else _column_compact_plan(plans, "sp_seg1", class_sums=True))
        plan = SpCompactPlan.from_buffer_copy(plan)
        plan.cls_b = _slots(ctypes.c_uint32, cp.cls_b)
        return plan
    # B18 holds B12's x and y rows
    sp = sp_plan_for(plans, "sp_seg2")
    fields = {f: getattr(sp, f) for f, _ in SpPlan._fields_}
    planes = sum(cp.dins)
    if (max(cp.bounds) >= _CLASS_BIAS or max(cp.dins) > _MAX_PLANES
            or planes > _MAX_CLASSES * _MAX_PLANES):
        raise ValueError(f"{plans.name}: class plan (dins={cp.dins}, "
                         f"bounds={cp.bounds}) is outside the kernel's "
                         f"range")
    bias = _CLASS_BIAS * sum(sp.pw)
    # the dense depths kp1 and kp2 give way to the compact c1.kp and c2.kp;
    # the row segment kernel's layout is B12's
    fields.update(din1=planes, lb1=0, kp1=0, add1=0, kp2=0,
                  kb1=(_group_bias(cp.groups, cp.bounds, q) - bias) % q,
                  **row_compact_fields(plans, planes, D, 1))
    return SpClassPlan(
        **fields,
        cdin=_slots(ctypes.c_int32, cp.dins),
        clb=_slots(ctypes.c_int32, (b.bit_length() - 1 for b in cp.bases)),
        cadd=_slots(ctypes.c_uint32,
                    ((_split_bias(din, base) - off) % (1 << 32)
                     for din, base, off in zip(cp.dins, cp.bases, cp.offs))))


def _prepare(plans: SpPlans, cp: ClassPlan, tabs, first: int, *tensors,
             width: int | None = None):
    sl = _shards(plans, first, *tensors, width=width)
    tabs = _tabs(tabs, plans, cp, tensors[0])
    _check_class_tables(tabs, plans, cp, tensors[0])
    return tabs, sl


# ----------------------------------------------------------------------
# Wrappers: kernel for CUDA tensors, plain version for CPU tensors.
# ----------------------------------------------------------------------

def sp_seg1_classes(x, plans: SpPlans, cp: ClassPlan, tabs=None,
                    first: int = 0, split: bool | None = None) -> torch.Tensor:
    """B17: canonical shards x (S, B, nloc) -> their biased raw class sums
    (S, B, Dout*nloc), shard s using shard first + s's tables.  Past one
    block's row (``column_split`` with its staged class sums) it runs the
    split form: B2's sweeps, then the tile kernel; ``split`` forces either
    form."""
    tabs, sl = _prepare(plans, cp, tabs, first, x)
    if (column_split(plans, "sp_seg1", class_sums=True) if split is None
            else split):
        return split_class_sums(column_sweeps(x, plans, inverse=False),
                                plans, cp, tabs, sl)
    if x.is_cuda:
        return _run_kernel(KERNELS["sp_seg1_classes"],
                           plan_for(plans, cp, "sp_seg1_classes"),
                           (tabs.sp.w1c[sl], None, None, None, tabs.sp.tw),
                           x, None, cp.Dout * plans.nloc)
    return seg1_classes_plain(x, plans, cp, tabs, first)


def sp_seg2_classes(u, v, plans: SpPlans, cp: ClassPlan, tabs=None,
                    first: int = 0) -> torch.Tensor:
    """B18: the row segment of the class planes of x and y (S, B,
    Dout*nloc); canonical (S, B, nloc) out."""
    tabs, sl = _prepare(plans, cp, tabs, first, u, v,
                        width=cp.Dout * plans.nloc)
    if u.is_cuda:
        return _run_kernel(KERNELS["sp_seg2_classes"],
                             plan_for(plans, cp, "sp_seg2_classes"),
                             (tabs.w2cc, tabs.c2c[sl], tabs.sp.w2ic[sl],
                              tabs.sp.c2i[sl], None), u, v, plans.nloc)
    return seg2_classes_plain(u, v, plans, cp, tabs, first)


# ----------------------------------------------------------------------
# The paths.
# ----------------------------------------------------------------------

def _class_spectral(x2, plans: SpPlans, cp: ClassPlan, tabs,
                    seg1=sp_seg1_classes) -> torch.Tensor:
    """(B, n) -> spectral class planes (k, B, Dout*nloc): seg1 (B17, or
    its twin) and the forward exchange."""
    return a2a_fwd_classes(seg1(to_shards(x2, plans), plans, cp, tabs),
                           plans, cp.Dout)


def polymul_fourstep_mxu_classes(x, y, plans: SpPlans, cp: ClassPlan,
                                 tabs=None) -> torch.Tensor:
    """z = x * y mod (X^n + 1) mod q over (B..., n) uint32 tensors through
    the class boundary: B17 on x and y, the forward exchange of Dout planes,
    B18, the inverse exchange, B16."""
    x2, y2 = _operands(plans, x, y)
    tabs = _tabs(tabs, plans, cp, x2)
    ux, uy = (_class_spectral(t, plans, cp, tabs) for t in (x2, y2))
    w = a2a_inv(sp_seg2_classes(ux, uy, plans, cp, tabs), plans)
    return from_shards(sp_seg3(w, plans, tabs.sp), plans).reshape(x.shape)


def polymul_fourstep_mxu_classes_plain(x, y, plans: SpPlans, cp: ClassPlan,
                                       tabs=None) -> torch.Tensor:
    """The class path through the twins, on any device."""
    x2, y2 = _operands(plans, x, y)
    tabs = _tabs(tabs, plans, cp, x2)
    ux, uy = (_class_spectral(t, plans, cp, tabs, seg1_classes_plain)
              for t in (x2, y2))
    w = a2a_inv(seg2_classes_plain(ux, uy, plans, cp, tabs), plans)
    return from_shards(seg3_plain(w, plans, tabs.sp), plans).reshape(x.shape)


def _class_plans(name: str, k: int, n1: int | None):
    """(plans, cp) of (name, n1, k); raises if a kernel of the path cannot
    take them, before anything runs."""
    n1 = n1 or _default_n1(name)
    plans = fourstep_mxu_plans(name, n1, k)
    cp = class_boundary_plan(name, n1, k)
    split = column_split(plans, "sp_seg1", class_sums=True)
    for seg in ("sp_seg1_classes_split" if split else "sp_seg1_classes",
                "sp_seg2_classes"):
        plan_for(plans, cp, seg)
    sp_plan_for(plans, "sp_seg3")
    return plans, cp


def polymul_fourstep_mxu_classes_fn(name: str, mesh, n1: int | None = None):
    """(x, y) -> z, the transforms split over the mesh's model axis of k
    shards with the class-sum boundary (B17, B18, B16).  On a stacked mesh
    x and y are (B..., n) tensors on its device; across ranks they are this
    rank's shards (B, nloc) in the "sp" layout, and so is z.  A plan the
    kernels cannot take (Dout > 3) raises here."""
    plans, cp = _class_plans(name, mesh.model, n1)
    if not mesh.across_ranks:
        def polymul(x, y):
            on_mesh(mesh, x)
            return polymul_fourstep_mxu_classes(x, y, plans, cp)
        return polymul
    inv, d, D = exchanges(plans, mesh).inv, mesh.model_index, cp.Dout

    def fwd_classes(u):
        B = u.shape[1]
        return all_to_all(u.reshape(B, D, plans.n1, plans.n2k),
                          mesh.model_group, 2, 3, async_op=True).then(
            lambda t: t.reshape(1, B, D * plans.nloc))

    def polymul_rank(xs, ys):
        _rank_shards(plans, mesh, xs, ys)
        tabs = class_device_tables(plans, cp, xs.device)
        ux, uy = [fwd_classes(sp_seg1_classes(t[None], plans, cp, tabs, d))
                  for t in (xs, ys)]
        w = sp_seg2_classes(ux.wait(), uy.wait(), plans, cp, tabs, d)
        return sp_seg3(inv(w).wait(), plans, tabs.sp, d)[0]

    return polymul_rank


def local_pipeline_classes_fn(name: str, k: int, n1: int | None = None,
                              device_index: int = 1):
    """The local work of one shard of the class path in a model axis of k,
    without the exchanges: (x, y) (B, nloc) -> (B, nloc), B17 on both
    operands, B18, B16 with shard min(device_index, k - 1)'s tables.
    Returns (pipe, plans, cp), as JAX's l.1117."""
    plans, cp = _class_plans(name, k, n1)
    d = min(device_index, k - 1)

    def pipe(x, y):
        tabs = class_device_tables(plans, cp, x.device)
        ux, uy = (sp_seg1_classes(t[None], plans, cp, tabs, first=d)
                  for t in (x, y))
        w = sp_seg2_classes(ux, uy, plans, cp, tabs, first=d)
        return sp_seg3(w, plans, tabs.sp, first=d)[0]

    return pipe, plans, cp
