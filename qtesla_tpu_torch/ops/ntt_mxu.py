"""Digit-matmul (MXU-form) kernels B5-B9: hand-written CUDA for Hopper, with
their plain PyTorch twins.

Counterpart of the callers of ``qtesla_tpu/ops/ntt_mxu.py``.  Each
``*_fn(name)`` returns a callable on (B..., n) ``torch.uint32`` tensors:

- ``polymul_mxu_fn``        B5, replaces ``polymul_mxu_fn``'s kernel (ntt_mxu.py:982)
- ``ntt_mxu_fn``            B6, replaces ``ntt_mxu_fn``'s kernel (l.1041)
- ``intt_mxu_fn``           B7, replaces ``intt_mxu_fn``'s kernel (l.1061);
  input below ``pw_bound``
- ``polymul_fixed_mxu_fn``  B8, replaces ``polymul_fixed_mxu_fn``'s kernel
  (l.1012); the spectrum is ``ntt_mxu_fn(name)`` (or any canonical forward
  spectrum) of the constant operand
- ``polymul_fixed_folded_mxu_fn``  B9, replaces the kernel of the function of
  that name (l.1210); the operand is ``fold_operand`` of the constant's
  spectrum: the inverse tables with the spectrum folded into their columns
  (``mxu_tables.fold_tables``), laid out as the stages B5's stream kernel
  copies, so the kernel has no pointwise stage

A transform runs its ``Lr`` wide stages as butterflies and the block-local
rest as one int8 digit-plane product per block of ``bw`` lanes against the
planner's tables (``mxu_tables.py``), recombined as

    out = const + group_bias + sum_j c_j * (2^{8j} mod q)   (mod q).

The plain twins follow that structure (the split as ``_digit_planes`` makes
it, a float64 product, which is exact because every class sum is below
2^24, and an int64 recombination), so the CPU tests check the ported tables
and the formula against the JAX kernels.  Every output is canonical.

Dispatch is on the input's device, as in ``ntt_fused``: a CUDA tensor
launches the kernel of ``csrc/ntt_mxu.cu`` (or raises), a CPU tensor runs
the twin, anything else raises.  Each launch adds one to its kernel's count
in ``KERNELS``.

At n <= 16 the lane block (bw = n) is narrower than the kernel's 32-deep
MMA step: the kernel runs ``mxu_tables.lane_packed(mt)``, 32 / n rows side
by side in one row of 32 lanes against block-diagonal tables
(``kernel_tables``), the batch padded with zero rows to whole packed rows
(``_packed``); plans, tables and operands of the kernel are the packed
ones, the twins run on the n lanes.

From n = ``SPLIT_FROM`` (32768) a row no longer fits the stream kernel's
block, and every wrapper runs the split form (``ntt_mxu_split``): the wide
stages as sweep launches over the rows in device memory and the block-local
ones as one digit-matmul launch a call, each block on one lane block of
many rows.  ``split=True`` forces it at smaller n (for tests); the plan
picks it, nothing falls back to it.  The split form's tables keep no dense
``wf``/``wi``: the twins read the stream (``staged_tables``).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import ntt as N
from .mxu_tables import (STAGE_DEPTH, FixedFoldPlan, MxuTables, _group_bias,
                         _split_bias, _stages, block_diagonal, fold_plan,
                         fold_tables, get_mxu_tables, lane_packed,
                         stream_stages, stream_tables)
from .ntt_fused import Kernel, _check, _check_tw

__all__ = ["KERNELS", "MxuDeviceTables", "MxuPlan", "MxuStreamPlan",
           "FoldedOperand", "SPLIT_FROM", "split_form", "dense_tables",
           "host_tables", "device_tables", "kernel_tables",
           "plan_for",
           "stream_plan", "fold_plan_for", "staged_tables",
           "block_rows", "fold_operand", "polymul_mxu_fn",
           "polymul_fixed_mxu_fn", "polymul_fixed_folded_mxu_fn",
           "ntt_mxu_fn", "intt_mxu_fn", "polymul_mxu", "polymul_fixed_mxu",
           "polymul_fixed_folded_mxu", "ntt_mxu", "intt_mxu",
           "polymul_mxu_plain", "polymul_fixed_mxu_plain",
           "polymul_fixed_folded_mxu_plain", "ntt_mxu_plain",
           "intt_mxu_plain"]

CUDA_SOURCE = "qtesla_tpu_torch/csrc/ntt_mxu.cu"

# ``smem_rows``: operand rows per batch row held in shared memory
KERNELS: dict[str, Kernel] = {k.name: k for k in (
    Kernel("polymul_mxu", "qt_polymul_mxu", "qtesla_tpu/ops/ntt_mxu.py:982",
           2),
    Kernel("ntt_mxu", "qt_ntt_mxu", "qtesla_tpu/ops/ntt_mxu.py:1041", 1),
    Kernel("intt_mxu", "qt_intt_mxu", "qtesla_tpu/ops/ntt_mxu.py:1061", 1),
    Kernel("polymul_fixed_mxu", "qt_polymul_fixed_mxu",
           "qtesla_tpu/ops/ntt_mxu.py:1012", 1),
    Kernel("polymul_fixed_folded_mxu", "qt_polymul_fixed_folded_mxu",
           "qtesla_tpu/ops/ntt_mxu.py:1210", 1),
)}

# operand rows a kernel block holds in shared memory: at most 32 (two
# 16-row MMA tiles) and 128 KiB of uint32
_ROW_BYTES = 128 * 1024
_MAX_ROWS = 32
_CLASS_BIAS = 1 << 24      # the kernel adds it to each class sum c_j
# the row length from which a B5 block holds no row of x and one of y
# (block_rows(n, 2) < 2): every wrapper runs the split form from there
SPLIT_FROM = 32768
# float64 bytes of tables and planes a twin's block product takes at once
_TWIN_BYTES = 1 << 30


def split_form(mt: MxuTables, split: bool | None = None) -> bool:
    """Whether a call on ``mt`` runs the split form: from ``SPLIT_FROM``,
    or where ``split`` forces it (True; False forces the stream kernel)."""
    return mt.n >= SPLIT_FROM if split is None else bool(split)


# ----------------------------------------------------------------------
# Tables on the device.
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class MxuDeviceTables:
    """The planner's tables in the kernel's layout, on one device.

    ``wf`` int8 (nb, D*bw, Df*bw): row j*bw + k' is output lane k' of
    digit class j, its columns the (plane i, input lane k) pairs at
    i*bw + k, i.e. ``MxuTables.wf`` with the output axis first; ``wi``
    likewise.  ``constf`` / ``consti`` uint32 (nb, bw) are the planner's
    const rows.  ``stream`` int8 (nb*(Cf + Ci), 64*bw*D) is ``wf`` and
    ``wi`` again as the stages the stream kernel copies into shared memory
    (``mxu_tables.stream_tables`` of ``lane_packed(mt)``, bw 32 at n <=
    16): B5 and B8 read all of it, B6 and B9 its
    first nb*Cf stages, the forward ones (B9's inverse stages are the
    constant's), B7 the rest, the inverse ones.  The dense ``wf`` and
    ``wi`` are read by the twins alone, and are None from ``SPLIT_FROM``
    (the twins read the stream there, ``dense_tables``)."""

    wf: torch.Tensor | None
    constf: torch.Tensor
    wi: torch.Tensor | None
    consti: torch.Tensor
    stream: torch.Tensor

    def tensors(self):
        return self.wf, self.constf, self.wi, self.consti, self.stream


def _kernel_layout(w) -> torch.Tensor:
    nb, din, bw, dbw = w.shape
    return torch.from_numpy(w).permute(0, 3, 1, 2).reshape(
        nb, dbw, din * bw).contiguous()


def host_tables(mt: MxuTables) -> MxuDeviceTables:
    """The kernel-layout tables on the CPU, in new storage; the stream is
    ``lane_packed(mt)``'s, the one the kernel reads.  From ``SPLIT_FROM``
    no dense ``wf``/``wi``."""
    dense = not split_form(mt)
    return MxuDeviceTables(
        _kernel_layout(mt.wf) if dense else None,
        torch.from_numpy(mt.constf[:, 0].copy()),
        _kernel_layout(mt.wi) if dense else None,
        torch.from_numpy(mt.consti[:, 0].copy()),
        torch.from_numpy(stream_tables(lane_packed(mt))))


@functools.lru_cache(maxsize=None)
def device_tables(mt: MxuTables, device: torch.device) -> MxuDeviceTables:
    """``host_tables(mt)`` on ``device``, made once per device."""
    return MxuDeviceTables(*(None if t is None else t.to(device)
                             for t in host_tables(mt).tensors()))


def dense_tables(tabs: MxuDeviceTables, mt: MxuTables, direction: str):
    """Blocks of one direction's kernel-layout tables as the twins read
    them: ``get(b0, b1)``, (b1 - b0, D*bw, K) int8 of lane blocks b0 .. b1
    - 1, from ``tabs.wf`` / ``tabs.wi`` (K = din*bw) or, where those are
    None, from the stream's stages (``staged_tables``, K = 64 * stages, zero
    past din*bw).  ``direction`` "f" or "i"."""
    w = tabs.wf if direction == "f" else tabs.wi
    if w is not None:
        return lambda b0, b1: w[b0:b1]
    pk = lane_packed(mt)
    if pk is not mt:
        raise ValueError("lane-packed tables keep their dense copies")
    cf, ci = (stream_stages(d, mt.bw) for d in (mt.Df, mt.Di))
    c, first = (cf, 0) if direction == "f" else (ci, mt.nb * cf)
    return lambda b0, b1: staged_tables(
        tabs.stream[first + b0 * c:first + b1 * c], b1 - b0, mt.bw, mt.D)


def kernel_tables(mt: MxuTables, device: torch.device,
                  tabs: MxuDeviceTables | None = None) -> MxuDeviceTables:
    """The tables the stream kernel reads: ``tabs`` (``device_tables(mt,
    device)`` unless given), or at n <= 16 those of ``lane_packed(mt)``."""
    pk = lane_packed(mt)
    if pk is not mt:
        return device_tables(pk, device)
    return device_tables(mt, device) if tabs is None else tabs


@dataclass(frozen=True)
class FoldedOperand:
    """One constant's folded inverse tables as B9 reads them, on one
    device: ``stages`` int8 (nb*C, 64*bw*Dout), ``fold_tables``'s W laid out
    as the stages of the stream kernel (``mxu_tables._stages``, C =
    Din*bw/64 a lane block, the order ``stream_tables`` gives the inverse
    tables), and ``c`` uint32 (nb, bw), its const rows.  No dense copy of W
    is kept: the twin reads the stages back (``staged_tables``)."""

    stages: torch.Tensor
    c: torch.Tensor

    def tensors(self):
        return self.stages, self.c


def fold_operand(spectrum: torch.Tensor, mt: MxuTables) -> FoldedOperand:
    """The folded operand of the constant whose canonical forward spectrum
    is ``spectrum`` (n values), on the spectrum's device, under
    ``fold_plan(mt)``.  The tables are built on the host (``fold_tables``),
    laid out as stages there and copied over once; at n <= 16 as the
    kernel reads them, lane packed (``lane_packed``: 32 / n copies of the
    block on the diagonal)."""
    _check("spectrum", spectrum.reshape(-1), spectrum.numel())
    W, c = fold_tables(mt, fold_plan(mt), spectrum.reshape(-1).cpu().numpy())
    k = lane_packed(mt).bw // mt.bw
    if k > 1:
        W, c = block_diagonal(W, k), np.tile(c, (1, 1, k))
    dev = spectrum.device
    return FoldedOperand(torch.from_numpy(_stages(W)).to(dev),
                         torch.from_numpy(c[:, 0].copy()).to(dev))


def staged_tables(stages: torch.Tensor, nb: int, bw: int,
                  D: int) -> torch.Tensor:
    """Stages (nb*C, 64*bw*D) -> the output-major tables (nb, D*bw, 64*C)
    they hold (``mxu_tables._unstages`` before its input-major move, on any
    device): row j*bw + o, column i*bw + k, zero past the planes."""
    C = stages.shape[0] // nb
    T = stages.reshape(nb, C, bw // 8, D, 8, 4, 2, 8)
    return T.permute(0, 3, 2, 4, 1, 6, 5, 7).reshape(nb, D * bw,
                                                     C * STAGE_DEPTH)


def _check_tables(tabs: MxuDeviceTables, mt: MxuTables, like) -> None:
    """The tables' types, shapes and device; ``wf`` and ``wi`` may be None
    (the twins then read the stream)."""
    nb, bw, D = mt.nb, mt.bw, mt.D
    sw = lane_packed(mt).bw
    stages = nb * (stream_stages(mt.Df, sw) + stream_stages(mt.Di, sw))
    want = ((torch.int8, (nb, D * bw, mt.Df * bw)), (torch.uint32, (nb, bw)),
            (torch.int8, (nb, D * bw, mt.Di * bw)), (torch.uint32, (nb, bw)),
            (torch.int8, (stages, STAGE_DEPTH * sw * D)))
    _check_shapes("MXU tables", tabs.tensors(), want, like, optional=(0, 2))


def _check_shapes(what: str, tensors, want, like, optional=()) -> None:
    for i, (t, (dtype, shape)) in enumerate(zip(tensors, want)):
        if t is None and i in optional:
            continue
        if (t is None or t.dtype != dtype or tuple(t.shape) != shape
                or t.device != like.device or not t.is_contiguous()):
            raise ValueError(f"{what} must be contiguous {dtype} "
                             f"{shape} tensors on {like.device}")


# ----------------------------------------------------------------------
# Plain versions (int64; float64 for the digit products).
# ----------------------------------------------------------------------

_I64, _U32 = torch.int64, torch.uint32


def _digit_planes(v: torch.Tensor, off: int, D: int,
                  base: int) -> torch.Tensor:
    """(..., bw) values -> (..., D*bw) balanced digit planes of v - off,
    plane i at [i*bw, (i+1)*bw): (v + split_bias - off) mod 2^32 read as
    int32, low planes its fields minus base/2, the top plane its
    arithmetic shift."""
    lb = base.bit_length() - 1
    a = (v + (_split_bias(D, base) - off)) % (1 << 32)
    a = torch.where(a >= 1 << 31, a - (1 << 32), a)
    planes = [((a >> (lb * i)) & (base - 1)) - base // 2
              for i in range(D - 1)]
    return torch.cat(planes + [a >> (lb * (D - 1))], dim=-1)


def class_sums(planes: torch.Tensor, w: torch.Tensor, D: int) -> torch.Tensor:
    """The class sums c_j of one digit-matmul per (shard, block): (S, R, nb,
    K') int64 digit planes against kernel-layout tables w int8 (S or 1, nb or
    1, D*bw, K), K >= K' (columns past K' are zero padding); (S, R, nb, D,
    bw) int64, exact in float64 (every product sum is far below 2^53)."""
    S, R, nb, kin = planes.shape
    # (S, nb, R, K') @ (S, nb, K', D*bw)
    c = torch.matmul(planes.transpose(1, 2).to(torch.float64),
                     w[..., :kin].to(torch.float64).transpose(-1, -2))
    return c.to(_I64).reshape(S, nb, R, D, -1).transpose(1, 2)


def recombine(c: torch.Tensor, const: torch.Tensor, group_bias: int,
              q: int) -> torch.Tensor:
    """Class sums c (S, R, nb, D, bw) and const rows (S or 1, nb or 1, bw)
    -> canonical (S, R, nb, bw): const + group_bias + sum_j c_j 2^{8j}."""
    pw = torch.tensor([pow(2, 8 * j, q) for j in range(c.shape[-2])],
                      dtype=_I64, device=c.device)
    out = (const.to(_I64)[:, None] + group_bias
           + (c * pw[:, None]).sum(dim=-2))
    return out % q


def digit_product(v: torch.Tensor, w: torch.Tensor, const: torch.Tensor,
                  group_bias: int, off: int, din: int, base: int, q: int,
                  D: int) -> torch.Tensor:
    """One digit-matmul per (shard, block): (S, R, nb, bw) int64 values below
    the split's bound against kernel-layout tables w int8 (S or 1, nb or 1,
    D*bw, K), K >= din*bw, and const rows (S or 1, nb or 1, bw); canonical
    (S, R, nb, bw) out."""
    return recombine(class_sums(_digit_planes(v, off, din, base), w, D),
                     const, group_bias, q)


def _block_matmul(v: torch.Tensor, w, const: torch.Tensor,
                  group_bias: int, off: int, din: int, base: int,
                  mt: MxuTables) -> torch.Tensor:
    """The block-local stages of one direction on (R, n) int64 values below
    the split's bound against kernel-layout tables ``w`` (nb, D*bw, K), or
    the blocks ``w(b0, b1)`` gives (``dense_tables``), as many lane blocks
    at once as ``_TWIN_BYTES`` of float64 hold; canonical out."""
    get = w if callable(w) else (lambda b0, b1: w[b0:b1])
    R, nb, bw = v.shape[0], mt.nb, mt.bw
    v = v.reshape(1, R, nb, bw)
    step = max(1, _TWIN_BYTES // (8 * (mt.D * bw + R) * din * bw))
    out = []
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        out.append(digit_product(v[:, :, b0:b1], get(b0, b1)[None],
                                 const[None, b0:b1], group_bias, off, din,
                                 base, mt.q, mt.D))
    return torch.cat(out, dim=2).reshape(R, mt.n)


def _fwd_block(v, mt: MxuTables, tabs: MxuDeviceTables):
    """The forward's block-local stages of (R, n) values below
    ``fwd_bound``; canonical out."""
    return _block_matmul(v, dense_tables(tabs, mt, "f"), tabs.constf,
                         mt.group_bias_f, mt.fwd_off, mt.Df, mt.fwd_base, mt)


def _inv_block(X, mt: MxuTables, tabs: MxuDeviceTables):
    """The inverse's block-local stages of (R, n) values below
    ``pw_bound``; canonical out."""
    return _block_matmul(X.to(_I64), dense_tables(tabs, mt, "i"),
                         tabs.consti, mt.group_bias_i, mt.inv_off, mt.Di,
                         mt.inv_base, mt)


def _folded_block(X, op: "FoldedOperand", mt: MxuTables):
    """B9's inverse block matmul of canonical (R, n) X against the
    constant's folded tables (its stages), under the fold plan; canonical
    out."""
    fp = fold_plan(mt)
    pk = lane_packed(mt)
    c = op.c
    if pk is not mt:
        # the first block on the packed diagonal: output lanes j*32 + o,
        # input lanes i*32 + k, o and k below bw
        bw = mt.bw
        w = staged_tables(op.stages, pk.nb, pk.bw, fp.Dout)
        w = w.reshape(1, fp.Dout, pk.bw, -1, pk.bw)[:, :, :bw, :fp.Din, :bw]
        w, c = w.reshape(1, fp.Dout * bw, fp.Din * bw), c[:, :bw]
    else:
        C = op.stages.shape[0] // mt.nb

        def w(b0, b1):
            return staged_tables(op.stages[b0 * C:b1 * C], b1 - b0, mt.bw,
                                 fp.Dout)
    return _block_matmul(X, w, c, _group_bias(fp.groups, fp.bounds, mt.q),
                         fp.off, fp.Din, fp.base, mt)


def _fwd_plain(x, mt: MxuTables, tabs: MxuDeviceTables, tw):
    v = N.ntt_fwd_merged(x.to(_I64), mt.tbl, tw, s_hi=mt.Lr)
    return _fwd_block(v, mt, tabs)


def _inv_plain(X, mt: MxuTables, tabs: MxuDeviceTables, tw):
    return N.intt_inv_merged(_inv_block(X, mt, tabs), mt.tbl, tw,
                             s_lo=mt.logn - mt.Lr)


def polymul_mxu_plain(x, y, mt: MxuTables, tabs=None, tw=None):
    tabs = tabs or device_tables(mt, x.device)
    n = mt.n
    X = _fwd_plain(x.reshape(-1, n), mt, tabs, tw)
    Y = _fwd_plain(y.reshape(-1, n), mt, tabs, tw)
    Z = N.pointwise_mul(X, Y, mt.tbl)
    return _inv_plain(Z, mt, tabs, tw).to(_U32).reshape(x.shape)


def polymul_fixed_mxu_plain(x, yspec, mt: MxuTables, tabs=None, tw=None):
    tabs = tabs or device_tables(mt, x.device)
    n = mt.n
    X = _fwd_plain(x.reshape(-1, n), mt, tabs, tw)
    Z = N.pointwise_mul(X, yspec.to(_I64).reshape(1, n), mt.tbl)
    return _inv_plain(Z, mt, tabs, tw).to(_U32).reshape(x.shape)


def polymul_fixed_folded_mxu_plain(x, op: FoldedOperand, mt: MxuTables,
                                   tabs=None, tw=None):
    tabs = tabs or device_tables(mt, x.device)
    X = _fwd_plain(x.reshape(-1, mt.n), mt, tabs, tw)
    return N.intt_inv_merged(_folded_block(X, op, mt), mt.tbl, tw,
                             s_lo=mt.logn - mt.Lr).to(_U32).reshape(x.shape)


def ntt_mxu_plain(x, mt: MxuTables, tabs=None, tw=None):
    tabs = tabs or device_tables(mt, x.device)
    return _fwd_plain(x.reshape(-1, mt.n), mt, tabs, tw).to(_U32).reshape(
        x.shape)


def intt_mxu_plain(X, mt: MxuTables, tabs=None, tw=None):
    tabs = tabs or device_tables(mt, X.device)
    return _inv_plain(X.reshape(-1, mt.n), mt, tabs, tw).to(_U32).reshape(
        X.shape)


# ----------------------------------------------------------------------
# Kernel launch.
# ----------------------------------------------------------------------

class MxuPlan(ctypes.Structure):
    """The plan values the kernels take at run time; field for field the
    ``MxuPlan`` struct of ``csrc/ntt_mxu.cu``."""

    _fields_ = [(f, ctypes.c_int32) for f in (
        "n", "logn", "bw", "nb", "lr", "d", "rows", "df", "fwd_lb")] + [
        ("fwd_add", ctypes.c_uint32), ("di", ctypes.c_int32),
        ("inv_lb", ctypes.c_int32)] + [(f, ctypes.c_uint32) for f in (
            "inv_add", "q", "r32", "r32_sh", "one_sh", "kbf", "kbi")] + [
        ("pw", ctypes.c_uint32 * 4), ("pw_sh", ctypes.c_uint32 * 4)]


def block_rows(n: int, ops: int) -> int:
    """Operand rows a kernel block holds: a multiple of ``ops`` (2 for B5,
    whose x and y rows share the digit products), at most 32 and 128 KiB of
    uint32."""
    rows = min(_MAX_ROWS, _ROW_BYTES // (4 * n))
    return rows - rows % ops


def _make_plan(mt: MxuTables, ops: int, di: int, inv_base: int,
               inv_off: int, group_bias_i: int,
               rows: int | None = None) -> MxuPlan:
    """The run-time plan of ``mt`` for ``ops`` operand rows per batch row,
    its inverse split (``di`` planes of ``inv_base`` at ``inv_off``) given
    apart, since the folded kernel splits under the fold plan's; ``rows``
    a block (``block_rows`` unless given: the split form's lane-block rows,
    ``ntt_mxu_split``)."""
    q, D = mt.q, mt.D
    if D > 4 or max(mt.Df, di) > 6 or mt.bw % 32:
        raise ValueError(f"{mt.tbl.ps.name}: MXU plan (D={D}, Df={mt.Df}, "
                         f"Di={di}, bw={mt.bw}) is outside the kernels' "
                         f"range")
    if rows is None:
        rows = block_rows(mt.n, ops)
        if rows < ops:
            raise ValueError(f"n={mt.n}: a row does not fit the kernels' "
                             f"shared memory")
    pw = [pow(2, 8 * j, q) for j in range(D)] + [0] * (4 - D)
    bias = _CLASS_BIAS * sum(pw)
    ps = mt.tbl.ps
    return MxuPlan(
        n=mt.n, logn=mt.logn, bw=mt.bw, nb=mt.nb, lr=mt.Lr, d=D, rows=rows,
        df=mt.Df, fwd_lb=mt.fwd_base.bit_length() - 1,
        fwd_add=(_split_bias(mt.Df, mt.fwd_base) - mt.fwd_off) % (1 << 32),
        di=di,
        inv_lb=inv_base.bit_length() - 1,
        inv_add=(_split_bias(di, inv_base) - inv_off) % (1 << 32),
        q=q, r32=ps.r32,
        r32_sh=ps.r32_shoup, one_sh=ps.one_shoup,
        kbf=(mt.group_bias_f - bias) % q, kbi=(group_bias_i - bias) % q,
        pw=(ctypes.c_uint32 * 4)(*pw),
        pw_sh=(ctypes.c_uint32 * 4)(*((w << 32) // q for w in pw)))


@functools.lru_cache(maxsize=None)
def plan_for(mt: MxuTables, ops: int) -> MxuPlan:
    """The plan of ``lane_packed(mt)`` for ``ops`` operand rows a batch
    row."""
    pk = lane_packed(mt)
    return _make_plan(pk, ops, pk.Di, pk.inv_base, pk.inv_off,
                      pk.group_bias_i)


@functools.lru_cache(maxsize=None)
def fold_plan_for(mt: MxuTables, fp: FixedFoldPlan) -> MxuPlan:
    """The folded kernel's plan, the base of ``stream_plan(mt, fp)``:
    ``mt``'s forward on x rows alone, and an inverse split of ``fp.Din``
    planes into ``fp.Dout`` classes.  The kernel holds max(Df, Din) planes
    and adds 2^24 to every class sum, so a plan with other classes than
    ``mt``, more than 6 planes or a class bound of 2^24 raises."""
    if fp.Dout != mt.D or max(fp.bounds) >= _CLASS_BIAS:
        raise ValueError(f"{mt.tbl.ps.name}: fold plan (Dout={fp.Dout}, "
                         f"class bounds {fp.bounds}) is outside the kernel's "
                         f"range (D={mt.D}, bounds below 2^24)")
    return _make_plan(lane_packed(mt), 1, fp.Din, fp.base, fp.off,
                      _group_bias(fp.groups, fp.bounds, mt.q))


class MxuStreamPlan(ctypes.Structure):
    """The stream kernel's run-time plan (B5-B9): ``MxuPlan``'s
    fields, then the stages of a forward and of an inverse block matmul and
    the stages the kernel's ring holds; field for field the
    ``MxuStreamPlan`` struct of ``csrc/ntt_mxu.cu``."""

    _fields_ = MxuPlan._fields_ + [(f, ctypes.c_int32) for f in (
        "stages_f", "stages_i", "ring")]


# the stream kernel's launch (csrc/ntt_mxu.cu computes the same sizes): the
# shared memory of one SM and what the runtime keeps of each block, the
# bytes after a row of digit planes, and the ring's most stages
_SM_SHARED, _BLOCK_RESERVE, _PLANES_PAD, _MAX_RING = 233472, 1024, 16, 8


def stream_smem(mt: MxuTables, rows: int, ring: int,
                di: int | None = None, df: int | None = None) -> int:
    """Shared memory of one stream kernel block: ``ring`` stages, ``rows``
    rows, their digit planes (a forward split of ``df`` planes, ``mt.Df``
    unless given, 0 for B7, which has no forward pass; an inverse split of
    ``di`` planes, ``mt.Di`` unless given, 0 for B6, which has no inverse
    pass) and two barriers a stage."""
    ks = max(stream_stages(mt.Df if df is None else df, mt.bw),
             stream_stages(mt.Di if di is None else di, mt.bw)
             ) * STAGE_DEPTH + _PLANES_PAD
    return (ring * STAGE_DEPTH * mt.bw * mt.D + rows * mt.n * 4
            + -(-rows // 16) * 16 * ks + 16 * ring)


# the stream kernel's modes, in the order of its StreamMode: B5's product
# of x and y, B9's product against a folded constant, B8's product against
# a constant's stored spectrum, B6's forward transform, B7's inverse one
STREAM_MODES = ("product", "folded", "fixed", "ntt", "intt")


@functools.lru_cache(maxsize=None)
def stream_plan(mt: MxuTables, mode: str = "product",
                fp: FixedFoldPlan | None = None) -> MxuStreamPlan:
    """The stream kernel's run-time plan for one of ``STREAM_MODES``: B5's
    (``plan_for(mt, 2)``: x's and y's rows), B9's (``fold_plan_for(mt,
    fp)``, ``fp`` the fold plan, ``fold_plan(mt)`` unless given: x rows
    alone, the fold plan's inverse split), B8's, B6's and B7's
    (``plan_for(mt, 1)``: x rows alone, ``mt``'s own split; B6 streams no
    inverse stage, ``stages_i`` 0, and B7 no forward one, ``stages_f`` 0),
    with the stage counts and the deepest ring that fits beside the rows
    and the planes the mode holds (3 stages of 24 KiB at
    qtesla-iii-speed, 2 of 32 KiB at the four-class sets).  At n <= 16 it
    is the plan of ``lane_packed(mt)`` (n = bw = 32: rows of 32 / n
    rows).  A plan the kernel cannot take raises: more than 4 digit
    classes, a split other than at most 4 planes of base 256 or 6 of base
    128, a lane block wider than 128, rows other than one MMA tile of 16
    or two (B5: x's and y's, at most 16, or 32), or no room for two
    stages."""
    if mode not in STREAM_MODES:
        raise ValueError(f"stream mode {mode!r}: not one of {STREAM_MODES}")
    if mode == "folded":
        fp = fold_plan(mt) if fp is None else fp
        base, di, inv_base = fold_plan_for(mt, fp), fp.Din, fp.base
    elif fp is not None:
        raise ValueError(f"stream mode {mode!r} takes no fold plan")
    else:
        base = plan_for(mt, 2 if mode == "product" else 1)
        di, inv_base = mt.Di, mt.inv_base
    mt = lane_packed(mt)
    for din, b in ((mt.Df, mt.fwd_base), (di, inv_base)):
        if b not in (128, 256) or din > (4 if b == 256 else 6):
            raise ValueError(f"{mt.tbl.ps.name}: {din} planes of base {b} "
                             f"are outside the stream kernel's split")
    if mt.bw > 128 or (base.rows > 16 and base.rows != 32):
        raise ValueError(f"bw={mt.bw}, rows={base.rows}: outside the stream "
                         f"kernel's range")
    # the forward and inverse planes the block holds
    held_f = 0 if mode == "intt" else mt.Df
    held_i = 0 if mode == "ntt" else di
    ring = max((r for r in range(2, _MAX_RING + 1)
                if stream_smem(mt, base.rows, r, held_i, held_f)
                + _BLOCK_RESERVE <= _SM_SHARED), default=0)
    if not ring:
        raise ValueError(f"n={mt.n}: two stages do not fit beside the rows")
    fields = {f: getattr(base, f) for f, _ in MxuPlan._fields_}
    return MxuStreamPlan(**fields, stages_f=stream_stages(held_f, mt.bw),
                         stages_i=stream_stages(held_i, mt.bw), ring=ring)


def _launch(kernel: Kernel, mt: MxuTables, plan: MxuPlan, tw, a, b, *,
            wf, cf, wi=None, ci) -> torch.Tensor:
    """Run ``kernel`` on CUDA tensors a (and b) into a new output, against
    the forward weights and const ``wf``, ``cf`` and the inverse ones
    ``wi``, ``ci`` (B5-B8: ``wf`` the stage stream, no ``wi``; B9: ``wf``
    the same stream, ``wi`` the constant's stages)."""
    from ..utils.build import load_library

    out = torch.empty_like(a)
    batch = a.numel() // plan.n
    if batch == 0:
        return out
    lib = load_library()
    ptr = [None if t is None else t.data_ptr() for t in (wf, cf, wi, ci)]
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = getattr(lib.cdll, kernel.symbol)(
            a.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), *ptr, tw.data_ptr(), batch,
            ctypes.addressof(plan), stream)
    if err != 0:
        raise RuntimeError(f"{kernel.symbol} launch failed: cudaError {err} "
                           f"({lib.error_string(err)})")
    kernel.launches += 1
    return out


def _prepare(mt: MxuTables, tabs, tw, *tensors):
    n = mt.n
    for i, t in enumerate(tensors):
        _check(f"operand {i}", t, n)
        if t.is_cuda and t.data_ptr() % 16:
            raise ValueError(f"operand {i}: the kernels need 16-byte aligned "
                             f"data")
    first = tensors[0]
    for t in tensors[1:]:
        if t.device != first.device:
            raise ValueError(f"operands on {first.device} and {t.device}")
    if tw is None:
        tw = N.twiddles(mt.tbl, first.device)
    _check_tw(tw, first, n)
    if tabs is None:
        tabs = device_tables(mt, first.device)
    _check_tables(tabs, mt, first)
    return tabs, tw


def _packed(mt: MxuTables, *tensors):
    """(B..., n) operands as the kernel of ``lane_packed(mt)`` takes them:
    as they are, or at n <= 16 rows of 32 lanes, the batch padded with
    zero rows to whole ones."""
    pk = lane_packed(mt)
    if pk is mt:
        return tensors
    k = pk.n // mt.n
    out = []
    for t in tensors:
        rows = t.reshape(-1, mt.n)
        pad = -rows.shape[0] % k
        if pad:
            rows = torch.cat([rows, rows.new_zeros(pad, mt.n)])
        out.append(rows.reshape(-1, pk.n))
    return out


def _unpacked(z: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The kernel's output rows back in the shape of ``like``."""
    return z.reshape(-1, like.shape[-1])[:like.numel() // like.shape[-1]] \
        .reshape(like.shape)


# ----------------------------------------------------------------------
# Wrappers: kernel for CUDA tensors, plain version for CPU tensors.
# ----------------------------------------------------------------------

def _split(mode: str, mt: MxuTables, tabs, tw, *args):
    from . import ntt_mxu_split as MS

    return MS.run(mode, mt, tabs, tw, *args)


def polymul_mxu(x, y, mt: MxuTables, tabs=None, tw=None,
                split: bool | None = None) -> torch.Tensor:
    """z = x * y mod (X^n + 1) mod q over (B..., n) uint32 tensors of
    canonical residues.  ``split``: ``split_form``'s (the plan's unless
    given)."""
    tabs, tw = _prepare(mt, tabs, tw, x, y)
    if x.shape != y.shape:
        raise ValueError(f"operand shapes differ: {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    if split_form(mt, split):
        return _split("product", mt, tabs, tw, x, y)
    if x.is_cuda:
        kt = kernel_tables(mt, x.device, tabs)
        z = _launch(KERNELS["polymul_mxu"], mt, stream_plan(mt), tw,
                    *_packed(mt, x, y), wf=kt.stream, cf=kt.constf,
                    ci=kt.consti)
        return _unpacked(z, x)
    return polymul_mxu_plain(x, y, mt, tabs, tw)


def polymul_fixed_mxu(x, yspec, mt: MxuTables, tabs=None, tw=None,
                      split: bool | None = None) -> torch.Tensor:
    """x (B..., n) times the constant whose canonical forward spectrum is
    ``yspec`` (n values), broadcast over the batch."""
    tabs, tw = _prepare(mt, tabs, tw, x, yspec)
    if yspec.numel() != mt.n:
        raise ValueError(f"spectrum must hold n={mt.n} values, got "
                         f"{tuple(yspec.shape)}")
    if split_form(mt, split):
        return _split("fixed", mt, tabs, tw, x, yspec)
    if x.is_cuda:
        # at n <= 16 the spectrum's n lanes once for each packed row
        k = lane_packed(mt).n // mt.n
        spec = yspec if k == 1 else yspec.reshape(-1).repeat(k)
        kt = kernel_tables(mt, x.device, tabs)
        z = _launch(KERNELS["polymul_fixed_mxu"], mt,
                    stream_plan(mt, "fixed"), tw, *_packed(mt, x), spec,
                    wf=kt.stream, cf=kt.constf, ci=kt.consti)
        return _unpacked(z, x)
    return polymul_fixed_mxu_plain(x, yspec, mt, tabs, tw)


def polymul_fixed_folded_mxu(x, op: FoldedOperand, mt: MxuTables,
                             tabs=None, tw=None,
                             split: bool | None = None) -> torch.Tensor:
    """x (B..., n) times the constant whose folded operand is ``op``
    (``fold_operand`` of its spectrum)."""
    fp = fold_plan(mt)
    tabs, tw = _prepare(mt, tabs, tw, x)
    pk = lane_packed(mt)
    nb, bw = pk.nb, pk.bw
    _check_shapes("folded operand", op.tensors(),
                  ((torch.int8, (nb * stream_stages(fp.Din, bw),
                                 STAGE_DEPTH * bw * fp.Dout)),
                   (torch.uint32, (nb, bw))), x)
    if split_form(mt, split):
        return _split("folded", mt, tabs, tw, x, op)
    if x.is_cuda:
        kt = kernel_tables(mt, x.device, tabs)
        z = _launch(KERNELS["polymul_fixed_folded_mxu"], mt,
                    stream_plan(mt, "folded", fp), tw, *_packed(mt, x), None,
                    wf=kt.stream, cf=kt.constf, wi=op.stages, ci=op.c)
        return _unpacked(z, x)
    return polymul_fixed_folded_mxu_plain(x, op, mt, tabs, tw)


def ntt_mxu(x, mt: MxuTables, tabs=None, tw=None,
            split: bool | None = None) -> torch.Tensor:
    """Forward merged-psi NTT (nat -> rev) of canonical x, canonical out."""
    tabs, tw = _prepare(mt, tabs, tw, x)
    if split_form(mt, split):
        return _split("ntt", mt, tabs, tw, x)
    if x.is_cuda:
        kt = kernel_tables(mt, x.device, tabs)
        z = _launch(KERNELS["ntt_mxu"], mt, stream_plan(mt, "ntt"), tw,
                    *_packed(mt, x), None, wf=kt.stream, cf=kt.constf,
                    ci=None)
        return _unpacked(z, x)
    return ntt_mxu_plain(x, mt, tabs, tw)


def intt_mxu(X, mt: MxuTables, tabs=None, tw=None,
             split: bool | None = None) -> torch.Tensor:
    """Inverse merged-psi NTT (rev -> nat) of values below
    ``mt.pw_bound``, canonical out."""
    tabs, tw = _prepare(mt, tabs, tw, X)
    if split_form(mt, split):
        return _split("intt", mt, tabs, tw, X)
    if X.is_cuda:
        kt = kernel_tables(mt, X.device, tabs)
        z = _launch(KERNELS["intt_mxu"], mt, stream_plan(mt, "intt"), tw,
                    *_packed(mt, X), None, wf=kt.stream, cf=None,
                    ci=kt.consti)
        return _unpacked(z, X)
    return intt_mxu_plain(X, mt, tabs, tw)


@functools.lru_cache(maxsize=None)
def polymul_mxu_fn(name: str):
    """(x, y) -> z negacyclic polymul for one parameter set (B5)."""
    return functools.partial(polymul_mxu, mt=get_mxu_tables(name))


@functools.lru_cache(maxsize=None)
def polymul_fixed_mxu_fn(name: str):
    """(x, yspec) -> z against a precomputed spectrum (B8)."""
    return functools.partial(polymul_fixed_mxu, mt=get_mxu_tables(name))


@functools.lru_cache(maxsize=None)
def polymul_fixed_folded_mxu_fn(name: str):
    """(x, op) -> z against a folded operand (B9); ``op`` is
    ``fold_operand(spectrum, get_mxu_tables(name))``."""
    return functools.partial(polymul_fixed_folded_mxu,
                             mt=get_mxu_tables(name))


@functools.lru_cache(maxsize=None)
def ntt_mxu_fn(name: str):
    """x -> forward spectrum, nat -> rev (B6)."""
    return functools.partial(ntt_mxu, mt=get_mxu_tables(name))


@functools.lru_cache(maxsize=None)
def intt_mxu_fn(name: str):
    """X -> inverse transform, rev -> nat, for X below pw_bound (B7)."""
    return functools.partial(intt_mxu, mt=get_mxu_tables(name))
