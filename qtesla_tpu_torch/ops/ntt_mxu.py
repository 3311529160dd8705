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
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import ntt as N
from .mxu_tables import (STAGE_DEPTH, FixedFoldPlan, MxuTables, _group_bias,
                         _split_bias, _stages, fold_plan, fold_tables,
                         get_mxu_tables, stream_stages, stream_tables)
from .ntt_fused import Kernel, _check, _check_tw

__all__ = ["KERNELS", "MxuDeviceTables", "MxuPlan", "MxuStreamPlan",
           "FoldedOperand", "host_tables", "device_tables", "plan_for",
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
    (``mxu_tables.stream_tables``): B5 reads all of it, B9 its first nb*Cf
    stages, the forward ones (its inverse stages are the constant's).  The
    dense ``wf`` and ``wi`` are read by B6-B8 and by the twins; once B6-B8
    read the stream too, only the twins need them."""

    wf: torch.Tensor
    constf: torch.Tensor
    wi: torch.Tensor
    consti: torch.Tensor
    stream: torch.Tensor

    def tensors(self):
        return self.wf, self.constf, self.wi, self.consti, self.stream


def _kernel_layout(w) -> torch.Tensor:
    nb, din, bw, dbw = w.shape
    return torch.from_numpy(w).permute(0, 3, 1, 2).reshape(
        nb, dbw, din * bw).contiguous()


def host_tables(mt: MxuTables) -> MxuDeviceTables:
    """The kernel-layout tables on the CPU, in new storage."""
    return MxuDeviceTables(
        _kernel_layout(mt.wf), torch.from_numpy(mt.constf[:, 0].copy()),
        _kernel_layout(mt.wi), torch.from_numpy(mt.consti[:, 0].copy()),
        torch.from_numpy(stream_tables(mt)))


@functools.lru_cache(maxsize=None)
def device_tables(mt: MxuTables, device: torch.device) -> MxuDeviceTables:
    """``host_tables(mt)`` on ``device``, made once per device."""
    return MxuDeviceTables(*(t.to(device) for t in host_tables(mt).tensors()))


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
    laid out as stages there and copied over once."""
    _check("spectrum", spectrum.reshape(-1), spectrum.numel())
    W, c = fold_tables(mt, fold_plan(mt), spectrum.reshape(-1).cpu().numpy())
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
    nb, bw, D = mt.nb, mt.bw, mt.D
    stages = nb * (stream_stages(mt.Df, bw) + stream_stages(mt.Di, bw))
    want = ((torch.int8, (nb, D * bw, mt.Df * bw)), (torch.uint32, (nb, bw)),
            (torch.int8, (nb, D * bw, mt.Di * bw)), (torch.uint32, (nb, bw)),
            (torch.int8, (stages, STAGE_DEPTH * bw * D)))
    _check_shapes("MXU tables", tabs.tensors(), want, like)


def _check_shapes(what: str, tensors, want, like) -> None:
    for t, (dtype, shape) in zip(tensors, want):
        if (t.dtype != dtype or tuple(t.shape) != shape
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


def _block_matmul(v: torch.Tensor, w: torch.Tensor, const: torch.Tensor,
                  group_bias: int, off: int, din: int, base: int,
                  mt: MxuTables) -> torch.Tensor:
    """The block-local stages of one direction on (R, n) int64 values below
    the split's bound; canonical out."""
    R = v.shape[0]
    out = digit_product(v.reshape(1, R, mt.nb, mt.bw), w[None], const[None],
                        group_bias, off, din, base, mt.q, mt.D)
    return out.reshape(R, mt.n)


def _fwd_plain(x, mt: MxuTables, tabs: MxuDeviceTables, tw):
    v = N.ntt_fwd_merged(x.to(_I64), mt.tbl, tw, s_hi=mt.Lr)
    return _block_matmul(v, tabs.wf, tabs.constf, mt.group_bias_f,
                         mt.fwd_off, mt.Df, mt.fwd_base, mt)


def _inv_plain(X, mt: MxuTables, tabs: MxuDeviceTables, tw):
    v = _block_matmul(X.to(_I64), tabs.wi, tabs.consti, mt.group_bias_i,
                      mt.inv_off, mt.Di, mt.inv_base, mt)
    return N.intt_inv_merged(v, mt.tbl, tw, s_lo=mt.logn - mt.Lr)


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
    fp = fold_plan(mt)
    tabs = tabs or device_tables(mt, x.device)
    X = _fwd_plain(x.reshape(-1, mt.n), mt, tabs, tw)
    w = staged_tables(op.stages, mt.nb, mt.bw, fp.Dout)
    v = _block_matmul(X, w, op.c, _group_bias(fp.groups, fp.bounds, mt.q),
                      fp.off, fp.Din, fp.base, mt)
    return N.intt_inv_merged(v, mt.tbl, tw, s_lo=mt.logn - mt.Lr).to(
        _U32).reshape(x.shape)


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
               inv_off: int, group_bias_i: int) -> MxuPlan:
    """The run-time plan of ``mt`` for ``ops`` operand rows per batch row,
    its inverse split (``di`` planes of ``inv_base`` at ``inv_off``) given
    apart, since the folded kernel splits under the fold plan's."""
    q, D = mt.q, mt.D
    if D > 4 or max(mt.Df, di) > 6 or mt.bw % 32:
        raise ValueError(f"{mt.tbl.ps.name}: MXU plan (D={D}, Df={mt.Df}, "
                         f"Di={di}, bw={mt.bw}) is outside the kernels' "
                         f"range")
    rows = block_rows(mt.n, ops)
    if rows < ops:
        raise ValueError(f"n={mt.n}: a row does not fit the kernels' shared "
                         f"memory")
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
    return _make_plan(mt, ops, mt.Di, mt.inv_base, mt.inv_off,
                      mt.group_bias_i)


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
    return _make_plan(mt, 1, fp.Din, fp.base, fp.off,
                      _group_bias(fp.groups, fp.bounds, mt.q))


class MxuStreamPlan(ctypes.Structure):
    """B5's and B9's run-time plan: ``MxuPlan``'s fields, then the stages of
    a forward and of an inverse block matmul and the stages the kernel's
    ring holds; field for field the ``MxuStreamPlan`` struct of
    ``csrc/ntt_mxu.cu``."""

    _fields_ = MxuPlan._fields_ + [(f, ctypes.c_int32) for f in (
        "stages_f", "stages_i", "ring")]


# the stream kernel's launch (csrc/ntt_mxu.cu computes the same sizes): the
# shared memory of one SM and what the runtime keeps of each block, the
# bytes after a row of digit planes, and the ring's most stages
_SM_SHARED, _BLOCK_RESERVE, _PLANES_PAD, _MAX_RING = 233472, 1024, 16, 8


def stream_smem(mt: MxuTables, rows: int, ring: int,
                di: int | None = None) -> int:
    """Shared memory of one stream kernel block: ``ring`` stages, ``rows``
    rows, their digit planes (an inverse split of ``di`` planes, ``mt.Di``
    unless given) and two barriers a stage."""
    ks = max(stream_stages(mt.Df, mt.bw),
             stream_stages(mt.Di if di is None else di, mt.bw)
             ) * STAGE_DEPTH + _PLANES_PAD
    return (ring * STAGE_DEPTH * mt.bw * mt.D + rows * mt.n * 4
            + -(-rows // 16) * 16 * ks + 16 * ring)


@functools.lru_cache(maxsize=None)
def stream_plan(mt: MxuTables,
                fp: FixedFoldPlan | None = None) -> MxuStreamPlan:
    """The stream kernel's run-time plan: B5's (``plan_for(mt, 2)``), or
    with a fold plan ``fp`` B9's (``fold_plan_for(mt, fp)``: its rows are x
    rows alone and its inverse split the fold plan's), with the stage
    counts and the deepest ring that fits beside the rows (3 stages of 24
    KiB at qtesla-iii-speed, 2 of 32 KiB at the four-class sets).  A plan
    the kernel cannot take raises: more than 4 digit classes, a split other
    than at most 4 planes of base 256 or 6 of base 128, a lane block wider
    than 128, rows other than one MMA tile of 16 or two (B5: x's and y's,
    at most 16, or 32), or no room for two stages."""
    if fp is None:
        base, di, inv_base = plan_for(mt, 2), mt.Di, mt.inv_base
    else:
        base, di, inv_base = fold_plan_for(mt, fp), fp.Din, fp.base
    for din, b in ((mt.Df, mt.fwd_base), (di, inv_base)):
        if b not in (128, 256) or din > (4 if b == 256 else 6):
            raise ValueError(f"{mt.tbl.ps.name}: {din} planes of base {b} "
                             f"are outside the stream kernel's split")
    if mt.bw > 128 or (base.rows > 16 and base.rows != 32):
        raise ValueError(f"bw={mt.bw}, rows={base.rows}: outside the stream "
                         f"kernel's range")
    ring = max((r for r in range(2, _MAX_RING + 1)
                if stream_smem(mt, base.rows, r, di) + _BLOCK_RESERVE
                <= _SM_SHARED), default=0)
    if not ring:
        raise ValueError(f"n={mt.n}: two stages do not fit beside the rows")
    fields = {f: getattr(base, f) for f, _ in MxuPlan._fields_}
    return MxuStreamPlan(**fields, stages_f=stream_stages(mt.Df, mt.bw),
                         stages_i=stream_stages(di, mt.bw), ring=ring)


def _launch(kernel: Kernel, mt: MxuTables, plan: MxuPlan, tw, a, b, *,
            wf, cf, wi=None, ci) -> torch.Tensor:
    """Run ``kernel`` on CUDA tensors a (and b) into a new output, against
    the forward weights and const ``wf``, ``cf`` and the inverse ones
    ``wi``, ``ci`` (B5: ``wf`` its stage stream, no ``wi``; B9: ``wf`` the
    same stream, ``wi`` the constant's stages)."""
    from ..utils.build import load_library

    out = torch.empty_like(a)
    batch = a.numel() // mt.n
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


def _dense(tabs: MxuDeviceTables) -> dict:
    """B6-B8's tables: the dense forward and inverse weights and consts."""
    return dict(wf=tabs.wf, cf=tabs.constf, wi=tabs.wi, ci=tabs.consti)


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


# ----------------------------------------------------------------------
# Wrappers: kernel for CUDA tensors, plain version for CPU tensors.
# ----------------------------------------------------------------------

def polymul_mxu(x, y, mt: MxuTables, tabs=None, tw=None) -> torch.Tensor:
    """z = x * y mod (X^n + 1) mod q over (B..., n) uint32 tensors of
    canonical residues."""
    tabs, tw = _prepare(mt, tabs, tw, x, y)
    if x.shape != y.shape:
        raise ValueError(f"operand shapes differ: {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    if x.is_cuda:
        return _launch(KERNELS["polymul_mxu"], mt, stream_plan(mt), tw, x,
                       y, wf=tabs.stream, cf=tabs.constf, ci=tabs.consti)
    return polymul_mxu_plain(x, y, mt, tabs, tw)


def polymul_fixed_mxu(x, yspec, mt: MxuTables, tabs=None,
                      tw=None) -> torch.Tensor:
    """x (B..., n) times the constant whose canonical forward spectrum is
    ``yspec`` (n values), broadcast over the batch."""
    tabs, tw = _prepare(mt, tabs, tw, x, yspec)
    if yspec.numel() != mt.n:
        raise ValueError(f"spectrum must hold n={mt.n} values, got "
                         f"{tuple(yspec.shape)}")
    if x.is_cuda:
        return _launch(KERNELS["polymul_fixed_mxu"], mt, plan_for(mt, 1),
                       tw, x, yspec, **_dense(tabs))
    return polymul_fixed_mxu_plain(x, yspec, mt, tabs, tw)


def polymul_fixed_folded_mxu(x, op: FoldedOperand, mt: MxuTables,
                             tabs=None, tw=None) -> torch.Tensor:
    """x (B..., n) times the constant whose folded operand is ``op``
    (``fold_operand`` of its spectrum)."""
    fp = fold_plan(mt)
    tabs, tw = _prepare(mt, tabs, tw, x)
    nb, bw = mt.nb, mt.bw
    _check_shapes("folded operand", op.tensors(),
                  ((torch.int8, (nb * stream_stages(fp.Din, bw),
                                 STAGE_DEPTH * bw * fp.Dout)),
                   (torch.uint32, (nb, bw))), x)
    if x.is_cuda:
        return _launch(KERNELS["polymul_fixed_folded_mxu"], mt,
                       stream_plan(mt, fp), tw, x, None, wf=tabs.stream,
                       cf=tabs.constf, wi=op.stages, ci=op.c)
    return polymul_fixed_folded_mxu_plain(x, op, mt, tabs, tw)


def ntt_mxu(x, mt: MxuTables, tabs=None, tw=None) -> torch.Tensor:
    """Forward merged-psi NTT (nat -> rev) of canonical x, canonical out."""
    tabs, tw = _prepare(mt, tabs, tw, x)
    if x.is_cuda:
        return _launch(KERNELS["ntt_mxu"], mt, plan_for(mt, 1), tw, x, None,
                       **_dense(tabs))
    return ntt_mxu_plain(x, mt, tabs, tw)


def intt_mxu(X, mt: MxuTables, tabs=None, tw=None) -> torch.Tensor:
    """Inverse merged-psi NTT (rev -> nat) of values below
    ``mt.pw_bound``, canonical out."""
    tabs, tw = _prepare(mt, tabs, tw, X)
    if X.is_cuda:
        return _launch(KERNELS["intt_mxu"], mt, plan_for(mt, 1), tw, X, None,
                       **_dense(tabs))
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
