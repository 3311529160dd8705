"""Fused merged-psi kernels B1-B4: hand-written CUDA for Hopper, with their
plain PyTorch twins.

Counterpart of ``qtesla_tpu/ops/ntt_pallas.py``.  Each ``*_fn(name)`` returns
a callable on (B..., n) ``torch.uint32`` tensors with canonical residues:

- ``polymul_fused_fn``       B1, replaces ``_polymul_kernel`` (ntt_pallas.py:100)
- ``polymul_fixed_fused_fn`` B4, replaces ``_polymul_fixed_kernel`` (l.112)
- ``ntt_fused_fn``           B2, replaces ``_ntt_kernel`` (l.123)
- ``intt_fused_fn``          B3, replaces ``_intt_kernel`` (l.129); input < 2q

Dispatch is on the input's device.  A CUDA tensor launches the kernel of
``csrc/ntt_fused.cu`` on ``torch.cuda.current_stream()``; a CPU tensor runs
the plain version (``ops/ntt.py``); any other device raises.  There is no
fallback: a CUDA tensor with no built library, or a refused launch, raises.
Every successful launch adds one to its kernel's ``launches`` count in
``KERNELS``; nothing else touches the counts.

All four run in register passes (``csrc/pass_stages.cuh``); device memory
sees one read per operand and one write of z.  B1 runs on gs_ct's window
sequence, under ``fused_pass_plan(n)``, which its launcher checks; B4 runs
B1's kernel with one operand (x alone through the forward, the spectrum
multiplied in where the forward ends) under ``fixed_pass_plan(n)``; B3 runs
B4's inverse half alone (``transform_pass_kernel``: a coalesced load, one
exchange to where B4's inverse starts) under ``intt_pass_plan(n)``, a plan
with no forward passes, and B2 B4's forward half alone (the same kernel: a
coalesced load, B4's forward passes, one exchange back to where the load
left the row, a coalesced store) under ``ntt_pass_plan(n)``, a plan with no
inverse passes, both for every n from 2 to 262144; B1 and B4 from 2 to
131072.  Where one block cannot hold a row (B1, B4 from 32768, B2, B3 from
65536) the row spans a thread-block cluster of 2 to 8 blocks, still one
launch a call (``passes.pass_plan``).  Past a cluster's reach (B1, B4 from
2^18, B2, B3 from 2^19, to 2^25) each runs its sweep form
(``csrc/pass_sweeps.cu``, ``passes.sweep_plan``): the row in device memory,
each transform in two or three launches of block-local windows of stages,
3 launches a product, 2 a transform, each counted; ``passes.kernel_plan``
picks the form and the wrappers take an explicit ``plan=``.
``polymul_fused_passes_plain``, ``polymul_fixed_fused_passes_plain``,
``ntt_passes_plain`` and ``intt_passes_plain`` run those schedules on the
CPU with the kernel's index maps, exchanges and lazy ranges.  All read
twiddles from compact n-entry tables instead of the TPU kernel's full-width
(L, n) tables; see the note at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import modmul as MM
from . import ntt as N
from .passes import (SWEEP_KIND_NAMES, PassModel, PassPlan, SweepModel,
                     SweepPlan, kernel_plan, pass_plan, sweep_reads)
from .tables import NttTables, get_tables

__all__ = ["KERNELS", "Kernel", "polymul_fused_fn", "polymul_fixed_fused_fn",
           "ntt_fused_fn", "intt_fused_fn", "polymul_fused",
           "polymul_fixed_fused", "ntt_fused", "intt_fused",
           "fused_pass_plan", "fixed_pass_plan", "ntt_pass_plan",
           "intt_pass_plan", "polymul_fused_passes_plain",
           "polymul_fixed_fused_passes_plain", "ntt_passes_plain",
           "intt_passes_plain"]

CUDA_SOURCE = "qtesla_tpu_torch/csrc/ntt_fused.cu"

# the most dynamic shared memory one H100 block may take (227 KB)
_MAX_SMEM = 232448


@dataclass
class Kernel:
    """One hand-written kernel: its C launcher, the TPU kernel it replaces,
    how many rows of n uint32 it holds in shared memory (0: a pass kernel,
    which takes its shared memory from its plan), and its count of
    launches."""

    name: str
    symbol: str
    replaces: str
    smem_rows: int
    launches: int = 0


KERNELS: dict[str, Kernel] = {k.name: k for k in (
    Kernel("polymul_fused", "qt_polymul_fused",
           "qtesla_tpu/ops/ntt_pallas.py:100", 0),
    Kernel("polymul_fixed_fused", "qt_polymul_fixed_fused",
           "qtesla_tpu/ops/ntt_pallas.py:112", 0),
    Kernel("ntt_fused", "qt_ntt_fused", "qtesla_tpu/ops/ntt_pallas.py:123", 0),
    Kernel("intt_fused", "qt_intt_fused", "qtesla_tpu/ops/ntt_pallas.py:129",
           0),
)}


def _check(what: str, t, n: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != torch.uint32:
        raise TypeError(f"{what}: expected torch.uint32, got {t.dtype}")
    if t.dim() == 0 or t.shape[-1] != n:
        raise ValueError(f"{what}: last axis must be n={n}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")


def _check_tw(tw: torch.Tensor, like: torch.Tensor, n: int) -> None:
    if (tw.dtype != torch.uint32 or tuple(tw.shape) != (4, n)
            or tw.device != like.device or not tw.is_contiguous()):
        raise ValueError(f"twiddles must be a contiguous (4, {n}) uint32 "
                         f"tensor on {like.device}")


def _launch(kernel: Kernel, tbl: NttTables, tw: torch.Tensor,
            a: torch.Tensor, b: torch.Tensor | None,
            plan: PassPlan | None = None) -> torch.Tensor:
    """Run ``kernel`` on CUDA tensors a (and b) into a new output; a pass
    kernel under ``plan``, as given: its launcher checks the plan and a
    refusal raises."""
    from ..utils.build import load_library

    n = tbl.n
    smem = kernel.smem_rows * n * 4
    if smem > _MAX_SMEM:
        raise ValueError(f"{kernel.name}: n={n} needs {smem} bytes of shared "
                         f"memory per block, more than {_MAX_SMEM}")
    out = torch.empty_like(a)
    batch = a.numel() // n
    if batch == 0:
        return out
    if batch >= 1 << 31:
        raise ValueError(f"{kernel.name}: batch {batch} exceeds the grid")
    lib = load_library()
    ps = tbl.ps
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = getattr(lib.cdll, kernel.symbol)(
            a.view(torch.int32).data_ptr(),
            None if b is None else b.view(torch.int32).data_ptr(),
            out.view(torch.int32).data_ptr(), tw.view(torch.int32).data_ptr(),
            batch, n, tbl.logn, tbl.q, ps.r32, ps.r32_shoup, ps.one_shoup,
            *(() if plan is None else (ctypes.addressof(plan),)), stream)
    if err != 0:
        raise RuntimeError(f"{kernel.symbol} launch failed: cudaError {err} "
                           f"({lib.error_string(err)})")
    kernel.launches += 1
    return out


def _launch_plan(kernel: Kernel, tbl: NttTables, tw: torch.Tensor,
                 a: torch.Tensor, b: torch.Tensor | None, plan,
                 operands: int) -> torch.Tensor:
    """``_launch`` under a pass plan, ``_launch_sweeps`` under a sweep
    plan."""
    if isinstance(plan, SweepPlan):
        return _launch_sweeps(kernel, tbl, tw, a, b, plan, operands)
    return _launch(kernel, tbl, tw, a, b, plan)


def _launch_sweeps(kernel: Kernel, tbl: NttTables, tw: torch.Tensor,
                   a: torch.Tensor, b: torch.Tensor | None, plan: SweepPlan,
                   operands: int) -> torch.Tensor:
    """Run ``kernel``'s sweep form (``csrc/pass_sweeps.cu``) on CUDA
    tensors a (and b: the second operand, or B4's spectrum) into a new
    output: one launch a sweep of ``plan``, each adding one to the
    kernel's count, through scratch rows of ``operands`` operands (two
    buffers in turns, ``passes.sweep_reads``), with ``tbl``'s in-window
    powers (``ntt.sweep_powers``, cached on the device) beside ``tw``.  The
    launcher checks the plan; a refusal raises."""
    from ..utils.build import load_library

    n = tbl.n
    out = torch.empty_like(a)
    batch = a.numel() // n
    if batch == 0:
        return out
    scratch = [torch.empty((batch, operands, n), dtype=torch.uint32,
                           device=a.device)
               for _ in range(min(2, plan.sweeps - 1))]
    ptrs = [t.view(torch.int32).data_ptr() for t in scratch] + [None, None]
    pw = N.sweep_powers(tbl, not SWEEP_KIND_NAMES[plan.kind].startswith("B"),
                        a.device)
    lib = load_library()
    ps = tbl.ps
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        for i in range(plan.sweeps):
            err = lib.cdll.qt_pass_sweep(
                a.view(torch.int32).data_ptr(),
                None if b is None else b.view(torch.int32).data_ptr(),
                out.view(torch.int32).data_ptr(), ptrs[0], ptrs[1],
                tw.view(torch.int32).data_ptr(),
                pw.view(torch.int32).data_ptr(), batch, n, tbl.logn, tbl.q,
                ps.r32, ps.r32_shoup, ps.one_shoup, ctypes.addressof(plan),
                i, stream)
            if err != 0:
                src, dst = sweep_reads(plan, i)
                raise RuntimeError(
                    f"qt_pass_sweep ({kernel.name}, launch {i} of "
                    f"{plan.sweeps}, {src} -> {dst}) failed: cudaError "
                    f"{err} ({lib.error_string(err)})")
            kernel.launches += 1
    return out


def _prepare(tbl: NttTables, tw, *tensors):
    n = tbl.n
    for i, t in enumerate(tensors):
        _check(f"operand {i}", t, n)
    first = tensors[0]
    for t in tensors[1:]:
        if t.device != first.device:
            raise ValueError(f"operands on {first.device} and {t.device}")
    if tw is None:
        tw = N.twiddles(tbl, first.device)
    _check_tw(tw, first, n)
    return tw


# ----------------------------------------------------------------------
# Plain versions (int64, canonical at every stage).
# ----------------------------------------------------------------------

_I64, _U32 = torch.int64, torch.uint32


def polymul_plain(x, y, tbl: NttTables, tw=None) -> torch.Tensor:
    X = N.ntt_fwd_merged(x.to(_I64), tbl, tw)
    Y = N.ntt_fwd_merged(y.to(_I64), tbl, tw)
    return N.intt_inv_merged(N.pointwise_mul(X, Y, tbl), tbl, tw).to(_U32)


def polymul_fixed_plain(x, yspec, tbl: NttTables, tw=None) -> torch.Tensor:
    X = N.ntt_fwd_merged(x.to(_I64), tbl, tw)
    Z = N.pointwise_mul(X, yspec.to(_I64).reshape(tbl.n), tbl)
    return N.intt_inv_merged(Z, tbl, tw).to(_U32)


def ntt_plain(x, tbl: NttTables, tw=None) -> torch.Tensor:
    return N.ntt_fwd_merged(x.to(_I64), tbl, tw).to(_U32)


def intt_plain(X, tbl: NttTables, tw=None) -> torch.Tensor:
    # the kernel takes inputs below 2q; reduce them for the canonical plain
    # transform
    return N.intt_inv_merged(X.to(_I64) % tbl.q, tbl, tw).to(_U32)


# ----------------------------------------------------------------------
# B1's and B4's register passes: the plans and their schedule on the CPU.
# ----------------------------------------------------------------------

def fused_pass_plan(n: int) -> PassPlan:
    """B1's schedule at row length ``n``: gs_ct's (``passes.pass_plan``),
    the forward from the widest stage down, the inverse from the narrowest
    up; from n = 32768 a row spans a cluster of 2, 4 or 8 blocks.  Raises
    for what the launcher refuses (past n = 131072).  Cached: copy it before
    changing a field."""
    return pass_plan(n, False, True)


def fixed_pass_plan(n: int) -> PassPlan:
    """B4's schedule at row length ``n``: B1's, with the shared memory a
    row of one operand (its forward runs on x alone).  Cached: copy it
    before changing a field."""
    return pass_plan(n, False, True, operands=1)


def ntt_pass_plan(n: int) -> PassPlan:
    """B2's schedule at row length ``n``: B4's forward passes, from the
    widest stage down, with no inverse after them (the inverse's fields 0),
    one operand's shared memory a row, and up to 1024 threads a block, so a
    row of n <= 32768 fits a block and one from 65536 to 262144 a cluster
    of 2 to 8.  Raises for other n.  Cached: copy it before changing a
    field."""
    return pass_plan(n, False, None, operands=1)


def intt_pass_plan(n: int) -> PassPlan:
    """B3's schedule at row length ``n``: B4's inverse passes with no
    forward before them (the forward's fields 0), one operand's shared
    memory a row, and up to 1024 threads a block, so a row of n <= 32768
    fits a block and one from 65536 to 262144 a cluster of 2 to 8.  Raises
    for other n.  Cached: copy it before changing a field."""
    return pass_plan(n, None, True, operands=1)


def _sweeps_plain(kind: str, ops, tbl: NttTables, plan: SweepPlan,
                  spec=None) -> torch.Tensor:
    """The sweep form's launches of ``kind`` (B1-B4) over the (B, n) int64
    rows ``ops`` (``passes.SweepModel``, on their device); the rows of
    z."""
    tw = torch.from_numpy(tbl.packed.astype(np.int64)).to(ops[0].device)
    return SweepModel(plan, tbl.n, tbl.q, tw,
                      lambda a, b: _barrett(a, b, tbl), spec).run(ops)


def _polymul_passes_plain(ops, tbl: NttTables, plan: PassPlan, product):
    """The pass schedule of B1 and B4 over the (B, n) int64 rows ``ops`` (x
    and y, or x alone) on the CPU: the forward's passes of every operand,
    ``product(V, mdl, b)`` of the values V (rows, operands, T, R) in the
    forward's last window b, then the inverse's passes and the last stage
    with the store; the rows of z."""
    B = ops[0].shape[0]
    mdl = PassModel(plan, tbl.n, tbl.q, B)
    ops = [mdl.pad(a) for a in ops]
    V, b = _forward_passes(ops, mdl, tbl)
    # the inverse starts on the forward's last window
    return _inverse_passes(product(V, mdl, b), mdl, b, tbl, B)


def _forward_passes(ops, mdl: PassModel, tbl: NttTables):
    """The forward's passes of B1, B4 and B2 over the padded int64 rows
    ``ops``: the load on the window [tb, L), then each pass's CT stages from
    the widest down, one exchange a pass after the first; the values V
    (rows, operands, T, R), below 4q, and the last window."""
    plan, t = mdl.plan, mdl.t
    fw, fw_sh = torch.from_numpy(tbl.packed[:2].astype(np.int64))
    b = mdl.tb
    idx = mdl.window(t, b)
    # (rows, operand, thread, register); no weighting: psi is merged
    V = torch.stack([a[:, idx] for a in ops], 1)
    for p in range(plan.passes):
        if p:
            V, b, _ = mdl.exchange(V, b, t, plan.fwd_b[p], t)
        assert b == plan.fwd_b[p]
        V = mdl.merged_stages(V, b, t, plan.fwd_lo[p], plan.fwd_hi[p], fw,
                              fw_sh, fwd=True)
    return V, b


def _inverse_passes(V, mdl: PassModel, b: int, tbl: NttTables, B: int):
    """The inverse's passes of B1, B3 and B4 on the values V (rows, 1, T,
    R) in the window b, then the last stage with the store; the B rows of
    z."""
    plan, L, q = mdl.plan, tbl.logn, tbl.q
    iw, iw_sh = torch.from_numpy(tbl.packed[2:].astype(np.int64))
    t, tb, R = mdl.t, mdl.tb, plan.radix
    for p in range(plan.passes):
        if p:
            V, b, _ = mdl.exchange(V, b, t, plan.inv_b[p], t)
        assert b == plan.inv_b[p]
        V = mdl.merged_stages(V, b, t, plan.inv_lo[p],
                              min(plan.inv_hi[p], L - 1), iw, iw_sh,
                              fwd=False)
    # the last stage in the last window [tb, L), on register bit r - 1
    assert b == tb and bool((V < 2 * q).all())
    U, D = V[:, 0, :, :R // 2], V[:, 0, :, R // 2:]
    out = torch.cat([
        MM._csub(MM.shoup_mulmod_lazy(U + D, iw[0], iw_sh[0], q), q),
        MM._csub(MM.shoup_mulmod_lazy(U + 2 * q - D, iw[1], iw_sh[1], q), q)],
        -1)
    z = torch.zeros((V.shape[0], mdl.n), dtype=_I64)
    z[:, mdl.window(t, tb)] = out
    return z[:B]


def _barrett(a, b, tbl: NttTables):
    ps = tbl.ps
    return MM.mulmod_barrett(a, b, tbl.q, ps.r32, ps.r32_shoup, ps.one_shoup)


def polymul_fused_passes_plain(x, y, tbl: NttTables,
                               plan: PassPlan | None = None):
    """z = x * y mod (X^n + 1) mod q through B1's schedule (``plan``,
    ``passes.kernel_plan`` unless given), on the CPU (``passes.PassModel``;
    a sweep plan's launches through ``passes.SweepModel``, on x's device):
    the kernel's index maps and exchanges, CT butterflies widest first and
    GS butterflies narrowest first with the merged-psi twiddles indexed by
    the bits above the stage, the last inverse stage with the store (n^{-1}
    on the sum, psi^{-1}_rev[1] n^{-1} on the difference), lazy ranges
    asserted."""
    n = tbl.n
    plan = kernel_plan(n, "B1") if plan is None else plan
    ops = [a.reshape(-1, n).to(_I64) for a in (x, y)]
    if isinstance(plan, SweepPlan):
        z = _sweeps_plain("B1", ops, tbl, plan)
    else:
        z = _polymul_passes_plain(
            ops, tbl, plan,
            lambda V, mdl, b: _barrett(V[:, :1], V[:, 1:], tbl))
    return z.reshape(*x.shape[:-1], n).to(_U32)


def polymul_fixed_fused_passes_plain(x, yspec, tbl: NttTables,
                                     plan: PassPlan | None = None):
    """x times the constant whose forward spectrum is ``yspec`` (n values,
    any uint32) through B4's schedule (``plan``, ``passes.kernel_plan``
    unless given; a sweep plan's as B1's), on the CPU: B1's with x alone
    through the forward, and where the
    forward ends (the window [0, r), thread t holding positions t R + c) the
    Barrett product with the spectrum's values at those positions."""
    n = tbl.n
    plan = kernel_plan(n, "B4") if plan is None else plan
    spec = yspec.reshape(n).to(_I64)
    if isinstance(plan, SweepPlan):
        z = _sweeps_plain("B4", [x.reshape(-1, n).to(_I64)], tbl, plan,
                          spec.to(x.device))
        return z.reshape(x.shape).to(_U32)

    def product(V, mdl, b):
        idx = mdl.window(mdl.t, b)
        assert b == 0 and bool((idx == torch.arange(n).reshape(idx.shape))
                               .all())
        return _barrett(V, spec[idx], tbl)

    z = _polymul_passes_plain([x.reshape(-1, n).to(_I64)], tbl, plan,
                              product)
    return z.reshape(x.shape).to(_U32)


def ntt_passes_plain(x, tbl: NttTables, plan: PassPlan | None = None):
    """The forward merged-psi NTT (nat -> rev) of values below 4q through
    B2's schedule (``plan``, ``passes.kernel_plan`` unless given; a sweep
    plan's as B1's), on the CPU:
    the coalesced load on the window [tb, L), B4's forward passes and
    exchanges, ending on [0, r), one more exchange back to [tb, L) and a
    coalesced store; canonical (csub by 2q, then by q)."""
    n, q = tbl.n, tbl.q
    plan = kernel_plan(n, "B2") if plan is None else plan
    x2 = x.reshape(-1, n).to(_I64)
    if isinstance(plan, SweepPlan):
        return _sweeps_plain("B2", [x2], tbl, plan).reshape(x.shape).to(_U32)
    mdl = PassModel(plan, n, q, x2.shape[0])
    t = mdl.t
    V, b = _forward_passes([mdl.pad(x2)], mdl, tbl)
    assert b == 0 and bool((V < 4 * q).all())
    if mdl.tb:
        V, b, _ = mdl.exchange(V, b, t, mdl.tb, t)
    z = torch.zeros((V.shape[0], n), dtype=_I64)
    z[:, mdl.window(t, b)] = MM._csub(MM._csub(V[:, 0], 2 * q), q)
    return z[:x2.shape[0]].reshape(x.shape).to(_U32)


def intt_passes_plain(X, tbl: NttTables, plan: PassPlan | None = None):
    """The inverse merged-psi NTT (rev -> nat) of values below 2q through
    B3's schedule (``plan``, ``passes.kernel_plan`` unless given; a sweep
    plan's as B1's), on the CPU:
    the coalesced load on the window [tb, L), one exchange into [0, r),
    then B4's inverse passes, exchanges and last stage with the store;
    canonical."""
    n = tbl.n
    plan = kernel_plan(n, "B3") if plan is None else plan
    X2 = X.reshape(-1, n).to(_I64)
    if isinstance(plan, SweepPlan):
        return _sweeps_plain("B3", [X2], tbl, plan).reshape(X.shape).to(_U32)
    B = X2.shape[0]
    mdl = PassModel(plan, n, tbl.q, B)
    t, b = mdl.t, mdl.tb
    V = mdl.pad(X2)[:, mdl.window(t, b)][:, None]
    if b:
        V, b, _ = mdl.exchange(V, b, t, 0, t)
    return _inverse_passes(V, mdl, b, tbl, B).reshape(X.shape).to(_U32)


# ----------------------------------------------------------------------
# Wrappers: kernel for CUDA tensors, plain version for CPU tensors.
# ----------------------------------------------------------------------

def polymul_fused(x, y, tbl: NttTables, tw=None, plan=None) -> torch.Tensor:
    """z = x * y mod (X^n + 1) mod q over (B..., n) uint32 tensors; on the
    card under ``plan`` (``passes.kernel_plan`` unless given: the block or
    cluster form, or past its reach the sweep form)."""
    tw = _prepare(tbl, tw, x, y)
    if x.shape != y.shape:
        raise ValueError(f"operand shapes differ: {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    if x.is_cuda:
        return _launch_plan(KERNELS["polymul_fused"], tbl, tw, x, y,
                            plan or kernel_plan(tbl.n, "B1"), 2)
    return polymul_plain(x, y, tbl, tw)


def polymul_fixed_fused(x, yspec, tbl: NttTables, tw=None,
                        plan=None) -> torch.Tensor:
    """x (B..., n) times the constant whose forward spectrum is ``yspec``
    (n values, any shape), broadcast over the batch; ``plan`` as
    ``polymul_fused``'s."""
    tw = _prepare(tbl, tw, x, yspec)
    if yspec.numel() != tbl.n:
        raise ValueError(f"spectrum must hold n={tbl.n} values, got "
                         f"{tuple(yspec.shape)}")
    if x.is_cuda:
        if yspec.data_ptr() % 16:
            yspec = yspec.clone()     # the kernel reads it 16 bytes a load
        return _launch_plan(KERNELS["polymul_fixed_fused"], tbl, tw, x,
                            yspec, plan or kernel_plan(tbl.n, "B4"), 1)
    return polymul_fixed_plain(x, yspec, tbl, tw)


def ntt_fused(x, tbl: NttTables, tw=None, plan=None) -> torch.Tensor:
    """Forward merged-psi NTT (nat -> rev), canonical output; ``plan`` as
    ``polymul_fused``'s."""
    tw = _prepare(tbl, tw, x)
    if x.is_cuda:
        return _launch_plan(KERNELS["ntt_fused"], tbl, tw, x, None,
                            plan or kernel_plan(tbl.n, "B2"), 1)
    return ntt_plain(x, tbl, tw)


def intt_fused(X, tbl: NttTables, tw=None, plan=None) -> torch.Tensor:
    """Inverse merged-psi NTT (rev -> nat) of values below 2q, canonical;
    ``plan`` as ``polymul_fused``'s."""
    tw = _prepare(tbl, tw, X)
    if X.is_cuda:
        return _launch_plan(KERNELS["intt_fused"], tbl, tw, X, None,
                            plan or kernel_plan(tbl.n, "B3"), 1)
    return intt_plain(X, tbl, tw)


@functools.lru_cache(maxsize=None)
def polymul_fused_fn(name: str):
    """(x, y) -> z negacyclic polymul for one parameter set (B1)."""
    return functools.partial(polymul_fused, tbl=get_tables(name))


@functools.lru_cache(maxsize=None)
def polymul_fixed_fused_fn(name: str):
    """(x, yspec) -> z against a precomputed spectrum (B4); the spectrum is
    ``ntt_fused_fn(name)`` of the constant operand."""
    return functools.partial(polymul_fixed_fused, tbl=get_tables(name))


@functools.lru_cache(maxsize=None)
def ntt_fused_fn(name: str):
    """x -> forward spectrum, nat -> rev (B2)."""
    return functools.partial(ntt_fused, tbl=get_tables(name))


@functools.lru_cache(maxsize=None)
def intt_fused_fn(name: str):
    """X -> inverse transform, rev -> nat, for X below 2q (B3)."""
    return functools.partial(intt_fused, tbl=get_tables(name))
