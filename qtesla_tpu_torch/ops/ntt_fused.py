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

On the H100 the kernels are bound by instruction issue and the block-wide
barrier between the log2(n) dependent butterfly stages, not by device
memory, which sees one read per operand and one write of z.  The design
keeps each row in shared memory for the whole pipeline (one thread block per
row, no batch padding) and reads twiddles from compact n-entry tables
instead of the TPU kernel's full-width (L, n) tables; see the note at the
top of the CUDA source.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import ntt as N
from .tables import NttTables, get_tables

__all__ = ["KERNELS", "Kernel", "polymul_fused_fn", "polymul_fixed_fused_fn",
           "ntt_fused_fn", "intt_fused_fn", "polymul_fused",
           "polymul_fixed_fused", "ntt_fused", "intt_fused"]

CUDA_SOURCE = "qtesla_tpu_torch/csrc/ntt_fused.cu"

# the most dynamic shared memory one H100 block may take (227 KB)
_MAX_SMEM = 232448


@dataclass
class Kernel:
    """One hand-written kernel: its C launcher, the TPU kernel it replaces,
    how many rows of n uint32 it holds in shared memory, and its count of
    launches."""

    name: str
    symbol: str
    replaces: str
    smem_rows: int
    launches: int = 0


KERNELS: dict[str, Kernel] = {k.name: k for k in (
    Kernel("polymul_fused", "qt_polymul_fused",
           "qtesla_tpu/ops/ntt_pallas.py:100", 2),
    Kernel("polymul_fixed_fused", "qt_polymul_fixed_fused",
           "qtesla_tpu/ops/ntt_pallas.py:112", 1),
    Kernel("ntt_fused", "qt_ntt_fused", "qtesla_tpu/ops/ntt_pallas.py:123", 1),
    Kernel("intt_fused", "qt_intt_fused", "qtesla_tpu/ops/ntt_pallas.py:129",
           1),
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
            a: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """Run ``kernel`` on CUDA tensors a (and b) into a new output."""
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
            stream)
    if err != 0:
        raise RuntimeError(f"{kernel.symbol} launch failed: cudaError {err} "
                           f"({lib.error_string(err)})")
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
# Wrappers: kernel for CUDA tensors, plain version for CPU tensors.
# ----------------------------------------------------------------------

def polymul_fused(x, y, tbl: NttTables, tw=None) -> torch.Tensor:
    """z = x * y mod (X^n + 1) mod q over (B..., n) uint32 tensors."""
    tw = _prepare(tbl, tw, x, y)
    if x.shape != y.shape:
        raise ValueError(f"operand shapes differ: {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    if x.is_cuda:
        return _launch(KERNELS["polymul_fused"], tbl, tw, x, y)
    return polymul_plain(x, y, tbl, tw)


def polymul_fixed_fused(x, yspec, tbl: NttTables, tw=None) -> torch.Tensor:
    """x (B..., n) times the constant whose forward spectrum is ``yspec``
    (n values, any shape), broadcast over the batch."""
    tw = _prepare(tbl, tw, x, yspec)
    if yspec.numel() != tbl.n:
        raise ValueError(f"spectrum must hold n={tbl.n} values, got "
                         f"{tuple(yspec.shape)}")
    if x.is_cuda:
        return _launch(KERNELS["polymul_fixed_fused"], tbl, tw, x, yspec)
    return polymul_fixed_plain(x, yspec, tbl, tw)


def ntt_fused(x, tbl: NttTables, tw=None) -> torch.Tensor:
    """Forward merged-psi NTT (nat -> rev), canonical output."""
    tw = _prepare(tbl, tw, x)
    if x.is_cuda:
        return _launch(KERNELS["ntt_fused"], tbl, tw, x, None)
    return ntt_plain(x, tbl, tw)


def intt_fused(X, tbl: NttTables, tw=None) -> torch.Tensor:
    """Inverse merged-psi NTT (rev -> nat) of values below 2q, canonical."""
    tw = _prepare(tbl, tw, X)
    if X.is_cuda:
        return _launch(KERNELS["intt_fused"], tbl, tw, X, None)
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
