"""Modular arithmetic on int64 tensors holding uint32 residues.

Counterpart of ``qtesla_tpu/ops/modmul.py``.  PyTorch has almost no
``torch.uint32`` arithmetic (``+``, ``-``, ``>>``, ``>=`` and ``%`` are not
implemented for it), so the plain versions compute in int64: every value is a
uint32 held in an int64 lane, and every intermediate below is kept under 2^63
so nothing wraps.  The 64-bit product of two uint32 values does not fit, so
``_mulhi32`` / ``_widemul32`` split one operand into 16-bit limbs; the CUDA
kernels use the native ``__umulhi`` instead.

Canonical outputs equal the JAX functions' outputs for every input those
functions accept: any uint32 ``x`` for the Shoup products, ``reduce_u32`` and
``mulmod_barrett``; canonical ``a, b`` for ``add_mod`` / ``sub_mod``.
"""

from __future__ import annotations

import torch

__all__ = [
    "add_mod",
    "sub_mod",
    "shoup_mulmod_lazy",
    "shoup_mulmod",
    "reduce_u32",
    "mulmod_barrett",
]

_U16 = 0xFFFF
_U32 = 0xFFFFFFFF


def _mulhi32(x: torch.Tensor, y) -> torch.Tensor:
    """floor(x * y / 2^32) for uint32 x, y; every partial product < 2^49."""
    x0 = x & _U16
    x1 = x >> 16
    return (x1 * y + ((x0 * y) >> 16)) >> 16


def _widemul32(x: torch.Tensor, y: torch.Tensor):
    """(hi, lo) words of the 64-bit product of uint32 x, y."""
    lo_part = (x & _U16) * y                 # < 2^48
    hi_part = (x >> 16) * y                  # < 2^48
    hi = (hi_part + (lo_part >> 16)) >> 16
    lo = (((hi_part & _U16) << 16) + lo_part) & _U32
    return hi, lo


def _csub(v: torch.Tensor, bound: int) -> torch.Tensor:
    return torch.where(v >= bound, v - bound, v)


def add_mod(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """(a + b) mod q for canonical a, b."""
    return _csub(a + b, q)


def sub_mod(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """(a - b) mod q for canonical a, b."""
    d = a - b
    return torch.where(d < 0, d + q, d)


def shoup_mulmod_lazy(x: torch.Tensor, w, w_shoup, q: int) -> torch.Tensor:
    """x*w mod q in [0, 2q), w a constant < q with w_shoup = floor(w*2^32/q),
    x any uint32.  x*w < 2^62 and hi*q < 2^62, so the difference is exact."""
    return x * w - _mulhi32(x, w_shoup) * q


def shoup_mulmod(x: torch.Tensor, w, w_shoup, q: int) -> torch.Tensor:
    """Canonical [0, q) Shoup product."""
    return _csub(shoup_mulmod_lazy(x, w, w_shoup, q), q)


def reduce_u32(x: torch.Tensor, q: int, one_shoup: int) -> torch.Tensor:
    """Any uint32 -> x mod q (Shoup with w = 1, one_shoup = floor(2^32/q))."""
    return shoup_mulmod(x, 1, one_shoup, q)


def mulmod_barrett(x: torch.Tensor, y: torch.Tensor, q: int, r32: int,
                   r32_shoup: int, one_shoup: int) -> torch.Tensor:
    """x*y mod q for ANY uint32 x, y: the 64-bit product as (hi, lo), folded
    as hi*(2^32 mod q) + lo with two Shoup products."""
    hi, lo = _widemul32(x, y)
    return add_mod(shoup_mulmod(hi, r32, r32_shoup, q),
                   reduce_u32(lo, q, one_shoup), q)
