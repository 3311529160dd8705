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
``fast_reduce_2q`` (any uint32 to [0, 2q)) is bit-equal to JAX's lazy value,
and ``sparse_reduce_plan`` is the plain-Python plan both it and the MXU
planner (``mxu_tables.py``) read.
"""

from __future__ import annotations

import functools

import torch

__all__ = [
    "add_mod",
    "sub_mod",
    "shoup_mulmod_lazy",
    "shoup_mulmod",
    "reduce_u32",
    "sparse_reduce_plan",
    "fast_reduce_2q",
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


@functools.lru_cache(maxsize=None)
def sparse_reduce_plan(q: int):
    """Shift-add reduction plan for sparse q = 2^a + sum(2^b) + 1 (8404993 =
    2^23 + 2^14 + 1 and 65537 = 2^16 + 1 qualify).  With hi = x >> a and
    lo = x & (2^a - 1), x == lo - sum_b (hi << b) - hi (mod q), every term
    int32-exact.  Returns (a, mids, k, ncsub): r + k*q >= 0, and ncsub
    conditional subtracts of 2q land in [0, 2q); None when q is not sparse
    or a bound would overflow int32.  Pure Python: the MXU planner costs
    its recombination plans with it."""
    bits = [i for i in range(q.bit_length()) if (q >> i) & 1]
    if not bits or bits[0] != 0 or len(bits) > 5 or len(bits) < 2:
        return None
    a, mids = bits[-1], bits[1:-1]
    himax = (1 << (32 - a)) - 1
    negmax = himax * (sum(1 << b for b in mids) + 1)
    if negmax >= 1 << 31 or any(himax << b >= 1 << 31 for b in mids):
        return None
    k = -(-negmax // q)
    bound = k * q + (1 << a)
    if bound >= 1 << 31:
        return None
    ncsub = 0
    while bound > 2 * q:
        bound = max(2 * q, bound - 2 * q)
        ncsub += 1
    return a, tuple(mids), k, ncsub


def fast_reduce_2q(x: torch.Tensor, q: int, one_shoup: int) -> torch.Tensor:
    """Any uint32 x -> a congruent value in [0, 2q), bit-equal to the JAX
    function: the sparse shift-add plan when q has one, else Shoup by 1 with
    the JAX version's sloppy high word, then one conditional subtract."""
    plan = sparse_reduce_plan(q)
    if plan is None:
        # mulhi32_sloppy: the high word without the low partial product
        # and the mid-sum carry, so it may fall short by up to 2
        x0, x1 = x & _U16, x >> 16
        y0, y1 = one_shoup & _U16, one_shoup >> 16
        hi = x1 * y1 + ((x0 * y1) >> 16) + ((x1 * y0) >> 16)
        return _csub(x - hi * q, 2 * q)          # x - hi*q in [0, 4q)
    a, mids, k, ncsub = plan
    hi = x >> a
    r = (x & ((1 << a) - 1)) - hi
    for b in mids:
        r = r - (hi << b)
    r = r + k * q
    for _ in range(ncsub):
        r = _csub(r, 2 * q)
    return r


def mulmod_barrett(x: torch.Tensor, y: torch.Tensor, q: int, r32: int,
                   r32_shoup: int, one_shoup: int) -> torch.Tensor:
    """x*y mod q for ANY uint32 x, y: the 64-bit product as (hi, lo), folded
    as hi*(2^32 mod q) + lo with two Shoup products."""
    hi, lo = _widemul32(x, y)
    return add_mod(shoup_mulmod(hi, r32, r32_shoup, q),
                   reduce_u32(lo, q, one_shoup), q)
