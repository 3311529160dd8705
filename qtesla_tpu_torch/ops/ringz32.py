"""Arithmetic in the ring Z_{2^32-1} on int64 tensors.

Counterpart of ``qtesla_tpu/ops/ringz32.py``: ``ring_add``, ``ring_sub``,
``ring_mul``, ``ring_neg``, ``ring_div2``, ``ring_normalize`` and
``RING_MOD``, used by the Nussbaumer ring path (``ops/nussbaumer.py``).
Elements are held as int64 values in [0, 2^32 - 1]; 0 and 0xFFFFFFFF both
denote zero, and ``ring_normalize`` maps the second to the first.

Every operation is exact in the ring (2^32 == 1 mod 2^32 - 1: a carry out of
the low word folds back in as 1), so the normalised residue of a result is
the same whatever order the operations ran in; only the representation of
zero before ``ring_normalize`` may depend on it.  Each function here also
returns the JAX function's uint32 bits for the same inputs.  The 64-bit
product does not fit in int64, so ``ring_mul`` takes it as 16-bit limbs
(``modmul._widemul32``).
"""

from __future__ import annotations

import torch

from .modmul import _widemul32

__all__ = ["ring_add", "ring_sub", "ring_mul", "ring_neg", "ring_div2",
           "ring_normalize", "RING_MOD"]

RING_MOD = (1 << 32) - 1


def ring_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """End-around-carry add: the low word of a + b plus its carry."""
    s = a + b
    return (s & RING_MOD) + (s >> 32)


def ring_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """End-around-borrow subtract: a - b, less one more where it borrows."""
    d = a - b
    return torch.where(d < 0, d + RING_MOD, d)


def ring_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod (2^32 - 1): the high word folded into the low one."""
    hi, lo = _widemul32(a, b)
    return ring_add(lo, hi)


def ring_neg(a: torch.Tensor) -> torch.Tensor:
    """-a as 0xFFFFFFFF - a, which keeps the two representations of zero."""
    return RING_MOD - a


def ring_div2(a: torch.Tensor) -> torch.Tensor:
    """a / 2 in the odd-modulus ring: an odd a gains 2^31."""
    return (a >> 1) + ((a & 1) << 31)


def ring_normalize(a: torch.Tensor) -> torch.Tensor:
    """The unique residue in [0, 2^32 - 2]: 0xFFFFFFFF becomes 0."""
    return torch.where(a == RING_MOD, torch.zeros_like(a), a)
