"""Incomplete (Kyber-shaped) negacyclic NTT polymul for q = 1 (mod n) but
not (mod 2n), in plain PyTorch.

Counterpart of ``qtesla_tpu/ops/incomplete.py``: ``incomplete_params``,
``ntt_incomplete``, ``intt_incomplete``, ``basemul_incomplete`` and
``polymul_incomplete_fn(n, q)``.  Such a q has no 2n-th root of unity, so
X^n + 1 splits into n/2 quadratics X^2 - gamma_i: the transform runs
log2(n) - 1 Cooley-Tukey levels and the pointwise stage multiplies
degree-1 pairs,

    (a0 + a1 X)(b0 + b1 X) = (a0 b0 + gamma_i a1 b1) + (a0 b1 + a1 b0) X
                                                   (mod X^2 - gamma_i).

The tables come from (n, q) with exact integers: zeta = g^((q-1)/n), the
level twiddles zeta^bitrev(k) in blocks, and the gamma_i found as JAX finds
them, by pushing X^2 through the forward transform (pair i of NTT(X^2) is
(gamma_i, 0)).  The inverse runs the mirror butterflies with (n/2)^-1
applied once at the end.  q must be prime: ``params._find_generator``
refuses any other q.

No TPU kernel lies behind it: it runs as torch operations on the operands'
device, the card for CUDA tensors, with the tables copied there once.
Values are int64 and canonical, so a product of two is exact as
``(a * b) % q``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ..params import _find_generator, _is_pow2
from .modmul import add_mod as _add
from .modmul import sub_mod as _sub

__all__ = ["incomplete_params", "ntt_incomplete", "intt_incomplete",
           "basemul_incomplete", "polymul_incomplete_fn",
           "IncompleteParams"]

_I64 = torch.int64


@dataclass(eq=False)
class IncompleteParams:
    """The tables of one (n, q), numpy uint32 (``zs[l]``, ``zs_inv[l]``:
    level l's 2^l twiddles and their inverses; ``gammas``: the n/2 pair
    residues), and their int64 copies per device (``on(device)``)."""

    n: int
    q: int
    g: int
    zeta: int
    L: int
    zs: list
    zs_inv: list
    half_inv: int
    gammas: np.ndarray | None = None
    _dev: dict = field(default_factory=dict, repr=False)

    def on(self, device: torch.device) -> dict:
        device = torch.device(device)
        if device not in self._dev:
            def put(a):
                return torch.from_numpy(a.astype(np.int64)).to(device)
            self._dev[device] = {
                "zs": [put(z) for z in self.zs],
                "zs_inv": [put(z) for z in self.zs_inv],
                "gammas": None if self.gammas is None else put(self.gammas)}
        return self._dev[device]


def _bitrev(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


@functools.lru_cache(maxsize=None)
def incomplete_params(n: int, q: int) -> IncompleteParams:
    """The tables of the incomplete negacyclic NTT over (n, q): n a power
    of two >= 4, q prime, q = 1 (mod n), q < 2^30."""
    if not _is_pow2(n) or n < 4:
        raise ValueError(f"n={n} must be a power of two >= 4")
    if (q - 1) % n != 0:
        raise ValueError(f"q={q} must satisfy q ≡ 1 (mod n), n={n}")
    if q >= 1 << 30:
        raise ValueError(f"q={q} must be < 2^30 for the int32-lane path")
    g = _find_generator(q)                  # raises unless q is prime
    zeta = pow(g, (q - 1) // n, q)          # a primitive n-th root
    if pow(zeta, n // 2, q) != q - 1:
        raise ValueError(f"zeta^(n/2) != -1 mod q={q}")
    L = n.bit_length() - 2                  # log2(n) - 1 levels
    zetas = [pow(zeta, _bitrev(k, L), q) for k in range(1 << L)]
    zs = [np.array(zetas[1 << l:2 << l], dtype=np.uint32) for l in range(L)]
    p = IncompleteParams(
        n=n, q=q, g=g, zeta=zeta, L=L, zs=zs,
        zs_inv=[np.array([pow(int(w), -1, q) for w in z], dtype=np.uint32)
                for z in zs],
        half_inv=pow(n // 2, -1, q))
    # the pair residues, self-derived: NTT(X^2) pair i = (gamma_i, 0)
    x2 = torch.zeros((1, n), dtype=torch.uint32)
    x2[0, 2] = 1
    spec = ntt_incomplete(x2, p)[0].to(_I64).numpy()
    if spec[1::2].any():
        raise ValueError(f"NTT(X^2) pairs are not (gamma, 0) for "
                         f"(n={n}, q={q})")
    p.gammas = spec[0::2].astype(np.uint32)
    p._dev.clear()          # the copies made above lack the gammas
    return p


def _u32_rows(a: torch.Tensor, n: int) -> torch.Tensor:
    if not isinstance(a, torch.Tensor) or a.dtype != torch.uint32:
        raise TypeError(f"expected a torch.uint32 tensor, got "
                        f"{getattr(a, 'dtype', type(a))}")
    if a.dim() == 0 or a.shape[-1] != n:
        raise ValueError(f"last axis must be n={n}, got {tuple(a.shape)}")
    return a.reshape(-1, n).to(_I64)


def _ntt(a: torch.Tensor, p: IncompleteParams) -> torch.Tensor:
    B, n, q = a.shape[0], p.n, p.q
    zs = p.on(a.device)["zs"]
    for l in range(p.L):
        v4 = a.reshape(B, 1 << l, 2, n >> (l + 1))
        t = (v4[:, :, 1, :] * zs[l][None, :, None]) % q
        u = v4[:, :, 0, :]
        a = torch.stack([_add(u, t, q), _sub(u, t, q)], dim=2).reshape(B, n)
    return a


def _intt(a: torch.Tensor, p: IncompleteParams) -> torch.Tensor:
    B, n, q = a.shape[0], p.n, p.q
    zs_inv = p.on(a.device)["zs_inv"]
    for l in range(p.L - 1, -1, -1):
        v4 = a.reshape(B, 1 << l, 2, n >> (l + 1))
        x, y = v4[:, :, 0, :], v4[:, :, 1, :]
        v = (_sub(x, y, q) * zs_inv[l][None, :, None]) % q
        a = torch.stack([_add(x, y, q), v], dim=2).reshape(B, n)
    return (a * p.half_inv) % q


def _basemul(A: torch.Tensor, Bv: torch.Tensor,
             p: IncompleteParams) -> torch.Tensor:
    q = p.q
    a, b = A.reshape(A.shape[0], -1, 2), Bv.reshape(Bv.shape[0], -1, 2)
    a0, a1, b0, b1 = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    gam = p.on(A.device)["gammas"][None, :]
    c0 = _add((a0 * b0) % q, (gam * ((a1 * b1) % q)) % q, q)
    c1 = _add((a0 * b1) % q, (a1 * b0) % q, q)
    return torch.stack([c0, c1], dim=2).reshape(A.shape[0], p.n)


def ntt_incomplete(a: torch.Tensor, p: IncompleteParams) -> torch.Tensor:
    """Forward incomplete NTT of canonical (B..., n) uint32 values: L CT
    levels (u, v) -> (u + z v, u - z v); canonical output."""
    return _ntt(_u32_rows(a, p.n), p).reshape(a.shape).to(torch.uint32)


def intt_incomplete(a: torch.Tensor, p: IncompleteParams) -> torch.Tensor:
    """Inverse: (x, y) -> (x + y, z^-1 (x - y)), then (n/2)^-1."""
    return _intt(_u32_rows(a, p.n), p).reshape(a.shape).to(torch.uint32)


def basemul_incomplete(A: torch.Tensor, Bv: torch.Tensor,
                       p: IncompleteParams) -> torch.Tensor:
    """The degree-1 pair products mod (X^2 - gamma_i) of two spectra."""
    if A.shape != Bv.shape or A.device != Bv.device:
        raise ValueError(f"spectra differ: {tuple(A.shape)} on {A.device} "
                         f"vs {tuple(Bv.shape)} on {Bv.device}")
    return _basemul(_u32_rows(A, p.n), _u32_rows(Bv, p.n),
                    p).reshape(A.shape).to(torch.uint32)


@functools.lru_cache(maxsize=None)
def polymul_incomplete_fn(n: int, q: int):
    """(x, y) -> z = x y mod (X^n + 1, q) over (B..., n) uint32 tensors,
    for q = 1 (mod n) only."""
    p = incomplete_params(n, q)

    def polymul(x, y):
        if x.shape != y.shape or x.device != y.device:
            raise ValueError(f"operands differ: {tuple(x.shape)} on "
                             f"{x.device} vs {tuple(y.shape)} on {y.device}")
        Z = _basemul(_ntt(_u32_rows(x, n), p), _ntt(_u32_rows(y, n), p), p)
        return _intt(Z, p).reshape(x.shape).to(torch.uint32)

    return polymul
