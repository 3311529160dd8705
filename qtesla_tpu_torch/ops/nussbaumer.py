"""Batched Nussbaumer negacyclic convolution over Z_{2^32-1} and Z_q, in
plain PyTorch.

Counterpart of ``qtesla_tpu/ops/nussbaumer.py``: ``nussbaumer_plan``, the
level functions ``_fwd_level`` / ``_inv_level``, the base products
(``_base_negacyclic``, ``_acyclic_schoolbook``, ``_acyclic`` and
``_base_negacyclic_karatsuba``), ``_nussbaumer``,
``nussbaumer_negacyclic_ring``, ``nussbaumer_negacyclic_modq``,
``ring_exact_coeff_bound``, ``polymul_nussbaumer_fn`` (the ring path with
its exactness guard and signed recovery) and ``polymul_nussbaumer_q_fn``
(the exact mod-q recursion, what ``algo="nussbaumer"`` runs).  No TPU
kernel lies behind it, so it runs as torch operations on the operands'
device, the card for CUDA tensors.

To multiply in Z[X]/(X^n + 1) with n = m r (m <= r), x becomes m
polynomials X_i(w) of length r (X_i[j] = x[j m + i]), duplicated to 2m rows
of a (2m, r, B) state with the batch minor; a 2m-point transform over
Z[w]/(w^r + 1), whose root w^(r/m) is a monomial, so every twiddle is a
negacyclic shift; 2m negacyclic r-point base products; the inverse levels
with their halvings deferred; then z[m j + i] = Z_i[j] + Z_{m+i}[j - 1]
(negacyclic at j = 0) and one scale by 2^-(log2 m + 1).

The JAX levels are unrolled per group into static slices, which suits the
TPU.  Here a level is one ``index_select`` that applies every group's shift
at once, the add and the subtract over the whole state, and a ``where`` that
swaps them on the wrapped segment (the sign of the negacyclic shift): a few
operations a level instead of a few per group.  Each element still goes
through the same add or subtract of the same two values as in JAX, so even
the ring path's unnormalised values are JAX's.

Values are int64: ring elements in [0, 2^32 - 1] (``ops/ringz32.py``), mod-q
values canonical, so a mod-q product of two values below q < 2^30 is exact
as ``(a * b) % q``.  Large batches run in chunks of rows (``_chunked_pairs``)
so that the peak memory stays bounded; the outputs do not depend on the
chunk.
"""

from __future__ import annotations

import functools
import math
import types
from typing import NamedTuple

import torch

from ..params import get_params
from .modmul import add_mod, sub_mod
from .ringz32 import RING_MOD, ring_add, ring_mul, ring_normalize, ring_sub

__all__ = ["nussbaumer_negacyclic_ring", "nussbaumer_negacyclic_modq",
           "polymul_nussbaumer_fn", "polymul_nussbaumer_q_fn",
           "nussbaumer_plan", "ring_exact_coeff_bound", "default_chunk",
           "BASES"]

BASES = ("karatsuba", "schoolbook")

_I64 = torch.int64


# ----------------------------------------------------------------------
# Coefficient arithmetic: add, sub, mul and scale_pow2_inv(v, k) = v 2^-k.
# ----------------------------------------------------------------------

def _ring_scale_pow2_inv(v: torch.Tensor, k: int) -> torch.Tensor:
    """v 2^-k mod 2^32 - 1: a right rotation of the 32 bits by k."""
    k %= 32
    if k == 0:
        return v
    return (v >> k) | ((v & ((1 << k) - 1)) << (32 - k))


_RING_ARITH = types.SimpleNamespace(add=ring_add, sub=ring_sub, mul=ring_mul,
                                    scale_pow2_inv=_ring_scale_pow2_inv)


def _modq_arith(q: int) -> types.SimpleNamespace:
    """Z_q arithmetic on canonical values (q < 2^30)."""

    def add(a, b):
        return add_mod(a, b, q)

    def sub(a, b):
        return sub_mod(a, b, q)

    def mul(a, b):
        return (a * b) % q

    def scale_pow2_inv(v, k):
        return (v * pow(2, -k, q)) % q

    return types.SimpleNamespace(add=add, sub=sub, mul=mul,
                                 scale_pow2_inv=scale_pow2_inv)


# ----------------------------------------------------------------------
# The static plan and its index tables.
# ----------------------------------------------------------------------

def _bitrev(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


@functools.lru_cache(maxsize=None)
def nussbaumer_plan(n: int):
    """(m, r, fwd, inv), as JAX's: each level a tuple of groups (start,
    width, shift); rows [start, start + width) are a group's 'a' half, the
    next width rows its 'b' half, and w^shift its twiddle.  The groups of a
    level tile the 2m rows in order."""
    logn = n.bit_length() - 1
    logm = logn // 2
    m = 1 << logm
    r = n // m
    if n < 2 or m * r != n:
        raise ValueError(f"n={n} must be a power of two >= 2")
    unit = r // m
    fwd = []
    for j in range(logm - 1, -1, -1):
        fwd.append(tuple((i << (j + 1), 1 << j,
                          (_bitrev(i, logm - j) << j) * unit)
                         for i in range(1 << (logm - j))))
    inv = [fwd[logm - 1 - j] for j in range(logm)]
    inv.append(((0, m, 0),))
    return m, r, tuple(fwd), tuple(inv)


class _Level(NamedTuple):
    """One level's groups as tensors: ``G`` groups of width ``w``, the rows
    of the flat (2m r, B) state each output row reads after the shift
    (``fwd_src``: the 'b' halves shifted by +s; ``inv_src``: both halves
    shifted by -s) and the wrapped positions (``fwd_neg``: i < s,
    ``inv_wrap``: i >= r - s), each (G, 1, r, 1)."""

    G: int
    w: int
    fwd_src: torch.Tensor
    inv_src: torch.Tensor
    fwd_neg: torch.Tensor
    inv_wrap: torch.Tensor


@functools.lru_cache(maxsize=None)
def _level(groups: tuple, r: int, device: torch.device) -> _Level:
    G, w = len(groups), groups[0][1]
    if any(g[1] != w or g[0] != i * 2 * w for i, g in enumerate(groups)):
        raise ValueError(f"groups {groups} do not tile the rows evenly")
    start = torch.tensor([g[0] for g in groups], dtype=_I64)[:, None, None]
    s = torch.tensor([g[2] for g in groups], dtype=_I64)[:, None, None]
    t = torch.arange(w, dtype=_I64)[None, :, None]
    i = torch.arange(r, dtype=_I64)[None, None, :]
    fwd_src = (start + w + t) * r + (i - s) % r                 # (G, w, r)
    half = torch.arange(2, dtype=_I64)[None, :, None, None] * w
    inv_src = ((start + t)[:, None] + half) * r + ((i + s) % r)[:, None]
    pos, shift = i.reshape(1, 1, r, 1), s.reshape(G, 1, 1, 1)
    return _Level(G, w, fwd_src.reshape(-1).to(device),
                  inv_src.reshape(-1).to(device), (pos < shift).to(device),
                  (pos >= r - shift).to(device))


def _rows(state: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The rows ``src`` of the state's flat (2m r, B) view."""
    return torch.index_select(state.reshape(-1, state.shape[-1]), 0, src)


def _fwd_level(state, groups, r: int, A):
    """One forward butterfly level on the (2m, r, B) state: per group,
    b' = w^s b has b'[:s] = -b[r-s:] and b'[s:] = b[:r-s]; the outputs are
    a + b' and a - b', the sign of the wrapped segment folded into swapping
    the two."""
    lv = _level(groups, r, state.device)
    st = state.view(lv.G, 2, lv.w, r, -1)
    a = st[:, 0]
    b = _rows(state, lv.fwd_src).view(lv.G, lv.w, r, -1)
    plus, minus = A.add(a, b), A.sub(a, b)
    return torch.stack([torch.where(lv.fwd_neg, minus, plus),
                        torch.where(lv.fwd_neg, plus, minus)],
                       dim=1).reshape(state.shape)


def _inv_level(state, groups, r: int, A):
    """One inverse butterfly level, its halving deferred: per group the
    outputs are a + b and (a - b) w^-s, whose wrapped segment (the last s
    positions) is b - a."""
    lv = _level(groups, r, state.device)
    st = state.view(lv.G, 2, lv.w, r, -1)
    sh = _rows(state, lv.inv_src).view(lv.G, 2, lv.w, r, -1)
    a, b = sh[:, 0], sh[:, 1]
    d = torch.where(lv.inv_wrap, A.sub(b, a), A.sub(a, b))
    return torch.stack([A.add(st[:, 0], st[:, 1]), d],
                       dim=1).reshape(state.shape)


# ----------------------------------------------------------------------
# Base products on (R, r, B) rows.
# ----------------------------------------------------------------------

def _base_negacyclic(X, Y, r: int, A):
    """Schoolbook negacyclic r-point products: the sum over j of X[j] times
    Y shifted by j, the terms that wrap subtracted."""
    acc = A.mul(X[:, 0:1], Y)
    for j in range(1, r):
        prod = A.mul(X[:, j:j + 1], torch.roll(Y, j, dims=1))
        acc = torch.cat([A.sub(acc[:, :j], prod[:, :j]),
                         A.add(acc[:, j:], prod[:, j:])], dim=1)
    return acc


def _acyclic_schoolbook(X, Y, h: int, A):
    """Acyclic product of length-h rows, (R, h, B) -> (R, 2h - 1, B)."""
    acc = A.mul(X[:, 0:1], Y)
    for j in range(1, h):
        prod = A.mul(X[:, j:j + 1], Y)
        acc = torch.cat([acc[:, :j], A.add(acc[:, j:], prod[:, :h - 1]),
                         prod[:, h - 1:]], dim=1)
    return acc


_KARATSUBA_CUTOFF = 8   # schoolbook at and below this width, as in JAX


def _acyclic(X, Y, h: int, A, cutoff: int | None = None):
    """Acyclic product by Karatsuba recursion down to the cutoff: the low,
    high and (lo + hi)(lo + hi) half products, assembled by slices."""
    if cutoff is None:
        cutoff = _KARATSUBA_CUTOFF
    if h <= cutoff or h % 2:
        return _acyclic_schoolbook(X, Y, h, A)
    g = h // 2
    X0, X1 = X[:, :g], X[:, g:]
    Y0, Y1 = Y[:, :g], Y[:, g:]
    P0 = _acyclic(X0, Y0, g, A, cutoff)
    P1 = _acyclic(X1, Y1, g, A, cutoff)
    Pm = _acyclic(A.add(X0, X1), A.add(Y0, Y1), g, A, cutoff)
    Mm = A.sub(A.sub(Pm, P0), P1)
    return torch.cat([P0[:, :g], A.add(P0[:, g:], Mm[:, :g - 1]),
                      Mm[:, g - 1:g], A.add(Mm[:, g:], P1[:, :g - 1]),
                      P1[:, g - 1:]], dim=1)


def _base_negacyclic_karatsuba(X, Y, r: int, A):
    """Negacyclic r-point products by one negacyclic Karatsuba split
    (X = X0 + w^h X1, h = r/2, w^r = -1) over acyclic Karatsuba products:
    Z = (X0Y0 - X1Y1) + w^h ((X0 + X1)(Y0 + Y1) - X0Y0 - X1Y1)."""
    h = r // 2
    X0, X1 = X[:, :h], X[:, h:]
    Y0, Y1 = Y[:, :h], Y[:, h:]
    P0 = _acyclic(X0, Y0, h, A)
    P1 = _acyclic(X1, Y1, h, A)
    Pm = _acyclic(A.add(X0, X1), A.add(Y0, Y1), h, A)
    Aa = A.sub(P0, P1)
    Mm = A.sub(A.sub(Pm, P0), P1)
    return torch.cat([A.sub(Aa[:, :h - 1], Mm[:, h:]), Aa[:, h - 1:h],
                      A.add(Aa[:, h:], Mm[:, :h - 1]), Mm[:, h - 1:h]],
                     dim=1)


def _nussbaumer(x: torch.Tensor, y: torch.Tensor, A,
                base: str = "karatsuba") -> torch.Tensor:
    """Negacyclic product over the arithmetic A of int64 (..., n) tensors,
    through the (2m, r, B) state."""
    n = x.shape[-1]
    m, r, fwd, inv = nussbaumer_plan(n)
    batch = x.shape[:-1]

    def lift(v):
        vm = v.reshape(-1, r, m).permute(2, 1, 0)      # X_i[j] = v[j m + i]
        return torch.cat([vm, vm], dim=0)

    X, Y = lift(x), lift(y)
    for groups in fwd:
        X = _fwd_level(X, groups, r, A)
        Y = _fwd_level(Y, groups, r, A)
    if base == "karatsuba" and r % 2 == 0:
        Z = _base_negacyclic_karatsuba(X, Y, r, A)
    else:
        Z = _base_negacyclic(X, Y, r, A)
    for groups in inv:
        Z = _inv_level(Z, groups, r, A)
    P, Q = Z[:m], Z[m:]
    zm = torch.cat([A.sub(P[:, :1], Q[:, r - 1:]),
                    A.add(P[:, 1:], Q[:, :r - 1])], dim=1)
    zm = A.scale_pow2_inv(zm, m.bit_length())     # 2^-(log2 m + 1)
    return zm.permute(2, 1, 0).reshape(*batch, n)


def _check_base(base: str) -> None:
    if base not in BASES:
        raise ValueError(f"unknown base {base!r}; available: {list(BASES)}")


def _operands(x, y) -> tuple[torch.Tensor, torch.Tensor]:
    for what, t in (("x", x), ("y", y)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.uint32:
            raise TypeError(f"{what}: expected a torch.uint32 tensor, got "
                            f"{getattr(t, 'dtype', type(t))}")
    if x.shape != y.shape:
        raise ValueError(f"operand shapes differ: {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    if x.device != y.device:
        raise ValueError(f"operands on {x.device} and {y.device}")
    return x.to(_I64), y.to(_I64)


def nussbaumer_negacyclic_ring(x, y, base: str = "karatsuba"):
    """Negacyclic product over Z_{2^32-1} of (..., n) uint32 tensors: the
    normalised representatives of (x y mod (X^n + 1)) mod (2^32 - 1)."""
    _check_base(base)
    x, y = _operands(x, y)
    return ring_normalize(_nussbaumer(x, y, _RING_ARITH, base)).to(
        torch.uint32)


def nussbaumer_negacyclic_modq(x, y, ps, base: str = "karatsuba"):
    """Negacyclic product over Z_q of canonical (..., n) uint32 tensors,
    exact for every operand: each butterfly and base product is mod q."""
    _check_base(base)
    x, y = _operands(x, y)
    return _nussbaumer(x, y, _modq_arith(ps.q), base).to(torch.uint32)


def ring_exact_coeff_bound(n: int) -> int:
    """The largest operand magnitude C for which the ring path is exact: a
    product coefficient is a sum of n terms +-x_i y_j, so n C^2 must stay
    <= RING_MOD // 2 for the signed recovery to be unambiguous."""
    return math.isqrt((RING_MOD // 2) // n)


# the bytes of one (2m, r, C) int64 plane a chunk of C rows may take: 16 n
# bytes a row, so 4096 rows at n = 1024.  A product holds a few tens of such
# planes at once, of shrinking width in the base products.
_PLANE_BYTES = 64 << 20


def default_chunk(n: int) -> int:
    """Rows of the chunks a batch runs in at transform length n."""
    return max(1, _PLANE_BYTES // (16 * n))


def _chunked_pairs(body, x, y, chunk: int | None = None):
    """body((C, n), (C, n)) -> (C, n) over (..., n) tensors, C rows at a
    time; the last chunk takes what is left."""
    shape, n = x.shape, x.shape[-1]
    xf, yf = x.reshape(-1, n), y.reshape(-1, n)
    chunk = default_chunk(n) if chunk is None else chunk
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if xf.shape[0] <= chunk:
        return body(xf, yf).reshape(shape)
    return torch.cat([body(xf[i:i + chunk], yf[i:i + chunk])
                      for i in range(0, xf.shape[0], chunk)]).reshape(shape)


@functools.lru_cache(maxsize=None)
def polymul_nussbaumer_fn(name: str, max_coeff: int | None = None):
    """(x, y) -> z mod q through the Z_{2^32-1} ring path.  A ring value
    above 2^31 - 1 stands for a negative integer, reduced mod q; that is
    exact only while the true product coefficients stay below 2^31 in
    magnitude.  ``max_coeff`` declares the operands' bound (None: q - 1);
    a bound outside the exact domain raises, as in JAX.  Use
    ``polymul_nussbaumer_q_fn`` for full-range operands."""
    ps = get_params(name)
    q = ps.q
    mc = q - 1 if max_coeff is None else int(max_coeff)
    limit = ring_exact_coeff_bound(ps.n)
    if mc > limit:
        raise ValueError(
            f"nussbaumer ring path is exact only for operand coefficients "
            f"<= {limit} at n={ps.n} (declared max_coeff={mc}); pass "
            f"max_coeff<={limit} for small/sparse operands, or use "
            f"algo='nussbaumer' (the exact mod-q recursion, "
            f"polymul_nussbaumer_q_fn) for full-range operands")
    m_mod_q = RING_MOD % q
    half = RING_MOD // 2

    def one(x, y):
        z = ring_normalize(_nussbaumer(x, y, _RING_ARITH))
        pos = z % q
        neg = torch.where(pos >= m_mod_q, pos - m_mod_q,
                          pos + (q - m_mod_q))
        return torch.where(z > half, neg, pos)

    def polymul(x, y, chunk: int | None = None):
        return _chunked_pairs(one, *_operands(x, y), chunk).to(torch.uint32)

    return polymul


@functools.lru_cache(maxsize=None)
def polymul_nussbaumer_q_fn(name: str, base: str = "karatsuba"):
    """(x, y) -> z through the exact mod-q recursion, valid for every
    canonical operand; ``base`` is "karatsuba" or "schoolbook"."""
    _check_base(base)
    ps = get_params(name)
    A = _modq_arith(ps.q)

    def polymul(x, y, chunk: int | None = None):
        return _chunked_pairs(lambda a, b: _nussbaumer(a, b, A, base),
                              *_operands(x, y), chunk).to(torch.uint32)

    return polymul
