"""NTT transforms in plain PyTorch.

Counterpart of ``qtesla_tpu/ops/ntt.py``:

- merged-psi negacyclic pair ``ntt_fwd_merged`` / ``intt_inv_merged``
  (l.92-116), nat -> rev -> nat;
- cyclic DIF ``gs_fwd_cyclic`` / ``gs_inv_cyclic`` (nat -> rev) and DIT
  ``ct_fwd_cyclic`` / ``ct_inv_cyclic`` (rev -> nat) (l.124-172);
- Stockham autosort ``stockham_fwd`` / ``stockham_inv``, nat -> nat
  (l.181-207);
- the dense ``matrix_ntt`` (l.216-247) and the four-step ``fourstep_ntt`` /
  ``fourstep_intt`` (l.257-325), nat -> nat;
- ``bitrev_permute``, the psi weightings and ``pointwise_mul``
  (l.332-380).

They work on int64 tensors holding canonical residues, over the last axis of
any batch shape, and keep every stage canonical, so no product of two values
ever exceeds 2^62.  These are the plain versions the CUDA kernels of
``ntt_fused`` and ``ntt_pairings`` are held against, and what the kernels'
wrappers run for CPU tensors.

The merged-psi twiddles come from the packed (4, n) table of
``tables.NttTables``, on the input's device: ``twiddles(tbl, device)``
caches one copy per device, and the merged functions take an explicit ``tw``
too (``models.NegacyclicPolymul`` passes its registered buffer).  The other
tables are cached per device the same way.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..params import ParamSet
from .modmul import add_mod, mulmod_barrett, shoup_mulmod, sub_mod
from .tables import NttTables, _build

__all__ = [
    "twiddles", "ntt_fwd_merged", "intt_inv_merged",
    "gs_fwd_cyclic", "gs_inv_cyclic", "ct_fwd_cyclic", "ct_inv_cyclic",
    "stockham_fwd", "stockham_inv", "matrix_ntt", "fourstep_ntt",
    "fourstep_intt", "bitrev_permute", "pointwise_mul", "weight_psi",
    "weight_ipsi_ninv", "weight_ipsi", "bitrev_weight_ipsi_ninv",
    "weight_psi_bitrev",
]


@functools.lru_cache(maxsize=None)
def twiddles(tbl: NttTables, device: torch.device) -> torch.Tensor:
    """The packed (4, n) uint32 twiddle table on ``device``."""
    return torch.from_numpy(tbl.packed).to(device)


def _rows(tbl: NttTables, device, tw):
    if tw is None:
        tw = twiddles(tbl, torch.device(device))
    return tw.to(torch.int64)


def _split(v: torch.Tensor, t: int):
    """(..., n) -> the two halves of m = n / 2t blocks, each (..., m, t)."""
    v = v.reshape(*v.shape[:-1], v.shape[-1] // (2 * t), 2, t)
    return v[..., 0, :], v[..., 1, :]


def _merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m, t = a.shape[-2:]
    return torch.stack([a, b], dim=-2).reshape(*a.shape[:-2], 2 * m * t)


def ntt_fwd_merged(x: torch.Tensor, tbl: NttTables,
                   tw: torch.Tensor | None = None,
                   s_hi: int | None = None) -> torch.Tensor:
    """Negacyclic forward NTT, psi merged into the twiddles. nat -> rev.
    With ``s_hi``, only stages [0, s_hi) (the MXU path's wide stages)."""
    q, n = tbl.q, tbl.n
    w_all, wsh_all = _rows(tbl, x.device, tw)[0:2]
    v = x
    for s in range(tbl.logn if s_hi is None else s_hi):
        m, t = 1 << s, n >> (s + 1)
        w, wsh = w_all[m:2 * m, None], wsh_all[m:2 * m, None]
        a, b = _split(v, t)
        V = shoup_mulmod(b, w, wsh, q)
        v = _merge(add_mod(a, V, q), sub_mod(a, V, q))
    return v


def intt_inv_merged(X: torch.Tensor, tbl: NttTables,
                    tw: torch.Tensor | None = None,
                    s_lo: int = 0) -> torch.Tensor:
    """Negacyclic inverse NTT, psi^{-1} and n^{-1} merged. rev -> nat.
    With ``s_lo``, only stages [s_lo, log2 n) (the MXU path's wide
    stages)."""
    q, n = tbl.q, tbl.n
    w_all, wsh_all = _rows(tbl, X.device, tw)[2:4]
    v = X
    for s in range(s_lo, tbl.logn):
        t, h = 1 << s, n >> (s + 1)
        w, wsh = w_all[h:2 * h, None], wsh_all[h:2 * h, None]
        a, b = _split(v, t)
        sm = add_mod(a, b, q)
        d = shoup_mulmod(sub_mod(a, b, q), w, wsh, q)
        if h == 1:      # last stage: the sum branch takes n^{-1} (entry 0)
            sm = shoup_mulmod(sm, w_all[0], wsh_all[0], q)
        v = _merge(sm, d)
    return v


def pointwise_mul(X: torch.Tensor, Y: torch.Tensor,
                  tbl: NttTables) -> torch.Tensor:
    """Hadamard product mod q, exact for any uint32 operands."""
    ps = tbl.ps
    return mulmod_barrett(X, Y, ps.q, ps.r32, ps.r32_shoup, ps.one_shoup)


# ----------------------------------------------------------------------
# Host tables as int64 tensors, one copy per device.
# ----------------------------------------------------------------------

def _i64(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)


@functools.lru_cache(maxsize=None)
def _pairs(tbl: NttTables, field: str, device: torch.device):
    """A table family of ``tbl`` as int64 (w, w_shoup) tensors on device:
    a dict for ``cyc_*``, a list for ``stockham_*``, one pair for a
    weighting row."""
    src = getattr(tbl, field)
    if isinstance(src, dict):
        return {h: (_i64(w, device), _i64(wsh, device))
                for h, (w, wsh) in src.items()}
    if isinstance(src, list):
        return [(_i64(w, device), _i64(wsh, device)) for w, wsh in src]
    return _i64(src, device), _i64(getattr(tbl, field + "_shoup"), device)


@functools.lru_cache(maxsize=None)
def _bitrev(tbl: NttTables, device: torch.device) -> torch.Tensor:
    return _i64(tbl.bitrev, device)


def _scale_ninv(v: torch.Tensor, tbl: NttTables) -> torch.Tensor:
    w0, w0sh = (int(a.reshape(-1)[0]) for a in tbl.ninv_fold)
    return shoup_mulmod(v, w0, w0sh, tbl.q)


# ----------------------------------------------------------------------
# Cyclic radix-2 families: DIF (GS butterfly) nat -> rev, DIT (CT
# butterfly) rev -> nat; the stage of half-width h uses omega^{j n/2h}.
# ----------------------------------------------------------------------

def _dif(v, tbl: NttTables, field: str):
    q, n = tbl.q, tbl.n
    rows = _pairs(tbl, field, v.device)
    for s in range(tbl.logn):
        h = n >> (s + 1)
        w, wsh = rows[h]
        a, b = _split(v, h)
        v = _merge(add_mod(a, b, q), shoup_mulmod(sub_mod(a, b, q), w, wsh,
                                                  q))
    return v


def _dit(v, tbl: NttTables, field: str):
    q = tbl.q
    rows = _pairs(tbl, field, v.device)
    for s in range(tbl.logn):
        h = 1 << s
        w, wsh = rows[h]
        a, b = _split(v, h)
        V = shoup_mulmod(b, w, wsh, q)
        v = _merge(add_mod(a, V, q), sub_mod(a, V, q))
    return v


def gs_fwd_cyclic(x: torch.Tensor, tbl: NttTables) -> torch.Tensor:
    """Cyclic DIF NTT: nat -> rev."""
    return _dif(x, tbl, "cyc_fwd")


def gs_inv_cyclic(X: torch.Tensor, tbl: NttTables,
                  scale_ninv: bool = True) -> torch.Tensor:
    """Cyclic DIF with omega^{-1}: nat -> rev; optional final n^{-1}."""
    v = _dif(X, tbl, "cyc_inv")
    return _scale_ninv(v, tbl) if scale_ninv else v


def ct_fwd_cyclic(x_rev: torch.Tensor, tbl: NttTables) -> torch.Tensor:
    """Cyclic DIT NTT: rev -> nat."""
    return _dit(x_rev, tbl, "cyc_fwd")


def ct_inv_cyclic(X_rev: torch.Tensor, tbl: NttTables,
                  scale_ninv: bool = True) -> torch.Tensor:
    """Cyclic DIT with omega^{-1}: rev -> nat; optional final n^{-1}."""
    v = _dit(X_rev, tbl, "cyc_inv")
    return _scale_ninv(v, tbl) if scale_ninv else v


# ----------------------------------------------------------------------
# Stockham autosort: nat -> nat.  Stage st views the row as (n >> st,
# 2^st), butterflies its upper and lower halves and interleaves the results.
# ----------------------------------------------------------------------

def _stockham(x, tbl: NttTables, field: str):
    q, n = tbl.q, x.shape[-1]
    batch = x.shape[:-1]
    v = x.reshape(*batch, n, 1)
    for w, wsh in _pairs(tbl, field, x.device):
        m, stride = v.shape[-2] // 2, v.shape[-1]
        a, b = v[..., :m, :], v[..., m:, :]
        d = shoup_mulmod(sub_mod(a, b, q), w, wsh, q)
        v = torch.stack([add_mod(a, b, q), d], dim=-2).reshape(
            *batch, m, 2 * stride)
    return v.reshape(*batch, n)


def stockham_fwd(x: torch.Tensor, tbl: NttTables) -> torch.Tensor:
    """Cyclic Stockham NTT, nat -> nat."""
    return _stockham(x, tbl, "stockham_fwd")


def stockham_inv(X: torch.Tensor, tbl: NttTables,
                 scale_ninv: bool = True) -> torch.Tensor:
    v = _stockham(X, tbl, "stockham_inv")
    return _scale_ninv(v, tbl) if scale_ninv else v


# ----------------------------------------------------------------------
# Dense matrix NTT: X[k] = sum_j x[j] w^{jk}, one Shoup product per row j
# (an integer matmul would overflow int64).
# ----------------------------------------------------------------------

def _shoup_i64(w: np.ndarray, q: int) -> np.ndarray:
    return (w.astype(np.int64) << 32) // q      # w < 2^30: exact


@functools.lru_cache(maxsize=None)
def _matrix_tables(tbl: NttTables, inverse: bool, device: torch.device):
    n = tbl.n
    tf = tbl.ps.omega_powers(n, inverse=inverse)
    W = tf[np.outer(np.arange(n), np.arange(n)) % n]
    return _i64(W, device), _i64(_shoup_i64(W, tbl.q), device)


def matrix_ntt(x: torch.Tensor, tbl: NttTables,
               inverse: bool = False) -> torch.Tensor:
    """nat -> nat, row by row of the (n, n) twiddle matrix; the inverse
    applies n^{-1}."""
    q, n = tbl.q, tbl.n
    W, Wsh = _matrix_tables(tbl, inverse, x.device)
    acc = torch.zeros_like(x)
    for j in range(n):
        acc = add_mod(acc, shoup_mulmod(x[..., j:j + 1], W[j], Wsh[j], q), q)
    return _scale_ninv(acc, tbl) if inverse else acc


# ----------------------------------------------------------------------
# Four-step N = N1 x N2: column NTTs (n1 points), twiddle w^{k1 j2}, row
# NTTs (n2 points), transpose.  nat -> nat.
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _subtables(name: str, q: int, length: int) -> NttTables:
    """Tables for the same prime at a shorter transform length."""
    return _build(ParamSet(name=f"{name}/sub{length}", n=length, q=q))


@functools.lru_cache(maxsize=None)
def _fourstep_twiddle(tbl: NttTables, n1: int, inverse: bool,
                      device: torch.device):
    n = tbl.n
    tf = tbl.ps.omega_powers(n, inverse=inverse)
    W = tf[np.outer(np.arange(n1), np.arange(n // n1)) % n]   # (k1, j2)
    return _i64(W, device), _i64(_shoup_i64(W, tbl.q), device)


def fourstep_ntt(x: torch.Tensor, tbl: NttTables, n1: int = 32,
                 inverse: bool = False) -> torch.Tensor:
    """Four-step cyclic NTT, nat -> nat: with j = j1 n2 + j2 and
    k = k2 n1 + k1, X[k] = NTT_n2(w^{j2 k1} NTT_n1(x[j1, j2])).  Each
    inverse sub-transform applies its own length^{-1}."""
    q, n = tbl.q, tbl.n
    n2 = n // n1
    t1 = _subtables(tbl.ps.name, q, n1)
    t2 = _subtables(tbl.ps.name, q, n2)
    small = stockham_inv if inverse else stockham_fwd
    W, Wsh = _fourstep_twiddle(tbl, n1, inverse, x.device)
    batch = x.shape[:-1]
    v = x.reshape(*batch, n1, n2).transpose(-1, -2)      # (..., j2, j1)
    v = small(v, t1).transpose(-1, -2)                   # (..., k1, j2)
    v = small(shoup_mulmod(v, W, Wsh, q), t2)            # (..., k1, k2)
    return v.transpose(-1, -2).reshape(*batch, n)        # k = k2 n1 + k1


def fourstep_intt(X: torch.Tensor, tbl: NttTables,
                  n1: int = 32) -> torch.Tensor:
    """Inverse four-step: the same decomposition with n1 and n2 swapped and
    omega^{-1}; the sub-inverses contribute n1^{-1} n2^{-1} = n^{-1}."""
    return fourstep_ntt(X, tbl, n1=tbl.n // n1, inverse=True)


# ----------------------------------------------------------------------
# Permutation and weightings.
# ----------------------------------------------------------------------

def bitrev_permute(v: torch.Tensor, tbl: NttTables) -> torch.Tensor:
    """out[i] = v[bitrev(i)] on the last axis."""
    return torch.index_select(v, -1, _bitrev(tbl, v.device))


def _weight(v: torch.Tensor, tbl: NttTables, field: str) -> torch.Tensor:
    w, wsh = _pairs(tbl, field, v.device)
    return shoup_mulmod(v, w, wsh, tbl.q)


def weight_psi(v: torch.Tensor, tbl: NttTables) -> torch.Tensor:
    """v[i] psi^i."""
    return _weight(v, tbl, "phi")


def weight_ipsi_ninv(v: torch.Tensor, tbl: NttTables) -> torch.Tensor:
    """v[i] n^{-1} psi^{-i}."""
    return _weight(v, tbl, "inv_phi")


def weight_ipsi(v: torch.Tensor, tbl: NttTables) -> torch.Tensor:
    """v[i] psi^{-i}, for inverses that already applied n^{-1}."""
    return _weight(v, tbl, "ipsi_pow")


def bitrev_weight_ipsi_ninv(v: torch.Tensor, tbl: NttTables) -> torch.Tensor:
    """out[i] = v[bitrev(i)] n^{-1} psi^{-i}."""
    return weight_ipsi_ninv(bitrev_permute(v, tbl), tbl)


def weight_psi_bitrev(v: torch.Tensor, tbl: NttTables) -> torch.Tensor:
    """out[i] = v[bitrev(i)] psi^{bitrev(i)}."""
    return bitrev_permute(weight_psi(v, tbl), tbl)
