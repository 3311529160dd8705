"""Merged-psi negacyclic transforms in plain PyTorch.

Counterparts of ``ntt_fwd_merged`` / ``intt_inv_merged`` (``qtesla_tpu/ops/
ntt.py:92-116``) and ``pointwise_mul`` (l.376-380).  They work on int64
tensors holding canonical residues, over the last axis of any batch shape,
and keep every stage canonical, so no product of two values ever exceeds
2^62.  These are the plain versions the CUDA kernels of ``ntt_fused`` are
held against, and what the kernels' wrappers run for CPU tensors.

Twiddles come from the packed (4, n) table of ``tables.NttTables``, on the
input's device: ``twiddles(tbl, device)`` caches one copy per device, and
every function takes an explicit ``tw`` too (``models.NegacyclicPolymul``
passes its registered buffer).
"""

from __future__ import annotations

import functools

import torch

from .modmul import add_mod, mulmod_barrett, shoup_mulmod, sub_mod
from .tables import NttTables

__all__ = ["twiddles", "ntt_fwd_merged", "intt_inv_merged", "pointwise_mul"]


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
