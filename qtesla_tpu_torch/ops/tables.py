"""Merged-psi twiddle tables for one parameter set (numpy uint32).

Counterpart of the merged-psi part of ``qtesla_tpu/ops/tables.py``
(``ct_fwd_stages``, ``gs_inv_stages``, ``ninv_fold`` and their Shoup
companions).  It is a module of its own because importing
``qtesla_tpu.ops.tables`` imports jax; this one needs only numpy and
``qtesla_tpu.params``.

Besides the per-stage lists it carries the compact arrays the CUDA kernels
read, four rows of n entries packed as ``packed`` (shape (4, n)):

- row 0, ``fwd_tw``: psi_rev; forward stage s, block i uses entry 2^s + i;
- row 1, its Shoup companion;
- row 2, ``inv_tw``: psi^{-1}_rev; inverse stage with h blocks, block i
  uses entry h + i.  n^{-1} is folded into the last stage: entry 1 holds
  psi^{-1}_rev[1] * n^{-1} (difference branch) and the otherwise unused
  entry 0 holds n^{-1} (sum branch);
- row 3, its Shoup companion.

``get_tables(name)`` builds the bundle from ``qtesla_tpu.params``;
``from_jax_tables(tbl)`` builds it from the JAX package's ``NttTables``
(duck-typed, so jax is never imported here).  The compact arrays are derived
from the stage lists in one place, so the two routes can be held equal.
"""

from __future__ import annotations

import functools

import numpy as np

from qtesla_tpu.params import ParamSet, get_params

__all__ = ["NttTables", "get_tables", "from_jax_tables"]


def _shoup_arr(tbl: np.ndarray, q: int) -> np.ndarray:
    return ((tbl.astype(object) << 32) // q).astype(np.uint32)


def _u32(pairs):
    return [tuple(np.asarray(a, dtype=np.uint32) for a in p) for p in pairs]


class NttTables:
    """Merged-psi stage tables and their compact form for one ParamSet.

    ``ct_fwd_stages[s]`` is the (2^s, 1) twiddle column of forward stage s;
    ``gs_inv_stages[s]`` the (n / 2^(s+1), 1) column of inverse stage s,
    n^{-1} folded into the last; ``ninv_fold`` the (1, 1) n^{-1} for the
    last stage's sum branch.  Each is a (w, w_shoup) pair of uint32 arrays.
    """

    def __init__(self, ps: ParamSet, ct_fwd_stages, gs_inv_stages, ninv_fold):
        n, q, L = ps.n, ps.q, ps.logn
        self.ps = ps
        self.n, self.q, self.logn = n, q, L
        self.ct_fwd_stages = _u32(ct_fwd_stages)
        self.gs_inv_stages = _u32(gs_inv_stages)
        (self.ninv_fold,) = _u32([ninv_fold])
        if len(self.ct_fwd_stages) != L or len(self.gs_inv_stages) != L:
            raise ValueError(f"expected {L} stages for n={n}")

        # row 0/1: psi_rev and Shoup; entry 0 (psi^0 = 1) is never read
        # row 2/3: psi^{-1}_rev with n^{-1} folded, entry 0 = n^{-1}
        packed = np.empty((4, n), dtype=np.uint32)
        packed[0:2, 0] = 1, ((1 << 32) // q)
        for s, (w, wsh) in enumerate(self.ct_fwd_stages):
            packed[0:2, 1 << s:2 << s] = w.reshape(-1), wsh.reshape(-1)
        packed[2:4, 0] = [a.reshape(-1)[0] for a in self.ninv_fold]
        for s, (w, wsh) in enumerate(self.gs_inv_stages):
            h = n >> (s + 1)
            packed[2:4, h:2 * h] = w.reshape(-1), wsh.reshape(-1)
        self.packed = packed
        self.fwd_tw, self.fwd_tw_shoup, self.inv_tw, self.inv_tw_shoup = packed

        # (L, n) per-lane stage twiddles: lane j of stage s sees its block's
        # twiddle; the MXU planner (mxu_tables.py) builds its stage matrices
        # from these
        j = np.arange(n)
        self.ct_fwd_full = np.stack([
            np.repeat(w.reshape(-1), n >> s) for s, (w, _) in
            enumerate(self.ct_fwd_stages)])
        inv_full = np.stack([
            np.repeat(w.reshape(-1), 2 << s) for s, (w, _) in
            enumerate(self.gs_inv_stages)])
        # last stage: the sum branch (bit n/2 clear) takes n^{-1}
        inv_full[L - 1, (j & (n >> 1)) == 0] = self.ninv_fold[0].reshape(-1)
        self.gs_inv_full = inv_full


def _pair(w: np.ndarray, q: int):
    w = w.astype(np.uint32)
    return w, _shoup_arr(w, q)


def _build(ps: ParamSet) -> NttTables:
    n, q, L = ps.n, ps.q, ps.logn
    psi_rev = ps.psi_rev.astype(object)
    ipsi_rev = ps.ipsi_rev.astype(object)
    fwd = [_pair(psi_rev[1 << s:2 << s].reshape(-1, 1), q) for s in range(L)]
    inv = []
    for s in range(L):
        h = n >> (s + 1)
        w = ipsi_rev[h:2 * h]
        if h == 1:
            w = (w * ps.n_inv) % q
        inv.append(_pair(w.reshape(h, 1), q))
    ninv = _pair(np.full((1, 1), ps.n_inv, dtype=object), q)
    return NttTables(ps, fwd, inv, ninv)


@functools.lru_cache(maxsize=None)
def get_tables(name: str) -> NttTables:
    return _build(get_params(name))


def from_jax_tables(tbl) -> NttTables:
    """The port's bundle from a ``qtesla_tpu.ops.tables.NttTables`` (read
    through its ``ps``, ``ct_fwd_stages``, ``gs_inv_stages`` and
    ``ninv_fold`` fields only)."""
    return NttTables(tbl.ps, tbl.ct_fwd_stages, tbl.gs_inv_stages,
                     tbl.ninv_fold)
