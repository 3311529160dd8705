"""Twiddle tables for one parameter set (numpy uint32).

Counterpart of ``qtesla_tpu/ops/tables.py``: the merged-psi stage tables
(``ct_fwd_stages``, ``gs_inv_stages``, ``ninv_fold``), the cyclic DIF/DIT
stage tables (``cyc_fwd``, ``cyc_inv``: half-width h -> a (1, h) pair),
the Stockham stage tables (``stockham_fwd``, ``stockham_inv``: one (m, 1)
pair per stage), the weighting rows ``phi`` (psi^i), ``inv_phi``
(n^{-1} psi^{-i}) and ``ipsi_pow`` (psi^{-i}), every table with its Shoup
companion, and ``bitrev``.  It is a module of its own because importing
``qtesla_tpu.ops.tables`` imports jax; this one needs only numpy and the
port's ``params``.  The JAX pairing kernels' full-width (L, n) tables
serve its lane rolls and are not carried over: a GPU thread computes its
twiddle index.

Besides the per-stage tables it carries the compact arrays the CUDA kernels
read.  ``packed`` (shape (4, n)) serves the merged-psi kernels:

- row 0, ``fwd_tw``: psi_rev; forward stage s, block i uses entry 2^s + i;
- row 1, its Shoup companion;
- row 2, ``inv_tw``: psi^{-1}_rev; inverse stage with h blocks, block i
  uses entry h + i.  n^{-1} is folded into the last stage: entry 1 holds
  psi^{-1}_rev[1] * n^{-1} (difference branch) and the otherwise unused
  entry 0 holds n^{-1} (sum branch);
- row 3, its Shoup companion.

``pairing_packed`` (shape (8, n)) serves the pairing kernels:

- row 0: the cyclic stage twiddles, ``cyc_fwd[h]`` at entries [h, 2h):
  entry h + j holds omega^{j n / 2h}, so the cyclic stage of half-width h
  reads entry h + (j mod h); the widest stage holds omega^m for every
  m < n/2 at entry n/2 + m, which Stockham stage st reads at
  m = ((j mod n/2) >> st) << st; entry 0 is unused;
- row 1, its Shoup companion; rows 2, 3 the same for ``cyc_inv``;
- rows 4, 5: ``phi`` and its Shoup companion;
- rows 6, 7: ``inv_phi`` and its Shoup companion.

``get_tables(name)`` builds the bundle from the port's registry;
``from_jax_tables(tbl)`` builds it from the JAX package's ``NttTables``
(duck-typed, so jax is never imported here).  The compact arrays are derived
from the stage tables in one place, so the two routes can be held equal.
"""

from __future__ import annotations

import functools

import numpy as np

from ..params import ParamSet, get_params, shoup_array

__all__ = ["NttTables", "get_tables", "from_jax_tables"]


def _u32(pairs):
    return [tuple(np.asarray(a, dtype=np.uint32) for a in p) for p in pairs]


class NttTables:
    """Stage tables, weighting rows and their compact forms for one
    ParamSet.

    ``ct_fwd_stages[s]`` is the (2^s, 1) twiddle column of forward stage s;
    ``gs_inv_stages[s]`` the (n / 2^(s+1), 1) column of inverse stage s,
    n^{-1} folded into the last; ``ninv_fold`` the (1, 1) n^{-1} for the
    last stage's sum branch; ``cyc_fwd[h]`` / ``cyc_inv[h]`` the (1, h) row
    omega^{+-j n/2h} of a cyclic stage of half-width h;
    ``stockham_fwd[st]`` / ``stockham_inv[st]`` the (n/2^(st+1), 1) column
    of Stockham stage st.  Each is a (w, w_shoup) pair of uint32 arrays, as
    are ``phi``, ``inv_phi`` and ``ipsi_pow``; ``bitrev`` is int32.
    """

    def __init__(self, ps: ParamSet, ct_fwd_stages, gs_inv_stages, ninv_fold,
                 cyc_fwd, cyc_inv, stockham_fwd, stockham_inv, phi, inv_phi,
                 ipsi_pow, bitrev):
        n, q, L = ps.n, ps.q, ps.logn
        self.ps = ps
        self.n, self.q, self.logn = n, q, L
        self.ct_fwd_stages = _u32(ct_fwd_stages)
        self.gs_inv_stages = _u32(gs_inv_stages)
        (self.ninv_fold,) = _u32([ninv_fold])
        self.cyc_fwd = {int(h): p for h, p in
                        zip(cyc_fwd, _u32(cyc_fwd.values()))}
        self.cyc_inv = {int(h): p for h, p in
                        zip(cyc_inv, _u32(cyc_inv.values()))}
        self.stockham_fwd = _u32(stockham_fwd)
        self.stockham_inv = _u32(stockham_inv)
        ((self.phi, self.phi_shoup), (self.inv_phi, self.inv_phi_shoup),
         (self.ipsi_pow, self.ipsi_pow_shoup)) = _u32([phi, inv_phi,
                                                       ipsi_pow])
        self.bitrev = np.asarray(bitrev, dtype=np.int32)
        if (len(self.ct_fwd_stages) != L or len(self.gs_inv_stages) != L
                or len(self.stockham_fwd) != L
                or len(self.stockham_inv) != L
                or sorted(self.cyc_fwd) != [1 << s for s in range(L)]
                or sorted(self.cyc_inv) != [1 << s for s in range(L)]):
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
    @functools.cached_property
    def ct_fwd_full(self) -> np.ndarray:
        return np.stack([np.repeat(w.reshape(-1), self.n >> s)
                         for s, (w, _) in enumerate(self.ct_fwd_stages)])

    @functools.cached_property
    def gs_inv_full(self) -> np.ndarray:
        n = self.n
        inv_full = np.stack([np.repeat(w.reshape(-1), 2 << s)
                             for s, (w, _) in enumerate(self.gs_inv_stages)])
        # last stage: the sum branch (bit n/2 clear) takes n^{-1}
        inv_full[-1, (np.arange(n) & (n >> 1)) == 0] = \
            self.ninv_fold[0].reshape(-1)
        return inv_full

    @functools.cached_property
    def pairing_packed(self) -> np.ndarray:
        packed = np.empty((8, self.n), dtype=np.uint32)
        packed[0:4, 0] = 1, (1 << 32) // self.q, 1, (1 << 32) // self.q
        for row, cyc in ((0, self.cyc_fwd), (2, self.cyc_inv)):
            for h, (w, wsh) in cyc.items():
                packed[row:row + 2, h:2 * h] = w.reshape(-1), wsh.reshape(-1)
        packed[4:] = (self.phi, self.phi_shoup, self.inv_phi,
                      self.inv_phi_shoup)
        return packed


def _pair(w: np.ndarray, q: int):
    w = w.astype(np.uint32)
    return w, shoup_array(w, q)


def _build(ps: ParamSet) -> NttTables:
    """The tables in int64 numpy: the psi and omega powers by blocked
    doubling (``params.powers_mod``), each stage's table a view of them
    (the views a stage or Stockham table takes of omega's powers and their
    Shoup companions share one array each way)."""
    n, q, L = ps.n, ps.q, ps.logn
    fwd = [_pair(ps.psi_rev[1 << s:2 << s].reshape(-1, 1), q)
           for s in range(L)]
    inv = []
    for s in range(L):
        h = n >> (s + 1)
        w = ps.ipsi_rev[h:2 * h].astype(np.int64)
        if h == 1:
            w = w * ps.n_inv % q
        inv.append(_pair(w.reshape(h, 1), q))
    ninv = _pair(np.full((1, 1), ps.n_inv, dtype=np.int64), q)

    cyc_fwd, cyc_inv = {}, {}
    stk_fwd, stk_inv = [], []
    for tf, cyc, stk in ((_pair(ps.omega_powers(n), q), cyc_fwd, stk_fwd),
                         (_pair(ps.omega_powers(n, inverse=True), q),
                          cyc_inv, stk_inv)):
        for s in range(L):
            h = 1 << s
            stride = n // (2 * h)
            cyc[h] = tuple(a[0:h * stride:stride].reshape(1, h) for a in tf)
        # Stockham stage st: current length nc = n >> st, root of order nc
        for st in range(L):
            m, stride = n >> (st + 1), 1 << st
            stk.append(tuple(a[0:m * stride:stride].reshape(m, 1)
                             for a in tf))

    phi = ps.psi_powers
    inv_phi = ps.ipsi_powers * ps.n_inv % q
    return NttTables(ps, fwd, inv, ninv, cyc_fwd, cyc_inv, stk_fwd, stk_inv,
                     _pair(phi, q), _pair(inv_phi, q),
                     _pair(inv_phi * n % q, q), ps.bitrev_tbl)


@functools.lru_cache(maxsize=None)
def get_tables(name: str) -> NttTables:
    return _build(get_params(name))


def from_jax_tables(tbl) -> NttTables:
    """The port's bundle from a ``qtesla_tpu.ops.tables.NttTables`` (read
    through its ``ps``, stage-table, weighting and ``bitrev`` fields)."""
    return NttTables(
        tbl.ps, tbl.ct_fwd_stages, tbl.gs_inv_stages, tbl.ninv_fold,
        tbl.cyc_fwd, tbl.cyc_inv, tbl.stockham_fwd, tbl.stockham_inv,
        (tbl.phi, tbl.phi_shoup), (tbl.inv_phi, tbl.inv_phi_shoup),
        (tbl.ipsi_pow, tbl.ipsi_pow_shoup), tbl.bitrev)
