"""Planner of the sequence-parallel (SP) digit-matmul polymul (host only).

Counterpart of the static half of ``qtesla_tpu/parallel/sharded_mxu.py``:
``_RollTables`` (l.89), ``_transform_matrix`` (l.119), ``_k1_position_map``
(l.132), ``_digit_plan`` (l.155) and ``fourstep_mxu_plans`` (l.229-410).  It
is a module of its own because the JAX module imports jax; this one computes
with numpy, reusing the single-transform planner's helpers
(``ops/mxu_tables.py``).  The tests hold every table and plan field equal to
JAX's.

The four-step split n = n1 x n2 runs over a model axis of k shards.  Shard d
holds the coefficients ``x.reshape(B, n1, n2)[:, :, d*n2k:(d+1)*n2k]``
(n2k = n2/k), flat index j1*n2k + lambda, nloc = n1*n2k values a row, cut
into A tiles of TW = min(128, nloc) lanes (Bk = TW/n2k values of j1 a tile).

- Segment 1 (column transform): the n1-point merged-psi forward along j1.
  Its first Lr = log2(A) stages pair whole tiles and stay butterflies; the
  rest act inside a tile and are one TW x TW matrix per (shard, tile), K1,
  with psi^{j2} and the four-step twiddle w^{k1 j2} folded in.
- Segment 2 (rows, after the exchange to (B, n1k, n2)): TW/n2 rows of n2
  lanes a tile; the forward is one matrix shared by every tile and shard,
  K2f = kron(I, R2); the inverse K2i folds w^{-k1 j2} per (shard, tile).
  Rows stay in the merged forward's position order (``k1map``).
- Segment 3 (inverse columns): K3 per (shard, tile), the tile-local inverse
  stages with psi^{-j2} folded in, then Lr inverse butterfly stages with
  n1^{-1} in the last; at Lr = 0 the matrix carries n1^{-1} too.

Each matrix becomes int8 digit tables under one digit plan (``DigitPlan``):
p1 (K1), p2f (K2f), p2i (K2i), p3 (K3), and for the folded fixed-operand
form the worst-case fold plan p2x and its p3x.

The planner works a tile at a time.  Every tile matrix is block-diagonal
once its lanes are put in the right order (``compact_layout``): K1 and K3
couple only lanes of equal lambda (n2k blocks of Bk lanes), K2f, K2i and
the folded F are TW/n2 blocks of n2 lanes.  So each matrix is built as its
own diagonal blocks (``_Blocks``), in int64 numpy vectorised over shards
and tiles in chunks, from the (Bk, Bk) diagonal blocks of the n1-point
stage matrices (``mxu_tables._fwd_blocks``, ``_inv_blocks``) and the
n2-point transform; the digit maxima of every candidate split come from one
pass over the blocks, and only the chosen split's tables are built, as
their nonzero blocks (``DigitPlan.Wc``, ``compact_tables``'s layout).  The
dense matrices and tables JAX's planner builds (``K1``, ``K2f``, ``K2i``,
``DigitPlan.W``) are expanded from the blocks where they are asked for,
for the tests and the twins at small n.  A plan whose tables would pass
``mxu_tables.MAX_TABLE_BYTES`` raises before anything is built
(``check_sp_table_bytes``: K2i's blocks take about n * n2 * din * D bytes).

``fourstep_mxu_plans(name, n1, k)`` plans from the port's registry;
``from_jax_fourstep_plans(plans)`` carries a JAX plan bundle's numpy and int
fields across (duck-typed: jax is never imported here).
``fourstep_fold_tables(plans, spectrum)`` (JAX l.586) builds one constant's
folded segment-2 tables under p2x (``fourstep_fold_blocks`` their nonzero
blocks alone), and ``from_jax_fourstep_fold_tables`` carries JAX's pair
across.
``class_boundary_plan(name, n1, k)`` (JAX l.902) plans the class-sum
boundary, where segment 1 hands on its raw class sums and segment 2 splits
each class plane on its own; ``from_jax_class_boundary_plan`` carries JAX's
plan across.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import ntt as N
from ..ops.mxu_tables import (MAX_TABLE_BYTES, _COST_CSUB, _COST_PLANE,
                              _COST_PLANE_EXTRA, _COST_SHOUP, _chain_csubs,
                              _digit_bounds, _digit_maxima, _digit_t,
                              _fwd_blocks, _group_bias, _input_digit_maxima,
                              _inv_blocks, _lazy_fwd_schedule,
                              _matrix_digit_block, _ndigits, _plan_cost,
                              _plan_groups, _plane_count, _recombine_bound,
                              _reduce_kind, _shifted_t, _split_bias,
                              host_threads, pointwise_bound)
from ..ops.ntt import _subtables
from ..ops.tables import NttTables, get_tables
from ..params import ParamSet, get_params
from .sharded import _fourstep_tables

__all__ = ["SpPlans", "DigitPlan", "FoldPlan", "ClassPlan", "RollTables",
           "CompactLayout", "compact_layout", "compact_tables",
           "expand_compact", "fourstep_mxu_plans", "from_jax_fourstep_plans",
           "fourstep_fold_tables", "fourstep_fold_blocks", "rank_spectrum",
           "from_jax_fourstep_fold_tables",
           "class_boundary_plan", "from_jax_class_boundary_plan",
           "sp_table_bytes", "check_sp_table_bytes"]

_TW_MAX = 128
# int64 entries of own blocks a vectorised planner step takes (16 MiB)
_CHUNK_ENTRIES = 1 << 21


class _Fields:
    """A record of named fields, hashed and compared by identity (device
    tables are cached per plan object)."""

    def __init__(self, **fields):
        self.__dict__.update(fields)

    def __repr__(self):
        scalars = {k: v for k, v in self.__dict__.items()
                   if isinstance(v, (int, bool, str))}
        return f"{type(self).__name__}({scalars})"


class DigitPlan(_Fields):
    """Digit tables of a stack of TW x TW input-major matrices under one
    split and recombination plan: ``Wc`` int8 (..., nblk, Dout*s, kp), the
    tables' nonzero blocks under the layout ``lay`` (``compact_tables``),
    ``W`` int8 (..., din, TW, Dout*TW) the dense tables JAX's planner
    builds (expanded from ``Wc`` when asked for), ``const`` uint32 (..., 1,
    TW); ``din`` planes of ``base`` centred at ``off`` cover inputs below
    2*off (+1); class ``bounds`` and Horner ``groups``; ``raw_bound`` is the
    TPU kernel's recombination bound and ``store_bound`` what it stores (2q
    when ``needs_reduce``)."""

    def __getattr__(self, name):
        d = self.__dict__
        if name == "W" and "Wc" in d:
            d["W"] = expand_compact(d["Wc"], d["lay"], d["din"])
            return d["W"]
        if name == "Wc" and "W" in d:
            d["Wc"] = compact_tables(d["W"], d["lay"])
            return d["Wc"]
        raise AttributeError(name)


class FoldPlan(_Fields):
    """The worst-case plan of the folded segment 2 (p2x), shared by every
    constant: sized for any matrix entry mod q (``mw_wc``)."""


class SpPlans(_Fields):
    """Every schedule, block matrix and digit plan of one (set, n1, k).
    ``K1``, ``K2f`` and ``K2i`` are JAX's dense object matrices, expanded
    from the own blocks (``blocks[kind]``, a ``_Blocks``) where asked
    for."""

    def __getattr__(self, name):
        d = self.__dict__
        if name in ("K1", "K2f", "K2i") and "blocks" in d:
            kind = "columns" if name == "K1" else "rows"
            d[name] = d["blocks"][name].dense(compact_layout(self, kind))
            return d[name]
        raise AttributeError(name)


class ClassPlan(_Fields):
    """The consumer's plan of the class-sum boundary: segment 1 stores class
    m's raw sum c_m as u_m = c_m + ``cls_b[m]`` (p1's inclusive class
    bounds); segment 2 splits u_j into ``dins[j]`` planes of ``bases[j]``
    centred at ``offs[j]`` (= cls_b[j]) and multiplies them by ``W[j]``, int8
    (din_j, TW, Dout*TW), the digit tables of 2^{8j} K2f mod q, summing every
    class's products into one recombination (class ``bounds``, Horner
    ``groups``) with the const row ``const`` uint32 (k, A, 1, TW): seg1's
    centring term off1 * colsum(K1), carried through the exchange and K2f,
    less the group biases."""


class RollTables:
    """The n1-point sub-transform's wide stages over (rows, TW) tiles:
    ``bw`` values of j1 a tile (Bk), the TPU kernel's laziness schedule
    (``fwd_sched``) and its forward hand-off, lazy or canonical."""

    def __init__(self, sub_tbl: NttTables, Lr: int, Bk: int):
        self.tbl = sub_tbl
        self.q = sub_tbl.q
        self.logn = sub_tbl.logn
        self.Lr = Lr
        self.bw = Bk
        self.fwd_sched, bnd = _lazy_fwd_schedule(self.q, Lr)
        self.lazy_bound = bnd
        self.lazy_coverable = _plane_count(bnd) is not None
        self.set_fwd(self.lazy_coverable)

    def set_fwd(self, lazy: bool) -> None:
        self.fwd_lazy = lazy and self.lazy_coverable
        self.fwd_bound = self.lazy_bound if self.fwd_lazy else self.q
        self.fwd_off = self.fwd_bound >> 1


def _transform_matrix(sub_tbl: NttTables, inverse: bool) -> np.ndarray:
    """(m, m) int64 matrix R with y = x @ R == stockham_{fwd,inv} on the
    last axis (n^{-1} included when inverse), canonical: the identity pushed
    through the port's own Stockham code in int64 (m = n2 <= 128)."""
    eye = torch.eye(sub_tbl.n, dtype=torch.int64)
    fn = N.stockham_inv if inverse else N.stockham_fwd
    return fn(eye, sub_tbl).numpy() % sub_tbl.q


def _forward_column(tbl: NttTables, j: int) -> np.ndarray:
    """Column j of the merged-psi forward's exact matrix
    (``mxu_tables._fwd_matrix(tbl, 0)[:, j]``): the unit vector e_j through
    the same stages, O(n log n)."""
    n, q, L = tbl.n, tbl.q, tbl.logn
    idx = np.arange(n)
    v = np.zeros(n, dtype=np.int64)
    v[j] = 1
    for s in range(L):
        t = n >> (s + 1)
        w = tbl.ct_fwd_full[s].astype(np.int64)
        sign = np.where((idx & t) != 0, -1, 1)
        v = (v[idx & ~t] + sign * w * v[idx | t] % q) % q
    return v


def _k1_position_map(sub_tbl: NttTables) -> np.ndarray:
    """pos -> k1: the cyclic output index the merged-psi forward emits at
    each position (out[pos] = sum_j psi1^j omega1^(j k1) x[j]), read off
    the forward's column 1 and checked against column 2."""
    q, n1 = sub_tbl.q, sub_tbl.n
    psi1, om1 = int(sub_tbl.ps.psi), int(sub_tbl.ps.omega)
    col1 = _forward_column(sub_tbl, 1) if n1 > 1 else np.ones(1, np.int64)
    dlog = {}
    v = psi1 % q
    for t in range(n1):
        dlog[v] = t
        v = (v * om1) % q
    k1map = np.array([dlog[int(c)] for c in col1], dtype=np.int64)
    if n1 > 2:
        col2 = _forward_column(sub_tbl, 2)
        psi2 = psi1 * psi1 % q
        want = np.array([psi2 * pow(om1, 2 * int(k), q) % q for k in k1map])
        assert (col2 == want).all(), "k1 map inconsistent"
    return k1map


# ----------------------------------------------------------------------
# Tile matrices as their own diagonal blocks.
# ----------------------------------------------------------------------

class _Blocks:
    """A stack of TW x TW tile matrices (``lead`` shape: (k, A), or () for
    the one shared K2f) given by their own diagonal blocks in position order
    (``compact_layout``): ``fn(f0, f1)`` -> the blocks of flat tiles f0 ..
    f1 - 1, (f1 - f0, nown, own, own) int64, canonical mod q, input-major;
    own block m of a tile covers positions [m * own, (m + 1) * own)."""

    def __init__(self, lead: tuple, nown: int, own: int, fn):
        self.lead, self.nown, self.own, self.fn = lead, nown, own, fn
        self.count = int(np.prod(lead, dtype=np.int64))
        self.entries = self.count * nown * own * own
        self._mw = {}             # digit maxima by base, kept per stack

    def chunks(self):
        step = max(1, _CHUNK_ENTRIES // (self.nown * self.own * self.own))
        for f0 in range(0, self.count, step):
            f1 = min(self.count, f0 + step)
            yield f0, f1, self.fn(f0, f1)

    def digit_maxima(self, q: int, D: int, planes: dict) -> dict:
        """Max |digit| per (plane, class) of the centred base^i * M mod q
        over every entry, for each base's first ``planes[base]`` planes,
        in one pass over the blocks (kept: a later plan of the same stack
        reads them again); a plane whose maxima reach those of any centred
        value mod q needs no further block."""
        want = {b: din for b, din in planes.items()
                if b not in self._mw or len(self._mw[b]) < din}
        if want:
            with host_threads(self.entries):
                self._maxima(q, D, want)
        return {b: self._mw[b][:din] for b, din in planes.items()}

    def _maxima(self, q: int, D: int, want: dict) -> None:
        cap = _digit_maxima(np.asarray([-(q // 2), q - 1 - q // 2])
                            + _split_bias(D, 256), D)
        mw = {b: np.zeros((din, D), dtype=np.int64)
              for b, din in want.items()}
        for _, _, M in self.chunks():
            Mt = torch.from_numpy(M)
            for base, m in mw.items():
                for i in range(m.shape[0]):
                    if (m[i] < cap).any():
                        got = _digit_maxima(
                            _shifted_t(Mt, pow(base, i, q), q, D), D)
                        m[i] = np.maximum(m[i], got)
        self._mw.update(mw)

    def compact(self, lay: "CompactLayout", q: int, D: int, din: int,
                base: int, off: int, bias: int, maxima: bool = False):
        """The split's tables as their nonzero blocks, int8 (*lead, nblk,
        D*s, kp) in ``compact_tables``' layout, the const rows uint32
        (*lead, 1, TW): the centring offset folded in, ``bias`` (the group
        biases) subtracted, and with ``maxima`` the max |digit| (din, D) of
        the tables (else zeros)."""
        with host_threads(self.entries):
            return self._compact(lay, q, D, din, base, off, bias, maxima)

    def _compact(self, lay, q, D, din, base, off, bias, maxima):
        s, nblk, TW = lay.s, lay.nblk, lay.TW
        Wc = np.zeros((self.count, nblk, D * s, compact_depth(din, s)),
                      dtype=np.int8)
        Wt = torch.from_numpy(Wc)
        const = np.empty((self.count, 1, TW), dtype=np.uint32)
        mw = np.zeros((din, D), dtype=np.int64)
        offq = off % q
        pos, korder = (torch.from_numpy(a) for a in (lay.pos, lay.korder))
        for f0, f1, O in self.chunks():
            M = torch.from_numpy(_widen(O, s))       # (c, nblk, s_in, s)
            cs = M.sum(dim=2).reshape(f1 - f0, TW) % q   # by position
            const[f0:f1, 0] = ((offq * cs[:, pos] - bias) % q).numpy()
            # output-major, the inputs in the depth's order
            Mt = M[:, :, korder, :].transpose(-1, -2).contiguous()
            out = Wt[f0:f1].view(f1 - f0, nblk, D, s, -1)
            for i in range(din):
                u = _shifted_t(Mt, pow(base, i, q), q, D)
                if maxima:
                    mw[i] = np.maximum(mw[i], _digit_maxima(u, D))
                for j in range(D):
                    out[:, :, j, :, i * s:(i + 1) * s] = _digit_t(u, j, D)
        return (Wc.reshape(*self.lead, *Wc.shape[1:]),
                const.reshape(*self.lead, 1, TW), mw)

    def dense(self, lay: "CompactLayout") -> np.ndarray:
        """The dense (*lead, TW, TW) matrices in lane order, as JAX's object
        arrays."""
        TW = lay.TW
        out = np.empty((self.count, TW, TW), dtype=np.int64)
        for f0, f1, O in self.chunks():
            P = _widen(O, TW)[:, 0]                # position order
            out[f0:f1] = P[:, lay.pos][:, :, lay.pos]
        return out.reshape(*self.lead, TW, TW).astype(object)

    def colsums(self, lay: "CompactLayout", q: int) -> np.ndarray:
        """Column sums mod q, (*lead, TW) int64 by lane."""
        out = np.empty((self.count, lay.TW), dtype=np.int64)
        for f0, f1, O in self.chunks():
            cs = O.sum(axis=2).reshape(f1 - f0, lay.TW) % q
            out[f0:f1] = cs[:, lay.pos]
        return out.reshape(*self.lead, lay.TW)


def _widen(O: np.ndarray, s: int) -> np.ndarray:
    """Own blocks (c, nown, own, own) -> blocks of s >= own positions (c,
    nown * own / s, s, s), each holding s / own own blocks on its diagonal
    and zeros between them."""
    c, nown, own = O.shape[:3]
    g = s // own
    if g == 1:
        return O
    M = np.zeros((c, nown // g, g, own, g, own), dtype=O.dtype)
    Og = O.reshape(c, nown // g, g, own, own)
    for h in range(g):
        M[:, :, h, :, h, :] = Og[:, :, h]
    return M.reshape(c, nown // g, s, s)


def _blocks_of_dense(M: np.ndarray, lay: "CompactLayout", own: int,
                     q: int) -> "_Blocks":
    """The own blocks of dense matrices (*lead, TW, TW) (a JAX bundle's),
    in position order."""
    lead, TW = M.shape[:-2], lay.TW
    P = (M.reshape(-1, TW, TW)[:, lay.lane][:, :, lay.lane]
         .astype(object) % q).astype(np.int64)
    nown = TW // own
    O = np.stack([P[:, m * own:(m + 1) * own, m * own:(m + 1) * own]
                  for m in range(nown)], axis=1)
    return _Blocks(tuple(lead), nown, own, lambda f0, f1: O[f0:f1])


# ----------------------------------------------------------------------
# Digit plans.
# ----------------------------------------------------------------------

def _digit_plan(K: _Blocks, lay: "CompactLayout", q: int, one_shoup: int,
                in_bound: int, downstream: str = "any",
                reduce_uncoverable: bool = True,
                bases: tuple = (256, 128)) -> DigitPlan:
    """One shared plan for the stack K: the cheapest split over ``bases``
    at each base's fewest covering planes, costed like the single-transform
    planner plus ``_COST_PLANE_EXTRA`` for every plane beyond the fewest of
    any base; bounds worst-case over the stack.  Only the chosen split's
    tables are built."""
    TW = lay.TW
    Dout = _ndigits(q)
    off = in_bound >> 1
    planes = {b: d for b in bases
              if (d := _plane_count(in_bound, b)) is not None}
    if not planes:
        raise ValueError(f"lazy bound {in_bound} uncoverable at any base")
    din_min = min(planes.values())
    mw = K.digit_maxima(q, Dout, planes)
    best = None
    for base, din in planes.items():
        bounds = _digit_bounds(
            mw[base], TW, _input_digit_maxima(din, off, in_bound, base))
        try:
            groups = _plan_groups(bounds, q, downstream)
        except ValueError:
            continue
        (sh, cs, ng), _ = _plan_cost(groups, bounds, q, downstream)
        cost = (_COST_SHOUP * sh + _COST_CSUB * cs
                + (_COST_PLANE + Dout) * din
                + _COST_PLANE_EXTRA * (din - din_min), ng)
        if best is None or cost < best[0]:
            best = (cost, base, din, bounds, groups)
    if best is None:
        raise ValueError(f"lazy bound {in_bound} uncoverable at any base")
    _, base, din, bounds, groups = best
    Wc, const, _ = K.compact(lay, q, Dout, din, base, off,
                             _group_bias(groups, bounds, q))
    raw_bound = _recombine_bound(groups, bounds, q)
    needs_reduce = reduce_uncoverable and _plane_count(raw_bound) is None
    return DigitPlan(
        Wc=Wc, lay=lay, const=const, groups=groups, bounds=bounds, bw=TW,
        din=din, off=off, base=base, q=q, one_shoup=one_shoup,
        raw_bound=raw_bound, needs_reduce=needs_reduce,
        store_bound=2 * q if needs_reduce else raw_bound)


def _fold_plan(p1: DigitPlan, q: int, n2: int, TW: int,
               one_shoup: int) -> FoldPlan:
    """The worst-case plan of the folded segment 2, F = K2f diag(A) K2i,
    block-diagonal over n2-blocks: split the stored seg-1 output as it is,
    or canonicalised first, at base 256 or 128."""
    Dout = _ndigits(q)
    wcm = _input_digit_maxima(Dout, q >> 1, q, 256)
    best = None
    for in_b, canon in ((p1.store_bound, False), (q, True)):
        if canon and p1.store_bound <= q:
            continue
        for base in (256, 128):
            din = _plane_count(in_b, base)
            if din is None:
                continue
            mw = np.tile(np.asarray(wcm, np.int64), (din, 1))
            bounds = _digit_bounds(
                mw, n2, _input_digit_maxima(din, in_b >> 1, in_b, base))
            try:
                groups = _plan_groups(bounds, q, "any")
            except ValueError:
                continue
            (sh, cs, ng), _ = _plan_cost(groups, bounds, q, "any")
            cost = (_COST_SHOUP * sh + _COST_CSUB * cs
                    + (_COST_PLANE + Dout + _COST_PLANE_EXTRA) * din)
            if canon:
                cost += _COST_CSUB * (
                    _chain_csubs(p1.store_bound, q, q)
                    if p1.store_bound <= 16 * q else 4)
            raw = _recombine_bound(groups, bounds, q)
            needs_reduce = _plane_count(raw) is None
            key = (cost, ng)
            if best is None or key < best.cost_key:
                best = FoldPlan(
                    cost_key=key, base=base, din=din, off=in_b >> 1,
                    in_bound=in_b, canon=canon, bw=TW, q=q,
                    one_shoup=one_shoup, groups=tuple(groups),
                    bounds=tuple(bounds), mw_wc=mw.copy(), raw_bound=raw,
                    needs_reduce=needs_reduce,
                    store_bound=2 * q if needs_reduce else raw, Dout=Dout)
    if best is None:
        raise ValueError("no digit split covers the SP fold")
    return best


def _shape(n: int, n1: int, k: int) -> dict:
    """The SP layout of (n, n1, k), or ValueError when the split does not
    apply."""
    if n1 <= 0 or n1 & (n1 - 1) or n % n1 or n1 > n:
        raise ValueError(f"n1={n1} must be a power of two dividing n={n}")
    n2 = n // n1
    if n1 % k or n2 % k:
        raise ValueError(
            f"model axis {k} must divide both n1={n1} and n2={n2}")
    if n2 > _TW_MAX:
        raise ValueError(
            f"row transform n2={n2} exceeds one {_TW_MAX}-lane tile; pick a "
            f"larger n1 (n1 >= n/{_TW_MAX} = {n // _TW_MAX}, "
            f"distributed.sp_n1(n))")
    n2k, n1k = n2 // k, n1 // k
    nloc = n1 * n2k
    TW = min(_TW_MAX, nloc)
    A = nloc // TW
    return dict(n=n, n1=n1, n2=n2, k=k, n1k=n1k, n2k=n2k, nloc=nloc, TW=TW,
                A=A, Bk=TW // n2k, Lr=A.bit_length() - 1)


def sp_table_bytes(n: int, q: int, n1: int, k: int) -> int:
    """The fewest bytes of int8 digit tables (the nonzero blocks of K1, K2f,
    K2i and K3 under p3 and p3x, one copy) a plan of (n, q, n1, k) can need,
    from the shapes and the fewest covering plane counts alone; nothing is
    built.  K2i's blocks dominate, n * n2 * din * D bytes."""
    g = _shape(n, n1, k)
    D = _ndigits(q)
    cols, rows = (compact_layout(_Fields(**g), kind)
                  for kind in ("columns", "rows"))

    def fewest(bound):
        return min((c for base in (256, 128)
                    if (c := _plane_count(bound, base)) is not None),
                   default=1)

    def per_tile(lay, din):
        return lay.nblk * D * lay.s * compact_depth(din, lay.s)

    tiles = g["k"] * g["A"]
    col_din = fewest(q)
    return (tiles * (3 * per_tile(cols, col_din)
                     + per_tile(rows, fewest(pointwise_bound(q))))
            + per_tile(rows, fewest(q)))


def check_sp_table_bytes(n: int, q: int, n1: int, k: int) -> None:
    """Raise, naming the bytes and the limit, where a plan of (n, q, n1, k)
    would need more than ``MAX_TABLE_BYTES`` of digit tables
    (``sp_table_bytes``)."""
    need = sp_table_bytes(n, q, n1, k)
    if need > MAX_TABLE_BYTES:
        raise ValueError(
            f"n={n}, q={q}, n1={n1}, k={k}: the SP digit tables would take "
            f"at least {need} bytes ({need / 2**30:.1f} GiB), past the "
            f"{MAX_TABLE_BYTES} bytes ({MAX_TABLE_BYTES >> 30} GiB) the "
            f"planner builds")


def _column_blocks(g: dict, mats: np.ndarray, lane_fold) -> _Blocks:
    """K1 or K3 as own blocks: the (A, Bk, Bk) input-major diagonal blocks
    ``mats`` of the n1-point tile-local stages, times ``lane_fold(t, c, d,
    lam)`` (broadcast over (tile, output j1 c, shard, lambda)) mod q; own
    block lam of tile (d, t) is (Bk, Bk) at positions lam * Bk + j1."""
    k, A, n2k, Bk = g["k"], g["A"], g["n2k"], g["Bk"]

    def fn(f0, f1):
        d = np.arange(f0, f1) // A
        t = np.arange(f0, f1) % A
        # (c, lam, b, c_out): mats[t][b, c] * fold(t, c_out, d, lam)
        fold = lane_fold(t[:, None, None], np.arange(Bk)[None, None, :],
                         d[:, None, None], np.arange(n2k)[None, :, None])
        return mats[t][:, None] * fold[:, :, None, :] % g["q"]

    return _Blocks((k, A), n2k, Bk, fn)


@functools.lru_cache(maxsize=None)
def fourstep_mxu_plans(name: str, n1: int, k: int) -> SpPlans:
    """All wide-stage schedules, block matrices and digit plans of one
    (parameter set, n1, model axis k).  Past ``MAX_TABLE_BYTES`` of tables
    it raises before anything is built."""
    ps = get_params(name)
    n, q = ps.n, ps.q
    g = _shape(n, n1, k)
    check_sp_table_bytes(n, q, n1, k)
    tbl = get_tables(name)
    g["q"] = q
    n2, n2k, n1k, TW, A, Bk, Lr = (g[f] for f in ("n2", "n2k", "n1k", "TW",
                                                  "A", "Bk", "Lr"))
    L1 = n1.bit_length() - 1
    t1 = _subtables(name, q, n1)
    t2 = _subtables(name, q, n2)
    # the folding identities the construction relies on
    assert int(t1.ps.psi) == pow(int(tbl.ps.psi), n2, q), "psi1 != psi^n2"
    assert int(t2.ps.omega) == pow(int(tbl.ps.omega), n1, q)
    one_shoup = tbl.ps.one_shoup
    rolls = RollTables(t1, Lr, Bk)
    T = _fourstep_tables(name, n1)
    phi = tbl.phi[:n2].astype(np.int64)
    ipsi = tbl.ipsi_pow[:n2].astype(np.int64)
    W = T["W"].astype(np.int64)
    Winv = T["Winv"].astype(np.int64)
    k1map = _k1_position_map(t1)
    # the tile-local stages' (Bk, Bk) diagonal blocks, input-major
    Mf = np.swapaxes(_fwd_blocks(t1, Lr, Bk), 1, 2)
    Mi = np.swapaxes(_inv_blocks(t1, L1 - Lr, Bk), 1, 2)
    R2 = _transform_matrix(t2, inverse=False)
    R2i = _transform_matrix(t2, inverse=True)
    shape = _Fields(**g)
    cols, rows = (compact_layout(shape, kind)
                  for kind in ("columns", "rows"))

    # segments 1 and 3: K1[d, t][b n2k + lam, c n2k + lam] = Mf[t][b, c]
    # psi^{j2} w^{k1 j2}, K3 the same with Mi and psi^{-j2} (j2 = d n2k +
    # lam, k1 = k1map[t Bk + c])
    def k1_fold(t, c, d, lam):
        j2 = d * n2k + lam
        return phi[j2] * W[k1map[t * Bk + c], j2] % q

    K1 = _column_blocks(g, Mf, k1_fold)
    K3 = _column_blocks(g, Mi, lambda t, c, d, lam: ipsi[d * n2k + lam])

    # segment 2: R = TW/n2 rows of n2 lanes a tile; K2i's own block rho of
    # tile (d, bb) is R2i w^{-k1 j2}, k1 = k1map[d n1k + bb R + rho]
    R = TW // n2
    K2f = _Blocks((), R, n2, lambda f0, f1: np.tile(R2, (f1 - f0, R, 1, 1)))
    # Shoup companions, and the tables in torch for the host's threads
    r2i, winv = torch.from_numpy(R2i), torch.from_numpy(Winv)
    winv_sh = (winv << 32) // q
    k1t = torch.from_numpy(k1map)

    def k2i_blocks(f0, f1):
        # R2i's columns times w^{-k1 j2}, Shoup-reduced (no division)
        rows = k1t[f0 * R:f1 * R]
        w, wsh = winv[rows][:, None, :], winv_sh[rows][:, None, :]
        r = r2i[None] * w - ((r2i[None] * wsh) >> 32) * q
        return torch.where(r >= q, r - q, r).reshape(
            f1 - f0, R, n2, n2).numpy()

    K2i = _Blocks((k, A), R, n2, k2i_blocks)

    pw_bound = pointwise_bound(q)
    # seg-1 forward split: lazy against the canonical chain-then-split
    candidates = []
    if rolls.lazy_coverable and rolls.lazy_bound > q:
        candidates.append((True, _digit_plan(K1, cols, q, one_shoup,
                                             in_bound=rolls.lazy_bound), 0))
    candidates.append((False, _digit_plan(K1, cols, q, one_shoup,
                                          in_bound=q),
                       _chain_csubs(rolls.lazy_bound, q, q)))
    din_floor = min(c[1].din for c in candidates)

    def p1_cost(p, extra_cs):
        (sh, cs, ng), _ = _plan_cost(p.groups, p.bounds, q, "any")
        return (_COST_SHOUP * sh + _COST_CSUB * (cs + extra_cs)
                + (_COST_PLANE + _ndigits(q)) * p.din
                + _COST_PLANE_EXTRA * (p.din - din_floor), ng)

    lazy_pick, p1, _ = min(candidates, key=lambda c: p1_cost(c[1], c[2]))
    rolls.set_fwd(lazy_pick)
    p2f = _digit_plan(K2f, rows, q, one_shoup, in_bound=p1.store_bound,
                      reduce_uncoverable=False)
    p2i = _digit_plan(K2i, rows, q, one_shoup, in_bound=pw_bound)
    p3 = _digit_plan(K3, cols, q, one_shoup, in_bound=p2i.store_bound,
                     downstream=_reduce_kind(q), reduce_uncoverable=False)
    p2x = _fold_plan(p1, q, n2, TW, one_shoup)
    p3x = _digit_plan(K3, cols, q, one_shoup, in_bound=p2x.store_bound,
                      downstream=_reduce_kind(q), reduce_uncoverable=False)
    return SpPlans(name=name, ps=tbl.ps, t1=t1, rolls=rolls,
                   pw_bound=pw_bound, k1map=k1map, p1=p1, p2f=p2f, p2i=p2i,
                   p3=p3, p2x=p2x, p3x=p3x, D=_ndigits(q),
                   blocks={"K1": K1, "K3": K3, "K2f": K2f, "K2i": K2i}, **g)


# ----------------------------------------------------------------------
# Folded segment 2 of one constant.
# ----------------------------------------------------------------------

def _mod_f64(v: torch.Tensor, q: int) -> torch.Tensor:
    """v mod q for float64 integers below 2^53, exact: the quotient's floor
    is off by at most one, which the two corrections take back."""
    r = v - torch.floor(v * (1.0 / q)) * q
    r = torch.where(r < 0, r + q, r)
    return torch.where(r >= q, r - q, r)


def _matmul_mod(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """a @ b mod q for int64 entries below q < 2^30 and an inner axis of at
    most 2^7: float64 products (torch, all host threads) of a's 15-bit
    halves by b, so no partial sum passes 2^52 and every one is exact."""
    assert a.shape[-1] <= 128, "inner axis past 2^7"
    with host_threads(a.size * b.shape[-1]):
        at, bf = torch.from_numpy(a), torch.from_numpy(b).to(torch.float64)
        lo = _mod_f64(torch.matmul((at & 0x7FFF).to(torch.float64), bf), q)
        hi = _mod_f64(torch.matmul((at >> 15).to(torch.float64), bf), q)
        return _mod_f64(lo + hi * 32768.0, q).to(torch.int64).numpy()


def _fold_input(plans: SpPlans, spectrum, first):
    """(S, A, R, 1, n2) int64 spectrum mod q of the shards the tables are
    for, and the flat tile number of their first tile."""
    q, A, k, n2, TW = plans.q, plans.A, plans.k, plans.n2, plans.TW
    spec = np.asarray(spectrum)
    if first is None:
        if spec.size != plans.n:
            raise ValueError(f"spectrum must hold n={plans.n} values, got "
                             f"{spec.shape}")
        first = 0
    elif (spec.ndim != 2 or spec.shape[1] != plans.nloc or first < 0
          or first + spec.shape[0] > k):
        raise ValueError(f"rows of shards {first}.. must be (S, "
                         f"{plans.nloc}) within the model axis of {k}, "
                         f"got {spec.shape}")
    S = spec.size // plans.nloc
    dg = (spec.astype(np.int64) % q).reshape(S, A, TW // n2, 1, n2)
    return dg, first * A


def fourstep_fold_blocks(plans: SpPlans, spectrum, first: int | None = None):
    """One constant's folded segment-2 tables under p2x as their nonzero
    blocks: per (shard d, tile t) the matrix F = K2f diag(A^[d, t])
    K2i[d, t], block-diagonal over n2-blocks, as ``Wc`` int8 (S, A, nblk,
    Dout*s, kp) (``compact_tables``' "rows" layout, what B15 multiplies)
    and ``const`` uint32 (S, A, 1, TW).

    ``spectrum`` is the constant's device-major SP spectrum, (n,) or (k,
    nloc) uint32, canonical or lazy (it is taken mod q); with ``first`` it
    is the rows (S, nloc) of shards first..first+S-1 alone (a rank's own),
    and the tables are those shards'.  F is built a chunk of tiles at a
    time in int64 from the own blocks, where JAX uses Python ints."""
    p = plans.p2x
    q, A = plans.q, plans.A
    dg, f_first = _fold_input(plans, spectrum, first)
    S = dg.shape[0]
    k2f = plans.blocks["K2f"].fn(0, 1)[0]            # (R, n2, n2)
    k2i = plans.blocks["K2i"]

    def fn(f0, f1):
        # K2f's columns scaled by the diagonal, then through K2i
        return _matmul_mod(k2f * dg.reshape(S * A, *dg.shape[2:])[f0:f1]
                           % q, k2i.fn(f_first + f0, f_first + f1), q)

    F = _Blocks((S, A), k2i.nown, k2i.own, fn)
    Wc, const, mw = F.compact(compact_layout(plans, "rows"), q, p.Dout,
                              p.din, p.base, p.off,
                              _group_bias(p.groups, p.bounds, q),
                              maxima=True)
    # plan soundness: the digits sit inside the worst case p2x covers
    assert (mw <= p.mw_wc).all(), \
        "folded-matrix digits exceed the worst-case SP plan"
    return Wc, const


def fourstep_fold_tables(plans: SpPlans, spectrum, first: int | None = None):
    """One constant's folded segment-2 tables under p2x, bit for bit JAX's
    ``fourstep_fold_tables`` (l.586): ``W`` int8 (S, A, din, TW, Dout*TW)
    dense, expanded from ``fourstep_fold_blocks``' nonzero blocks, and
    ``const`` uint32 (S, A, 1, TW); S = k, or the shards of ``first``."""
    Wc, const = fourstep_fold_blocks(plans, spectrum, first)
    return (expand_compact(Wc, compact_layout(plans, "rows"), plans.p2x.din),
            const)


# ----------------------------------------------------------------------
# The class-sum boundary.
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def class_boundary_plan(name: str, n1: int, k: int) -> ClassPlan:
    """The class-sum boundary's plan of one (set, n1, k), field for field
    JAX's ``class_boundary_plan`` (l.902).  It is built for every set; the
    kernels' limits (at most 3 classes, class bounds below 2^24) are checked
    where a kernel is planned (``sharded_classes.plan_for``).  Its tables
    are one TW x TW matrix's, whatever n."""
    plans = fourstep_mxu_plans(name, n1, k)
    q, TW = plans.q, plans.TW
    Dout = _ndigits(q)
    cls_b = [int(b) for b in plans.p1.bounds]
    K2f = _k2f_dense(plans)
    Ws, dins, bases = [], [], []
    bounds = [0] * Dout
    for j, bj in enumerate(cls_b):
        # u_j = c_j + bj lies in [0, 2 bj]: the fewest planes, base 256 first
        in_b = 2 * bj + 1
        split = min(((d, -b) for b in (256, 128)
                     if (d := _plane_count(in_b, b)) is not None),
                    default=None)
        if split is None:
            raise ValueError(f"class bound {bj} uncoverable at any base")
        din, base = split[0], -split[1]
        mw = np.zeros((din, Dout), dtype=np.int64)
        W, _ = _matrix_digit_block(K2f * pow(2, 8 * j, q) % q, q, din, Dout,
                                   mw, in_base=base)
        Ws.append(W)
        dins.append(din)
        bases.append(base)
        bounds = [a + b for a, b in zip(bounds, _digit_bounds(
            mw, TW, _input_digit_maxima(din, bj, in_b, base)))]
    groups = _plan_groups(bounds, q, "any")
    return ClassPlan(
        Dout=Dout, cls_b=cls_b, W=Ws, dins=tuple(dins), bases=tuple(bases),
        offs=tuple(cls_b), groups=tuple(groups), bounds=tuple(bounds),
        raw_bound=_recombine_bound(groups, bounds, q),
        const=_class_const(plans, _group_bias(groups, bounds, q)),
        one_shoup=plans.ps.one_shoup)


def _k2f_dense(plans: SpPlans) -> np.ndarray:
    """K2f (TW, TW) int64 canonical: one tile matrix, whatever n."""
    return plans.blocks["K2f"].dense(
        compact_layout(plans, "rows"))[()].astype(np.int64)


def _class_const(plans: SpPlans, group_bias: int) -> np.ndarray:
    """The consumer's const rows (k, A, 1, TW): seg1's centring term
    off1 * colsum(K1[d, t]) of every producer lane, moved to its row position
    after the forward exchange, through K2f, less ``group_bias``; int64 where
    JAX uses Python ints."""
    q, k, A, TW = plans.q, plans.k, plans.A, plans.TW
    n2, n2k, n1k, Bk = plans.n2, plans.n2k, plans.n1k, plans.Bk
    colsum = plans.blocks["K1"].colsums(compact_layout(plans, "columns"), q)
    cs1 = (plans.p1.off % q) * colsum % q                      # (k, A, TW)
    # row position rho * n2 + j2 of consumer tile (dc, bb) holds source j1 =
    # dc * n1k + bb * R + rho, lane j2 of producer shard j2 // n2k
    R = TW // n2
    j1 = (np.arange(k)[:, None, None, None] * n1k
          + np.arange(A)[None, :, None, None] * R
          + np.arange(R)[None, None, :, None])
    j2 = np.arange(n2)[None, None, None, :]
    vec = cs1[j2 // n2k, j1 // Bk, (j1 % Bk) * n2k + j2 % n2k]
    row = _matmul_mod(vec.reshape(k, A, TW), _k2f_dense(plans), q)
    return ((row - group_bias) % q).astype(np.uint32).reshape(k, A, 1, TW)


# ----------------------------------------------------------------------
# The tables' nonzero blocks.
# ----------------------------------------------------------------------

_MMA_LANES = 8          # output lanes of one tensor-core tile


class CompactLayout(_Fields):
    """Where a TW x TW tile matrix of one kind is nonzero: after the lane
    permutation ``pos`` (lane l of a tile sits at position pos[l]; ``lane``
    is its inverse) it is block-diagonal over ``nblk`` blocks of ``s``
    positions.  ``llam`` and ``lbk`` give the permutation in closed form, as
    the kernels compute it: pos = ((l & (2^llam - 1)) << lbk) | (l >> llam).
    ``korder`` is the order of a block's positions along the depth of its
    table: byte b of a plane holds position korder[b].  The kernels' split
    packs four digits into one word, so byte 4w + j is position
    w + j * 2^lq: lq = log2(s/4) for the column tables (a thread's four
    values then lie s/4 * n2k lanes apart, in four different banks), lq = 0
    (positions as they lie, one 16-byte load) for the row tables."""


def compact_layout(plans, kind: str) -> CompactLayout:
    """The block structure of one kind of tile matrix, from the plan's
    shapes alone (TW, n2k, Bk, n2; ``compact_tables`` checks it against the
    entries).

    ``"columns"`` (K1, K3): a lane is j1 * n2k + lambda and the matrix
    couples only lanes of equal lambda, so lambda-major order (position
    lambda * Bk + j1) gives n2k blocks of Bk lanes.  ``"rows"`` (K2f, K2i,
    the class tables, the folded F): TW / n2 blocks of n2 lanes as they lie.
    A block narrower than a tensor-core tile's 8 output lanes is widened to
    8 positions: the block then holds several of the matrix's own blocks
    and the zeros between them."""
    TW = plans.TW
    ltw = TW.bit_length() - 1
    if kind == "columns":
        llam, lbk, own = plans.n2k.bit_length() - 1, \
            plans.Bk.bit_length() - 1, plans.Bk
    elif kind == "rows":
        llam, lbk, own = 0, ltw, plans.n2
    else:
        raise ValueError(f"unknown table kind {kind!r}")
    s = min(TW, max(own, _MMA_LANES))
    ls = s.bit_length() - 1
    lq = ls - 2 if kind == "columns" else 0
    lanes = np.arange(TW)
    pos = ((lanes & ((1 << llam) - 1)) << lbk) | (lanes >> llam)
    lane = np.empty(TW, dtype=np.int64)
    lane[pos] = lanes
    byte = np.arange(s)
    korder = (byte >> 2) * (1 if lq else 4) + ((byte & 3) << lq)
    return CompactLayout(kind=kind, TW=TW, s=s, ls=ls, nblk=TW // s,
                         llam=llam, lbk=lbk, lq=lq, pos=pos, lane=lane,
                         korder=korder)


def compact_depth(din: int, s: int) -> int:
    """A block's table depth: din * s rounded up to a multiple of 32."""
    return -(-din * s // 32) * 32


def compact_tables(W: np.ndarray, lay: CompactLayout) -> np.ndarray:
    """Input-major digit tables W int8 (..., din, TW, D*TW) -> their
    diagonal blocks (..., nblk, D*s, kp) int8, output-major: block b's row
    j*s + o is class j of the output lane at position b*s + o, its column
    i*s + k plane i of the input lane at position b*s + korder[k]; columns
    din*s .. kp-1 are zero.  Raises if an entry outside the blocks is
    nonzero."""
    *lead, din, TW, dtw = W.shape
    D, s, nblk = dtw // TW, lay.s, lay.nblk
    if TW != lay.TW:
        raise ValueError(f"tables of {TW} lanes, layout of {lay.TW}")
    # (..., din, in position, D, out position), both split into (block, s)
    P = W.reshape(*lead, din, TW, D, TW)[..., lay.lane, :, :][..., lay.lane]
    P = P.reshape(*lead, din, nblk, s, D, nblk, s)
    out = np.zeros((*lead, nblk, D * s, compact_depth(din, s)), dtype=np.int8)
    for b in range(nblk):
        # (..., din, s, D, s), the input positions in the depth's order
        blk = P[..., :, b, :, :, b, :][..., lay.korder, :, :]
        out[..., b, :, :din * s] = np.moveaxis(blk, (-2, -1), (-4, -3)) \
            .reshape(*lead, D * s, din * s)
    if np.count_nonzero(out) != np.count_nonzero(W):
        raise ValueError(f"{lay.kind} tables have nonzero entries outside "
                         f"their {nblk} blocks of {s} lanes")
    return out


def expand_compact(C: np.ndarray, lay: CompactLayout, din: int) -> np.ndarray:
    """The inverse of ``compact_tables``: blocks (..., nblk, D*s, kp) -> the
    dense input-major tables (..., din, TW, D*TW), zero outside the
    blocks."""
    *lead, nblk, ds, _ = C.shape
    s, TW = lay.s, lay.TW
    D = ds // s
    P = np.zeros((*lead, din, nblk, s, D, nblk, s), dtype=np.int8)
    for b in range(nblk):
        blk = C[..., b, :, :din * s].reshape(*lead, D, s, din, s)
        P[..., :, b, lay.korder, :, b, :] = np.moveaxis(
            np.moveaxis(blk, (-4, -3), (-2, -1)), -3, 0)
    P = P.reshape(*lead, din, TW, D, TW)[..., lay.pos, :, :][..., lay.pos]
    return P.reshape(*lead, din, TW, D * TW)


# ----------------------------------------------------------------------
# Carried across from a JAX plan bundle.
# ----------------------------------------------------------------------

_LAYOUT_FIELDS = ("n", "n1", "n2", "k", "n1k", "n2k", "nloc", "TW", "A",
                  "Bk", "Lr")
_PLAN_FIELDS = ("name", "q", "pw_bound", "k1map", "K1", "K2f", "K2i")
_ROLL_FIELDS = ("fwd_sched", "lazy_bound", "lazy_coverable", "fwd_lazy",
                "fwd_bound", "fwd_off")
DIGIT_FIELDS = ("W", "const", "groups", "bounds", "bw", "din", "off", "base",
                "q", "one_shoup", "raw_bound", "needs_reduce", "store_bound")
FOLD_FIELDS = ("cost_key", "base", "din", "off", "in_bound", "canon", "bw",
               "q", "one_shoup", "groups", "bounds", "mw_wc", "raw_bound",
               "needs_reduce", "store_bound", "Dout")


def _copy(v):
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, list):
        return list(v)
    return v


def from_jax_fourstep_plans(plans) -> SpPlans:
    """The port's bundle from a ``qtesla_tpu.parallel.sharded_mxu``
    ``fourstep_mxu_plans`` result, read through its numpy and int fields
    only; the sub-transform tables are the port's own."""
    f = {a: _copy(getattr(plans, a)) for a in _LAYOUT_FIELDS + _PLAN_FIELDS}
    if _shape(f["n"], f["n1"], f["k"]) != {a: f[a] for a in _LAYOUT_FIELDS}:
        raise ValueError("plan bundle's layout fields are inconsistent")
    q, n1 = f["q"], f["n1"]
    t1 = _subtables(f["name"], q, n1)
    rolls = RollTables(t1, f["Lr"], f["Bk"])
    for a in _ROLL_FIELDS:
        setattr(rolls, a, _copy(getattr(plans.rolls, a)))
    shape = _Fields(**{a: f[a] for a in _LAYOUT_FIELDS})
    cols, rows = (compact_layout(shape, kind)
                  for kind in ("columns", "rows"))
    digit = {p: DigitPlan(lay=cols if p in ("p1", "p3", "p3x") else rows,
                          **{a: _copy(getattr(getattr(plans, p), a))
                             for a in DIGIT_FIELDS})
             for p in ("p1", "p2f", "p2i", "p3", "p3x")}
    p2x = FoldPlan(**{a: _copy(getattr(plans.p2x, a)) for a in FOLD_FIELDS})
    ps = ParamSet(name=f["name"], n=f["n"], q=q)
    blocks = {"K1": _blocks_of_dense(f["K1"], cols, f["Bk"], q),
              "K2f": _blocks_of_dense(f["K2f"], rows, f["n2"], q),
              "K2i": _blocks_of_dense(f["K2i"], rows, f["n2"], q)}
    return SpPlans(ps=ps, t1=t1, rolls=rolls, p2x=p2x, D=_ndigits(q),
                   blocks=blocks, **digit, **f)


CLASS_FIELDS = ("Dout", "cls_b", "dins", "bases", "offs", "groups", "bounds",
                "raw_bound", "const", "one_shoup")


def from_jax_class_boundary_plan(cp) -> ClassPlan:
    """The port's plan from a JAX ``class_boundary_plan`` result, read
    through its numpy and int fields; ``W`` becomes a list of numpy int8
    arrays."""
    f = {a: _copy(getattr(cp, a)) for a in CLASS_FIELDS}
    W = [np.array(w) for w in cp.W]
    if len(W) != f["Dout"] or any(
            w.dtype != np.int8 or w.shape[0] != din
            for w, din in zip(W, f["dins"])):
        raise ValueError(f"expected {f['Dout']} int8 tables of "
                         f"{f['dins']} planes, got "
                         f"{[(w.dtype, w.shape) for w in W]}")
    return ClassPlan(W=W, **f)


def rank_spectrum(spectrum, plans: SpPlans, d: int) -> np.ndarray:
    """Row d (1, nloc) of a device-major spectrum (n,) or (k, nloc), JAX's
    prepared (lazy) one among them: what the rank of model index d
    multiplies against on a mesh across ranks."""
    spec = np.asarray(spectrum)
    if spec.size != plans.n or not 0 <= d < plans.k:
        raise ValueError(f"expected n={plans.n} values and a shard in "
                         f"[0, {plans.k}), got {spec.shape} and {d}")
    return spec.reshape(plans.k, plans.nloc)[d:d + 1].copy()


def from_jax_fourstep_fold_tables(W, c):
    """JAX's per-constant (W, const) pair of ``fourstep_fold_tables`` as the
    port's numpy pair."""
    W, c = np.array(W), np.array(c)
    if W.dtype != np.int8 or W.ndim != 5 or c.dtype != np.uint32 or \
            c.shape != (*W.shape[:2], 1, W.shape[3]):
        raise ValueError(f"expected int8 (k, A, din, TW, Dout*TW) and uint32 "
                         f"(k, A, 1, TW), got {W.dtype} {W.shape} and "
                         f"{c.dtype} {c.shape}")
    return W, c
