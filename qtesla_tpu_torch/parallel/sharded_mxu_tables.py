"""Planner of the sequence-parallel (SP) digit-matmul polymul (numpy only).

Counterpart of the static half of ``qtesla_tpu/parallel/sharded_mxu.py``:
``_RollTables`` (l.89), ``_transform_matrix`` (l.119), ``_k1_position_map``
(l.132), ``_digit_plan`` (l.155) and ``fourstep_mxu_plans`` (l.229-410).  It
is a module of its own because the JAX module imports jax; this one computes
with numpy and Python ints, reusing the single-transform planner's helpers
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

``fourstep_mxu_plans(name, n1, k)`` plans from the port's registry;
``from_jax_fourstep_plans(plans)`` carries a JAX plan bundle's numpy and int
fields across (duck-typed: jax is never imported here).
``fourstep_fold_tables(plans, spectrum)`` (JAX l.586) builds one constant's
folded segment-2 tables under p2x, and ``from_jax_fourstep_fold_tables``
carries JAX's pair across.
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
from ..ops.mxu_tables import (_COST_CSUB, _COST_PLANE, _COST_PLANE_EXTRA,
                              _COST_SHOUP, _balanced_digits, _chain_csubs,
                              _const_row, _digit_bounds, _fwd_matrix,
                              _group_bias, _input_digit_maxima, _inv_matrix,
                              _lazy_fwd_schedule, _matrix_digit_block,
                              _ndigits, _plan_cost, _plan_groups,
                              _plane_count, _recombine_bound, _reduce_kind,
                              pointwise_bound)
from ..ops.ntt import _subtables
from ..ops.tables import NttTables, get_tables
from ..params import ParamSet
from .sharded import _fourstep_tables

__all__ = ["SpPlans", "DigitPlan", "FoldPlan", "ClassPlan", "RollTables",
           "CompactLayout", "compact_layout", "compact_tables",
           "expand_compact", "fourstep_mxu_plans", "from_jax_fourstep_plans",
           "fourstep_fold_tables", "rank_spectrum",
           "from_jax_fourstep_fold_tables",
           "class_boundary_plan", "from_jax_class_boundary_plan"]

_TW_MAX = 128


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
    split and recombination plan: ``W`` int8 (..., din, TW, Dout*TW),
    ``const`` uint32 (..., 1, TW); ``din`` planes of ``base`` centred at
    ``off`` cover inputs below 2*off (+1); class ``bounds`` and Horner
    ``groups``; ``raw_bound`` is the TPU kernel's recombination bound and
    ``store_bound`` what it stores (2q when ``needs_reduce``)."""


class FoldPlan(_Fields):
    """The worst-case plan of the folded segment 2 (p2x), shared by every
    constant: sized for any matrix entry mod q (``mw_wc``)."""


class SpPlans(_Fields):
    """Every schedule, block matrix and digit plan of one (set, n1, k)."""


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
    """(m, m) object matrix R with y = x @ R == stockham_{fwd,inv} on the
    last axis (n^{-1} included when inverse): the identity pushed through
    the port's own Stockham code in int64."""
    eye = torch.eye(sub_tbl.n, dtype=torch.int64)
    fn = N.stockham_inv if inverse else N.stockham_fwd
    return fn(eye, sub_tbl).numpy().astype(object)


def _k1_position_map(sub_tbl: NttTables) -> np.ndarray:
    """pos -> k1: the cyclic output index the merged-psi forward emits at
    each position (out[pos] = sum_j psi1^j omega1^(j k1) x[j]), read off
    the exact stage matrix and checked against a second column."""
    q, n1 = sub_tbl.q, sub_tbl.n
    psi1, om1 = int(sub_tbl.ps.psi), int(sub_tbl.ps.omega)
    F1 = _fwd_matrix(sub_tbl, 0)
    dlog = {}
    v = psi1 % q
    for t in range(n1):
        dlog[v] = t
        v = (v * om1) % q
    k1map = np.array([dlog[int(F1[p, 1]) % q] for p in range(n1)],
                     dtype=np.int64)
    if n1 > 2:
        psi2 = psi1 * psi1 % q
        for p in range(n1):
            want = psi2 * pow(om1, 2 * int(k1map[p]), q) % q
            assert int(F1[p, 2]) % q == want, "k1 map inconsistent"
    return k1map


def _digit_plan(Ms: np.ndarray, q: int, one_shoup: int, in_bound: int,
                downstream: str = "any", reduce_uncoverable: bool = True,
                bases: tuple = (256, 128)) -> DigitPlan:
    """One shared plan for the stack Ms (..., TW, TW): the cheapest split
    over ``bases`` at each base's fewest covering planes, costed like the
    single-transform planner plus ``_COST_PLANE_EXTRA`` for every plane
    beyond the fewest of any base; bounds worst-case over the stack."""
    bw = Ms.shape[-1]
    lead = Ms.shape[:-2]
    Dout = _ndigits(q)
    off = in_bound >> 1
    indices = list(np.ndindex(*lead)) if lead else [()]
    din_min = min((d for d in (_plane_count(in_bound, b) for b in bases)
                   if d is not None), default=None)
    if din_min is None:
        raise ValueError(f"lazy bound {in_bound} uncoverable at any base")
    best = None
    for base in bases:
        din = _plane_count(in_bound, base)
        if din is None:
            continue
        W = np.zeros(lead + (din, bw, Dout * bw), dtype=np.int8)
        colsums = np.zeros(lead + (bw,), dtype=object)
        mw = np.zeros((din, Dout), dtype=np.int64)
        for idx in indices:
            W[idx], colsums[idx] = _matrix_digit_block(Ms[idx], q, din, Dout,
                                                       mw, in_base=base)
        bounds = _digit_bounds(
            mw, bw, _input_digit_maxima(din, off, in_bound, base))
        try:
            groups = _plan_groups(bounds, q, downstream)
        except ValueError:
            continue
        (sh, cs, ng), _ = _plan_cost(groups, bounds, q, downstream)
        cost = (_COST_SHOUP * sh + _COST_CSUB * cs
                + (_COST_PLANE + Dout) * din
                + _COST_PLANE_EXTRA * (din - din_min), ng)
        if best is None or cost < best[0]:
            best = (cost, base, din, W, colsums, bounds, groups)
    if best is None:
        raise ValueError(f"lazy bound {in_bound} uncoverable at any base")
    _, base, din, W, colsums, bounds, groups = best
    const = np.zeros(lead + (1, bw), dtype=np.uint32)
    for idx in indices:
        const[idx + (0,)] = _const_row(colsums[idx], off, groups, bounds, q)
    raw_bound = _recombine_bound(groups, bounds, q)
    needs_reduce = reduce_uncoverable and _plane_count(raw_bound) is None
    return DigitPlan(
        W=W, const=const, groups=groups, bounds=bounds, bw=bw, din=din,
        off=off, base=base, q=q, one_shoup=one_shoup, raw_bound=raw_bound,
        needs_reduce=needs_reduce,
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
            f"larger n1")
    n2k, n1k = n2 // k, n1 // k
    nloc = n1 * n2k
    TW = min(_TW_MAX, nloc)
    A = nloc // TW
    return dict(n=n, n1=n1, n2=n2, k=k, n1k=n1k, n2k=n2k, nloc=nloc, TW=TW,
                A=A, Bk=TW // n2k, Lr=A.bit_length() - 1)


@functools.lru_cache(maxsize=None)
def fourstep_mxu_plans(name: str, n1: int, k: int) -> SpPlans:
    """All wide-stage schedules, block matrices and digit plans of one
    (parameter set, n1, model axis k)."""
    tbl = get_tables(name)
    n, q = tbl.n, tbl.q
    g = _shape(n, n1, k)
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
    phi_lane = tbl.phi.astype(object)
    ipsi_lane = tbl.ipsi_pow.astype(object)
    W = T["W"].astype(object)
    Winv = T["Winv"].astype(object)
    k1map = _k1_position_map(t1)
    Mf = _fwd_matrix(t1, Lr)
    Mi = _inv_matrix(t1, L1 - Lr)
    R2 = _transform_matrix(t2, inverse=False)
    R2i = _transform_matrix(t2, inverse=True)

    # segments 1 and 3: per-(shard, tile) TW x TW input-major matrices, in-
    # tile index (j1 within the tile b) * n2k + lane
    for t in range(A):
        for M, tag in ((Mf, "fwd"), (Mi, "inv")):
            row = M[t * Bk:(t + 1) * Bk].copy()
            row[:, t * Bk:(t + 1) * Bk] = 0
            assert not row.any(), f"{tag} in-tile stages not tile-local"
    K1 = np.zeros((k, A, TW, TW), dtype=object)
    K3 = np.zeros((k, A, TW, TW), dtype=object)
    for d in range(k):
        for t in range(A):
            for c in range(Bk):
                p = t * Bk + c
                k1 = int(k1map[p])
                for b in range(Bk):
                    mf = int(Mf[p, t * Bk + b]) % q
                    mi = int(Mi[p, t * Bk + b]) % q
                    for lam in range(n2k):
                        j2g = d * n2k + lam
                        i, o = b * n2k + lam, c * n2k + lam
                        if mf:
                            K1[d, t, i, o] = (int(phi_lane[j2g]) * mf % q
                                              * int(W[k1, j2g])) % q
                        if mi:
                            K3[d, t, i, o] = mi * int(ipsi_lane[j2g]) % q

    # segment 2: R = TW/n2 rows of n2 lanes a tile
    R = TW // n2
    K2f = np.zeros((TW, TW), dtype=object)
    for rho in range(R):
        sl = slice(rho * n2, (rho + 1) * n2)
        K2f[sl, sl] = R2 % q
    K2i = np.zeros((k, A, TW, TW), dtype=object)
    for d in range(k):
        for bb in range(A):
            for rho in range(R):
                p = d * n1k + bb * R + rho
                sl = slice(rho * n2, (rho + 1) * n2)
                K2i[d, bb, sl, sl] = (R2i * Winv[int(k1map[p])][None, :]) % q

    pw_bound = pointwise_bound(q)
    # seg-1 forward split: lazy against the canonical chain-then-split
    candidates = []
    if rolls.lazy_coverable and rolls.lazy_bound > q:
        candidates.append((True, _digit_plan(K1, q, one_shoup,
                                             in_bound=rolls.lazy_bound), 0))
    candidates.append((False, _digit_plan(K1, q, one_shoup, in_bound=q),
                       _chain_csubs(rolls.lazy_bound, q, q)))
    din_floor = min(c[1].din for c in candidates)

    def p1_cost(p, extra_cs):
        (sh, cs, ng), _ = _plan_cost(p.groups, p.bounds, q, "any")
        return (_COST_SHOUP * sh + _COST_CSUB * (cs + extra_cs)
                + (_COST_PLANE + _ndigits(q)) * p.din
                + _COST_PLANE_EXTRA * (p.din - din_floor), ng)

    lazy_pick, p1, _ = min(candidates, key=lambda c: p1_cost(c[1], c[2]))
    rolls.set_fwd(lazy_pick)
    p2f = _digit_plan(K2f, q, one_shoup, in_bound=p1.store_bound,
                      reduce_uncoverable=False)
    p2i = _digit_plan(K2i, q, one_shoup, in_bound=pw_bound)
    p3 = _digit_plan(K3, q, one_shoup, in_bound=p2i.store_bound,
                     downstream=_reduce_kind(q), reduce_uncoverable=False)
    p2x = _fold_plan(p1, q, n2, TW, one_shoup)
    p3x = _digit_plan(K3, q, one_shoup, in_bound=p2x.store_bound,
                      downstream=_reduce_kind(q), reduce_uncoverable=False)
    return SpPlans(name=name, q=q, ps=tbl.ps, t1=t1, rolls=rolls,
                   pw_bound=pw_bound, k1map=k1map, p1=p1, p2f=p2f, p2i=p2i,
                   p3=p3, p2x=p2x, p3x=p3x, K1=K1, K2f=K2f, K2i=K2i, **g)


# ----------------------------------------------------------------------
# Folded segment 2 of one constant.
# ----------------------------------------------------------------------

def _diagonal_blocks(M: np.ndarray, n2: int) -> np.ndarray:
    """(..., TW, TW) -> its R = TW/n2 diagonal (n2, n2) blocks, (..., R, n2,
    n2)."""
    R = M.shape[-1] // n2
    M = M.reshape(*M.shape[:-2], R, n2, R, n2)
    return np.stack([M[..., r, :, r, :] for r in range(R)], axis=-3)


@functools.lru_cache(maxsize=None)
def _fold_blocks(plans: SpPlans) -> tuple[np.ndarray, np.ndarray]:
    """K2f's diagonal blocks (R, n2, n2) and K2i's (k, A, R, n2, n2), reduced
    mod q in int64, made once per plan bundle."""
    q, n2 = plans.q, plans.n2
    return tuple((_diagonal_blocks(M, n2) % q).astype(np.int64)
                 for M in (plans.K2f, plans.K2i))


def _matmul_mod(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """a @ b mod q for int64 entries below q < 2^30 and an inner axis of at
    most 2^7: a in 15-bit halves, so no partial sum passes 2^52."""
    lo = np.matmul(a & 0x7FFF, b) % q
    hi = np.matmul(a >> 15, b) % q
    return (lo + (hi << 15)) % q


def fourstep_fold_tables(plans: SpPlans, spectrum, first: int | None = None):
    """One constant's folded segment-2 tables under p2x, bit for bit JAX's
    ``fourstep_fold_tables`` (l.586): per (shard d, tile t) the matrix
    F = K2f diag(A^[d, t]) K2i[d, t], block-diagonal over n2-blocks, as
    ``W`` int8 (k, A, din, TW, Dout*TW) and ``const`` uint32 (k, A, 1, TW).

    ``spectrum`` is the constant's device-major SP spectrum, (n,) or (k,
    nloc) uint32, canonical or lazy (it is taken mod q); with ``first`` it
    is the rows (S, nloc) of shards first..first+S-1 alone (a rank's own),
    and the tables are those shards', (S, ...).  F is built in int64 from
    the blocks cached per plan bundle, where JAX uses Python ints."""
    p = plans.p2x
    q, TW, A, k, n2 = plans.q, plans.TW, plans.A, plans.k, plans.n2
    R = TW // n2
    spec = np.asarray(spectrum)
    k2f, k2i = _fold_blocks(plans)
    if first is None:
        if spec.size != plans.n:
            raise ValueError(f"spectrum must hold n={plans.n} values, got "
                             f"{spec.shape}")
    else:
        if (spec.ndim != 2 or spec.shape[1] != plans.nloc or first < 0
                or first + spec.shape[0] > k):
            raise ValueError(f"rows of shards {first}.. must be (S, "
                             f"{plans.nloc}) within the model axis of {k}, "
                             f"got {spec.shape}")
        k, k2i = spec.shape[0], k2i[first:first + spec.shape[0]]
    dg = (spec.astype(np.int64) % q).reshape(k, A, R, 1, n2)
    # K2f's columns scaled by the diagonal, then through K2i
    blocks = _matmul_mod(k2f * dg % q, k2i, q)       # (k, A, R, n2, n2)
    F = np.zeros((k, A, TW, TW), dtype=np.int64)
    for r in range(R):
        F[:, :, r * n2:(r + 1) * n2, r * n2:(r + 1) * n2] = blocks[:, :, r]
    W = np.empty((k, A, p.din, TW, p.Dout * TW), dtype=np.int8)
    mw = np.zeros((p.din, p.Dout), dtype=np.int64)
    for i in range(p.din):
        Fi = F * pow(p.base, i, q) % q
        Fc = np.where(Fi > q // 2, Fi - q, Fi)
        for jd, dig in enumerate(_balanced_digits(Fc, p.Dout)):
            W[:, :, i, :, jd * TW:(jd + 1) * TW] = dig
            mw[i, jd] = np.abs(dig).max()
    # plan soundness: the digits sit inside the worst case p2x covers
    assert (mw <= p.mw_wc).all(), \
        "folded-matrix digits exceed the worst-case SP plan"
    colsum = F.sum(axis=-2) % q
    const = ((p.off % q) * colsum - _group_bias(p.groups, p.bounds, q)) % q
    return W, const.astype(np.uint32).reshape(k, A, 1, TW)


# ----------------------------------------------------------------------
# The class-sum boundary.
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def class_boundary_plan(name: str, n1: int, k: int) -> ClassPlan:
    """The class-sum boundary's plan of one (set, n1, k), field for field
    JAX's ``class_boundary_plan`` (l.902).  It is built for every set; the
    kernels' limits (at most 3 classes, class bounds below 2^24) are checked
    where a kernel is planned (``sharded_classes.plan_for``)."""
    plans = fourstep_mxu_plans(name, n1, k)
    q, TW = plans.q, plans.TW
    Dout = _ndigits(q)
    cls_b = [int(b) for b in plans.p1.bounds]
    K2f = plans.K2f % q
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
        mw =np.zeros((din, Dout), dtype=np.int64)
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


def _class_const(plans: SpPlans, group_bias: int) -> np.ndarray:
    """The consumer's const rows (k, A, 1, TW): seg1's centring term
    off1 * colsum(K1[d, t]) of every producer lane, moved to its row position
    after the forward exchange, through K2f, less ``group_bias``; int64 where
    JAX uses Python ints."""
    q, k, A, TW = plans.q, plans.k, plans.A, plans.TW
    n2, n2k, n1k, Bk = plans.n2, plans.n2k, plans.n1k, plans.Bk
    colsum = plans.K1.astype(np.int64).sum(axis=-2) % q        # (k, A, TW)
    cs1 = (plans.p1.off % q) * colsum % q
    # row position rho * n2 + j2 of consumer tile (dc, bb) holds source j1 =
    # dc * n1k + bb * R + rho, lane j2 of producer shard j2 // n2k
    R = TW // n2
    j1 = (np.arange(k)[:, None, None, None] * n1k
          + np.arange(A)[None, :, None, None] * R
          + np.arange(R)[None, None, :, None])
    j2 = np.arange(n2)[None, None, None, :]
    vec = cs1[j2 // n2k, j1 // Bk, (j1 % Bk) * n2k + j2 % n2k]
    row = _matmul_mod(vec.reshape(k, A, TW),
                      (plans.K2f % q).astype(np.int64), q)
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


def compact_layout(plans: SpPlans, kind: str) -> CompactLayout:
    """The block structure of one kind of tile matrix, from the plan's
    shapes alone (``compact_tables`` checks it against the entries).

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
    digit = {p: DigitPlan(**{a: _copy(getattr(getattr(plans, p), a))
                             for a in DIGIT_FIELDS})
             for p in ("p1", "p2f", "p2i", "p3", "p3x")}
    p2x = FoldPlan(**{a: _copy(getattr(plans.p2x, a)) for a in FOLD_FIELDS})
    ps = ParamSet(name=f["name"], n=f["n"], q=q)
    return SpPlans(ps=ps, t1=t1, rolls=rolls, p2x=p2x, **digit, **f)


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
