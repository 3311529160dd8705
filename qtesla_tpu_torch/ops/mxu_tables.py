"""Digit-matmul stage tables for the MXU path (host only: numpy, and torch
on the host's threads for the elementwise reductions).

Counterpart of the static planner of ``qtesla_tpu/ops/ntt_mxu.py``
(l.66-565) and of its ``pointwise_bound`` (l.813).  It is a module of its own
because ``qtesla_tpu.ops.ntt_mxu`` imports jax; this one computes with numpy
and Python ints only.  The tests hold every table and plan field equal to the
JAX planner's.

The MXU form of a transform: the first ``Lr = log2(n / bw)`` forward stages
(pair distance >= bw) stay butterflies; the remaining stages act inside each
aligned block of ``bw`` lanes, so their composition is one exact (bw, bw)
matrix per block.  Each matrix is expanded into balanced base-256 int8 digit
classes (``W``), and the operand into ``Din`` balanced digit planes centred
at ``off``.  One block's output is

    out_k = const_k + sum_j 2^{8j} c_jk   (mod q),
    c_j   = sum_i plane_i(x - off) @ W[b, i][:, j*bw:(j+1)*bw],

where ``const`` folds the centring offset and subtracts ``group_bias``, the
biases the TPU kernel adds to its Horner-packed class groups.  A
recombination that does not bias its groups adds ``group_bias`` back.

``stream_tables(mt)`` lays the forward and inverse tables out as the
stages B5's kernel copies into shared memory one by one (``expand_stream``
is its inverse).  ``lane_packed(mt)`` is ``mt`` as that kernel runs it:
a lane block narrower than the MMA's 32-deep step (n <= 16) packed 32 / n
rows to a row of 32 lanes, its tables block diagonal.

The planner works a lane block at a time: the block-local stages pair
lanes of one block only, so each direction's (bw, bw) diagonal blocks are
built on their own (``_fwd_blocks``, ``_inv_blocks``, O(bw) a lane, in
int64 numpy over chunks of blocks), the digit maxima that every candidate
split's bounds come from are taken in one pass over them, and only the
chosen split's tables are built; JAX's planner (``qtesla_tpu/ops/
ntt_mxu.py:91``, ``:106``) builds the dense (n, n) matrices, 8.6 GB each at
n = 32768.  The results are equal field by field.  A plan whose tables
would pass ``MAX_TABLE_BYTES`` raises before anything is built
(``check_table_bytes``: n = 2^25 would need 128 GiB).

``get_mxu_tables(name)`` plans from the port's registry;
``from_jax_mxu_tables(mt)`` carries a JAX ``MxuTables``'s numpy fields across.

The folded fixed-operand form (``fixed_fold_plan``, ``fixed_fold_tables``,
counterparts of ``qtesla_tpu/ops/ntt_mxu.py:1078-1190``) scales the columns
of the inverse block matrices by a constant's spectrum, M' = M_inv diag(A),
so a product with that constant needs no pointwise stage.  One plan, sized
for any matrix entry mod q, serves every constant; the tables are built from
the (bw, bw) diagonal blocks alone, never from the (n, n) matrix.
"""

from __future__ import annotations

import contextlib
import copy
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .modmul import sparse_reduce_plan
from ..params import get_params
from .tables import NttTables, from_jax_tables, get_tables

__all__ = ["MxuTables", "get_mxu_tables", "from_jax_mxu_tables",
           "MAX_TABLE_BYTES", "table_bytes", "check_table_bytes",
           "pointwise_bound", "FixedFoldPlan", "fold_plan", "fixed_fold_plan",
           "fold_tables", "fixed_fold_tables", "from_jax_fold_plan",
           "from_jax_fold_tables", "STAGE_DEPTH", "stream_stages",
           "stream_tables", "expand_stream", "MMA_K", "lane_packed",
           "block_diagonal"]

_BW_MAX = 128            # block width: one TPU vreg of lanes

# relative VPU-op costs of the TPU kernel that the split search minimises
# (a sloppy Shoup, a conditional subtract, an extra input digit plane)
_COST_SHOUP, _COST_CSUB, _COST_PLANE = 4, 2, 3
# the penalty per digit plane beyond the fewest that cover an input, in the
# sequence-parallel segment kernels, whose products no wide stages hide
# (parallel/sharded_mxu_tables.py); the single-transform planner above
# charges none
_COST_PLANE_EXTRA = 4


# ----------------------------------------------------------------------
# Digits and stage matrices (exact, numpy int64 / object mod q).
# ----------------------------------------------------------------------

def _ndigits(q: int) -> int:
    """Smallest D such that D balanced base-256 digits (each in [-128, 127])
    cover the centred range [-(q//2), q-1-q//2]."""
    D = 1
    while True:
        span = (256 ** D - 1) // 255
        if 127 * span >= q - 1 - (q // 2) and 128 * span >= q // 2:
            return D
        D += 1


def _balanced_digits(a: np.ndarray, D: int) -> list[np.ndarray]:
    """D balanced base-256 digits of an int64 array, each in [-128, 127];
    sum_i 256^i d_i == a exactly."""
    digs = []
    a = a.astype(np.int64).copy()
    for _ in range(D - 1):
        d = ((a + 128) & 255) - 128
        digs.append(d)
        a = (a - d) >> 8
    assert np.all(a >= -128) and np.all(a <= 127), "digit overflow"
    digs.append(a)
    return digs


def _fwd_matrix(tbl: NttTables, s_lo: int) -> np.ndarray:
    """Exact (n, n) matrix of the merged-psi CT forward stages s in
    [s_lo, L), canonical mod q."""
    n, q, L = tbl.n, tbl.q, tbl.logn
    j = np.arange(n)
    M = np.eye(n, dtype=np.int64)
    for s in range(s_lo, L):
        t = n >> (s + 1)
        w = tbl.ct_fwd_full[s].astype(np.int64)
        sign = np.where((j & t) != 0, -1, 1)
        M = (M[j & ~t] + (sign * w)[:, None] * M[j | t]) % q
    return M % q


def _inv_matrix(tbl: NttTables, s_hi: int) -> np.ndarray:
    """Exact (n, n) matrix of the merged-psi GS inverse stages s in
    [0, s_hi) mod q; the last stage, if included, scales both branches by
    gs_inv_full's n^{-1} row."""
    n, q, L = tbl.n, tbl.q, tbl.logn
    j = np.arange(n)
    M = np.eye(n, dtype=np.int64)
    for s in range(s_hi):
        t = 1 << s
        w = tbl.gs_inv_full[s].astype(np.int64)
        u = M[j & ~t]
        v = M[j | t]
        bit = (j & t) != 0
        if s == L - 1:
            sign = np.where(bit, -1, 1)
            M = (w[:, None] * (u + sign[:, None] * v)) % q
        else:
            M = np.where(bit[:, None], (w[:, None] * (u - v)) % q,
                         (u + v) % q)
    return M % q


# ----------------------------------------------------------------------
# The TPU kernel's recombination cost model (the JAX helpers' static,
# v=None, mode: bounds and op counts only).
# ----------------------------------------------------------------------

def _csub_to(bnd: int, limit: int, q: int):
    """The TPU kernel's conditional-subtract chain v < bnd -> v < limit (a
    multiple of q), halving the bound per step: (bound', csub count)."""
    cs = 0
    while bnd > limit:
        t = max(((bnd - 1) // q).bit_length() - 1,
                (limit // q).bit_length() - 1)
        c = (1 << t) * q
        cs += 1
        bnd = max(c, bnd - c)
    return bnd, cs


def _chain_csubs(bnd: int, limit: int, q: int) -> int:
    return _csub_to(bnd, limit, q)[1]


def _apply_shrink(m: int, limit_m: int, q: int):
    """Shrink one lazy term of inclusive maximum m to <= limit_m: a Shoup
    fold by 1 when m is huge, else a csub chain.  (m', shoups, csubs)."""
    sh = cs = 0
    if m > 16 * q:
        m = 4 * q - 1
        sh = 1
    while m > limit_m:
        t = max((m // q).bit_length() - 1,
                ((limit_m + 1) // q).bit_length() - 1)
        c = (1 << t) * q
        cs += 1
        m = max(c - 1, m - c)
    return m, sh, cs


def _pack_terms(maxima, q: int):
    """The overflow fixer for the recombination term sum: while the
    inclusive maxima could sum past uint32, shrink the largest term
    (earliest on ties) one step (2q-1, then q-1).  (maxima, shoups,
    csubs)."""
    maxima = list(maxima)
    sh = cs = 0
    while sum(maxima) >= 1 << 32:
        k = max(range(len(maxima)), key=lambda i: (maxima[i], -i))
        assert maxima[k] > q - 1, "recombination terms cannot fit uint32"
        limit = 2 * q - 1 if maxima[k] > 2 * q - 1 else q - 1
        maxima[k], s1, c1 = _apply_shrink(maxima[k], limit, q)
        sh += s1
        cs += c1
    return maxima, sh, cs


def _group_bound(bounds, j0, ln) -> int:
    return sum((256 ** m) * bounds[j0 + m] for m in range(ln))


def _initial_terms(groups, bounds, q: int) -> list[int]:
    """Inclusive maxima of the recombination terms before the fixer: the
    const row, then per group the biased Horner value (group 0) or the
    post-Shoup 2q-1."""
    terms = [q - 1]
    for j0, ln in groups:
        terms.append(2 * _group_bound(bounds, j0, ln) if j0 == 0
                     else 2 * q - 1)
    return terms


def _reduce_kind(q: int) -> str:
    return "reduce_sparse" if sparse_reduce_plan(q) else "reduce_shoup"


def _plan_cost(groups, bounds, q: int, downstream: str):
    """((shoups, csubs, ngroups), exclusive output bound) of one plan."""
    sh = sum(1 for j0, _ in groups if j0 != 0)
    cs = sh
    terms, s2, c2 = _pack_terms(_initial_terms(groups, bounds, q), q)
    sh += s2
    cs += c2
    bound = sum(terms) + 1
    if downstream != "any" and bound > 2 * q:
        if bound <= 16 * q:
            cs += _chain_csubs(bound, 2 * q, q)
        elif downstream == "reduce_shoup":
            sh += 1
            cs += 1
        else:
            cs += 3
    return (sh, cs, len(groups)), bound


def _plan_groups(bounds: list[int], q: int,
                 downstream: str = "any") -> list[tuple[int, int]]:
    """The cheapest packing of digit classes into consecutive int32-exact
    Horner groups [(j0, len), ...], over every feasible composition."""
    D = len(bounds)

    def compositions(j):
        if j == D:
            yield []
            return
        for ln in range(1, D - j + 1):
            if _group_bound(bounds, j, ln) < (1 << 31):
                for rest in compositions(j + ln):
                    yield [(j, ln)] + rest

    def feasible(g):
        return sum(min(t, q - 1)
                   for t in _initial_terms(g, bounds, q)) < 1 << 32

    cands = [g for g in compositions(0) if feasible(g)]
    if not cands:
        raise ValueError(
            f"q={q}: recombination terms cannot fit uint32 for any digit "
            f"grouping of bounds {bounds}")
    return min(cands,
               key=lambda g: _plan_cost(g, bounds, q, downstream)[0])


def _recombine_bound(groups, bounds, q: int) -> int:
    """Exclusive output bound of the TPU kernel's recombination (what a
    consumer's digit split must cover)."""
    return sum(_pack_terms(_initial_terms(groups, bounds, q), q)[0]) + 1


# ----------------------------------------------------------------------
# Digit splits and tables.
# ----------------------------------------------------------------------

def _split_bias(D: int, base: int) -> int:
    """Borrow-propagation pre-bias of a D-plane balanced base-`base` split:
    (base/2)*base^i summed over the D-1 low planes."""
    lb = base.bit_length() - 1
    return sum((base // 2) << (lb * i) for i in range(D - 1))


def _covers(D: int, bound: int, base: int = 256) -> bool:
    """Do D balanced base-`base` planes (top plane the arithmetic-shift
    residue, which must fit int8) represent every v - off, v in
    [0, bound), off = bound // 2, within a 32-bit word?"""
    off = bound >> 1
    lb = base.bit_length() - 1
    bias = _split_bias(D, base)
    s = lb * (D - 1)
    if s > 28 or bound - 1 - off + bias >= 1 << 31:
        return False
    top_min = (-off + bias) >> s
    top_max = (bound - 1 - off + bias) >> s
    return -128 <= top_min and top_max <= 127


def _plane_count(in_bound: int, base: int = 256) -> int | None:
    for D in range(1, 7):
        if _covers(D, in_bound, base):
            return D
    return None


def _lazy_fwd_schedule(q: int, Lr: int):
    """Per-wide-stage (lo_bnd, h_bnd) laziness schedule of the TPU kernel
    from canonical input; returns (schedule, final exclusive bound)."""
    bnd = q
    sched = []
    for _ in range(Lr):
        h_bnd = 4 * q
        lo_bnd = bnd
        if lo_bnd + h_bnd > 1 << 32:
            h_bnd = 2 * q
        if lo_bnd + h_bnd > 1 << 32:
            lo_bnd = 2 * q
        sched.append((lo_bnd, h_bnd))
        bnd = lo_bnd + h_bnd
    return sched, bnd


def _matrix_digit_block(K, q: int, Din: int, Dout: int, mw: np.ndarray,
                        in_base: int = 256):
    """One (bw, bw) input-major matrix K (out = x @ K) as int8 digit tables
    (Din, bw, Dout*bw) of the centred in_base^i * K mod q, plus its column
    sums; accumulates max |digit| into mw (Din, Dout)."""
    bw = K.shape[0]
    K = K.astype(object) % q
    Wblk = np.zeros((Din, bw, Dout * bw), dtype=np.int8)
    for i in range(Din):
        Ki = (K * pow(in_base, i, q)) % q
        Kc = np.where(Ki > q // 2, Ki - q, Ki)
        for jd, dig in enumerate(_balanced_digits(Kc.astype(np.int64),
                                                  Dout)):
            Wblk[i, :, jd * bw:(jd + 1) * bw] = dig.astype(np.int8)
            mw[i, jd] = max(mw[i, jd], np.abs(dig).max())
    return Wblk, K.sum(axis=0)


def _input_digit_maxima(Din: int, off: int, in_bound: int,
                        base: int = 256) -> list[int]:
    """Exact max |digit_i(v - off)| over v in [0, in_bound) per plane."""
    cmin, cmax = -off, in_bound - 1 - off
    lb = base.bit_length() - 1
    bias = _split_bias(Din, base)
    s = lb * (Din - 1)
    top = max(abs((cmin + bias) >> s), abs((cmax + bias) >> s))
    return [base // 2] * (Din - 1) + [int(top)]


def _digit_bounds(mw: np.ndarray, bw: int, dmax: list[int]):
    Din, Dout = mw.shape
    return [int(sum(bw * dmax[i] * mw[i, j] for i in range(Din)))
            for j in range(Dout)]


def _const_row(colsum, off: int, groups, bounds, q: int) -> np.ndarray:
    """Per-output const: the centring offset folded in, the group biases
    (group_bias) subtracted."""
    bias_sum = _group_bias(groups, bounds, q)
    return np.asarray([(off * int(cs) - bias_sum) % q for cs in colsum],
                      dtype=np.uint32)


def _group_bias(groups, bounds, q: int) -> int:
    """sum over groups of gb * 2^{8 j0} mod q, gb the group's Horner
    bound."""
    return sum(_group_bound(bounds, j0, ln) * pow(2, 8 * j0, q)
               for j0, ln in groups) % q


# lane blocks a vectorised step of the block planner takes: 2 MiB of one
# (bw, bw) int64 matrix a block at bw = 128, so that a step's temporaries
# stay in the host's caches
_PLAN_CHUNK = 16
# the most bytes of int8 digit tables (one direction's W and the other's,
# one copy) a plan may need: the planner holds them three times on the host
# (wf, wi and their stream) and the card once beside the operands
MAX_TABLE_BYTES = 1 << 34


def _chunks(nb: int):
    for b0 in range(0, nb, _PLAN_CHUNK):
        yield b0, min(nb, b0 + _PLAN_CHUNK)


def _shifted_t(K: torch.Tensor, mult: int, q: int, D: int) -> torch.Tensor:
    """u = centred(K * mult mod q) + split_bias(D), int32, K int64
    canonical: digit j < D - 1 of the balanced base-256 split is ((u >>
    8j) & 255) - 128 and the top one u >> 8(D - 1), as ``_balanced_digits``
    makes them.  K * mult mod q by Shoup's reduction with mult's companion
    floor(mult * 2^32 / q) (K times it stays below 2^63), no division, in
    torch on all the host's threads."""
    mult %= q
    r = K * mult - ((K * ((mult << 32) // q)) >> 32) * q
    r = torch.where(r >= q, r - q, r)
    return (r - torch.where(r > q // 2, q, 0)
            + _split_bias(D, 256)).to(torch.int32)


# values of planner work from which the host's threads take it (torch);
# below, one thread, so that the planners of a test's worker processes do
# not oversubscribe the host
_THREADED_ENTRIES = 1 << 22


@contextlib.contextmanager
def host_threads(entries: int):
    """torch's host threads for ``entries`` values of planner work: all of
    them from ``_THREADED_ENTRIES``, one below."""
    if entries >= _THREADED_ENTRIES:
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _shifted(K: np.ndarray, mult: int, q: int, D: int) -> np.ndarray:
    """``_shifted_t`` of an int64 numpy array, as numpy."""
    with host_threads(K.size):
        return _shifted_t(torch.from_numpy(
            np.ascontiguousarray(K, dtype=np.int64)), mult, q, D).numpy()


def _digit_t(u: torch.Tensor, j: int, D: int) -> torch.Tensor:
    """Digit j (int32) of the values whose shifted form is u."""
    return u >> 8 * j if j == D - 1 else ((u >> 8 * j) & 255) - 128


def _low_digit(u: np.ndarray, j: int) -> np.ndarray:
    return ((u >> (8 * j)).astype(np.uint8) ^ np.uint8(0x80)).view(np.int8)


def _top_range(u, D: int) -> tuple[int, int]:
    """(min, max) of the top digit; raises where it leaves int8."""
    lo, hi = int(u.min()) >> 8 * (D - 1), int(u.max()) >> 8 * (D - 1)
    assert -128 <= lo and hi <= 127, "digit overflow"
    return lo, hi


def _digit_maxima(u, D: int) -> list[int]:
    """Max |digit| per class of the values whose shifted form is u (numpy
    or torch)."""
    out = []
    for j in range(D - 1):
        if isinstance(u, np.ndarray):
            d = _low_digit(u, j)
            out.append(max(int(d.max()), -int(d.min())))
        else:
            out.append(int(_digit_t(u, j, D).abs().max()))
    lo, hi = _top_range(u, D)
    return out + [max(hi, -lo)]


def _store_digits(W: np.ndarray, u: np.ndarray, D: int, bw: int) -> None:
    """Digit j of u into W[..., j*bw:(j+1)*bw]."""
    _top_range(u, D)
    for j in range(D - 1):
        W[..., j * bw:(j + 1) * bw] = _low_digit(u, j)
    W[..., (D - 1) * bw:] = u >> 8 * (D - 1)


class _Direction:
    """One direction's block matrices (``blocks(b0, b1)``: input-major,
    canonical, (b1 - b0, bw, bw)), kept as int32, and the digit maxima of
    every plane its splits over ``in_bounds`` may take, both made in one
    pass over the blocks."""

    def __init__(self, blocks, nb: int, q: int, bw: int, in_bounds):
        self.nb, self.q, self.bw, self.D = nb, q, bw, _ndigits(q)
        planes = {base: max(_plane_count(b, base) or 0 for b in in_bounds)
                  for base in (256, 128)}
        self.mw = {base: np.zeros((k, self.D), dtype=np.int64)
                   for base, k in planes.items() if k}
        # no digit of a centred value mod q exceeds these: a plane whose
        # maxima reach them needs no further block
        cap = _digit_maxima(np.asarray([-(q // 2), q - 1 - q // 2])
                            + _split_bias(self.D, 256), self.D)
        self.K = np.empty((nb, bw, bw), dtype=np.int32)
        for b0, b1 in _chunks(nb):
            K = blocks(b0, b1)
            self.K[b0:b1] = K
            for base, mw in self.mw.items():
                for i in range(mw.shape[0]):
                    if (mw[i] < cap).any():
                        got = _digit_maxima(_shifted(K, pow(base, i, q), q,
                                                     self.D), self.D)
                        mw[i] = np.maximum(mw[i], got)

    def search(self, in_bound: int, downstream: str):
        """The cheapest input split over base 256 and base 128 at their
        smallest covering plane counts: (cost, (base, Din, bounds,
        groups)), or None when no base covers in_bound."""
        q, Dout = self.q, self.D
        best = None
        for base in (256, 128):
            Din = _plane_count(in_bound, base)
            if Din is None:
                continue
            bounds = _digit_bounds(self.mw[base][:Din], self.bw,
                                   _input_digit_maxima(Din, in_bound >> 1,
                                                       in_bound, base))
            groups = _plan_groups(bounds, q, downstream)
            (sh, cs, ng), _ = _plan_cost(groups, bounds, q, downstream)
            cost = (_COST_SHOUP * sh + _COST_CSUB * cs
                    + (_COST_PLANE + Dout) * Din, ng)
            if best is None or cost < best[0]:
                best = (cost, (base, Din, bounds, groups))
        return best

    def tables(self, pick, in_bound: int):
        """The split ``pick`` as digit tables: W int8 (nb, Din, bw, D*bw),
        plane i of input lane k, class j of output lane o at [b, i, k, j*bw
        + o] the digit j of the centred base^i * K_b[k, o] mod q, and const
        uint32 (nb, 1, bw): the centring offset folded in, the group biases
        subtracted.  (base, Din, W, const, bounds, groups)."""
        base, Din, bounds, groups = pick
        q, bw, D = self.q, self.bw, self.D
        W = np.empty((self.nb, Din, bw, D * bw), dtype=np.int8)
        const = np.empty((self.nb, 1, bw), dtype=np.uint32)
        bias = _group_bias(groups, bounds, q)
        off = (in_bound >> 1) % q
        for b0, b1 in _chunks(self.nb):
            K = self.K[b0:b1].astype(np.int64)
            for i in range(Din):
                _store_digits(W[b0:b1, i], _shifted(K, pow(base, i, q), q, D),
                              D, bw)
            const[b0:b1, 0] = (off * (K.sum(axis=1) % q) - bias) % q
        return base, Din, W, const, bounds, groups


def table_bytes(n: int, q: int, bw: int | None = None) -> int:
    """The fewest bytes of int8 digit tables (forward and inverse, one copy)
    a plan of (n, q) can need, from the plane counts alone: (Df + Di) * D *
    bw * n at the smallest plane counts that cover the forward's and the
    pointwise product's bounds.  Nothing is built."""
    bw = min(bw or _BW_MAX, n)
    Lr = n.bit_length() - bw.bit_length()
    _, bnd = _lazy_fwd_schedule(q, Lr)
    fewest = [min((c for b in bounds for base in (256, 128)
                   if (c := _plane_count(b, base)) is not None),
                  default=0)
              for bounds in ((bnd, q), (pointwise_bound(q),))]
    return sum(fewest) * _ndigits(q) * bw * n


def pointwise_bound(q: int) -> int:
    """Exclusive bound of the pointwise product handed to the inverse
    split: lazy (6q-1, or 4q-1 when 6q-2 overflows uint32) when that costs
    no extra digit plane, else q."""
    pw_lazy = 6 * q - 1 if 6 * q - 2 < 1 << 32 else 4 * q - 1
    return pw_lazy if _plane_count(pw_lazy) == _ndigits(q) else q


# ----------------------------------------------------------------------
# The bundle.
# ----------------------------------------------------------------------

# plan fields carried across from a JAX MxuTables
_FIELDS = ("n", "q", "logn", "bw", "nb", "Lr", "D", "fwd_sched", "fwd_lazy",
           "fwd_bound", "fwd_base", "Df", "wf", "constf", "bounds_f",
           "groups_f", "fwd_off", "pw_bound", "inv_off", "inv_base", "Di",
           "wi", "consti", "bounds_i", "groups_i")


class MxuTables:
    """Digit-matmul stage tables and plans for one parameter set.

    ``wf`` int8 (nb, Df, bw, D*bw) and ``constf`` uint32 (nb, 1, bw) map
    the forward split (``Df`` planes of base ``fwd_base``, centred at
    ``fwd_off``, input < ``fwd_bound``) through the block-local forward
    stages; ``wi``/``consti`` likewise the inverse (``Di`` planes of
    ``inv_base`` at ``inv_off``, input < ``pw_bound``).  ``group_bias_f``
    and ``group_bias_i`` are what ``const`` subtracts for the TPU kernel's
    biased Horner groups."""

    def __init__(self, tbl: NttTables, bw: int | None = None):
        self.tbl = tbl
        n, q, L = tbl.n, tbl.q, tbl.logn
        self.n, self.q, self.logn = n, q, L
        self.bw = bw = min(bw or _BW_MAX, n)
        assert bw >= 128 or bw == n, "block width must be >= one vreg"
        self.nb = n // bw
        self.Lr = L - bw.bit_length() + 1
        self.D = _ndigits(q)
        check_table_bytes(n, q, bw)
        self.fwd_sched, bnd = _lazy_fwd_schedule(q, self.Lr)
        s_hi = L - self.Lr
        fwd = _Direction(lambda b0, b1: np.swapaxes(
            _fwd_blocks(tbl, self.Lr, bw, b0, b1), 1, 2), self.nb, q, bw,
            (bnd, q))
        lazy = fwd.search(bnd, "any") if bnd > q else None
        canon = fwd.search(q, "any")
        ccost = (canon[0][0] + _COST_CSUB * _chain_csubs(bnd, q, q),
                 canon[0][1])
        self.fwd_lazy = lazy is not None and lazy[0] <= ccost
        self.fwd_bound = bnd if self.fwd_lazy else q
        (self.fwd_base, self.Df, self.wf, self.constf, self.bounds_f,
         self.groups_f) = fwd.tables((lazy if self.fwd_lazy else canon)[1],
                                     self.fwd_bound)
        self.fwd_off = self.fwd_bound >> 1
        self.pw_bound = pointwise_bound(q)
        self.inv_off = self.pw_bound >> 1
        inv = _Direction(lambda b0, b1: np.swapaxes(
            _inv_blocks(tbl, s_hi, bw, b0, b1), 1, 2), self.nb, q, bw,
            (self.pw_bound,))
        (self.inv_base, self.Di, self.wi, self.consti, self.bounds_i,
         self.groups_i) = inv.tables(inv.search(self.pw_bound,
                                                _reduce_kind(q))[1],
                                     self.pw_bound)
        self._derive()

    def _derive(self):
        q = self.q
        self.group_bias_f = _group_bias(self.groups_f, self.bounds_f, q)
        self.group_bias_i = _group_bias(self.groups_i, self.bounds_i, q)
        # the port's recombination sums the classes one by one in 64 bits
        # (plain twin) or adds a fixed 2^24 bias to each (CUDA kernel)
        if max(self.bounds_f + self.bounds_i) >= 1 << 24:
            raise ValueError(f"q={q}: a digit class sum may reach 2^24")


def check_table_bytes(n: int, q: int, bw: int | None = None) -> None:
    """Raise, naming the bytes and the limit, where a plan of (n, q) would
    need more than ``MAX_TABLE_BYTES`` of digit tables (``table_bytes``)."""
    need = table_bytes(n, q, bw)
    if need > MAX_TABLE_BYTES:
        raise ValueError(
            f"n={n}, q={q}: the MXU digit tables would take at least {need} "
            f"bytes ({need / 2**30:.1f} GiB), past the {MAX_TABLE_BYTES} "
            f"bytes ({MAX_TABLE_BYTES >> 30} GiB) the planner builds")


@functools.lru_cache(maxsize=None)
def get_mxu_tables(name: str, bw: int | None = None) -> MxuTables:
    """The plan of a registered set; past ``MAX_TABLE_BYTES`` it raises
    before any table (the NTT tables included) is built."""
    ps = get_params(name)
    check_table_bytes(ps.n, ps.q, bw)
    return MxuTables(get_tables(name), bw)


def from_jax_mxu_tables(mt) -> MxuTables:
    """The port's bundle from a ``qtesla_tpu.ops.ntt_mxu.MxuTables``, read
    through its numpy and int fields only (jax is never imported here)."""
    out = MxuTables.__new__(MxuTables)
    out.tbl = from_jax_tables(mt.tbl)
    for f in _FIELDS:
        v = getattr(mt, f)
        setattr(out, f, v.copy() if isinstance(v, np.ndarray) else v)
    out._derive()
    return out


# ----------------------------------------------------------------------
# Fixed-operand folding: the constant's pointwise diagonal inside the
# inverse block matrices.
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class FixedFoldPlan:
    """The digit and recombination plan of the folded inverse, shared by
    every constant of one parameter set: ``Din`` planes of base ``base``
    centred at ``off`` over inputs below ``in_bound``, ``Dout`` classes
    with ``bounds`` and Horner ``groups``.  ``canon`` says the TPU kernel
    reduces the forward output (below ``fwd_out``) before the split;
    ``mw_wc`` is the worst-case |digit| per class the plan was sized for."""

    base: int
    Din: int
    Dout: int
    groups: tuple
    bounds: tuple
    off: int
    in_bound: int
    fwd_out: int
    canon: bool
    mw_wc: tuple
    out_bound: int


_FOLD_FIELDS = tuple(FixedFoldPlan.__dataclass_fields__)


@functools.lru_cache(maxsize=None)
def fold_plan(mt: MxuTables) -> FixedFoldPlan:
    """The cheapest fold plan for ``mt``, costed as the TPU kernel's: split
    the lazy forward output as it is (LAZY), or reduce it to canonical
    first (CANON), at base 256 or 128."""
    q, bw = mt.q, mt.bw
    Dout = _ndigits(q)
    down = _reduce_kind(q)
    fwd_out = _recombine_bound(mt.groups_f, mt.bounds_f, q)
    # worst-case |digit| per class of any centred entry mod q, the same for
    # every input plane
    wcm = _input_digit_maxima(Dout, q >> 1, q, 256)
    best = None
    for in_bound, canon in ((fwd_out, False), (q, True)):
        for base in (256, 128):
            Din = _plane_count(in_bound, base)
            if Din is None:
                continue
            mw = np.tile(np.asarray(wcm, np.int64), (Din, 1))
            bounds = _digit_bounds(
                mw, bw, _input_digit_maxima(Din, in_bound >> 1, in_bound,
                                            base))
            try:
                groups = _plan_groups(bounds, q, down)
            except ValueError:
                continue
            (sh, cs, ng), _ = _plan_cost(groups, bounds, q, down)
            cost = (_COST_SHOUP * sh + _COST_CSUB * cs
                    + (_COST_PLANE + Dout) * Din)
            if canon:
                # the TPU kernel's reduction of the forward output to q
                if fwd_out <= 2 * q:
                    cost += _COST_CSUB
                elif fwd_out <= 16 * q:
                    cost += _COST_CSUB * (_chain_csubs(fwd_out, 2 * q, q) + 1)
                elif down == "reduce_sparse":
                    cost += 4 * _COST_CSUB
                else:
                    cost += _COST_SHOUP + 2 * _COST_CSUB
            key = (cost, ng)
            if best is None or key < best[0]:
                best = (key, FixedFoldPlan(
                    base=base, Din=Din, Dout=Dout, groups=tuple(groups),
                    bounds=tuple(bounds), off=in_bound >> 1,
                    in_bound=in_bound, fwd_out=fwd_out, canon=canon,
                    mw_wc=tuple(wcm),
                    out_bound=_recombine_bound(groups, bounds, q)))
    if best is None:
        raise ValueError(f"{mt.tbl.ps.name}: no digit split covers the "
                         f"fixed-fold input bounds")
    return best[1]


def fixed_fold_plan(name: str, bw: int | None = None) -> FixedFoldPlan:
    return fold_plan(get_mxu_tables(name, bw))


def _fwd_blocks(tbl: NttTables, s_lo: int, bw: int, b0: int = 0,
                b1: int | None = None) -> np.ndarray:
    """Diagonal blocks b0 .. b1 - 1 (all unless given) of
    ``_fwd_matrix(tbl, s_lo)``, (b1 - b0, bw, bw) output-major: every
    stage from s_lo pairs lanes of one block of bw, so each block is built
    on its own, O(bw) a lane."""
    n, q, L = tbl.n, tbl.q, tbl.logn
    if n >> s_lo > bw:
        raise ValueError(f"stages from {s_lo} are not local to {bw} lanes")
    b1 = n // bw if b1 is None else b1
    c = b1 - b0
    M = np.tile(np.eye(bw, dtype=np.int64), (c, 1, 1))
    for s in range(s_lo, L):
        # rows j (bit t clear) and j | t: lo + w_j hi, lo - w_{j|t} hi
        t = n >> (s + 1)
        w = tbl.ct_fwd_full[s][b0 * bw:b1 * bw].astype(np.int64).reshape(
            c, bw // (2 * t), 2, t, 1)
        V = M.reshape(c, bw // (2 * t), 2, t, bw)
        lo, hi = V[:, :, 0], V[:, :, 1]
        M = np.stack([(lo + w[:, :, 0] * hi) % q, (lo - w[:, :, 1] * hi) % q],
                     axis=2).reshape(c, bw, bw)
    return M


def _inv_blocks(tbl: NttTables, s_hi: int, bw: int, b0: int = 0,
                b1: int | None = None) -> np.ndarray:
    """Diagonal blocks b0 .. b1 - 1 (all unless given) of
    ``_inv_matrix(tbl, s_hi)``, (b1 - b0, bw, bw): every stage below s_hi
    pairs lanes of one block, so each block is built on its own."""
    n, q, L = tbl.n, tbl.q, tbl.logn
    if 1 << s_hi > bw:
        raise ValueError(f"stages below {s_hi} are not local to {bw} lanes")
    b1 = n // bw if b1 is None else b1
    c = b1 - b0
    M = np.tile(np.eye(bw, dtype=np.int64), (c, 1, 1))
    for s in range(s_hi):
        # rows j (bit t clear) and j | t from u = M[j], v = M[j | t]: u + v
        # and w_{j|t} (u - v); the last stage w_j (u + v) and w_{j|t} (u - v)
        t = 1 << s
        w = tbl.gs_inv_full[s][b0 * bw:b1 * bw].astype(np.int64).reshape(
            c, bw // (2 * t), 2, t, 1)
        V = M.reshape(c, bw // (2 * t), 2, t, bw)
        u, v = V[:, :, 0], V[:, :, 1]
        top = (u + v) * w[:, :, 0] if s == L - 1 else u + v
        M = np.stack([top % q, (w[:, :, 1] * (u - v)) % q],
                     axis=2).reshape(c, bw, bw)
    return M


def fold_tables(mt: MxuTables, fp: FixedFoldPlan, spectrum):
    """The folded inverse tables of one constant under ``fp``: ``W`` int8
    (nb, Din, bw, Dout*bw) and ``const`` uint32 (nb, 1, bw), bit for bit
    JAX's ``fixed_fold_tables``.  ``spectrum`` is the constant's canonical
    forward spectrum, (n,) in the merged output order."""
    q, bw, nb = mt.q, mt.bw, mt.nb
    d = np.asarray(spectrum)
    if d.shape != (mt.n,):
        raise ValueError(f"spectrum must be ({mt.n},), got {d.shape}")
    if fp.Dout != mt.D:
        raise ValueError(f"fold plan has {fp.Dout} classes, tables {mt.D}")
    W = np.empty((nb, fp.Din, bw, fp.Dout * bw), dtype=np.int8)
    const = np.empty((nb, 1, bw), dtype=np.uint32)
    mw = np.zeros((fp.Din, fp.Dout), dtype=np.int64)
    bias = _group_bias(fp.groups, fp.bounds, q)
    spec = (d.astype(np.int64) % q).reshape(nb, bw, 1)
    for b0, b1 in _chunks(nb):
        # columns of M_inv scaled by the spectrum: every product < 2^60
        K = (np.swapaxes(_inv_blocks(mt.tbl, mt.logn - mt.Lr, bw, b0, b1),
                         1, 2) * spec[b0:b1]) % q
        for i in range(fp.Din):
            u = _shifted(K, pow(fp.base, i, q), q, fp.Dout)
            _store_digits(W[b0:b1, i], u, fp.Dout, bw)
            mw[i] = np.maximum(mw[i], _digit_maxima(u, fp.Dout))
        const[b0:b1, 0] = ((fp.off % q) * (K.sum(axis=1) % q) - bias) % q
    # plan soundness: the digits sit inside the worst case the plan covers
    assert (mw <= np.asarray(fp.mw_wc, np.int64)[None, :]).all(), \
        "folded-matrix digits exceed the worst-case plan"
    return W, const


def fixed_fold_tables(name: str, spectrum, bw: int | None = None):
    """``fold_tables`` for a parameter set by name, as JAX's function."""
    mt = get_mxu_tables(name, bw)
    return fold_tables(mt, fold_plan(mt), spectrum)


def from_jax_fold_plan(fp) -> FixedFoldPlan:
    """The port's plan from a JAX ``_FixedFoldPlan`` (its int and tuple
    fields only)."""
    return FixedFoldPlan(**{f: getattr(fp, f) for f in _FOLD_FIELDS})


def from_jax_fold_tables(W, c):
    """JAX's per-constant (W, const) arrays as the port's numpy pair."""
    W, c = np.array(W), np.array(c)
    if W.dtype != np.int8 or W.ndim != 4 or c.dtype != np.uint32 or \
            c.shape != (W.shape[0], 1, W.shape[2]):
        raise ValueError(f"expected int8 (nb, Din, bw, Dout*bw) and uint32 "
                         f"(nb, 1, bw), got {W.dtype} {W.shape} and "
                         f"{c.dtype} {c.shape}")
    return W, c


# ----------------------------------------------------------------------
# B5's table stream.
# ----------------------------------------------------------------------

STAGE_DEPTH = 64         # table depth of one stage: two 32-deep MMA steps
_MMA_LANES = 8           # output lanes of one MMA tile


def stream_stages(din: int, bw: int) -> int:
    """Stages of one block's table of ``din`` planes: din*bw over 64."""
    return -(-din * bw // STAGE_DEPTH)


def _stages(w: np.ndarray) -> np.ndarray:
    """Input-major tables (nb, din, bw, D*bw) -> their stages (nb*C,
    bw*D*64) int8, in the order the MMA warps read them: stage (b, c) of a
    block holds depth [64c, 64c + 64) of the output-major table T[b] (row
    j*bw + o, column i*bw + k, zero past din*bw) as [lt][j][g][t][s][8]:
    the 16 bytes lane 4g + t of the warp of output tile lt takes for class
    j, row j*bw + 8lt + g, bytes 32s + 8t .. 32s + 8t + 7 of the slice (s the
    32-deep step)."""
    nb, din, bw, dbw = w.shape
    D, C = dbw // bw, stream_stages(din, bw)
    T = np.zeros((nb, dbw, C * STAGE_DEPTH), dtype=np.int8)
    T[..., :din * bw] = np.moveaxis(w, -1, 1).reshape(nb, dbw, din * bw)
    T = T.reshape(nb, D, bw // _MMA_LANES, _MMA_LANES, C, 2, 4, 8)
    # (b, j, lt, g, c, s, t, byte) -> (b, c, lt, j, g, t, s, byte)
    return np.ascontiguousarray(T.transpose(0, 4, 2, 1, 3, 6, 5, 7)).reshape(
        nb * C, STAGE_DEPTH * dbw)


def _unstages(st: np.ndarray, nb: int, din: int, bw: int,
              D: int) -> np.ndarray:
    C = stream_stages(din, bw)
    T = st.reshape(nb, C, bw // _MMA_LANES, D, _MMA_LANES, 4, 2, 8)
    T = T.transpose(0, 3, 2, 4, 1, 6, 5, 7).reshape(nb, D * bw,
                                                     C * STAGE_DEPTH)
    return np.moveaxis(T[..., :din * bw].reshape(nb, D * bw, din, bw), 1, -1)


def stream_tables(mt: MxuTables) -> np.ndarray:
    """B5's table stream: the forward tables' stages, then the inverse
    tables', (nb * (Cf + Ci), 64 * bw * D) int8 with C = din*bw / 64 rounded
    up.  One stage is one bulk copy; the kernel walks them in this order
    once per row group."""
    return np.concatenate([_stages(mt.wf), _stages(mt.wi)])


def expand_stream(st: np.ndarray, mt: MxuTables) -> tuple:
    """The inverse of ``stream_tables``: (wf, wi) input-major as in
    ``MxuTables``.  Raises if the depth padding of a stage is not zero."""
    nf = mt.nb * stream_stages(mt.Df, mt.bw)
    out = tuple(_unstages(part, mt.nb, din, mt.bw, mt.D)
                for part, din in ((st[:nf], mt.Df), (st[nf:], mt.Di)))
    if np.count_nonzero(st) != sum(np.count_nonzero(w) for w in out):
        raise ValueError("the stream's depth padding holds nonzero bytes")
    return out


# ----------------------------------------------------------------------
# Lane blocks narrower than one MMA step.
# ----------------------------------------------------------------------

MMA_K = 32               # the int8 MMA's k step: the narrowest lane block


def block_diagonal(w: np.ndarray, k: int) -> np.ndarray:
    """Input-major tables (1, din, bw, D*bw) -> (1, din, k*bw, D*k*bw) with
    k copies of the block on the diagonal of every class, zero elsewhere:
    input lane c*bw + i feeds output lane c*bw + o of class j (column
    (j*k + c)*bw + o) as lane i fed lane o."""
    nb, din, bw, dbw = w.shape
    D = dbw // bw
    out = np.zeros((nb, din, k * bw, D * k * bw), dtype=w.dtype)
    for c in range(k):
        for j in range(D):
            out[:, :, c * bw:(c + 1) * bw,
                (j * k + c) * bw:(j * k + c + 1) * bw] = \
                w[:, :, :, j * bw:(j + 1) * bw]
    return out


@functools.lru_cache(maxsize=None)
def lane_packed(mt: MxuTables) -> MxuTables:
    """``mt`` as B5's stream kernel runs it.  Its MMA takes 32 input lanes
    a step and its warps 8 output lanes each, so a lane block narrower
    than 32 (n <= 16, where bw = n, nb = 1 and Lr = 0) is packed: k = 32 /
    n rows side by side make one row of 32 lanes, the tables hold k copies
    of the block on their diagonal (``block_diagonal``) and the const rows
    k copies of theirs, so each row's lanes meet only its own block.
    Splits, bounds, classes and biases are per value or per class and stay
    as they are; ``tbl`` stays the n-point table (no wide stage reads
    it).  A table of 32 lanes or more comes back as it is."""
    if mt.bw >= MMA_K:
        return mt
    assert mt.nb == 1 and mt.Lr == 0
    k = MMA_K // mt.bw
    out = copy.copy(mt)
    out.n = out.bw = MMA_K
    out.logn = MMA_K.bit_length() - 1
    out.wf, out.wi = (block_diagonal(w, k) for w in (mt.wf, mt.wi))
    out.constf, out.consti = (np.tile(c, (1, 1, k))
                              for c in (mt.constf, mt.consti))
    return out
