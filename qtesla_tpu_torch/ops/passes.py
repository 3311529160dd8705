"""The register-pass schedule shared by the pass kernels (B10's five
pairings, B1, B4), and a model of those kernels on the CPU.

A row of n = 2^L values is held by T = n / R threads, R values of each
operand a thread; a pass runs up to r = log2(R) stages in registers on the
window [b, b + r) of index bits, and the values go through shared memory
between passes (see ``csrc/pass_stages.cuh``).  ``pass_plan`` makes the
schedule a kernel's launcher takes: R, threads a row, rows a block, each
pass's stages and window, the shared memory a row; it refuses what the
launcher refuses.  ``PassModel`` runs a schedule on the CPU with the
kernels' index maps, exchanges through a model of each block's shared memory
at the kernels' padded addresses and uint32 lazy arithmetic (asserted), so
that the CPU twins ``ntt_pairings.polymul_pairing_passes_plain``,
``ntt_fused.polymul_fused_passes_plain`` and
``ntt_fused.polymul_fixed_fused_passes_plain`` hold the schedules
themselves against the plain pipelines and JAX.

Stockham's windows follow its autosort: at the start of each pass thread t
holds the Stockham positions t + c 2^tb (tb = L - r) of the stage st the
pass starts at.  Position p at stage st is DIF index ``stockham_index(p,
st, L)``; in DIF indices a pass's window then has its top at the pass's
widest stage (b = hi - r, so the last pass covers r stages), and thread t is
the virtual thread ``stockham_thread(t, st, tb)``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import modmul as MM

__all__ = ["MAX_PASSES", "PASS_SHAPES", "PassPlan", "schedule",
           "pass_plan", "describe_pass_plan", "brev", "stockham_thread",
           "stockham_index", "PassModel"]

MAX_PASSES = 3
# (R, passes) the launchers have a kernel for: R = n up to 32 in one pass a
# transform, R = 32 in two passes (n <= 1024) or three
PASS_SHAPES = frozenset({(2, 1), (4, 1), (8, 1), (16, 1), (32, 1), (32, 2),
                         (32, 3)})
# threads a block the kernels are built for (__launch_bounds__)
_MAX_THREADS = {1: 256, 2: 256, 3: 512}
_BLOCK_THREADS = 256


class PassPlan(ctypes.Structure):
    """The pass kernels' run-time plan; field for field the ``PassPlan``
    struct of ``csrc/pass_stages.cuh``.  Pass p of the forward runs the
    stages of half-width 2^k, k in [fwd_lo[p], fwd_hi[p]), on the register
    window [fwd_b[p], fwd_b[p] + log2(radix)); the inverse's likewise.
    ``row_stride``: words of shared memory a row (0 for one pass)."""

    _fields_ = [(f, ctypes.c_int32) for f in (
        "radix", "threads", "rows", "passes", "row_stride")] + [
        (f, ctypes.c_int32 * MAX_PASSES) for f in (
            "fwd_lo", "fwd_hi", "fwd_b", "inv_lo", "inv_hi", "inv_b")]


def _log2(n: int) -> int:
    return n.bit_length() - 1


def schedule(L: int, r: int, sizes: list[int], up: bool,
             stockham: bool = False):
    """(lo, hi, window) of each pass: from the narrowest stage up (``up``)
    or from the widest down; the window [b, b + r) is the highest that
    holds the pass (b = min(lo, L - r)), or under Stockham's rule the one
    whose top is the pass's widest stage (b = hi - r)."""
    out, edge = [], 0 if up else L
    for s in sizes:
        lo, hi = (edge, edge + s) if up else (edge - s, edge)
        out.append((lo, hi, hi - r if stockham else min(lo, L - r)))
        edge = hi if up else lo
    return out


@functools.lru_cache(maxsize=None)
def pass_plan(n: int, fwd_up: bool, inv_up: bool,
              stockham: bool = False, operands: int = 2) -> PassPlan:
    """The schedule of a pass kernel at row length ``n`` whose forward runs
    from the narrowest stage up (``fwd_up``) or the widest down, likewise
    its inverse: R = min(n, 32) values of each operand a thread, n / R
    threads a row, rows enough for a block of 256 threads (one row when a
    row takes more), ceil(log2(n) / log2(R)) passes a transform, the stages
    split as evenly as they go, larger first; under Stockham's windows the
    last pass takes r stages and the others split the rest so; shared
    memory a row for the ``operands`` its exchanges carry (2, or 1 for
    B4's, whose forward runs on x alone).  Raises for
    what the launchers refuse: an n that is not a power of two from 2, more
    than three passes (n > 32768), a row of more threads than its kernel's
    block takes (n = 32768).  The returned plan is cached: copy it before
    changing a field."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"n={n}: not a power of two from 2")
    if operands not in (1, 2):
        raise ValueError(f"{operands} operands: the kernels carry 1 or 2")
    L = _log2(n)
    R = min(n, 32)
    r = _log2(R)
    P = -(-L // r)
    if (R, P) not in PASS_SHAPES:
        raise ValueError(f"n={n}: {P} passes, no kernel (kernels for "
                         f"(radix, passes) in {sorted(PASS_SHAPES)})")
    T = n // R
    rows = max(1, _BLOCK_THREADS // T)
    if rows * T > _MAX_THREADS[P]:
        raise ValueError(f"n={n}: {T} threads a row, more than the "
                         f"{_MAX_THREADS[P]} a block of its kernel takes")
    stride = 0
    if P > 1:
        # each operand, index i at i + i // 32; rows of fewer than 32
        # threads share a warp, so a row's banks start T past its
        # neighbour's.  A block of at most 512 threads holds at most 16384
        # values an operand: 135 KB for two, inside the 227 KB a block may
        # take.
        stride = (-(-operands * (n + n // 32) // 32) * 32
                  + (T if T < 32 else 0))
    if stockham:
        q, rem = divmod(L - r, P - 1) if P > 1 else (0, 0)
        sizes = [q + 1] * rem + [q] * (P - 1 - rem) + [min(L, r)]
    else:
        q, rem = divmod(L, P)
        sizes = [q + 1] * rem + [q] * (P - rem)
    fields = {}
    for side, up in (("fwd", fwd_up), ("inv", inv_up)):
        sched = schedule(L, r, sizes, up, stockham)
        for i, f in enumerate(("lo", "hi", "b")):
            fields[f"{side}_{f}"] = (ctypes.c_int32 * MAX_PASSES)(
                *(p[i] for p in sched))
    return PassPlan(radix=R, threads=T, rows=rows, passes=P,
                    row_stride=stride, **fields)


def describe_pass_plan(plan: PassPlan) -> str:
    """One line: R, threads and rows, each transform's passes."""
    def passes(side):
        lo, hi, b = (getattr(plan, f"{side}_{f}") for f in ("lo", "hi", "b"))
        return " ".join(f"[{lo[p]},{hi[p]})@{b[p]}"
                        for p in range(plan.passes))
    return (f"R={plan.radix}, threads a row {plan.threads}, rows a block "
            f"{plan.rows}, passes a transform {plan.passes} (stages [lo,hi)@"
            f"window: forward {passes('fwd')}, inverse {passes('inv')}), "
            f"{plan.row_stride * 4} bytes of shared memory a row")


def brev(v, bits: int):
    """v with its low ``bits`` bits reversed (int or int64 tensor)."""
    out = torch.zeros_like(v) if isinstance(v, torch.Tensor) else 0
    for k in range(bits):
        out |= ((v >> k) & 1) << (bits - 1 - k)
    return out


def stockham_thread(t, st: int, tb: int):
    """The DIF virtual thread whose window [tb - st, L - st) holds the
    Stockham positions t + c 2^tb of stage st."""
    return (t >> st) | (brev(t & ((1 << st) - 1), st) << (tb - st))


def stockham_index(p, st: int, L: int):
    """The DIF index of Stockham position p at stage st: (p >> st) |
    brev_st(p mod 2^st) << (L - st)."""
    return (p >> st) | (brev(p & ((1 << st) - 1), st) << (L - st))


class PassModel:
    """One pass kernel's rows on the CPU: values V of shape (rows,
    operands, T, R) in int64 holding uint32 values, thread t holding R
    registers in the window [b, b + r) of its virtual thread vt, rows
    padded to whole blocks of ``plan.rows`` (a row past the batch computes
    on row 0)."""

    def __init__(self, plan: PassPlan, n: int, q: int, batch: int):
        self.plan, self.n, self.q = plan, n, q
        self.L, self.r = _log2(n), _log2(plan.radix)
        self.tb = self.L - self.r
        self.blocks = -(-batch // plan.rows)
        self.t = torch.arange(plan.threads)
        self.c = torch.arange(plan.radix)

    def pad(self, a: torch.Tensor) -> torch.Tensor:
        rows = self.blocks * self.plan.rows
        return torch.cat([a, a[:1].expand(rows - a.shape[0], self.n)])

    def window(self, vt, b):
        """(T, R) indices the threads hold in the window [b, b + r)."""
        assert 0 <= b <= self.tb
        base = (vt & ((1 << b) - 1)) | ((vt >> b) << (b + self.r))
        return base[:, None] | (self.c << b)[None, :]

    def bit_reverse(self, V, b, vt):
        """The kernels' renaming: registers, virtual thread and window."""
        return V[..., brev(self.c, self.r)], self.tb - b, brev(vt, self.tb)

    def exchange(self, V, b, vt, b2, vt2):
        """Through each row's shared memory at the kernels' padded
        addresses, from the window [b, b + r) of vt to [b2, b2 + r) of
        vt2."""
        plan, n = self.plan, self.n
        stride = n + n // 32
        rows = self.blocks * plan.rows
        smem = torch.zeros(rows * max(plan.row_stride, 1), dtype=torch.int64)
        row_base = torch.arange(rows) * plan.row_stride
        ops = torch.arange(V.shape[1])[None, :, None, None] * stride
        addr = []
        for idx in (self.window(vt, b), self.window(vt2, b2)):
            i = idx + (idx >> 5)
            assert i.max() < stride and i.unique().numel() == n
            addr.append(row_base[:, None, None, None] + ops + i)
        assert V.shape[1] * stride <= plan.row_stride
        smem[addr[0]] = V
        return smem[addr[1]], b2, vt2

    def cyclic_stages(self, V, b, vt, lo, hi, w, w_sh, ct: bool):
        """The cyclic stages [lo, hi): CT from the narrowest up (below 4q),
        or GS from the widest down ([0, 2q)); the stage on window bit t
        reads w[2^k + (vt mod 2^b) + (c mod 2^t) 2^b]."""
        vlo = vt & ((1 << b) - 1)

        def tw(k, cs, m):
            return (1 << k) + vlo[:, None] + ((cs & (m - 1)) << b)[None, :]
        return self._stages(V, b, lo, hi, w, w_sh, ct, ct, tw)

    def merged_stages(self, V, b, vt, lo, hi, w, w_sh, fwd: bool):
        """B1's and B4's merged-psi stages [lo, hi): the forward's CT
        butterflies from the widest down, or the inverse's GS butterflies
        from the narrowest up; the stage on window bit t reads
        w[2^(L-1-k) + (j >> (k+1))]."""
        L, r = self.L, self.r

        def tw(k, cs, m):
            t = k - b
            return ((1 << (L - 1 - k)) + ((vt >> b) << (r - 1 - t))[:, None]
                    + (cs >> (t + 1))[None, :])
        return self._stages(V, b, lo, hi, w, w_sh, fwd, not fwd, tw)

    def _stages(self, V, b, lo, hi, w, w_sh, ct, up, tw):
        q, q2, R = self.q, 2 * self.q, self.plan.radix
        for k in (range(lo, hi) if up else range(hi - 1, lo - 1, -1)):
            m = 1 << (k - b)
            assert 1 <= m < R
            cs = self.c[(self.c & m) == 0]
            j = tw(k, cs, m)
            U, D = V[..., cs], V[..., cs + m]
            if ct:
                assert bool((V < 4 * q).all())
                u = MM._csub(U, q2)
                h = MM.shoup_mulmod_lazy(D, w[j], w_sh[j], q)
                U, D = u + h, u + q2 - h
            else:
                assert bool((V < q2).all())
                U, D = (MM._csub(U + D, q2),
                        MM.shoup_mulmod_lazy(U + q2 - D, w[j], w_sh[j], q))
            V = V.clone()
            V[..., cs], V[..., cs + m] = U, D
        return V
