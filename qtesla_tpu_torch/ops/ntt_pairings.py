"""The five reference pipeline pairings as one hand-written CUDA kernel each
(B10), with their plain PyTorch twins.

Counterpart of ``qtesla_tpu/ops/ntt_pairings_pallas.py``.  A pairing is a
forward scheme and an inverse scheme (``PAIRINGS``): "dif" (GS butterfly,
nat -> rev), "dit" (CT butterfly, rev -> nat) or "stk" (Stockham autosort,
nat -> nat).  Every pairing computes the same negacyclic product

    z = phi^{-1} n^{-1} * INV(bitrev?(FWD(phi x) * FWD(phi y)))

with phi the psi^i weighting, a bit reversal wherever the forward output
order differs from the inverse input order (DIT forwards also reverse their
input, a DIF inverse its output), and canonical output.

``polymul_pairing(x, y, tbl, pairing)`` launches the pairing's kernel of
``csrc/ntt_pairings.cu`` on a CUDA tensor (or raises) and runs the plain
pipeline on a CPU tensor; each launch adds one to the pairing's count in
``KERNELS``.  ``polymul_pairing_plain`` is the plain pipeline of the same
pairing (what ``models.polymul_fn(name, pairing)`` runs), so the tests hold
it against JAX's XLA pipelines and the chip holds the kernel against it.
The kernels read the compact (8, n) table ``NttTables.pairing_packed``
(``pairing_twiddles`` caches it per device).

The four cyclic pairings (``PASS_PAIRINGS``) run in register passes: a row
is held by n / R threads, R values of each operand a thread, and a pass
runs up to log2(R) stages in registers between two exchanges through
shared memory (see the note at the top of the CUDA source).
``pairing_pass_plan(n, pairing)`` is the schedule their launcher takes:
R, threads a row, rows a block, each pass's stages and window, the shared
memory a row; it refuses what the launcher refuses.
``polymul_pairing_passes_plain`` runs that schedule on the CPU with the
kernel's index maps and uint32 arithmetic, so the tests hold the schedule
itself against the plain pipeline and JAX's kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import modmul as MM
from . import ntt as N
from .ntt_fused import Kernel, _check, _launch
from .tables import NttTables, get_tables

__all__ = ["PAIRINGS", "PASS_PAIRINGS", "KERNELS", "PairingPassPlan",
           "pairing_pass_plan", "describe_pass_plan", "pairing_twiddles",
           "pipeline", "polymul_pairing", "polymul_pairing_plain",
           "polymul_pairing_passes_plain", "polymul_pairing_fn"]

CUDA_SOURCE = "qtesla_tpu_torch/csrc/ntt_pairings.cu"

# pairing -> (forward scheme, inverse scheme)
PAIRINGS: dict[str, tuple[str, str]] = {
    "gs_ct": ("dif", "dit"),
    "ct_ct": ("dit", "dit"),
    "gs_gs": ("dif", "dif"),
    "ct_gs": ("dit", "dif"),
    "stockham": ("stk", "stk"),
}
# the pairings that run in register passes (Stockham: a block a row)
PASS_PAIRINGS = ("gs_ct", "ct_ct", "gs_gs", "ct_gs")
_OUT_ORDER = {"dif": "rev", "dit": "nat", "stk": "nat"}
_IN_ORDER = {"dif": "nat", "dit": "rev", "stk": "nat"}

# Stockham holds a ping-pong row per operand: 4 rows of shared memory (the
# pass kernels take theirs from their plan)
KERNELS: dict[str, Kernel] = {
    f"polymul_pairing_{p}": Kernel(
        f"polymul_pairing_{p}", f"qt_polymul_pairing_{p}",
        "qtesla_tpu/ops/ntt_pairings_pallas.py:160",
        4 if p == "stockham" else 2)
    for p in PAIRINGS}


@functools.lru_cache(maxsize=None)
def pairing_twiddles(tbl: NttTables, device: torch.device) -> torch.Tensor:
    """The (8, n) uint32 pairing table on ``device``."""
    return torch.from_numpy(tbl.pairing_packed).to(device)


# ----------------------------------------------------------------------
# The pass plan of the four cyclic pairings.
# ----------------------------------------------------------------------

MAX_PASSES = 3
# (R, passes) the launcher has a kernel for: R = n up to 32 in one pass a
# transform, R = 32 in two passes (n <= 1024) or three
PASS_SHAPES = frozenset({(2, 1), (4, 1), (8, 1), (16, 1), (32, 1), (32, 2),
                         (32, 3)})
# threads a block the kernels are built for (__launch_bounds__)
_MAX_THREADS = {1: 256, 2: 256, 3: 512}
_BLOCK_THREADS = 256


class PairingPassPlan(ctypes.Structure):
    """The pass kernels' run-time plan; field for field the ``PassPlan``
    struct of ``csrc/ntt_pairings.cu``.  Pass p of the forward runs the
    stages of half-width 2^k, k in [fwd_lo[p], fwd_hi[p]), on the register
    window [fwd_b[p], fwd_b[p] + log2(radix)); the inverse's likewise.
    ``row_stride``: words of shared memory a row (0 for one pass)."""

    _fields_ = [(f, ctypes.c_int32) for f in (
        "radix", "threads", "rows", "passes", "row_stride")] + [
        (f, ctypes.c_int32 * MAX_PASSES) for f in (
            "fwd_lo", "fwd_hi", "fwd_b", "inv_lo", "inv_hi", "inv_b")]


def _log2(n: int) -> int:
    return n.bit_length() - 1


def _schedule(L: int, r: int, sizes: list[int], ct: bool):
    """(lo, hi, window) of each pass: CT from the narrowest stage up, GS
    from the widest down; the window [b, b + r) is the highest that holds
    the pass (b = min(lo, L - r))."""
    out, edge = [], 0 if ct else L
    for s in sizes:
        lo, hi = (edge, edge + s) if ct else (edge - s, edge)
        out.append((lo, hi, min(lo, L - r)))
        edge = hi if ct else lo
    return out


@functools.lru_cache(maxsize=None)
def pairing_pass_plan(n: int, pairing: str) -> PairingPassPlan:
    """The schedule of ``pairing``'s pass kernel at row length ``n``: R =
    min(n, 32) values of each operand a thread, n / R threads a row, rows
    enough for a block of 256 threads (one row when a row takes more),
    ceil(log2(n) / log2(R)) passes a transform, the stages split as evenly
    as they go, larger first.  Raises for what the launcher refuses:
    Stockham, an n that is not a power of two from 2, more than three
    passes (n > 32768), a row of more threads than its kernel's block takes
    (n = 32768).  The returned plan is cached: copy it before changing a
    field."""
    _check_pairing(pairing)
    if pairing not in PASS_PAIRINGS:
        raise ValueError(f"{pairing} has no pass plan; pass pairings are "
                         f"{PASS_PAIRINGS}")
    if n < 2 or n & (n - 1):
        raise ValueError(f"n={n}: not a power of two from 2")
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
        # both operands, index i at i + i // 32; rows of fewer than 32
        # threads share a warp, so a row's banks start T past its
        # neighbour's.  A block of at most 512 threads holds at most 16384
        # values an operand: 135 KB, inside the 227 KB a block may take.
        stride = -(-2 * (n + n // 32) // 32) * 32 + (T if T < 32 else 0)
    q, rem = divmod(L, P)
    sizes = [q + 1] * rem + [q] * (P - rem)
    fwd, inv = PAIRINGS[pairing]
    fields = {}
    for side, kind in (("fwd", fwd), ("inv", inv)):
        sched = _schedule(L, r, sizes, kind == "dit")
        for i, f in enumerate(("lo", "hi", "b")):
            fields[f"{side}_{f}"] = (ctypes.c_int32 * MAX_PASSES)(
                *(p[i] for p in sched))
    return PairingPassPlan(radix=R, threads=T, rows=rows, passes=P,
                           row_stride=stride, **fields)


def describe_pass_plan(plan: PairingPassPlan) -> str:
    """One line: R, threads and rows, each transform's passes."""
    def passes(side):
        lo, hi, b = (getattr(plan, f"{side}_{f}") for f in ("lo", "hi", "b"))
        return " ".join(f"[{lo[p]},{hi[p]})@{b[p]}"
                        for p in range(plan.passes))
    return (f"R={plan.radix}, threads a row {plan.threads}, rows a block "
            f"{plan.rows}, passes a transform {plan.passes} (stages [lo,hi)@"
            f"window: forward {passes('fwd')}, inverse {passes('inv')}), "
            f"{plan.row_stride * 4} bytes of shared memory a row")


# ----------------------------------------------------------------------
# Plain pipelines (int64, canonical at every stage).
# ----------------------------------------------------------------------

def _forward(v, tbl: NttTables, kind: str):
    v = N.weight_psi(v, tbl)
    if kind == "dif":
        return N.gs_fwd_cyclic(v, tbl)
    if kind == "dit":
        return N.ct_fwd_cyclic(N.bitrev_permute(v, tbl), tbl)
    return N.stockham_fwd(v, tbl)


def pipeline(x: torch.Tensor, y: torch.Tensor, tbl: NttTables,
             pairing: str) -> torch.Tensor:
    """The plain pipeline of ``pairing`` on int64 tensors of canonical
    residues."""
    fwd, inv = PAIRINGS[pairing]
    Z = N.pointwise_mul(_forward(x, tbl, fwd), _forward(y, tbl, fwd), tbl)
    if _OUT_ORDER[fwd] != _IN_ORDER[inv]:
        Z = N.bitrev_permute(Z, tbl)
    if inv == "dit":
        v = N.ct_inv_cyclic(Z, tbl, scale_ninv=False)
    elif inv == "dif":
        v = N.bitrev_permute(N.gs_inv_cyclic(Z, tbl, scale_ninv=False), tbl)
    else:
        v = N.stockham_inv(Z, tbl, scale_ninv=False)
    return N.weight_ipsi_ninv(v, tbl)


def polymul_pairing_plain(x, y, tbl: NttTables, pairing: str):
    return pipeline(x.to(torch.int64), y.to(torch.int64), tbl,
                    pairing).to(torch.uint32)


# ----------------------------------------------------------------------
# The pass kernels' schedule on the CPU (int64 holding uint32 values).
# ----------------------------------------------------------------------

def _brev(v: torch.Tensor, bits: int) -> torch.Tensor:
    out = torch.zeros_like(v)
    for k in range(bits):
        out |= ((v >> k) & 1) << (bits - 1 - k)
    return out


def polymul_pairing_passes_plain(x, y, tbl: NttTables, pairing: str,
                                 plan: PairingPassPlan | None = None):
    """z = x * y mod (X^n + 1) mod q through ``pairing``'s pass kernel's
    schedule (``plan``, ``pairing_pass_plan`` unless given), on the CPU:
    rows padded to whole blocks, thread t of a row holding R registers an
    operand in the window [b, b + r) of its virtual thread vt, each pass's
    butterflies on register pairs with the kernel's twiddle indices, the
    exchanges through a model of each block's shared memory at the
    kernel's padded addresses, the bit reversals as the kernel's renaming,
    every value in the kernel's lazy ranges (asserted), so below 2^32 as
    the kernel's uint32 values are."""
    fwd, inv = PAIRINGS[pairing]
    n, L, q = tbl.n, tbl.logn, tbl.q
    plan = pairing_pass_plan(n, pairing) if plan is None else plan
    R, T, P, rows = plan.radix, plan.threads, plan.passes, plan.rows
    r = _log2(R)
    tb = L - r
    q2 = 2 * q
    (w, w_sh, iw, iw_sh, phi, phi_sh, iphi,
     iphi_sh) = torch.from_numpy(tbl.pairing_packed.astype(np.int64))
    lead = x.shape[:-1]
    xs, ys = (a.reshape(-1, n).to(torch.int64) for a in (x, y))
    B = xs.shape[0]
    blocks = -(-B // rows)
    # a row past the batch computes on row 0
    pad = blocks * rows - B
    xs, ys = (torch.cat([a, a[:1].expand(pad, n)]) for a in (xs, ys))
    t, c = torch.arange(T), torch.arange(R)
    stride = n + n // 32
    # every block's shared memory end to end: row i's at i * row_stride
    row_base = torch.arange(blocks * rows) * plan.row_stride

    def window(vt, b):
        assert 0 <= b <= tb
        base = (vt & ((1 << b) - 1)) | ((vt >> b) << (b + r))
        return base[:, None] | (c << b)[None, :]                  # (T, R)

    def bit_reverse(V, b, vt):
        return V[..., _brev(c, r)], tb - b, _brev(vt, tb)

    def exchange(V, b, vt, b2):
        smem = torch.zeros(blocks * rows * max(plan.row_stride, 1),
                           dtype=torch.int64)
        ops = torch.arange(V.shape[1])[None, :, None, None] * stride
        addr = []
        for idx in (window(vt, b), window(t, b2)):
            i = idx + (idx >> 5)
            assert i.max() < stride and i.unique().numel() == n
            addr.append(row_base[:, None, None, None] + ops + i)
        assert 2 * stride <= plan.row_stride
        smem[addr[0]] = V
        return smem[addr[1]], b2, t

    def stages(V, b, vt, lo, hi, wt, wt_sh, ct):
        vlo = vt & ((1 << b) - 1)
        for k in (range(lo, hi) if ct else range(hi - 1, lo - 1, -1)):
            m = 1 << (k - b)
            assert 1 <= m < R
            cs = c[(c & m) == 0]
            j = (1 << k) + vlo[:, None] + ((cs & (m - 1)) << b)[None, :]
            U, D = V[..., cs], V[..., cs + m]
            if ct:
                assert bool((V < 4 * q).all())
                u = MM._csub(U, q2)
                h = MM.shoup_mulmod_lazy(D, wt[j], wt_sh[j], q)
                U, D = u + h, u + q2 - h
            else:
                assert bool((V < q2).all())
                U, D = (MM._csub(U + D, q2),
                        MM.shoup_mulmod_lazy(U + q2 - D, wt[j], wt_sh[j], q))
            V = V.clone()
            V[..., cs], V[..., cs + m] = U, D
        return V

    b, vt = tb, t
    idx = window(vt, b)
    # (rows, operand, thread, register)
    V = torch.stack([MM.shoup_mulmod_lazy(a[:, idx], phi[idx], phi_sh[idx],
                                          q) for a in (xs, ys)], 1)
    if fwd == "dit":
        V, b, vt = bit_reverse(V, b, vt)
    for p in range(P):
        if p:
            V, b, vt = exchange(V, b, vt, plan.fwd_b[p])
        assert b == plan.fwd_b[p]
        V = stages(V, b, vt, plan.fwd_lo[p], plan.fwd_hi[p], w, w_sh,
                   fwd == "dit")
    ps = tbl.ps
    V = MM.mulmod_barrett(V[:, :1], V[:, 1:], q, ps.r32, ps.r32_shoup,
                          ps.one_shoup)
    if _OUT_ORDER[fwd] != _IN_ORDER[inv]:
        V, b, vt = bit_reverse(V, b, vt)
    for p in range(P):
        if p:
            V, b, vt = exchange(V, b, vt, plan.inv_b[p])
        assert b == plan.inv_b[p]
        V = stages(V, b, vt, plan.inv_lo[p], plan.inv_hi[p], iw, iw_sh,
                   inv == "dit")
    if inv == "dif":
        V, b, vt = bit_reverse(V, b, vt)
    idx = window(vt, b)
    assert idx.unique().numel() == n
    z = torch.zeros_like(xs)
    z[:, idx] = MM._csub(
        MM.shoup_mulmod_lazy(V[:, 0], iphi[idx], iphi_sh[idx], q), q)
    return z[:B].reshape(*lead, n).to(torch.uint32)


# ----------------------------------------------------------------------
# Wrapper: kernel for CUDA tensors, plain version for CPU tensors.
# ----------------------------------------------------------------------

def _check_pairing(pairing: str) -> None:
    if pairing not in PAIRINGS:
        raise ValueError(f"unknown pairing {pairing!r}; choose from "
                         f"{sorted(PAIRINGS)}")


def _launch_passes(kernel: Kernel, tbl: NttTables, tw: torch.Tensor,
                   x: torch.Tensor, y: torch.Tensor,
                   plan: PairingPassPlan) -> torch.Tensor:
    """Run a pass kernel on CUDA tensors x and y under ``plan``, as given:
    the launcher checks it and a refusal raises."""
    from ..utils.build import load_library

    n = tbl.n
    out = torch.empty_like(x)
    batch = x.numel() // n
    if batch == 0:
        return out
    lib = load_library()
    ps = tbl.ps
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib.cdll, kernel.symbol)(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), tw.data_ptr(), batch,
            n, tbl.logn, tbl.q, ps.r32, ps.r32_shoup, ps.one_shoup,
            ctypes.addressof(plan), stream)
    if err != 0:
        raise RuntimeError(f"{kernel.symbol} launch failed: cudaError {err} "
                           f"({lib.error_string(err)})")
    kernel.launches += 1
    return out


def polymul_pairing(x, y, tbl: NttTables, pairing: str,
                    tw=None) -> torch.Tensor:
    """z = x * y mod (X^n + 1) mod q over (B..., n) uint32 tensors of
    canonical residues, through ``pairing``'s kernel."""
    _check_pairing(pairing)
    n = tbl.n
    _check("operand 0", x, n)
    _check("operand 1", y, n)
    if x.device != y.device:
        raise ValueError(f"operands on {x.device} and {y.device}")
    if x.shape != y.shape:
        raise ValueError(f"operand shapes differ: {tuple(x.shape)} vs "
                         f"{tuple(y.shape)}")
    if tw is None:
        tw = pairing_twiddles(tbl, x.device)
    if (tw.dtype != torch.uint32 or tuple(tw.shape) != (8, n)
            or tw.device != x.device or not tw.is_contiguous()):
        raise ValueError(f"pairing twiddles must be a contiguous (8, {n}) "
                         f"uint32 tensor on {x.device}")
    if x.is_cuda:
        kernel = KERNELS[f"polymul_pairing_{pairing}"]
        if pairing in PASS_PAIRINGS:
            return _launch_passes(kernel, tbl, tw, x, y,
                                  pairing_pass_plan(n, pairing))
        return _launch(kernel, tbl, tw, x, y)
    return polymul_pairing_plain(x, y, tbl, pairing)


@functools.lru_cache(maxsize=None)
def polymul_pairing_fn(name: str, pairing: str):
    """(x, y) -> z negacyclic polymul through one pairing's kernel (B10)."""
    _check_pairing(pairing)
    return functools.partial(polymul_pairing, tbl=get_tables(name),
                             pairing=pairing)
