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

All five run in register passes: a row is held by n / R threads, R values
of each operand a thread, and a pass runs up to log2(R) stages in registers
between two exchanges through shared memory (see the notes at the top of
the CUDA source and of ``csrc/pass_stages.cuh``).
``pairing_pass_plan(n, pairing)`` is the schedule a launcher takes (made by
``ops/passes.py pass_plan``); Stockham's windows follow its position map.
From n = 32768 to 131072 a row spans a thread-block cluster of 2 to 8
blocks, one launch a call; from 2^18 to 2^25 the kernels run their sweep
form (``csrc/pass_sweeps.cu``, ``passes.sweep_plan``: the row in device
memory, 3 launches a call, Stockham's 5 from 2^24, its scratch rows at its
autosort's positions), each launch counted.
``polymul_pairing_passes_plain`` runs that schedule on the CPU with the
kernel's index maps and uint32 arithmetic, so the tests hold the schedule
itself against the plain pipeline, JAX's kernel and, for Stockham, the
plain Stockham stages.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import modmul as MM
from . import ntt as N
from .ntt_fused import Kernel, _barrett, _check, _launch_plan
from .passes import (PassModel, PassPlan, SweepModel, SweepPlan, kernel_plan,
                     pass_plan, stockham_thread)
from .tables import NttTables, get_tables

__all__ = ["PAIRINGS", "KERNELS", "pairing_pass_plan", "pairing_twiddles",
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
_OUT_ORDER = {"dif": "rev", "dit": "nat", "stk": "nat"}
_IN_ORDER = {"dif": "nat", "dit": "rev", "stk": "nat"}

# pass kernels: their shared memory comes from the plan
KERNELS: dict[str, Kernel] = {
    f"polymul_pairing_{p}": Kernel(
        f"polymul_pairing_{p}", f"qt_polymul_pairing_{p}",
        "qtesla_tpu/ops/ntt_pairings_pallas.py:160", 0)
    for p in PAIRINGS}


@functools.lru_cache(maxsize=None)
def pairing_twiddles(tbl: NttTables, device: torch.device) -> torch.Tensor:
    """The (8, n) uint32 pairing table on ``device``."""
    return torch.from_numpy(tbl.pairing_packed).to(device)


def pairing_pass_plan(n: int, pairing: str) -> PassPlan:
    """The schedule of ``pairing``'s pass kernel at row length ``n``
    (``passes.pass_plan``): a DIT transform from the narrowest stage up,
    DIF and Stockham from the widest down, Stockham under its own windows.
    Raises for what the launcher refuses.  Cached: copy it before changing
    a field."""
    _check_pairing(pairing)
    fwd, inv = PAIRINGS[pairing]
    return pass_plan(n, fwd == "dit", inv == "dit", pairing == "stockham")


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

def polymul_pairing_passes_plain(x, y, tbl: NttTables, pairing: str,
                                 plan: PassPlan | None = None,
                                 trace: list | None = None):
    """z = x * y mod (X^n + 1) mod q through ``pairing``'s pass kernel's
    schedule (``plan``, ``passes.kernel_plan`` unless given), on the CPU
    (``passes.PassModel``; a sweep plan's launches through
    ``passes.SweepModel``, on x's device): the kernel's index maps,
    exchanges, bit reversals as renamings and lazy ranges, Stockham's
    threads (``stockham_thread``) at the start of each pass.  With ``trace`` a
    list, each pass appends (side, lo, hi, indices (T, R), values (rows,
    operands, T, R)) after its stages: DIF indices for Stockham too."""
    fwd, inv = PAIRINGS[pairing]
    n, L, q = tbl.n, tbl.logn, tbl.q
    plan = kernel_plan(n, pairing) if plan is None else plan
    if isinstance(plan, SweepPlan):
        tw = torch.from_numpy(tbl.pairing_packed.astype(np.int64)).to(
            x.device)
        z = SweepModel(plan, n, q, tw, lambda a, b: _barrett(a, b, tbl)).run(
            [a.reshape(-1, n).to(torch.int64) for a in (x, y)])
        return z.reshape(x.shape).to(torch.uint32)
    stk = pairing == "stockham"
    (w, w_sh, iw, iw_sh, phi, phi_sh, iphi,
     iphi_sh) = torch.from_numpy(tbl.pairing_packed.astype(np.int64))
    lead = x.shape[:-1]
    xs, ys = (a.reshape(-1, n).to(torch.int64) for a in (x, y))
    B = xs.shape[0]
    mdl = PassModel(plan, n, q, B)
    xs, ys = mdl.pad(xs), mdl.pad(ys)
    t, tb = mdl.t, mdl.tb

    def transform(V, b, vt, side, kind, wt, wt_sh):
        lo, hi, bs = (getattr(plan, f"{side}_{f}") for f in ("lo", "hi", "b"))
        for p in range(plan.passes):
            # Stockham: thread t holds positions t + c 2^tb of stage L - hi
            t2 = stockham_thread(t, L - hi[p], tb) if stk else t
            if p:
                V, b, vt = mdl.exchange(V, b, vt, bs[p], t2)
            assert b == bs[p]
            assert not stk or bool((vt == t2).all())
            V = mdl.cyclic_stages(V, b, vt, lo[p], hi[p], wt, wt_sh,
                                  kind == "dit")
            if trace is not None:
                trace.append((side, lo[p], hi[p], mdl.window(vt, b), V))
        return V, b, vt

    b, vt = tb, t
    idx = mdl.window(vt, b)
    # (rows, operand, thread, register)
    V = torch.stack([MM.shoup_mulmod_lazy(a[:, idx], phi[idx], phi_sh[idx],
                                          q) for a in (xs, ys)], 1)
    if fwd == "dit":
        V, b, vt = mdl.bit_reverse(V, b, vt)
    V, b, vt = transform(V, b, vt, "fwd", fwd, w, w_sh)
    ps = tbl.ps
    V = MM.mulmod_barrett(V[:, :1], V[:, 1:], q, ps.r32, ps.r32_shoup,
                          ps.one_shoup)
    # a DIF or Stockham forward gives rev order in DIF indices, a DIT
    # inverse takes it
    if (fwd != "dit") != (inv == "dit"):
        V, b, vt = mdl.bit_reverse(V, b, vt)
    V, b, vt = transform(V, b, vt, "inv", inv, iw, iw_sh)
    if inv != "dit":
        V, b, vt = mdl.bit_reverse(V, b, vt)
    idx = mdl.window(vt, b)
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


def polymul_pairing(x, y, tbl: NttTables, pairing: str, tw=None,
                    plan=None) -> torch.Tensor:
    """z = x * y mod (X^n + 1) mod q over (B..., n) uint32 tensors of
    canonical residues, through ``pairing``'s kernel under ``plan``
    (``passes.kernel_plan`` unless given: the block or cluster form, or
    past its reach the sweep form)."""
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
        return _launch_plan(KERNELS[f"polymul_pairing_{pairing}"], tbl, tw,
                            x, y, plan or kernel_plan(n, pairing), 2)
    return polymul_pairing_plain(x, y, tbl, pairing)


@functools.lru_cache(maxsize=None)
def polymul_pairing_fn(name: str, pairing: str):
    """(x, y) -> z negacyclic polymul through one pairing's kernel (B10)."""
    _check_pairing(pairing)
    return functools.partial(polymul_pairing, tbl=get_tables(name),
                             pairing=pairing)
