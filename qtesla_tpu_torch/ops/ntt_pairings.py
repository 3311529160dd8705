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
"""

from __future__ import annotations

import functools

import torch

from . import ntt as N
from .ntt_fused import Kernel, _check, _launch
from .tables import NttTables, get_tables

__all__ = ["PAIRINGS", "KERNELS", "pairing_twiddles", "pipeline",
           "polymul_pairing", "polymul_pairing_plain", "polymul_pairing_fn"]

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

# Stockham holds a ping-pong row per operand: 4 rows of shared memory
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
# Wrapper: kernel for CUDA tensors, plain version for CPU tensors.
# ----------------------------------------------------------------------

def _check_pairing(pairing: str) -> None:
    if pairing not in PAIRINGS:
        raise ValueError(f"unknown pairing {pairing!r}; choose from "
                         f"{sorted(PAIRINGS)}")


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
        return _launch(KERNELS[f"polymul_pairing_{pairing}"], tbl, tw, x, y)
    return polymul_pairing_plain(x, y, tbl, pairing)


@functools.lru_cache(maxsize=None)
def polymul_pairing_fn(name: str, pairing: str):
    """(x, y) -> z negacyclic polymul through one pairing's kernel (B10)."""
    _check_pairing(pairing)
    return functools.partial(polymul_pairing, tbl=get_tables(name),
                             pairing=pairing)
