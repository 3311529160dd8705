"""Negacyclic polynomial multiplication z = x * y mod (X^n + 1) mod q.

Counterpart of ``qtesla_tpu/models/polymul.py``.  Public functions take and
return (B..., n) ``torch.uint32`` tensors of canonical residues, on the CPU
or a CUDA device:

- ``algo="merged"``: the plain PyTorch merged-psi pipeline (``ops/ntt.py``);
- ``algo="fused"``: one hand-written CUDA kernel per call on a CUDA tensor
  (``ops/ntt_fused.py``), its plain twin on a CPU tensor;
- ``algo="mxu"``: the digit-matmul form, likewise (``ops/ntt_mxu.py``):
  wide butterfly stages, then int8 digit-plane products per lane block;
- ``algo`` one of the reference pairings ``gs_ct``, ``ct_ct``, ``gs_gs``,
  ``ct_gs``, ``stockham``, or ``four_step`` or ``matrix``: plain PyTorch
  pipelines with explicit psi weighting (``ops/ntt.py``,
  ``ops/ntt_pairings.py``);
- ``algo="<pairing>_kernel"``: that pairing's hand-written CUDA kernel on a
  CUDA tensor, its plain pipeline on a CPU tensor (``ops/ntt_pairings.py``);
- ``algo="nussbaumer"``: the exact mod-q Nussbaumer recursion with its
  Karatsuba base products (``ops/nussbaumer.py``
  ``polymul_nussbaumer_q_fn``), plain PyTorch on the operands' device, as
  the JAX package's ``polymul_fn`` maps the name.  The Z_{2^32-1} ring path
  stays ``ops.nussbaumer.polymul_nussbaumer_fn(name, max_coeff=...)``.

``polymul_fixed_fn`` also serves ``"mxu-folded"``, whose prepared operand is
the constant's spectrum folded into the inverse tables.  Every algo name of
the JAX package's ``polymul_fn`` is ported.  ``NegacyclicPolymul`` carries
one parameter set's twiddles and MXU tables as registered buffers, so
``.to(device)`` moves them with the module.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from ..ops import ntt as N
from ..ops import ntt_fused as F
from ..ops import ntt_mxu as M
from ..ops import ntt_pairings as P
from ..ops.nussbaumer import polymul_nussbaumer_q_fn
from ..ops.mxu_tables import get_mxu_tables
from ..ops.tables import NttTables, get_tables

__all__ = ["ntt", "intt", "polymul_fn", "polymul_fixed_fn",
           "polymul_negacyclic", "NegacyclicPolymul", "ALGORITHMS"]

def _unsupported(algo: str, allowed) -> Exception:
    return ValueError(f"unknown algo {algo!r}; available: {list(allowed)}")


def _tables(ps) -> NttTables:
    """Tables of a set given by name, as ``NttTables``, or as any parameter
    set object with ``name``, ``n`` and ``q`` (the port's ``ParamSet`` or the
    JAX package's), whose name the port's registry must know with the same
    (n, q)."""
    if isinstance(ps, str):
        return get_tables(ps)
    if isinstance(ps, NttTables):
        return ps
    if all(hasattr(ps, f) for f in ("name", "n", "q")):
        tbl = get_tables(ps.name)
        if (tbl.n, tbl.q) != (ps.n, ps.q):
            raise ValueError(f"param set {ps.name!r} is registered as "
                             f"({tbl.n}, {tbl.q}), got ({ps.n}, {ps.q})")
        return tbl
    raise TypeError(f"expected param-set name/ParamSet/NttTables, got {ps!r}")


def _check_u32(x: torch.Tensor) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.uint32:
        raise TypeError(f"expected a torch.uint32 tensor, got "
                        f"{getattr(x, 'dtype', type(x))}")


# ----------------------------------------------------------------------
# Transforms.
# ----------------------------------------------------------------------

_TRANSFORMS = ("merged", "fused", "mxu", "stockham")


def ntt(x: torch.Tensor, ps, algo: str = "merged") -> torch.Tensor:
    """Forward negacyclic NTT, canonical output: nat -> rev, or nat -> nat
    for ``stockham`` (psi weighting, then the cyclic Stockham NTT)."""
    tbl = _tables(ps)
    if algo == "merged":
        _check_u32(x)
        return N.ntt_fwd_merged(x.to(torch.int64), tbl).to(torch.uint32)
    if algo == "fused":
        return F.ntt_fused(x, tbl)
    if algo == "mxu":
        return M.ntt_mxu(x, get_mxu_tables(tbl.ps.name))
    if algo == "stockham":
        _check_u32(x)
        return N.stockham_fwd(N.weight_psi(x.to(torch.int64), tbl),
                              tbl).to(torch.uint32)
    raise _unsupported(algo, _TRANSFORMS)


def intt(X: torch.Tensor, ps, algo: str = "merged") -> torch.Tensor:
    """Inverse negacyclic NTT (matching ``ntt``'s output order)."""
    tbl = _tables(ps)
    if algo == "merged":
        _check_u32(X)
        return N.intt_inv_merged(X.to(torch.int64), tbl).to(torch.uint32)
    if algo == "fused":
        return F.intt_fused(X, tbl)
    if algo == "mxu":
        return M.intt_mxu(X, get_mxu_tables(tbl.ps.name))
    if algo == "stockham":
        _check_u32(X)
        v = N.stockham_inv(X.to(torch.int64), tbl, scale_ninv=False)
        return N.weight_ipsi_ninv(v, tbl).to(torch.uint32)
    raise _unsupported(algo, _TRANSFORMS)


# ----------------------------------------------------------------------
# Pipelines: (B..., n) x (B..., n) -> (B..., n).
# ----------------------------------------------------------------------

def _pm_merged(x, y, tbl: NttTables, tw=None):
    """Plain merged-psi CT forward, Barrett pointwise, GS inverse."""
    _check_u32(x)
    _check_u32(y)
    return F.polymul_plain(x, y, tbl, tw)


def _pm_mxu(x, y, tbl: NttTables, tw=None, tabs=None):
    """Wide butterfly stages, then int8 digit-plane products per block."""
    return M.polymul_mxu(x, y, get_mxu_tables(tbl.ps.name), tabs, tw)


def _plain(pipeline):
    """A plain int64 pipeline (x, y, tbl) as a uint32 one."""
    def run(x, y, tbl: NttTables, tw=None):
        _check_u32(x)
        _check_u32(y)
        return pipeline(x.to(torch.int64), y.to(torch.int64),
                        tbl).to(torch.uint32)
    return run


def _pm_fourstep(x, y, tbl: NttTables):
    """Four-step N = n1 x n2 pipeline, n1 = 2^(log2(n) // 2); the
    sub-inverses already apply n^{-1}."""
    n1 = 1 << (tbl.logn // 2)
    X = N.fourstep_ntt(N.weight_psi(x, tbl), tbl, n1=n1)
    Y = N.fourstep_ntt(N.weight_psi(y, tbl), tbl, n1=n1)
    Z = N.pointwise_mul(X, Y, tbl)
    return N.weight_ipsi(N.fourstep_intt(Z, tbl, n1=n1), tbl)


def _pm_matrix(x, y, tbl: NttTables):
    """Dense twiddle-matrix pipeline; the inverse applies n^{-1}."""
    X = N.matrix_ntt(N.weight_psi(x, tbl), tbl)
    Y = N.matrix_ntt(N.weight_psi(y, tbl), tbl)
    Z = N.pointwise_mul(X, Y, tbl)
    return N.weight_ipsi(N.matrix_ntt(Z, tbl, inverse=True), tbl)


def _pm_pairing_kernel(pairing: str):
    """The pairing's kernel; ``tw`` is its (8, n) table."""
    def run(x, y, tbl: NttTables, tw=None):
        return P.polymul_pairing(x, y, tbl, pairing, tw)
    return run


def _pm_nussbaumer(x, y, tbl: NttTables, tw=None):
    """The exact mod-q Nussbaumer recursion; it takes no twiddles."""
    return polymul_nussbaumer_q_fn(tbl.ps.name)(x, y)


_PIPELINES = {
    "merged": _pm_merged, "fused": F.polymul_fused, "mxu": _pm_mxu,
    **{p: _plain(functools.partial(P.pipeline, pairing=p))
       for p in P.PAIRINGS},
    "four_step": _plain(_pm_fourstep), "matrix": _plain(_pm_matrix),
    **{p + "_kernel": _pm_pairing_kernel(p) for p in P.PAIRINGS},
    "nussbaumer": _pm_nussbaumer,
}
ALGORITHMS = tuple(_PIPELINES)


@functools.lru_cache(maxsize=None)
def polymul_fn(name: str, algo: str = "merged"):
    """An (x, y) -> z negacyclic polymul for one parameter set and
    algorithm."""
    if algo not in _PIPELINES:
        raise _unsupported(algo, ALGORITHMS)
    return functools.partial(_PIPELINES[algo], tbl=get_tables(name))


@functools.lru_cache(maxsize=None)
def polymul_fixed_fn(name: str, algo: str = "mxu"):
    """(prepare, multiply) pair for products z = x * a with a constant a:
    prepare(a) -> its spectrum A (run once), multiply(x, A) -> z, one
    forward and one inverse transform per product (the qTESLA verification
    shape, a the public polynomial).  The default is 'mxu', as in the JAX
    package.  The spectra of every algo are the same canonical values.
    For 'mxu-folded', prepare(a) runs the forward (B6) on a's device, builds
    the folded inverse tables on the host and returns them on a's device as
    an ``ops.ntt_mxu.FoldedOperand``; multiply (B9) has no pointwise stage.
    The MXU forms plan first: past ``mxu_tables.MAX_TABLE_BYTES`` they raise
    before any table is built."""
    if algo == "mxu-folded":
        mt = get_mxu_tables(name)

        def prep_folded(a):
            return M.fold_operand(M.ntt_mxu(a.reshape(1, mt.n), mt), mt)

        return prep_folded, functools.partial(M.polymul_fixed_folded_mxu,
                                              mt=mt)
    if algo == "mxu":
        mt = get_mxu_tables(name)
        return (functools.partial(M.ntt_mxu, mt=mt),
                functools.partial(M.polymul_fixed_mxu, mt=mt))
    tbl = get_tables(name)
    if algo == "fused":
        return (functools.partial(F.ntt_fused, tbl=tbl),
                functools.partial(F.polymul_fixed_fused, tbl=tbl))
    if algo == "merged":
        def prep(a):
            return ntt(a, tbl, "merged")

        def mul(x, A):
            _check_u32(x)
            _check_u32(A)
            return F.polymul_fixed_plain(x, A, tbl)

        return prep, mul
    raise _unsupported(algo, ("mxu", "mxu-folded", "fused", "merged"))


def polymul_negacyclic(x: torch.Tensor, y: torch.Tensor, ps,
                       algo: str = "merged") -> torch.Tensor:
    """z = x*y mod (X^n + 1) mod q, batched over leading axes."""
    tbl = _tables(ps)
    if x.shape[-1] != tbl.n or y.shape[-1] != tbl.n:
        raise ValueError(
            f"last axis must be n={tbl.n} for {tbl.ps.name}; got "
            f"x{tuple(x.shape)}, y{tuple(y.shape)}")
    return polymul_fn(tbl.ps.name, algo)(x, y)


class NegacyclicPolymul(nn.Module):
    """Negacyclic polymul for one parameter set; its twiddles, pairing
    twiddles and MXU tables are buffers."""

    def __init__(self, ps):
        super().__init__()
        self.tbl = _tables(ps)
        self.register_buffer("twiddles",
                             torch.from_numpy(self.tbl.packed).clone())
        self.register_buffer(
            "pairing_twiddles",
            torch.from_numpy(self.tbl.pairing_packed).clone())
        tabs = M.host_tables(get_mxu_tables(self.tbl.ps.name))
        for field, t in zip(("wf", "constf", "wi", "consti", "stream"),
                            tabs.tensors()):
            self.register_buffer("mxu_" + field, t)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                algo: str = "merged") -> torch.Tensor:
        if algo not in _PIPELINES:
            raise _unsupported(algo, ALGORITHMS)
        if algo == "mxu":
            tabs = M.MxuDeviceTables(self.mxu_wf, self.mxu_constf,
                                     self.mxu_wi, self.mxu_consti,
                                     self.mxu_stream)
            return _pm_mxu(x, y, self.tbl, self.twiddles, tabs)
        if algo.endswith("_kernel"):
            return _PIPELINES[algo](x, y, self.tbl, self.pairing_twiddles)
        return _PIPELINES[algo](x, y, self.tbl, self.twiddles)
