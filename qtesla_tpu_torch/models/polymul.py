"""Negacyclic polynomial multiplication z = x * y mod (X^n + 1) mod q.

Counterpart of ``qtesla_tpu/models/polymul.py``.  Public functions take and
return (B..., n) ``torch.uint32`` tensors of canonical residues, on the CPU
or a CUDA device:

- ``algo="merged"``: the plain PyTorch merged-psi pipeline (``ops/ntt.py``);
- ``algo="fused"``: one hand-written CUDA kernel per call on a CUDA tensor
  (``ops/ntt_fused.py``), its plain twin on a CPU tensor.

The JAX package's other algorithms are not ported yet; asking for one raises
``NotImplementedError`` naming the ROADMAP.md item that ports it.
``NegacyclicPolymul`` carries one parameter set's twiddles as a registered
buffer, so ``.to(device)`` moves them with the module.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from qtesla_tpu.params import ParamSet

from ..ops import ntt as N
from ..ops import ntt_fused as F
from ..ops.tables import NttTables, get_tables

__all__ = ["ntt", "intt", "polymul_fn", "polymul_fixed_fn",
           "polymul_negacyclic", "NegacyclicPolymul", "ALGORITHMS"]

# JAX algorithm names the port does not have yet -> where ROADMAP.md queues
# their port
_NOT_PORTED = {
    "mxu": "queue B, B5-B9 (ops/ntt_mxu.py)",
    "mxu-folded": "queue B, B9 (ops/ntt_mxu.py) and queue A item 7",
    "stockham": "queue A item 8 (rest of ops/ntt.py and models/polymul.py)",
    "gs_ct": "queue A item 8", "ct_ct": "queue A item 8",
    "gs_gs": "queue A item 8", "ct_gs": "queue A item 8",
    "four_step": "queue A item 8", "matrix": "queue A item 8",
    "nussbaumer": "queue A item 10 (ops/ringz32.py, ops/nussbaumer.py)",
}
for _p in ("gs_ct", "ct_ct", "gs_gs", "ct_gs", "stockham"):
    _NOT_PORTED[_p + "_kernel"] = "queue B, B10 (ops/ntt_pairings_pallas.py)"


def _unsupported(algo: str, allowed) -> Exception:
    if algo in _NOT_PORTED:
        return NotImplementedError(
            f"algo {algo!r} is not ported to qtesla_tpu_torch yet: see "
            f"ROADMAP.md {_NOT_PORTED[algo]}")
    return ValueError(f"unknown algo {algo!r}; available: {list(allowed)}")


def _tables(ps) -> NttTables:
    if isinstance(ps, str):
        return get_tables(ps)
    if isinstance(ps, ParamSet):
        return get_tables(ps.name)
    if isinstance(ps, NttTables):
        return ps
    raise TypeError(f"expected param-set name/ParamSet/NttTables, got {ps!r}")


def _check_u32(x: torch.Tensor) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.uint32:
        raise TypeError(f"expected a torch.uint32 tensor, got "
                        f"{getattr(x, 'dtype', type(x))}")


# ----------------------------------------------------------------------
# Transforms.
# ----------------------------------------------------------------------

def ntt(x: torch.Tensor, ps, algo: str = "merged") -> torch.Tensor:
    """Forward negacyclic NTT, nat -> rev, canonical output."""
    tbl = _tables(ps)
    if algo == "merged":
        _check_u32(x)
        return N.ntt_fwd_merged(x.to(torch.int64), tbl).to(torch.uint32)
    if algo == "fused":
        return F.ntt_fused(x, tbl)
    raise _unsupported(algo, ("merged", "fused"))


def intt(X: torch.Tensor, ps, algo: str = "merged") -> torch.Tensor:
    """Inverse negacyclic NTT (matching ``ntt``'s output order)."""
    tbl = _tables(ps)
    if algo == "merged":
        _check_u32(X)
        return N.intt_inv_merged(X.to(torch.int64), tbl).to(torch.uint32)
    if algo == "fused":
        return F.intt_fused(X, tbl)
    raise _unsupported(algo, ("merged", "fused"))


# ----------------------------------------------------------------------
# Pipelines: (B..., n) x (B..., n) -> (B..., n).
# ----------------------------------------------------------------------

def _pm_merged(x, y, tbl: NttTables, tw=None):
    """Plain merged-psi CT forward, Barrett pointwise, GS inverse."""
    _check_u32(x)
    _check_u32(y)
    return F.polymul_plain(x, y, tbl, tw)


_PIPELINES = {"merged": _pm_merged, "fused": F.polymul_fused}
ALGORITHMS = tuple(_PIPELINES)


@functools.lru_cache(maxsize=None)
def polymul_fn(name: str, algo: str = "merged"):
    """An (x, y) -> z negacyclic polymul for one parameter set and
    algorithm."""
    if algo not in _PIPELINES:
        raise _unsupported(algo, ALGORITHMS)
    return functools.partial(_PIPELINES[algo], tbl=get_tables(name))


@functools.lru_cache(maxsize=None)
def polymul_fixed_fn(name: str, algo: str = "fused"):
    """(prepare, multiply) pair for products z = x * a with a constant a:
    prepare(a) -> its spectrum A (run once), multiply(x, A) -> z, one
    forward and one inverse transform per product.  The JAX package's
    default, 'mxu', is not ported yet, so the default here is 'fused'."""
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
    raise _unsupported(algo, ("fused", "merged"))


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
    """Negacyclic polymul for one parameter set, its twiddles a buffer."""

    def __init__(self, ps):
        super().__init__()
        self.tbl = _tables(ps)
        self.register_buffer("twiddles",
                             torch.from_numpy(self.tbl.packed).clone())

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                algo: str = "merged") -> torch.Tensor:
        if algo not in _PIPELINES:
            raise _unsupported(algo, ALGORITHMS)
        return _PIPELINES[algo](x, y, self.tbl, self.twiddles)
