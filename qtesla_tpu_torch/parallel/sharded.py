"""Sequence-parallel (four-step) negacyclic polymul: the entry point and its
twiddle tables.

Counterpart of ``qtesla_tpu/parallel/sharded.py``: ``_fourstep_tables``
(l.103, numpy only) and ``polymul_fourstep_sharded_fn`` (l.221).  The local
transforms run as the digit-matmul segment kernels of
``parallel/sharded_mxu.py``; the JAX package's plain Stockham locals
(``local="jnp"``) and its data-parallel and Ulysses paths need
``torch.distributed`` and are ROADMAP queue A item 13.
"""

from __future__ import annotations

import functools

from ..ops.ntt import _fourstep_twiddle
from ..ops.tables import get_tables

__all__ = ["polymul_fourstep_sharded_fn"]


@functools.lru_cache(maxsize=None)
def _fourstep_tables(name: str, n1: int) -> dict:
    """numpy uint32 tables shaped (n1, n2): the four-step twiddles
    w^{+-k1 j2} and the psi weightings, each with its Shoup companion."""
    tbl = get_tables(name)
    n2 = tbl.n // n1
    cpu = "cpu"
    W, W_sh, Winv, Winv_sh = (
        t.numpy().astype("uint32") for inverse in (False, True)
        for t in _fourstep_twiddle(tbl, n1, inverse, cpu))
    return dict(W=W, W_sh=W_sh, Winv=Winv, Winv_sh=Winv_sh,
                phi=tbl.phi.reshape(n1, n2),
                phi_sh=tbl.phi_shoup.reshape(n1, n2),
                ipsi=tbl.ipsi_pow.reshape(n1, n2),
                ipsi_sh=tbl.ipsi_pow_shoup.reshape(n1, n2))


def polymul_fourstep_sharded_fn(name: str, mesh, n1: int | None = None,
                                local: str = "auto"):
    """(x, y) -> z over (B, n) uint32 tensors, the transform split over the
    mesh's model axis.  ``local="mxu"`` and ``"auto"`` run the segment
    kernels (B11, B12, B16; their plain twins on CPU tensors) and never
    downgrade: a configuration the planner rejects raises ValueError.  A
    model axis of 1 is the single-transform digit-matmul polymul (B5), as
    in the JAX package.  ``local="jnp"`` is not ported."""
    if local == "jnp":
        raise NotImplementedError(
            "local='jnp' (the plain Stockham locals under torch.distributed) "
            "is not ported to qtesla_tpu_torch yet: see ROADMAP.md queue A "
            "item 13")
    if local not in ("auto", "mxu"):
        raise ValueError(f"unknown local {local!r}; available: 'auto', "
                         f"'mxu', 'jnp'")
    if mesh.model == 1:
        from ..models.polymul import polymul_fn
        return polymul_fn(name, "mxu")
    from .sharded_mxu import polymul_fourstep_mxu_fn
    return polymul_fourstep_mxu_fn(name, mesh, n1)
