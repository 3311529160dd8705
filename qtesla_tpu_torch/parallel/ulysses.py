"""Ulysses sequence parallelism: a batch<->position exchange around the
unmodified single-device pipeline, and the strategy dispatcher of the
sequence-parallel paths.

Counterpart of ``qtesla_tpu/parallel/ulysses.py``: ``polymul_ulysses_fn``
(l.84), ``polymul_fixed_ulysses_fn`` (l.137) and ``polymul_sp_fn``
(l.179).  At rest each of the k model shards holds one position chunk of
every row: the position shards (k, B, n/k).  One product exchanges x and y
into row shards (k, B/k, n), shard s holding rows [s B/k, (s+1) B/k) in
full (``_a2a_to_rows``), runs the single-device pipeline on them, and
exchanges z back (``_a2a_to_positions``).  The k shards are the leading
axis of one tensor on the mesh's device, and JAX's two ``lax.all_to_all``
calls are permutations of it; the pipeline runs once over all k row shards.
Taken from (B, n) rows on one device, the position shards are a strided
view of them and the row shards hold the rows where they already are, so
torch resolves both exchanges as views: no copy is made, and the path costs
what its pipeline costs.

On a mesh across ranks (``distributed.make_global_mesh``) a rank holds its
position shard (B, n/k) of its data index's rows (the "ulysses" layout of
``distributed.global_batch``), pads B with zero rows to a multiple of k, and
the two exchanges are ``distributed.all_to_all`` over the model group
(split_axis 0 and concat_axis 1 to rows, 1 and 0 back, JAX's l.67-77): the
pipeline runs on the rank's B/k full rows.

``local="auto"`` is ``"fused"`` on a CUDA mesh (B1; for the fixed form B2
to prepare and B4 to multiply) and ``"merged"`` on a CPU mesh, as JAX takes
its merged pipeline off the TPU; any name that ``polymul_fn`` (or
``polymul_fixed_fn``) takes is accepted.  The batch is padded with zero
rows to a multiple of data * k and the output sliced back, as in JAX.

``polymul_sp_fn`` picks a strategy as JAX does (``sp_strategy``): a model
axis of 1 is plain data parallelism (``polymul_dp_fn``), a batch of at
least data * k rows (or none declared) Ulysses, a smaller one the four-step
(``polymul_fourstep_sharded_fn``: the segment kernels B11, B12, B16).
"""

from __future__ import annotations

import torch

from ..ops.tables import get_tables
from .distributed import all_to_all
from .mesh import on_mesh

__all__ = ["polymul_ulysses_fn", "polymul_fixed_ulysses_fn",
           "polymul_sp_fn", "sp_strategy"]


def _local_name(mesh, local: str) -> str:
    if local == "auto":
        return "fused" if mesh.device.type == "cuda" else "merged"
    return local


def _a2a_to_rows(v: torch.Tensor) -> torch.Tensor:
    """Position shards (k, B, nloc) -> row shards (k, B/k, n):
    out[s, b, d nloc + l] = in[d, s B/k + b, l], JAX's
    ``all_to_all(split_axis=0, concat_axis=1, tiled=True)``."""
    k, B, nloc = v.shape
    return v.reshape(k, k, B // k, nloc).permute(1, 2, 0, 3).reshape(
        k, B // k, k * nloc)


def _a2a_to_positions(v: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_a2a_to_rows``."""
    k, Bk, n = v.shape
    return v.reshape(k, Bk, k, n // k).permute(2, 0, 1, 3).reshape(
        k, k * Bk, n // k)


def _to_rows(x: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """(B, n) rows -> the row shards (k, B'/k, n) of the batch padded with
    zero rows to B', a multiple of data * k: the position shards (k, B',
    n/k), a view of the padded rows, through ``_a2a_to_rows``."""
    on_mesh(mesh, x)
    if x.dim() != 2 or x.shape[1] != n:
        raise ValueError(f"expected (B, {n}) rows, got {tuple(x.shape)}")
    k = mesh.model
    pad = (-x.shape[0]) % (mesh.data * k)
    if pad:
        x = torch.cat([x, x.new_zeros((pad, n))])
    return _a2a_to_rows(x.reshape(-1, k, n // k).transpose(0, 1))


def _from_rows(z: torch.Tensor, B: int) -> torch.Tensor:
    """Row shards (k, B'/k, n) -> the first B of the (B', n) rows, through
    the position shards."""
    n = z.shape[-1]
    return _a2a_to_positions(z).transpose(0, 1).reshape(-1, n)[:B]


def _rank_rows(xs: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """A rank's position shard (B, n/k) -> its B'/k full rows (B' = B
    padded with zero rows to a multiple of k), one exchange across the
    model group."""
    on_mesh(mesh, xs)
    k = mesh.model
    if xs.dim() != 2 or xs.shape[1] != n // k:
        raise ValueError(f"expected a rank's (B, {n // k}) position shard, "
                         f"got {tuple(xs.shape)}")
    pad = (-xs.shape[0]) % k
    if pad:
        xs = torch.cat([xs, xs.new_zeros((pad, n // k))])
    return all_to_all(xs, mesh.model_group, 0, 1)


def _rank_positions(z: torch.Tensor, mesh, B: int) -> torch.Tensor:
    """The inverse of ``_rank_rows``: the first B rows of the rank's
    position shard."""
    return all_to_all(z, mesh.model_group, 1, 0)[:B]


def _check_model_axis(name: str, mesh) -> int:
    n = get_tables(name).n
    if n % mesh.model:
        raise ValueError(f"model axis {mesh.model} must divide n={n}")
    return n


def polymul_ulysses_fn(name: str, mesh, local: str = "auto"):
    """(x, y) -> z over (B, n) uint32 tensors on the mesh's device,
    positions split over the model axis at rest and exchanged to full rows
    around the single-device pipeline ``local``.  Across ranks x, y and z
    are this rank's position shards (B, n/k)."""
    from ..models.polymul import polymul_fn
    n = _check_model_axis(name, mesh)
    pipeline = polymul_fn(name, _local_name(mesh, local))

    def polymul(x, y):
        if y.shape != x.shape:
            raise ValueError(f"operand shapes differ: {tuple(x.shape)} vs "
                             f"{tuple(y.shape)}")
        if mesh.across_ranks:
            z = pipeline(_rank_rows(x, mesh, n), _rank_rows(y, mesh, n))
            return _rank_positions(z, mesh, x.shape[0])
        xr, yr = _to_rows(x, mesh, n), _to_rows(y, mesh, n)
        z = pipeline(xr.reshape(-1, n), yr.reshape(-1, n))
        return _from_rows(z.reshape(xr.shape), x.shape[0])

    return polymul


def polymul_fixed_ulysses_fn(name: str, mesh, local: str = "auto"):
    """(prepare, multiply) for products x * a with a constant a under the
    Ulysses layout: ``prepare(a)`` (n values) -> a's spectrum, computed
    once on the whole row (on every rank, across ranks); ``multiply(x, A)``
    exchanges x to rows, runs the fixed-operand product and exchanges z
    back (across ranks x and z are this rank's position shards)."""
    from ..models.polymul import polymul_fixed_fn
    n = _check_model_axis(name, mesh)
    picked = _local_name(mesh, local)
    prep, mul = polymul_fixed_fn(name, picked)

    def prepare(a):
        on_mesh(mesh, a)
        A = prep(a.reshape(1, n))
        return A if picked == "mxu-folded" else A[0]

    def multiply(x, A):
        if mesh.across_ranks:
            return _rank_positions(mul(_rank_rows(x, mesh, n), A), mesh,
                                   x.shape[0])
        xr = _to_rows(x, mesh, n)
        z = mul(xr.reshape(-1, n), A)
        return _from_rows(z.reshape(xr.shape), x.shape[0])

    return prepare, multiply


def sp_strategy(mesh, batch_hint: int | None = None) -> str:
    """The path ``polymul_sp_fn`` takes: "dp" for a model axis of 1,
    "ulysses" when the batch fills data * k rows or is not declared,
    "fourstep" below that."""
    if mesh.model == 1:
        return "dp"
    if batch_hint is None or batch_hint >= mesh.data * mesh.model:
        return "ulysses"
    return "fourstep"


def polymul_sp_fn(name: str, mesh, batch_hint: int | None = None,
                  local: str = "auto"):
    """The sequence-parallel polymul for an expected batch of
    ``batch_hint`` rows (see ``sp_strategy``).  ``local`` goes to the path
    taken; for data parallelism it is the fused kernel (B1) on a CUDA mesh
    and the merged pipeline on a CPU mesh.  Across ranks the function takes
    this rank's shards in the layout of the path taken
    (``distributed.global_batch``): "dp" rows, "ulysses" positions, or the
    four-step's "sp" columns."""
    strategy = sp_strategy(mesh, batch_hint)
    if strategy == "dp":
        from .sharded import polymul_dp_fn
        return polymul_dp_fn(name, mesh, algo=_local_name(mesh, "auto"))
    if strategy == "ulysses":
        return polymul_ulysses_fn(name, mesh, local=local)
    from .sharded import polymul_fourstep_sharded_fn
    return polymul_fourstep_sharded_fn(name, mesh, local=local)
