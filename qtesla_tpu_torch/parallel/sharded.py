"""Sharded negacyclic polymul: batch data parallelism, the plain-torch
four-step with its model axis of k shards, and the four-step entry point.

Counterpart of ``qtesla_tpu/parallel/sharded.py``: ``polymul_dp_fn``
(l.40), ``polymul_fixed_dp_fn`` (l.80), ``_fourstep_tables`` (l.103),
``ntt_fourstep_sharded_fn`` / ``intt_fourstep_sharded_fn`` (l.126-139),
``_build`` (l.142) and ``polymul_fourstep_sharded_fn`` (l.221).

The data parallel forms run the single-device pipeline (or prepare and
multiply pair) on the rows the process holds: on a stacked mesh
(``parallel/mesh.py``) the whole batch, on a mesh across ranks the rank's
rows ("dp" layout of ``distributed.global_batch``), with no collective, as
JAX's do; the constant is prepared on every rank.  A ragged batch needs no
padding.  The four-step with Stockham locals (``local="jnp"``, the JAX
package's name) holds the k shards as the leading axis of one tensor:
coefficient shards (k, B, n1, n2/k), shard d holding columns j2 in
[d n2/k, (d+1) n2/k), and spectral shards (k, B, n1/k, n2), shard d holding
rows k1 in [d n1/k, (d+1) n1/k).  Each shard runs JAX's local steps: psi weighting,
the n1-point Stockham NTT along j1, the twiddle w^(k1 j2), then after the
exchange the n2-point Stockham NTT along j2; the inverse retraces them.
JAX's two ``lax.all_to_all`` calls become the permutations ``_a2a_fwd`` and
``_a2a_inv`` between the two layouts, as ``sharded_mxu.a2a_fwd`` /
``a2a_inv`` are for the segment kernels.  Across ranks a rank holds shard
d = its model index, (B, n/k) in the "sp" layout (columns) and (B, n1/k,
n2) spectral, and the two exchanges are ``distributed.all_to_all`` over the
model group on the values as int32 (canonical, below q < 2^31): split_axis
1 and concat_axis 2 of (B, n1, n2k) forward, 2 and 1 back, as JAX's
l.160-170.  Every value stays canonical, so
the spectra and products equal JAX's bit for bit.  These paths run torch
operations on the mesh's device (the digit-matmul and fused kernels where
the pipeline named is one); an operand on another device raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..ops import ntt as N
from ..ops.modmul import shoup_mulmod
from ..ops.ntt import _fourstep_twiddle, _subtables
from ..ops.tables import get_tables
from ..params import get_params
from .distributed import all_to_all, sp_n1
from .mesh import on_mesh

__all__ = ["polymul_dp_fn", "polymul_fixed_dp_fn",
           "polymul_fourstep_sharded_fn", "ntt_fourstep_sharded_fn",
           "intt_fourstep_sharded_fn"]

_I64, _U32 = torch.int64, torch.uint32


def polymul_dp_fn(name: str, mesh, algo: str = "merged"):
    """(x, y) -> z, the batch data parallel over the mesh: the
    single-device pipeline ``algo`` on the rows this process holds (B1 for
    "fused", B5 for "mxu"), the whole batch on a stacked mesh, the rank's
    rows across ranks."""
    from ..models.polymul import polymul_fn
    pipeline = polymul_fn(name, algo)

    def polymul(x, y):
        on_mesh(mesh, x, y)
        return pipeline(x, y)

    return polymul


def polymul_fixed_dp_fn(name: str, mesh, algo: str = "mxu"):
    """(prepare, multiply) for products x * a with a constant a, the x
    batch data parallel over the mesh: ``polymul_fixed_fn(name, algo)``'s
    pair on the mesh's device (B6 and B8 for the default "mxu")."""
    from ..models.polymul import polymul_fixed_fn
    prep, mul = polymul_fixed_fn(name, algo)

    def prepare(a):
        on_mesh(mesh, a)
        return prep(a)

    def multiply(x, A):
        on_mesh(mesh, x)
        return mul(x, A)

    return prepare, multiply


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


@functools.lru_cache(maxsize=None)
def _shard_tables(name: str, n1: int, k: int, device: torch.device) -> dict:
    """``_fourstep_tables`` as int64 shards on ``device``, shaped to
    broadcast over (k, B, ...): the forward twiddle and the weightings
    split by columns j2, (k, 1, n1, n2/k); the inverse twiddle by rows k1,
    (k, 1, n1/k, n2)."""
    out = {}
    for f, t in _fourstep_tables(name, n1).items():
        t = torch.from_numpy(t.astype("int64"))
        n2 = t.shape[1]
        if f.startswith("Winv"):
            t = t.reshape(k, n1 // k, n2)
        else:
            t = t.reshape(n1, k, n2 // k).permute(1, 0, 2)
        out[f] = t[:, None].contiguous().to(device)
    return out


def _a2a_fwd(v: torch.Tensor) -> torch.Tensor:
    """Coefficient shards (k, B, n1, n2k) -> spectral shards (k, B, n1k,
    n2): out[d, b, i, s n2k + l] = in[s, b, d n1k + i, l], JAX's
    ``all_to_all(split_axis=1, concat_axis=2, tiled=True)``."""
    k, B, n1, n2k = v.shape
    return v.reshape(k, B, k, n1 // k, n2k).permute(2, 1, 3, 0, 4).reshape(
        k, B, n1 // k, k * n2k)


def _a2a_inv(v: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_a2a_fwd``."""
    k, B, n1k, n2 = v.shape
    return v.reshape(k, B, n1k, k, n2 // k).permute(3, 1, 0, 2, 4).reshape(
        k, B, k * n1k, n2 // k)


def _across(group, split: int, concat: int):
    """A rank's exchange of its one shard (1, B, ...) of canonical int64
    values: ``all_to_all`` of them as int32 over ``group``."""
    def exchange(v):
        out = all_to_all(v[0].to(torch.int32), group, split, concat)
        return out.to(_I64)[None]
    return exchange


def _along_j1(v: torch.Tensor, fn) -> torch.Tensor:
    """``fn`` along the n1 axis (-2) of (..., n1, m)."""
    return fn(v.transpose(-1, -2)).transpose(-1, -2)


class _FourStep(NamedTuple):
    fwd: object
    inv: object
    polymul: object
    dims: tuple


def _check_rows(what: str, t: torch.Tensor, mesh, shape) -> None:
    on_mesh(mesh, t)
    if t.dtype != _U32:
        raise TypeError(f"{what}: expected torch.uint32, got {t.dtype}")
    if t.dim() != len(shape) or tuple(t.shape[1:]) != shape[1:]:
        raise ValueError(f"{what}: expected shape (B, "
                         f"{', '.join(map(str, shape[1:]))}), got "
                         f"{tuple(t.shape)}")


@functools.lru_cache(maxsize=None)
def _build(name: str, mesh, n1: int | None,
           with_weighting: bool = True) -> _FourStep:
    tbl = get_tables(name)
    n, q = tbl.n, tbl.q
    if n1 is None:
        n1 = 1 << (tbl.logn // 2)
    n2 = n // n1
    k = mesh.model
    if n1 * n2 != n or n1 % k or n2 % k:
        raise ValueError(f"model axis {k} must divide both n1={n1} and "
                         f"n2={n2} (n1 a power of two dividing n={n})")
    t1 = _subtables(name, q, n1)
    t2 = _subtables(name, q, n2)
    T = _shard_tables(name, n1, k, mesh.device)
    if mesh.across_ranks:
        # this rank's shard alone: its tables, its exchanges, its rows
        d = mesh.model_index
        T = {f: t[d:d + 1] for f, t in T.items()}
        a2a_fwd = _across(mesh.model_group, 1, 2)
        a2a_inv = _across(mesh.model_group, 2, 1)
        rows, spec = (None, n // k), (None, n1 // k, n2)

        def to_shards(x):
            return x.to(_I64).reshape(1, x.shape[0], n1, n2 // k)

        def from_shards(v):
            return v[0].reshape(v.shape[1], n // k).to(_U32)

        def to_spectrum(V):
            return V[0].to(_U32)

        def from_spectrum(Z):
            return Z.to(_I64)[None]
    else:
        a2a_fwd, a2a_inv = _a2a_fwd, _a2a_inv
        rows, spec = (None, n), (None, n1, n2)

        def to_shards(x):
            B = x.shape[0]
            return x.to(_I64).reshape(B, n1, k, n2 // k).permute(2, 0, 1, 3)

        def from_shards(v):
            return v.permute(1, 2, 0, 3).reshape(v.shape[1], n).to(_U32)

        def to_spectrum(V):
            return V.permute(1, 0, 2, 3).reshape(V.shape[1], n1, n2).to(_U32)

        def from_spectrum(Z):
            return Z.to(_I64).reshape(Z.shape[0], k, n1 // k, n2).permute(
                1, 0, 2, 3)

    def fwd_local(v):
        # (k, B, n1, n2k) coefficient shards -> (k, B, n1k, n2) spectral
        if with_weighting:
            v = shoup_mulmod(v, T["phi"], T["phi_sh"], q)
        v = _along_j1(v, lambda u: N.stockham_fwd(u, t1))   # j1 -> k1
        v = shoup_mulmod(v, T["W"], T["W_sh"], q)           # w^(k1 j2)
        return N.stockham_fwd(a2a_fwd(v), t2)               # j2 -> k2

    def inv_local(v):
        # (k, B, n1k, n2) spectral shards -> (k, B, n1, n2k) coefficient
        v = N.stockham_inv(v, t2)                           # k2 -> j2
        v = shoup_mulmod(v, T["Winv"], T["Winv_sh"], q)     # w^(-k1 j2)
        v = _along_j1(a2a_inv(v), lambda u: N.stockham_inv(u, t1))
        if with_weighting:
            v = shoup_mulmod(v, T["ipsi"], T["ipsi_sh"], q)
        return v

    def fwd(x):
        """(B, n) -> the spectrum (B, n1, n2), rows k1, columns k2; across
        ranks the rank's shard (B, n/k) -> its rows k1 (B, n1/k, n2)."""
        _check_rows("x", x, mesh, rows)
        return to_spectrum(fwd_local(to_shards(x)))

    def inv(Z):
        """The inverse of ``fwd``."""
        _check_rows("Z", Z, mesh, spec)
        return from_shards(inv_local(from_spectrum(Z)))

    def polymul(x, y):
        """(B, n) x (B, n) -> (B, n); across ranks the rank's shards (B,
        n/k)."""
        _check_rows("x", x, mesh, rows)
        _check_rows("y", y, mesh, rows)
        if y.shape != x.shape:
            raise ValueError(f"operand shapes differ: {tuple(x.shape)} vs "
                             f"{tuple(y.shape)}")
        Z = N.pointwise_mul(fwd_local(to_shards(x)), fwd_local(to_shards(y)),
                            tbl)
        return from_shards(inv_local(Z))

    return _FourStep(fwd, inv, polymul, (n1, n2))


def ntt_fourstep_sharded_fn(name: str, mesh, n1: int | None = None,
                            with_weighting: bool = True):
    """x (B, n) -> its negacyclic-weighted four-step spectrum (B, n1, n2),
    in JAX's global order, through the plain-torch shards; across ranks the
    rank's shard (B, n/k) ("sp" layout) -> its spectral rows (B, n1/k,
    n2)."""
    return _build(name, mesh, n1, with_weighting).fwd


def intt_fourstep_sharded_fn(name: str, mesh, n1: int | None = None,
                             with_weighting: bool = True):
    """The inverse of ``ntt_fourstep_sharded_fn``: (B, n1, n2) -> (B, n)."""
    return _build(name, mesh, n1, with_weighting).inv


def polymul_fourstep_sharded_fn(name: str, mesh, n1: int | None = None,
                                local: str = "auto"):
    """(x, y) -> z over (B, n) uint32 tensors, the transform split over the
    mesh's model axis.  ``local="mxu"`` and ``"auto"`` run the segment
    kernels (B11, B12, B16; their plain twins on CPU tensors) and never
    downgrade: a configuration the planner rejects raises ValueError.  A
    model axis of 1 is then the single-transform digit-matmul polymul (B5),
    as in the JAX package.  ``local="jnp"`` runs the plain-torch four-step
    with Stockham locals at every k.  Across ranks x, y and z are this
    rank's shards (B, n/k) in the "sp" layout.  Where ``n1`` is not given
    it is ``distributed.sp_n1(n)``: JAX's 2^(log2(n) // 2) up to n = 16384,
    n / 128 from 32768, where JAX's "auto" falls back to its jnp locals
    (its segment kernels refuse n2 > 128) and the port's kernels take the
    split whose n2 is 128; the product is the same at every split."""
    if n1 is None:
        n1 = sp_n1(get_params(name).n)
    if local == "jnp":
        return _build(name, mesh, n1).polymul
    if local not in ("auto", "mxu"):
        raise ValueError(f"unknown local {local!r}; available: 'auto', "
                         f"'mxu', 'jnp'")
    if mesh.model == 1:
        from ..models.polymul import polymul_fn
        return polymul_fn(name, "mxu")
    from .sharded_mxu import polymul_fourstep_mxu_fn
    return polymul_fourstep_mxu_fn(name, mesh, n1)
