"""Parameter registry and exact-integer precompute for qTESLA NTT parameter
sets.

The port's own copy of ``qtesla_tpu/params.py``: the same ``ParamSet``, the
same five registered sets and the same ``get_params``,
``available_param_sets`` and ``register_param_set``, so that the port imports
nothing of the JAX package.  The two registries are separate: a set
registered at run time in one package is unknown to the other.  The tests
hold every derived constant and table equal to the JAX copy's.

Every root, twiddle table and Barrett/Shoup constant is derived from (n, q)
with exact Python integers.  Negacyclic psi-weighting is merged into the
twiddle tables (``psi_rev`` / ``ipsi_rev``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "ParamSet",
    "get_params",
    "register_param_set",
    "available_param_sets",
    "PARAM_SETS",
]


def _is_pow2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def _pow_mod(base: int, exp: int, mod: int) -> int:
    return pow(base, exp, mod)


def _factorize(m: int) -> list[int]:
    """Distinct prime factors of m (trial division; q-1 here is < 2^30)."""
    fs = []
    d = 2
    while d * d <= m:
        if m % d == 0:
            fs.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        fs.append(m)
    return fs


def _is_prime(m: int) -> bool:
    """Deterministic Miller-Rabin for m < 3.3e24 (bases up to 41)."""
    if m < 2:
        return False
    bases = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41)
    for p in bases:
        if m % p == 0:
            return m == p
    d, s = m - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in bases:
        x = pow(a, d, m)
        if x in (1, m - 1):
            continue
        for _ in range(s - 1):
            x = x * x % m
            if x == m - 1:
                break
        else:
            return False
    return True


def _find_generator(q: int) -> int:
    """Smallest generator of the multiplicative group Z_q^*; q must be
    prime (for a composite q the search need not end)."""
    if not _is_prime(q):
        raise ValueError(f"q={q} must be prime")
    phi = q - 1
    factors = _factorize(phi)
    g = 2
    while True:
        if all(_pow_mod(g, phi // f, q) != 1 for f in factors):
            return g
        g += 1


def bitrev_permutation(n: int) -> np.ndarray:
    """Bit-reversal permutation table (reference: constants.h:3-6 bitrev_tbl,
    NTT.cu:61-100), generated instead of hardcoded: the table of 2m is that
    of m doubled, then that of m doubled plus one."""
    r = np.zeros(1, dtype=np.uint32)
    while r.size < n:
        r = np.concatenate([r << 1, (r << 1) | 1])
    return r


def powers_mod(base: int, count: int, q: int) -> np.ndarray:
    """base^i mod q for i < count, int64, by blocked doubling: the next
    block is the first times base^(its start), every product below 2^60
    (q < 2^30)."""
    out = np.empty(count, dtype=np.int64)
    out[:1] = 1
    filled, step = 1, base % q
    while filled < count:
        k = min(filled, count - filled)
        out[filled:filled + k] = out[:k] * step % q
        filled += k
        step = step * step % q
    return out


def shoup_array(w: np.ndarray, q: int) -> np.ndarray:
    """floor(w * 2^32 / q) of each entry (w < q < 2^30), uint32."""
    return ((np.asarray(w).astype(np.int64) << 32) // q).astype(np.uint32)


def _shoup(w: int, q: int) -> int:
    """Shoup precomputed companion: floor(w * 2^32 / q), for the lane-parallel
    constant-operand mulmod (ops/modmul.py).  Replaces the reference's Barrett
    MIU constants (main.cuh:20-21) with a per-table-entry precompute."""
    assert 0 <= w < q
    return (w << 32) // q


@dataclass(frozen=True)
class ParamSet:
    """One qTESLA NTT parameter set with all derived constants and tables.

    Scalar fields are exact Python ints; table fields are numpy uint32
    arrays.
    """

    name: str
    n: int            # transform length (polynomial degree bound)
    q: int            # NTT-friendly prime, q ≡ 1 (mod 2n), q < 2^30
    # --- derived scalars ---
    g: int = field(init=False)        # generator of Z_q^*
    psi: int = field(init=False)      # primitive 2n-th root of unity (psi^n = -1)
    psi_inv: int = field(init=False)
    omega: int = field(init=False)    # primitive n-th root = psi^2
    omega_inv: int = field(init=False)
    n_inv: int = field(init=False)    # n^{-1} mod q
    logn: int = field(init=False)

    def __post_init__(self):
        n, q = self.n, self.q
        if not _is_pow2(n):
            raise ValueError(f"n={n} must be a power of two")
        if (q - 1) % (2 * n) != 0:
            raise ValueError(f"q={q} must satisfy q ≡ 1 (mod 2n), n={n}")
        if q >= 1 << 30:
            raise ValueError(f"q={q} must be < 2^30 for the int32-lane kernels")
        g = _find_generator(q)
        psi = _pow_mod(g, (q - 1) // (2 * n), q)
        assert _pow_mod(psi, n, q) == q - 1, "psi^n must be -1 mod q"
        object.__setattr__(self, "g", g)
        object.__setattr__(self, "psi", psi)
        object.__setattr__(self, "psi_inv", pow(psi, -1, q))
        object.__setattr__(self, "omega", (psi * psi) % q)
        object.__setattr__(self, "omega_inv", pow(psi * psi, -1, q))
        object.__setattr__(self, "n_inv", pow(n, -1, q))
        object.__setattr__(self, "logn", n.bit_length() - 1)

    # ------------------------------------------------------------------
    # Exact-integer table builders (cached).  numpy uint32 outputs.
    # ------------------------------------------------------------------

    @functools.cached_property
    def psi_powers(self) -> np.ndarray:
        """psi^i mod q for i < n, int64."""
        return powers_mod(self.psi, self.n, self.q)

    @functools.cached_property
    def ipsi_powers(self) -> np.ndarray:
        """psi^{-i} mod q for i < n, int64."""
        return powers_mod(self.psi_inv, self.n, self.q)

    @functools.cached_property
    def psi_rev(self) -> np.ndarray:
        """psi^bitrev(i) table for the merged-psi CT forward NTT.

        Subsumes the reference's Phi table + separate weighting pass
        (constants.h:13-16, NTT.cu:502-509)."""
        return self.psi_powers[self.bitrev_tbl].astype(np.uint32)

    @functools.cached_property
    def psi_rev_shoup(self) -> np.ndarray:
        return shoup_array(self.psi_rev, self.q)

    @functools.cached_property
    def ipsi_rev(self) -> np.ndarray:
        """psi^{-bitrev(i)} table for the merged-psi GS inverse NTT.

        Subsumes the reference's invPhi table (pre-fused with N^{-1} there,
        constants.h:19-27); here N^{-1} is folded into the *last stage* twiddles
        by the kernel-table builder instead (see stage_tables_inv)."""
        return self.ipsi_powers[self.bitrev_tbl].astype(np.uint32)

    @functools.cached_property
    def ipsi_rev_shoup(self) -> np.ndarray:
        return shoup_array(self.ipsi_rev, self.q)

    # --- classic omega twiddles (cyclic NTT variants: matrix, four-step) ---

    def omega_powers(self, length: int, inverse: bool = False) -> np.ndarray:
        """tf[i] = w^i (or w^{-i}) for the principal `length`-th root derived
        from this set's omega (reference: main.cu:118-146 runtime twiddle
        precompute, constants.h:29-35 tf0/ti0 tables)."""
        n, q = self.n, self.q
        assert _is_pow2(length) and length <= n and n % length == 0
        w = _pow_mod(self.omega, n // length, q)
        if inverse:
            w = pow(w, -1, q)
        return powers_mod(w, length, q).astype(np.uint32)

    def shoup_of(self, table: np.ndarray) -> np.ndarray:
        return shoup_array(table, self.q)

    @functools.cached_property
    def bitrev_tbl(self) -> np.ndarray:
        return bitrev_permutation(self.n)

    # --- scalar helpers exposed as uint32 for kernels ---

    @property
    def r32(self) -> int:
        """2^32 mod q — used by the generic (variable x variable) mulmod."""
        return (1 << 32) % self.q

    @property
    def r32_shoup(self) -> int:
        return _shoup(self.r32, self.q)

    @property
    def one_shoup(self) -> int:
        """Shoup companion of w=1: floor(2^32/q) — reduces any uint32 to [0,2q)."""
        return _shoup(1, self.q)

    @property
    def n_inv_shoup(self) -> int:
        return _shoup(self.n_inv, self.q)


# ----------------------------------------------------------------------
# Registry: all four qTESLA sets (generalized beyond the reference, which
# ships only qTESLA-III-speed — main.cuh:14-16) plus the reference's
# small-prime debug fixture (main.cuh:23-29).
# ----------------------------------------------------------------------

PARAM_SETS: dict[str, tuple[int, int]] = {
    "qtesla-i": (512, 4205569),
    "qtesla-iii-speed": (1024, 8404993),
    "qtesla-p-i": (1024, 343576577),
    "qtesla-p-iii": (2048, 856145921),
    "smallprime": (32, 65537),
}


def register_param_set(name: str, n: int, q: int) -> "ParamSet":
    """Register a custom NTT-friendly parameter set at runtime (the
    reference only offers two compile-time sets, main.cuh:7-30).  Validity
    (power-of-two n, prime q ≡ 1 mod 2n, q < 2^30) is checked by
    ParamSet.__post_init__; the registered name flows through every layer
    of the port (tables, pipelines, kernels)."""
    ps = ParamSet(name=name, n=n, q=q)   # validates before registering
    existing = PARAM_SETS.get(name)
    if existing is not None and existing != (n, q):
        raise ValueError(
            f"param set {name!r} already registered as {existing}")
    PARAM_SETS[name] = (n, q)
    get_params.cache_clear()
    return ps


@functools.lru_cache(maxsize=None)
def get_params(name: str) -> ParamSet:
    try:
        n, q = PARAM_SETS[name]
    except KeyError:
        raise KeyError(
            f"unknown param set {name!r}; available: {sorted(PARAM_SETS)}"
        ) from None
    return ParamSet(name=name, n=n, q=q)


def available_param_sets() -> list[str]:
    return sorted(PARAM_SETS)
