"""Exact-integer (Python int) oracles: the ground truth of the port's tests
and of ``chip_smoke.py``.

The port's own copy of the negacyclic product of ``qtesla_tpu/oracle.py``
(``negacyclic_schoolbook``, ``polymul_negacyclic_oracle``,
``all_ones_square_closed_form``), so that the port imports nothing of the
JAX package.  Python ints cannot overflow, so these deliberately slow
functions define bit-exactness for the kernels.
"""

from __future__ import annotations

import numpy as np

from .params import ParamSet

__all__ = ["negacyclic_schoolbook", "polymul_negacyclic_oracle",
           "all_ones_square_closed_form"]


def _as_int_list(x) -> list[int]:
    return [int(v) for v in np.asarray(x).reshape(-1)]


def negacyclic_schoolbook(x, y, ps: ParamSet) -> np.ndarray:
    """z = x*y mod (X^n + 1) mod q by schoolbook double loop."""
    n, q = ps.n, ps.q
    xv, yv = _as_int_list(x), _as_int_list(y)
    out = [0] * n
    for i in range(n):
        for j in range(n):
            k = i + j
            p = xv[i] * yv[j]
            if k < n:
                out[k] = (out[k] + p) % q
            else:
                out[k - n] = (out[k - n] - p) % q
    return np.array(out, dtype=np.uint64)


def polymul_negacyclic_oracle(x, y, ps: ParamSet) -> np.ndarray:
    return negacyclic_schoolbook(x, y, ps)


def all_ones_square_closed_form(ps: ParamSet) -> np.ndarray:
    """Negacyclic square of the all-ones polynomial: z[i] = (2i + 2 - n) mod
    q."""
    n, q = ps.n, ps.q
    return np.array([(2 * i + 2 - n) % q for i in range(n)], dtype=np.uint64)
