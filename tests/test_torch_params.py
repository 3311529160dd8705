"""The port's own parameter registry and oracle (``qtesla_tpu_torch/params.py``,
``qtesla_tpu_torch/oracle.py``) against the JAX package's, and the port's
import isolation.

- every derived constant and table of the 5 registered sets equals JAX's;
- the negacyclic oracle and the all-ones closed form equal JAX's on one
  numpy-seeded row per set;
- the two registries are separate, and the port's models take a JAX
  ``ParamSet`` of a set both registries know;
- importing the port (every module) and ``chip_smoke`` loads neither jax nor
  any ``qtesla_tpu`` module (checked in a subprocess).

Tolerance: none (exact integers)."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qtesla_tpu import oracle as JO
from qtesla_tpu import params as JPARAMS
from qtesla_tpu_torch import oracle as TO
from qtesla_tpu_torch import params as TPARAMS
from qtesla_tpu_torch.models import polymul as TP

REPO = Path(__file__).resolve().parent.parent
SETS = ["smallprime", "qtesla-i", "qtesla-iii-speed", "qtesla-p-i",
        "qtesla-p-iii"]
_SCALARS = ("name", "n", "q", "g", "psi", "psi_inv", "omega", "omega_inv",
            "n_inv", "logn", "r32", "r32_shoup", "one_shoup", "n_inv_shoup")
_TABLES = ("psi_rev", "psi_rev_shoup", "ipsi_rev", "ipsi_rev_shoup",
           "bitrev_tbl")


def test_registries_hold_the_same_sets():
    """The five shipped sets have the same (n, q) in both registries, and the
    port's registry ships exactly those.  Other tests of the same process
    register sets in either package and leave them there, so the shipped
    registry is read from a fresh copy of the port's module."""
    for name in SETS:
        assert TPARAMS.PARAM_SETS[name] == JPARAMS.PARAM_SETS[name], name
    for mod in (TPARAMS, JPARAMS):
        assert set(SETS) <= set(mod.available_param_sets())
    spec = importlib.util.spec_from_file_location("_shipped_params",
                                                  TPARAMS.__file__)
    shipped = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = shipped      # dataclasses look the module up
    try:
        spec.loader.exec_module(shipped)
    finally:
        del sys.modules[spec.name]
    assert shipped.available_param_sets() == sorted(SETS)
    assert shipped.PARAM_SETS == {n: TPARAMS.PARAM_SETS[n] for n in SETS}


@pytest.mark.parametrize("name", SETS)
def test_params_match_jax(name):
    mine, ref = TPARAMS.get_params(name), JPARAMS.get_params(name)
    assert type(mine) is not type(ref)
    for f in _SCALARS:
        assert getattr(mine, f) == getattr(ref, f), f
    for f in _TABLES:
        got, want = getattr(mine, f), getattr(ref, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for length in (2, mine.n // 4, mine.n):
        for inverse in (False, True):
            np.testing.assert_array_equal(
                mine.omega_powers(length, inverse),
                ref.omega_powers(length, inverse))
    np.testing.assert_array_equal(mine.shoup_of(mine.psi_rev[:8]),
                                  ref.shoup_of(ref.psi_rev[:8]))


@pytest.mark.parametrize("n,q,match", [(48, 97, "power of two"),
                                       (32, 97, "2n"),
                                       (4, 1073741833, "2\\^30")])
def test_param_validation_matches_jax(n, q, match):
    for mod in (TPARAMS, JPARAMS):
        with pytest.raises(ValueError, match=match):
            mod.ParamSet(name="bad", n=n, q=q)


@pytest.mark.parametrize("name", SETS)
def test_oracle_matches_jax(name):
    ps = TPARAMS.get_params(name)
    rng = np.random.default_rng(41)
    x, y = rng.integers(0, ps.q, (2, ps.n), dtype=np.uint32)
    got = TO.polymul_negacyclic_oracle(x, y, ps)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(
        got, JO.polymul_negacyclic_oracle(x, y, JPARAMS.get_params(name)))
    np.testing.assert_array_equal(
        TO.all_ones_square_closed_form(ps),
        JO.all_ones_square_closed_form(JPARAMS.get_params(name)))
    ones = np.ones(ps.n, dtype=np.uint32)
    if ps.n <= 512:
        np.testing.assert_array_equal(TO.negacyclic_schoolbook(ones, ones, ps),
                                      TO.all_ones_square_closed_form(ps))


def test_registries_are_separate():
    name = "port-only-64"
    TPARAMS.register_param_set(name, 64, 257)
    try:
        assert name in TPARAMS.available_param_sets()
        assert name not in JPARAMS.available_param_sets()
        assert TPARAMS.get_params(name).n == 64
        with pytest.raises(KeyError):
            JPARAMS.get_params(name)
        with pytest.raises(ValueError, match="already registered"):
            TPARAMS.register_param_set(name, 128, 257)
    finally:
        del TPARAMS.PARAM_SETS[name]
        TPARAMS.get_params.cache_clear()
    with pytest.raises(KeyError, match="unknown param set"):
        TPARAMS.get_params(name)


def test_models_take_either_param_set():
    """A ParamSet of either package selects the port's tables; one whose
    (n, q) differs from the port's registry raises."""
    rng = np.random.default_rng(42)
    x, y = (torch.from_numpy(rng.integers(0, 65537, (2, 32), dtype=np.uint32))
            for _ in range(2))
    z = TP.polymul_negacyclic(x, y, "smallprime")
    for ps in (TPARAMS.get_params("smallprime"),
               JPARAMS.get_params("smallprime")):
        assert torch.equal(TP.polymul_negacyclic(x, y, ps), z)
    other = JPARAMS.ParamSet(name="smallprime", n=64, q=65537)
    with pytest.raises(ValueError, match="registered as"):
        TP.polymul_negacyclic(x, y, other)
    with pytest.raises(TypeError, match="param-set"):
        TP.polymul_negacyclic(x, y, 12)


_ISOLATION = """
import importlib, pkgutil, sys
import qtesla_tpu_torch
for m in pkgutil.walk_packages(qtesla_tpu_torch.__path__, "qtesla_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "qtesla_tpu"))
assert not bad, bad
print("ok", len([m for m in sys.modules if m.startswith("qtesla_tpu_torch")]))
"""


def test_port_and_chip_smoke_load_nothing_of_jax():
    proc = subprocess.run([sys.executable, "-c", _ISOLATION], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok ")
    assert int(proc.stdout.split()[1]) >= 15
