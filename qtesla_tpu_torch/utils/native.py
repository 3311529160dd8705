"""ctypes bindings for the port's native C++ oracle (``csrc/oracle.cpp``).

Counterpart of ``qtesla_tpu/utils/native.py``: the same six C entry points
behind the same five functions, ``native_available()`` and
``NativeOracleUnavailable``.  The source is the port's own copy.  At first
use it is compiled with the host compiler (``g++ -O2 -shared -fPIC``; no
``make``) into ``build/`` at the repository root, as ``utils/build.py``
places the CUDA library, under a name that carries a hash of the source and
the flags, so an edited source builds anew; nothing is written under
``csrc/``.  Every entry point raises ``NativeOracleUnavailable``, naming the
reason, when no compiler is found or the build fails; the callers then take
the big-int Python oracle (``oracle.py``).

Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["native_available", "negacyclic_schoolbook", "ntt_naive",
           "intt_naive", "negacyclic_schoolbook_ring", "polymul_ntt",
           "NativeOracleUnavailable", "CXX_FLAGS"]

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "csrc" / "oracle.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")


class NativeOracleUnavailable(RuntimeError):
    pass


def _library_path(build_dir: Path) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return build_dir / f"liboracle_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeOracleUnavailable(
            f"no host C++ compiler (g++) on PATH to build {path.name} from "
            f"{SOURCE}")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                       check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, path)
    except subprocess.CalledProcessError as e:
        raise NativeOracleUnavailable(
            f"g++ could not build {path.name}: {e.stderr}") from e
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeOracleUnavailable(
            f"could not build {path.name}: {e}") from e
    finally:
        tmp.unlink(missing_ok=True)


@functools.lru_cache(maxsize=1)
def _lib():
    path = _library_path(BUILD_DIR)
    if not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u32 = ctypes.c_uint32
    for name, argtypes in (
            ("oracle_negacyclic_schoolbook", [u32p, u32p, u32p, u32, u32]),
            ("oracle_negacyclic_schoolbook_batch",
             [u32p, u32p, u32p, u32, u32, u32]),
            ("oracle_ntt_naive", [u32p, u32p, u32, u32, u32]),
            ("oracle_intt_naive", [u32p, u32p, u32, u32, u32]),
            ("oracle_negacyclic_schoolbook_ring", [u32p, u32p, u32p, u32]),
            ("oracle_polymul_ntt", [u32p, u32p, u32p, u32, u32, u32])):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def native_available() -> bool:
    """Whether the oracle builds (or is built) and loads here."""
    try:
        _lib()
        return True
    except NativeOracleUnavailable:
        return False


def _u32c(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.uint32))


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _same_shape(x: np.ndarray, y: np.ndarray) -> None:
    if x.shape != y.shape:
        raise ValueError(f"operand shapes differ: {x.shape} vs {y.shape}")


def negacyclic_schoolbook(x, y, q: int) -> np.ndarray:
    """Batched schoolbook negacyclic product mod q: (..., n) arrays."""
    x, y = _u32c(x), _u32c(y)
    _same_shape(x, y)
    n = x.shape[-1]
    batch = int(np.prod(x.shape[:-1], dtype=np.int64)) if x.ndim > 1 else 1
    z = np.empty_like(x)
    _lib().oracle_negacyclic_schoolbook_batch(
        _ptr(x.reshape(-1)), _ptr(y.reshape(-1)), _ptr(z.reshape(-1)),
        batch, n, q)
    return z


def ntt_naive(x, q: int, omega: int) -> np.ndarray:
    """Cyclic NTT X[k] = sum_j x[j] omega^(jk) mod q of one (n,) row."""
    x = _u32c(x)
    out = np.empty_like(x)
    _lib().oracle_ntt_naive(_ptr(x), _ptr(out), x.shape[-1], q, omega)
    return out


def intt_naive(X, q: int, omega: int) -> np.ndarray:
    """The inverse of ``ntt_naive``."""
    X = _u32c(X)
    out = np.empty_like(X)
    _lib().oracle_intt_naive(_ptr(X), _ptr(out), X.shape[-1], q, omega)
    return out


def negacyclic_schoolbook_ring(x, y) -> np.ndarray:
    """Negacyclic product of one (n,) row pair over Z_{2^32-1}."""
    x, y = _u32c(x), _u32c(y)
    _same_shape(x, y)
    z = np.empty_like(x)
    _lib().oracle_negacyclic_schoolbook_ring(_ptr(x), _ptr(y), _ptr(z),
                                             x.shape[-1])
    return z


def polymul_ntt(x, y, q: int, psi: int) -> np.ndarray:
    """Negacyclic product of one (n,) row pair through psi-weighted naive
    NTTs, a path independent of the schoolbook one."""
    x, y = _u32c(x), _u32c(y)
    _same_shape(x, y)
    z = np.empty_like(x)
    _lib().oracle_polymul_ntt(_ptr(x), _ptr(y), _ptr(z), x.shape[-1], q, psi)
    return z
