"""Build the package's CUDA sources with nvcc and load them with ctypes.

``load_library()`` compiles every ``qtesla_tpu_torch/csrc/*.cu`` into one
shared library with a plain C interface, at first use, into ``build/`` at the
repository root (the parent of the package directory).  The file name carries
a hash of the sources and flags, so an edited source builds anew.  There is
no fallback: a missing ``nvcc`` or a failed build raises.

Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["NVCC_FLAGS", "Library", "load_library", "find_nvcc"]

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every launcher in csrc/ntt_fused.cu shares one C signature:
# (a, b, out, twiddles, batch, n, logn, q, r32, r32_shoup, one_shoup, stream)
LAUNCHERS = ("qt_polymul_fused", "qt_polymul_fixed_fused", "qt_ntt_fused",
             "qt_intt_fused")
_LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 4
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                    + [ctypes.c_uint32] * 4 + [ctypes.c_void_p])


@dataclass(frozen=True)
class Library:
    """The loaded kernels plus what the build reported."""

    cdll: ctypes.CDLL
    path: Path
    build_seconds: float      # 0.0 when an existing build was reused
    log: str                  # nvcc's output (ptxas register/smem report)

    def error_string(self, err: int) -> str:
        return self.cdll.qt_error_string(err).decode()


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (checked PATH, $CUDA_HOME, "
                       "/usr/local/cuda); the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def load_library() -> Library:
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    path = BUILD_DIR / f"libqtesla_tpu_torch_{_digest(sources)}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - start
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
        os.replace(tmp, path)
    cdll = ctypes.CDLL(str(path))
    for name in LAUNCHERS:
        fn = getattr(cdll, name)
        fn.argtypes = _LAUNCH_ARGTYPES
        fn.restype = ctypes.c_int
    cdll.qt_error_string.argtypes = [ctypes.c_int]
    cdll.qt_error_string.restype = ctypes.c_char_p
    return Library(cdll, path, seconds, log)
