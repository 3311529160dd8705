"""Build the package's CUDA sources with nvcc and load them with ctypes.

``load_library()`` compiles every ``qtesla_tpu_torch/csrc/*.cu`` into one
shared library with a plain C interface, at first use, into ``build/`` at the
repository root (the parent of the package directory): one nvcc per source,
all started together, then one link.  The file name carries a hash of the
sources, the headers (``*.cuh``) and the flags, so an edited source or header
builds anew.  There is no fallback: a missing ``nvcc`` or a failed build
raises.

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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
# the pass kernels (B1-B4 of csrc/ntt_fused.cu, the five pairings of
# csrc/ntt_pairings.cu): (a, b, out, twiddles, batch, n, logn, q, r32,
# r32_shoup, one_shoup, &plan, stream)
_PASSES = ([_P] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
           + [ctypes.c_uint32] * 4 + [_P, _P])
# csrc/pass_sweeps.cu: (x, y, z, scratch a, scratch b, twiddles, in-window
# powers, batch, n, logn, q, r32, r32_shoup, one_shoup, &plan, launch,
# stream)
_SWEEP = ([_P] * 7 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
          + [ctypes.c_uint32] * 4 + [_P, ctypes.c_int, _P])
# csrc/ntt_mxu.cu and csrc/ntt_mxu_split.cu: (a, b, out, wf, constf, wi,
# consti, twiddles, batch, &plan, stream)
_MXU = [_P] * 8 + [ctypes.c_longlong, _P, _P]
# csrc/sharded_mxu.cu, csrc/sharded_classes.cu and csrc/sp_column_split.cu:
# (a, b, out, w1, c1, w2, c2, twiddles, batch, k_local, &plan, stream)
_SP = [_P] * 8 + [ctypes.c_longlong, ctypes.c_int, _P, _P]

# every launcher symbol and its C signature
LAUNCHERS = {
    "qt_polymul_fused": _PASSES, "qt_polymul_fixed_fused": _PASSES,
    "qt_ntt_fused": _PASSES, "qt_intt_fused": _PASSES,
    "qt_pass_sweep": _SWEEP,
    "qt_polymul_mxu": _MXU, "qt_polymul_fixed_mxu": _MXU,
    "qt_ntt_mxu": _MXU, "qt_intt_mxu": _MXU,
    "qt_polymul_fixed_folded_mxu": _MXU,
    **{f"qt_{k}_mxu_split": _MXU
       for k in ("polymul", "polymul_fixed", "ntt", "intt",
                 "polymul_fixed_folded")},
    **{f"qt_polymul_pairing_{p}": _PASSES
       for p in ("gs_ct", "ct_ct", "gs_gs", "ct_gs", "stockham")},
    **{f"qt_sp_seg{s}": _SP
       for s in ("1", "2", "2_fixed", "2_fwd", "2_folded", "3", "1_classes",
                 "2_classes", "1_split", "3_split", "1_classes_split")},
}


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


def _sources(csrc: Path = CSRC_DIR) -> list[Path]:
    """The files the build reads: the .cu sources and the .cuh headers."""
    return sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")])


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> str:
    """Run the commands at once; their output, or RuntimeError naming the
    first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


@functools.lru_cache(maxsize=None)
def load_library() -> Library:
    sources = _sources()
    units = [s for s in sources if s.suffix == ".cu"]
    if not units:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    path = BUILD_DIR / f"libqtesla_tpu_torch_{_digest(sources)}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{path.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{u.stem}.o" for u in units]
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        start = time.perf_counter()
        try:
            log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(u)]
                        for u, o in zip(units, objs)])
            log += _run([[nvcc, "-shared", "-o", str(tmp),
                          *map(str, objs)]])
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        seconds = time.perf_counter() - start
        os.replace(tmp, path)
    cdll = ctypes.CDLL(str(path))
    for name, argtypes in LAUNCHERS.items():
        fn = getattr(cdll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    cdll.qt_error_string.argtypes = [ctypes.c_int]
    cdll.qt_error_string.restype = ctypes.c_char_p
    return Library(cdll, path, seconds, log)
