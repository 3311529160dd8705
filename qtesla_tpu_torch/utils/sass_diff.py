"""Compare the compiled kernels of two source trees, instruction by instruction.

    python -m qtesla_tpu_torch.utils.sass_diff OLD_TREE NEW_TREE

Each tree is a checkout of this repository.  In a fresh Python process each
tree builds its kernels into its own ``build/`` (``utils/build.py``); then
``cuobjdump -sass`` disassembles both libraries, and for every kernel
instantiation (``mxu_kernel<mode>``,
``polymul_stream_kernel<classes,mode>``, ``sp_kernel<mode,threads>`` (in a
tree before B13, B14 and B15 moved: B13 3, B14 4, B15 5),
``classes_kernel<mode,threads>`` (B17 in such a tree),
``column_compact_kernel<threads,shared,direction>`` (B11 0, B16 1, B17 2),
their split form's ``column_tile_kernel<class_sums>`` (B11 and B16 0, B17
1),
``seg2_compact_kernel<mode,shared,slots,full>`` (B12 0, B18 1, B13 2, B15
3, B14 4), B2's and B3's ``transform_pass_kernel<fwd,radix,passes,logn>``
(B2 fwd 1, B3 0; ``<..,cluster>`` once they took the cluster form),
B1-B4's ``polymul_fused_kernel`` (B1's ``polymul_pass_kernel<radix,
passes,logn>`` in a tree after it took register passes, and
``polymul_pass_kernel<radix,passes,logn,operands>`` once B4 joined it,
B1 2 and B4 1, ``<..,operands,cluster>`` once the pass kernels took the
cluster form: a row across the blocks of a cluster 1, the block form 0), ``polymul_fixed_fused_kernel`` (B4 before it did),
``ntt_fused_kernel`` and ``intt_fused_kernel`` (B2 and B3 before they took
register passes), B10's pairings,
``pairing_kernel<fwd,inv>`` in a tree before they took register passes
and ``pass_kernel<fwd,inv,radix,passes,logn>`` after (DIF 0, DIT 1,
Stockham 2), ``<..,logn,cluster>`` once they took the cluster form) it prints the SASS instruction count of each tree and the
opcodes whose counts differ; a bool template argument of an older tree
reads as 0 or 1.  In a
tree before B12 and B9 took those kernels, B5's
``polymul_stream_kernel<classes>`` is compared as
``polymul_stream_kernel<classes,0>`` and B18's
``seg2_classes_compact_kernel<shared,full>`` as
``seg2_compact_kernel<1,shared,3,full>``; in a tree before B4 took B1's
kernel, B1's ``polymul_pass_kernel<radix,passes,logn>`` as
``polymul_pass_kernel<radix,passes,logn,2>``.  A kernel one tree has and
the other has not (B9's ``polymul_stream_kernel<..,1>`` against
``mxu_kernel<4>``, B12's ``seg2_compact_kernel<0,..>`` against
``sp_kernel<1,..>``) counts 0 on the side that lacks it; a kernel of the
old tree whose work the new tree runs in another kernel (``SUCCESSORS``:
B8's ``mxu_kernel<1>`` and B6's ``mxu_kernel<2>`` of the tree before they
moved, B9's ``mxu_kernel<4>`` and B7's ``mxu_kernel<3>`` of the trees
before they did, all now modes of the stream kernel, B4's
``polymul_fixed_fused_kernel`` of the tree before it took the pass kernel,
B2's ``ntt_fused_kernel`` and B3's ``intt_fused_kernel`` of the trees before
they took ``transform_pass_kernel<1,..>`` and ``<0,..>``, and B15's
``sp_kernel<5,threads>`` and B14's ``sp_kernel<4,threads>`` of the trees
before they took ``seg2_compact_kernel<3,..>`` and ``<4,..>``) is then
printed once more
beside the new kernel's instantiations, one per class count or length.  A refactor of
shared device code that leaves a kernel's count and opcodes as they were
compiled to the same work; ``utils/ab_timing.py`` times what it did not.
It needs the CUDA toolkit (``cuobjdump`` beside ``nvcc``).
"""

from __future__ import annotations

import collections
import re
import subprocess
import sys
from pathlib import Path

from .build import find_nvcc

__all__ = ["main", "kernel_sass", "issue_bound_ms"]

_BUILD = """
import sys
sys.path.insert(0, {tree!r})
from qtesla_tpu_torch.utils.build import load_library
print(load_library().path)
"""
_KERNEL = re.compile(r"(mxu_kernel|polymul_stream_kernel|sp_kernel|"
                     r"classes_kernel|column_compact_kernel|"
                     r"column_tile_kernel|"
                     r"seg2_classes_compact_kernel|seg2_compact_kernel|"
                     r"pairing_kernel|polymul_pass_kernel|"
                     r"transform_pass_kernel|pass_kernel|"
                     r"polymul_fused_kernel|"
                     r"polymul_fixed_fused_kernel|intt_fused_kernel|"
                     r"ntt_fused_kernel)"
                     r"(?:I((?:L[ib]\d+E)+)E)?")
_ARG = re.compile(r"L[ib](\d+)E")
# kernels an older tree compiled -> (kernel, the start and end of the
# names of the instantiations that run it now)
_STREAM = "polymul_stream_kernel<"
SUCCESSORS = {"mxu_kernel<1>": ("B8", _STREAM, ",2>"),
              "mxu_kernel<2>": ("B6", _STREAM, ",3>"),
              "mxu_kernel<3>": ("B7", _STREAM, ",4>"),
              "mxu_kernel<4>": ("B9", _STREAM, ",1>"),
              "polymul_fixed_fused_kernel": ("B4", "polymul_pass_kernel<",
                                             ",1,0>"),
              "ntt_fused_kernel": ("B2", "transform_pass_kernel<1,", ">"),
              "intt_fused_kernel": ("B3", "transform_pass_kernel<0,", ">"),
              **{f"sp_kernel<5,{t}>": ("B15", "seg2_compact_kernel<3,", ">")
                 for t in (128, 256, 512)},
              **{f"sp_kernel<4,{t}>": ("B14", "seg2_compact_kernel<4,", ">")
                 for t in (128, 256, 512)}}


# the pass kernels' template arguments once they took the cluster form
# (its bool last): a tree before it compiled the block form alone
_PASS_ARGS = {"polymul_pass_kernel": 5, "transform_pass_kernel": 5,
              "pass_kernel": 6}


def _name(m: re.Match) -> str:
    """The instantiation as kernel<arg,...>; B5's polymul_stream_kernel<d>
    as polymul_stream_kernel<d,0>, B1's polymul_pass_kernel<R,P,L> as
    polymul_pass_kernel<R,P,L,2>, a pass kernel of a tree before the
    cluster form as its block form (the bool last 0) and B18's
    seg2_classes_compact_kernel<s,f> as seg2_compact_kernel<1,s,3,f>."""
    kernel, args = m.group(1), _ARG.findall(m.group(2) or "")
    if not args:
        return kernel
    if kernel == "polymul_stream_kernel" and len(args) == 1:
        args = args + ["0"]
    if kernel == "polymul_pass_kernel" and len(args) == 3:
        args = args + ["2"]
    if len(args) == _PASS_ARGS.get(kernel, 0) - 1:
        args = args + ["0"]
    if kernel == "seg2_classes_compact_kernel":
        kernel, args = "seg2_compact_kernel", ["1", args[0], "3", args[1]]
    return f"{kernel}<{','.join(args)}>"
# an instruction line: its offset (four hex digits or more: a kernel past
# 64 KiB of code has five), then the instruction
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


# The H100's SM issues one warp instruction a clock from each of its 4
# schedulers; 32-bit integer work runs on two pipes of 16 lanes a
# scheduler, half a warp instruction a clock each (the CUDA C++ Programming
# Guide's throughput table, compute capability 9.0: 64 results a clock an
# SM): the FMA pipe takes the IMAD family (the compiler moves adds and
# moves there as IMAD.IADD and IMAD.MOV to balance the two), the ALU pipe
# the adds, logic, shifts, compares, selects and min/max.
_FMA = re.compile(r"^(IMAD|HFMA2|FFMA|FMUL|FADD)(\.|$)")
_ALU = re.compile(r"^(IADD3|VIADD|VIADDMNMX|LEA|LOP3|SHF|SEL|ISETP|VIMNMX|"
                  r"IMNMX|PRMT|BREV|FLO|POPC|IABS|MOV|PLOP3|P2R|R2P)(\.|$)")


def issue_bound_ms(sass: list[str], rows: int, threads_per_row: int,
                   sms: int, clock_hz: float) -> tuple[float, dict]:
    """The least time (ms) of ``rows`` rows through a kernel whose every
    instruction runs once a warp and row (straight-line code,
    ``threads_per_row`` threads a row), and its instruction counts: the
    larger of all instructions over 4 a clock an SM and each integer
    pipe's over 2."""
    counts = {"total": len(sass),
              "fma": sum(1 for op in sass if _FMA.match(op)),
              "alu": sum(1 for op in sass if _ALU.match(op))}
    warps = rows * threads_per_row / 32
    clocks = warps * max(counts["total"] / 4, counts["fma"] / 2,
                         counts["alu"] / 2) / sms
    return clocks / clock_hz * 1e3, counts


def _library(tree: Path) -> str:
    proc = subprocess.run([sys.executable, "-c", _BUILD.format(tree=str(tree))],
                          cwd=tree, capture_output=True, text=True, check=True)
    return proc.stdout.strip().splitlines()[-1]


def kernel_sass(library: str) -> dict[str, list[str]]:
    """Kernel instantiation -> its SASS instructions (predicate dropped)."""
    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", library],
                          capture_output=True, text=True, check=True).stdout
    kernels, current = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            m = _KERNEL.search(line)
            current = _name(m) if m else None
            if current:
                kernels[current] = []
        elif current and (m := _INSTR.search(line)):
            kernels[current].append(
                next((t for t in m.group(1).split() if not t.startswith("@")),
                     ""))
    return kernels


def main(argv: list[str]) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    old, new = (kernel_sass(_library(Path(t).resolve())) for t in argv)
    for name in sorted(set(old) | set(new)):
        a, b = (collections.Counter(k.get(name, [])) for k in (old, new))
        diff = {op: b[op] - a[op] for op in sorted(set(a) | set(b))
                if a[op] != b[op]}
        top = sorted(diff.items(), key=lambda t: -abs(t[1]))[:8]
        print(f"{name}: old {sum(a.values())}, new {sum(b.values())}"
              + (f"; {dict(top)}" if top else ""))
    for name, (label, start, end) in SUCCESSORS.items():
        if name in old and name not in new:
            now = sorted(k for k in new
                         if k.startswith(start) and k.endswith(end))
            print(f"{label}: old {name} {len(old[name])}, new " + ", ".join(
                f"{k} {len(new[k])}" for k in now))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
