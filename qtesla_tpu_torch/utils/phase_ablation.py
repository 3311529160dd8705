"""Cut digit-matmul kernels down phase by phase and time what is left.

    python -m qtesla_tpu_torch.utils.phase_ablation [--sp K] TREE KERNEL...

``TREE`` is a checkout of this repository (this one, or a parent commit
unpacked with ``git archive``).  Its ``qtesla_tpu_torch`` package is copied
to ``build/ablation/`` of the current directory and its CUDA sources are
patched there with ``#if QT_ABL`` guards; the sources of ``TREE`` itself
carry no such switch.  For each level a fresh Python process builds the copy
with ``-DQT_ABL=<level>`` and times the named kernels (keys of the
``KERNELS`` registries: ``sp_seg1``, ``sp_seg2_classes``, ``polymul_mxu``,
...) at qtesla-iii-speed, B = 32768, model axis K (default 4) for the
sequence-parallel ones, CUDA events, 3 warmup then 20 timed calls:

    0  load and store only
    1  + the wide stages (and the pointwise product of the row segments)
    2  + the digit split
    3  + the products, every table fragment a register constant
    4  + the table reads
    5  + the recombination: the whole kernel

Levels below 5 compute wrong values; only their times mean anything.  The
difference of two neighbouring levels is what the added phase costs with
everything before it in place.  The patches cover the compact building
blocks of ``csrc/mxu_compact.cuh`` (B11-B18), the row segment kernel of
B12-B15 and B18 (B13's pointwise product, p2i split and second product have
patches of their own), the column kernel of B11, B16 and B17 (B17 has no
recombination, so level 5 adds nothing to it; its staged store of the class
sums counts with load and store) and
the streaming kernel of B5-B9 in ``csrc/ntt_mxu.cu``, where level 3 still
runs the ring of stages but copies no bytes.  The patches of the streaming
kernel sit in the code its five modes share, so they take apart B6, B7 and
B8 as they do B5 and B9.  The patch set follows the tree it is
given as far back as the tree of the commit before B12 and B9 took these
designs: there the row segment kernel (B18 alone) lies in
``csrc/sharded_classes.cu``, and the patches of the dense building blocks
that ``csrc/mxu_block.cuh`` held until B14 took the row segment kernel take
apart B12 (a mode of the dense segment kernel) and B9 (a mode of
``mxu_kernel``); in a tree before B6, B7 and B8 moved to the streaming
kernel they take those apart as modes of ``mxu_kernel``, in a tree before
B13 and B17 moved to the compact bodies, B13 as a mode of the dense segment
kernel and B17 through ``mxu_block.cuh``, and in a tree before B14 and B15
moved, those two as modes of the dense segment kernel.  A patch of code every such tree has fails the run when its anchor is
missing; the patches of code one tree has and another has not (``OPTIONAL``)
are applied where their anchor is found.

    python -m qtesla_tpu_torch.utils.phase_ablation --passes TREE

takes apart the pass kernels instead (B1-B4 and the five pairings,
``csrc/pass_stages.cuh``, ``csrc/ntt_fused.cu``), each under
``passes.kernel_plan`` at q30 and 128 MiB an operand (``PASS_RINGS``: n =
16384, the block form, to 131072, B2 and B3 to 262144), levels
``PASS_LEVELS``:

    0  load and store only (the pointwise product, the psi weighting)
    1  + the butterflies, every twiddle a value made in registers
    2  + the twiddle reads
    3  + the exchanges inside a block (the cluster form's crossing
         exchanges left out, and in a tree whose crossing exchanges push
         into the reading block, every cluster barrier)
    4  + the crossing exchanges: the whole kernel

and prints each kernel's registers and spills (``-Xptxas -v``).  It needs a
CUDA device.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

__all__ = ["main", "patch_sources", "LEVELS", "PASS_LEVELS", "PASS_RINGS"]

LEVELS = (0, 1, 2, 3, 4, 5)
PASS_LEVELS = (0, 1, 2, 3, 4)
# (log2 n, q, rows, kinds) of each ring the pass kernels are timed at: q30
# where it divides, 128 MiB an operand
PASS_RINGS = (
    (14, 1073479681, 2048, ("B1", "B4", "B2", "B3", "gs_ct", "ct_ct",
                            "gs_gs", "ct_gs", "stockham")),
    (15, 1073479681, 1024, ("B1", "B4", "B2", "B3", "gs_ct", "ct_ct",
                            "gs_gs", "ct_gs", "stockham")),
    (16, 1073479681, 512, ("B1", "B4", "B2", "B3", "gs_ct", "ct_ct",
                           "gs_gs", "ct_gs", "stockham")),
    (17, 786433, 256, ("B1", "B4", "B2", "B3", "gs_ct", "ct_ct", "gs_gs",
                       "ct_gs", "stockham")),
    (18, 7340033, 128, ("B2", "B3")))


def _guard(cond: str, body: str, other: str | None = None) -> str:
    out = f"#if {cond}\n{body}\n"
    if other is not None:
        out += f"#else\n{other}\n"
    return out + "#endif\n"


# (file, anchor, replacement): the anchor is exact source text
_DENSE_SPLIT = """    zero_depth_pad(planes, rows, ks, din * bw, K);
    for (int b = 0; b < nb; ++b) {
"""
_DENSE_MMA = """        mma_classes(planes, rows, ks, w + b * w_step, K, bw, p.d,
                    [&](int lt, const int (&acc)[2][kMaxClasses][4]) {
                        recombine_tile(data + b * bw, rows, len, lt, acc, cb,
                                       kb, p);
                    });
"""
_DENSE_LOAD = """                        bf[st][j] = __ldg(reinterpret_cast<const uint2*>(
                            wb + static_cast<size_t>(j * bw + lt * 8 + g) * K +
                            k0 + st * 32 + tig * 8));
"""
_DENSE_RECOMBINE = """                uint32_t v = __ldg(cb + o) + kb;                      // < 2q
#pragma unroll
                for (int j = 0; j < kMaxClasses; ++j) {
                    if (j < d) {
                        const uint32_t t =
                            static_cast<uint32_t>(acc[mm][j][e]) + kClassBias;
                        v = csub(v + shoup_lazy(t, p.pw[j], p.pw_sh[j], q),
                                 q2);                                 // < 2q
                    }
                }
                out[r * len + o] = csub(v, q);
"""
_RAW_STORE = """                uint32_t v = 0;
#pragma unroll
                for (int j = 0; j < kMaxClasses; ++j)
                    if (j < d) v ^= static_cast<uint32_t>(acc[mm][j][e]);
                out[r * len + o] = v + (q2 & 1u);
"""
# B13's pointwise product in a tree before B13 took the row segment kernel
# (and the dense B12's, in a tree before B12 took it)
_SEG2_POINTWISE = """        for (int idx = threadIdx.x; idx < tb * nloc; idx += blockDim.x)
            data[idx] = mulmod_barrett(data[idx], other[idx & mask], m);
"""
DENSE_PATCHES = (
    ("mxu_block.cuh", _DENSE_SPLIT,
     _guard("QT_ABL < 2", "    return;") + _DENSE_SPLIT),
    ("mxu_block.cuh", _DENSE_MMA, _guard("QT_ABL >= 3", _DENSE_MMA)),
    ("mxu_block.cuh", _DENSE_LOAD, _guard(
        "QT_ABL == 3",
        "                        bf[st][j] = make_uint2(0x01010101u, "
        "0x01010101u);", _DENSE_LOAD)),
    ("mxu_block.cuh", _DENSE_RECOMBINE,
     _guard("QT_ABL < 5", _RAW_STORE, _DENSE_RECOMBINE)),
    ("sharded_mxu.cu", _SEG2_POINTWISE,
     _guard("QT_ABL >= 1", _SEG2_POINTWISE)),
)
# B11, B16, B12 and B18 on the compact building blocks
_C_SPLIT = "    const int kbs = compact_block_stride(c.kp), lw = c.ls - 2;\n"
_C_MMA = "    const int mt = (rows + 15) >> 4;           // 1 or 2\n"
_C_DEPTH = "        for (int k0 = 0; k0 < kp; k0 += 32 * kSteps) {\n"
_C_LOAD = "    if (kSmemTables) return *reinterpret_cast<const uint2*>(p);\n"
_C_RECOMBINE = """    uint32_t v = start;                                               // < 2q
#pragma unroll
    for (int j = 0; j < kMaxClasses; ++j) {
        if (j < d) {
            const uint32_t t = static_cast<uint32_t>(sum(j)) + kClassBias;
            v = csub(v + shoup_lazy(t, p.pw[j], p.pw_sh[j], q), q2);  // < 2q
        }
    }
    return csub(v, q);
"""
_C_RAW_VALUE = """    uint32_t v = start & (q2 & 1u);
#pragma unroll
    for (int j = 0; j < kMaxClasses; ++j)
        if (j < d) v ^= static_cast<uint32_t>(sum(j));
    return v;"""
# B11 and B16 in one body (column_compact_kernel)
_C_FWD_WIDE = ("        if (!kInverse) qt::fwd_wide(data, tb, p.logm, p.llanes, "
               "p.lr, tw, p.q);\n")
_C_INV_WIDE = ("        if (kInverse) qt::inv_wide(data, tb, p.logm, p.llanes, "
               "p.lr, tw, p.q);\n")
_C_STORE_PLANES = "    if (lb == 8) {\n        const uint32_t lo01"
_C_DEPTH_A = "            for (int k0 = 0; k0 < ca.kp; k0 += 32) {\n"
_C_DEPTH_B = "            for (int k0 = 0; k0 < cb.kp; k0 += 32) {\n"
_C_POINTWISE = """                    zz[c] = static_cast<int32_t>(mulmod_barrett(vx, vy, m) +
                                                 p.add2);
"""
_C_POINTWISE_SPLIT = "                for (int i = 0; i < p.din2; ++i) {\n"
# B13 in the row segment kernel: its pointwise product against the
# spectrum, its p2i split and its second product's depth loop
_F_POINTWISE = """                            zf[e][c] = static_cast<int32_t>(
                                mulmod_barrett(v, a, m) + p.add2);
"""
_F_SPLIT = "                        for (int i = 0; i < p.din2; ++i)\n"
_F_DEPTH = "                for (int k2 = 0; k2 < cb.kp; k2 += 32) {\n"

COMPACT_PATCHES = (
    ("mxu_compact.cuh", _C_SPLIT,
     _guard("QT_ABL < 2", "    return;") + _C_SPLIT),
    # below level 3 the depth loop runs no step; the epilogue still stores
    ("mxu_compact.cuh", _C_MMA,
     _C_MMA + "    const int kp_abl = QT_ABL < 3 ? 0 : c.kp;\n"),
    ("mxu_compact.cuh", _C_DEPTH, _C_DEPTH.replace("< kp;", "< kp_abl;")),
    ("mxu_compact.cuh", _C_LOAD, _guard(
        "QT_ABL == 3", "    return make_uint2(0x01010101u, 0x01010101u);")
     + _C_LOAD),
    ("mxu_compact.cuh", _C_RECOMBINE,
     _guard("QT_ABL < 5", _C_RAW_VALUE, _C_RECOMBINE)),
    # the row segment kernel splits through store_planes alone: below level
    # 2 one word a thread keeps its loads alive (B11's split has returned by
    # then)
    ("mxu_compact.cuh", _C_STORE_PLANES, _guard(
        "QT_ABL < 2", "    pr[0] = a[0] ^ a[1] ^ a[2] ^ a[3];\n    return;")
     + _C_STORE_PLANES),
)
# the row segment kernel (B12 and B18; B18 alone in a tree before B12 took
# its body), in the file ROW_SOURCES names first of those the tree has
ROW_SOURCES = ("seg2_compact.cuh", "sharded_classes.cu")
ROW_PATCHES = (
    (_C_DEPTH_A,
     _C_DEPTH_A.replace("< ca.kp;", "< (QT_ABL < 3 ? 0 : ca.kp);")),
    (_C_DEPTH_B,
     _C_DEPTH_B.replace("< cb.kp;", "< (QT_ABL < 3 ? 0 : cb.kp);")),
    (_C_POINTWISE, _guard(
        "QT_ABL >= 1", _C_POINTWISE,
        "                    zz[c] = static_cast<int32_t>(vx + vy);")),
    (_C_POINTWISE_SPLIT,
     _C_POINTWISE_SPLIT.replace("i < p.din2;",
                                "i < (QT_ABL < 2 ? 1 : p.din2);")),
    (_F_POINTWISE, _guard(
        "QT_ABL >= 1", _F_POINTWISE,
        "                            zf[e][c] = static_cast<int32_t>(v + a);"
    )),
    (_F_SPLIT, _F_SPLIT.replace("i < p.din2;",
                                "i < (QT_ABL < 2 ? 1 : p.din2);")),
    (_F_DEPTH, _F_DEPTH.replace("< cb.kp;", "< (QT_ABL < 3 ? 0 : cb.kp);")),
)
# B11, B16 and B17 in column_compact_kernel
COLUMN_PATCHES = (
    ("sharded_mxu.cu", _C_FWD_WIDE, _guard("QT_ABL >= 1", _C_FWD_WIDE)),
    ("sharded_mxu.cu", _C_INV_WIDE, _guard("QT_ABL >= 1", _C_INV_WIDE)),
)
# anchors in code that one tree has and another has not: the dense
# building blocks of mxu_block.cuh (gone once B14 took the row segment
# kernel), B13 as a mode of the dense segment kernel (and the dense B12),
# or B13 in the row segment kernel
OPTIONAL = (_DENSE_SPLIT, _DENSE_MMA, _DENSE_LOAD, _DENSE_RECOMBINE,
            _SEG2_POINTWISE, _F_POINTWISE, _F_SPLIT, _F_DEPTH)
# B5-B9 in polymul_stream_kernel: below level 4 the producer arrives on
# each stage's barrier without copying, so the ring still paces the MMA
# warps; B5's and B8's pointwise products sit in the forward epilogue, and
# below level 1 they are a xor; the recombination is mxu_compact.cuh's
# recombine_value.  The wide stages read as the _B6 anchors in a tree
# before B7 took the kernel (B7 skips the forward ones and stores from the
# inverse ones' registers).
_S_FWD_WIDE = ("            if constexpr (MODE != kIntt)\n"
               "                wide_stages<false>(data, rows, p, tw);\n")
_S_FWD_WIDE_B6 = "            wide_stages<false>(data, rows, p, tw);\n"
_S_INV_WIDE = ("            if (wide_stages<true, MODE == kIntt>(data, tb, "
               "p, tw, z + base,\n" + " " * 49 + "live))\n"
               "                continue;\n")
_S_INV_WIDE_B6 = "            wide_stages<true>(data, tb, p, tw);\n"
_S_POINTWISE = "    return mulmod_barrett(a, b, m);\n"
_S_SPLIT = ("        split_packed<Team>(data, nr, p.n, p.bw, b, planes, ks, din, "
            "lb, add);\n")
_S_MMA = "            if (mma_warp) {\n                const int8_t* sb"
_S_LOAD = """                    bv[j] = *reinterpret_cast<const uint4*>(
                        sb + j * 32 * kStageLane);
"""
_S_COPY = "                mbar_expect_tx(full + rg.slot, stage_bytes);\n"
STREAM_PATCHES = (
    ("ntt_mxu.cu", _S_POINTWISE, _guard("QT_ABL >= 1", _S_POINTWISE,
                                        "    return a ^ b;")),
    ("ntt_mxu.cu", _S_SPLIT, _guard("QT_ABL >= 2", _S_SPLIT)),
    ("ntt_mxu.cu", _S_MMA, _S_MMA.replace("(mma_warp)",
                                          "(mma_warp && QT_ABL >= 3)")),
    ("ntt_mxu.cu", _S_LOAD, _guard(
        "QT_ABL == 3",
        "                    bv[j] = make_uint4(0x01010101u, 0x01010101u, "
        "0x01010101u, 0x01010101u);", _S_LOAD)),
    ("ntt_mxu.cu", _S_COPY, _guard(
        "QT_ABL < 4",
        "                mbar_arrive(full + rg.slot);\n"
        "                if (false)",
        _S_COPY)),
)


# the pass kernels: the exchanges (pass_stages.cuh row_exchange), the
# cyclic stages' twiddle reads (pass_stages) and the merged-psi stages'
# (ntt_fused.cu merged_stages)
_P_EXCHANGE = """    if constexpr (kCluster) {
        if ((pl.cross >> e) & 1)
            cluster_exchange<R, NOPS>(v, buf, stride, b, vt, b2, t, lbits);
        else
"""
_P_CYCLIC = """    constexpr int r = ilog2(R);
    const int vlo = vt & ((1 << b) - 1);
"""
_P_CYCLIC_TW = """            const uint32_t tw = __ldg(w + base + (cl << b));
            const uint32_t tw_sh = __ldg(w_sh + base + (cl << b));
"""
_P_MERGED = """    constexpr int r = ilog2(R);
    const int vhi = vt >> b;
"""
_P_MERGED_TW = """                load_twiddles<kVec>(tw, tw_sh, w + base + h, w_sh + base + h,
                                    vec);
"""
# the exchanges of a tree whose crossing exchanges push into the reading
# block (the current design): below level 4 the crossing exchanges and every
# cluster barrier go, so that no arrive lacks its wait
_P_PUSH = """    if constexpr (kCluster) {
        const int lb = lbits - ilog2(R);
"""
_P_PUSH_CROSS = "        const bool low = (pl.low >> e) & 1;\n"
_P_PUSH_ARRIVE = """        if ((((pl.cross & ~pl.pull) >> (e + 1)) & 1) || pull)
            cluster_arrive();
        else if (cross || m2 != kOwn)
"""
_P_PUSH_WAIT = """        if ((cross && !pull) || (e > 0 && ((pl.pull >> (e - 1)) & 1)))
            cluster_wait();
"""
_P_PUSH_START = "            if ((pl.cross & ~pl.pull) & 1) cluster_arrive();\n"
_P_PUSH_DRAIN = ("    if constexpr (kCluster)\n"
                 "        if ((pl.pull >> e) & 1) cluster_wait();\n")
PASS_PATCHES_PULL = (
    ("pass_stages.cuh", _P_EXCHANGE, _guard("QT_ABL < 3", "    return;")
     + """    if constexpr (kCluster) {
        if ((pl.cross >> e) & 1) {
""" + _guard("QT_ABL >= 4", "            cluster_exchange<R, NOPS>(v, buf, "
             "stride, b, vt, b2, t, lbits);") + """        } else
"""),)
PASS_PATCHES_PUSH = (
    ("pass_stages.cuh", _P_PUSH, _guard("QT_ABL < 3", "    return;")
     + _P_PUSH),
    ("pass_stages.cuh", _P_PUSH_CROSS, _P_PUSH_CROSS
     + _guard("QT_ABL < 4", "        if (cross) return;")),
    ("pass_stages.cuh", _P_PUSH_ARRIVE, _guard(
        "QT_ABL >= 4", "        if ((((pl.cross & ~pl.pull) >> (e + 1)) & 1)"
        " || pull)\n            cluster_arrive();\n        else")
     + "        if (cross || m2 != kOwn)\n"),
    ("pass_stages.cuh", _P_PUSH_WAIT, _guard("QT_ABL >= 4",
                                             _P_PUSH_WAIT.rstrip())),
    ("pass_stages.cuh", _P_PUSH_START, _guard("QT_ABL >= 4",
                                              _P_PUSH_START.rstrip())),
    ("pass_stages.cuh", _P_PUSH_DRAIN, _guard("QT_ABL >= 4",
                                              _P_PUSH_DRAIN.rstrip())),)
PASS_PATCHES = (
    ("pass_stages.cuh", _P_CYCLIC, _P_CYCLIC + _guard("QT_ABL < 1",
                                                      "    return;")),
    ("pass_stages.cuh", _P_CYCLIC_TW, _guard(
        "QT_ABL < 2",
        "            const uint32_t tw = static_cast<uint32_t>(base + (cl << "
        "b));\n            const uint32_t tw_sh = tw * 3u;", _P_CYCLIC_TW)),
    ("ntt_fused.cu", _P_MERGED, _P_MERGED + _guard("QT_ABL < 1",
                                                   "    return;")),
    ("ntt_fused.cu", _P_MERGED_TW, _guard(
        "QT_ABL < 2",
        "                for (int i = 0; i < kVec; ++i)\n"
        "                    tw[i] = static_cast<uint32_t>(base + h + i), "
        "tw_sh[i] = tw[i] * 3u;", _P_MERGED_TW)),
)


def _patches(csrc: Path) -> list:
    """The patches for the kernels as the tree under ``csrc`` builds them."""
    row = next(f for f in ROW_SOURCES if (csrc / f).exists())
    stream = csrc / "ntt_mxu.cu"
    text = stream.read_text() if stream.exists() else ""
    wide = [now if now in text else before for now, before in (
        (_S_FWD_WIDE, _S_FWD_WIDE_B6), (_S_INV_WIDE, _S_INV_WIDE_B6))]
    return (list(DENSE_PATCHES) + list(COMPACT_PATCHES)
            + [(row, anchor, new) for anchor, new in ROW_PATCHES]
            + list(COLUMN_PATCHES)
            + [("ntt_mxu.cu", a, _guard("QT_ABL >= 1", a)) for a in wide]
            + list(STREAM_PATCHES))


def patch_sources(csrc: Path, passes: bool = False) -> list[str]:
    """Patch the sources under ``csrc`` in place (the pass kernels' patches
    with ``passes``); the patched files."""
    if passes:
        text = (csrc / "pass_stages.cuh").read_text()
        patches = (PASS_PATCHES_PULL if _P_EXCHANGE in text
                   else PASS_PATCHES_PUSH) + PASS_PATCHES
    else:
        patches = _patches(csrc)
    done = []
    for name, anchor, new in patches:
        path = csrc / name
        text = path.read_text() if path.exists() else ""
        if text.count(anchor) == 0 and anchor in OPTIONAL:
            continue
        if text.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor found {text.count(anchor)} "
                               f"times, expected once:\n{anchor}")
        path.write_text(text.replace(anchor, new))
        done.append(name)
    return sorted(set(done))


_RUN = """
import functools, json, sys
sys.path.insert(0, {copy!r})
import torch
from qtesla_tpu_torch.utils import build
assert build.__file__.startswith({copy!r}), build.__file__
build.NVCC_FLAGS = build.NVCC_FLAGS + ("-DQT_ABL={level}",)
from qtesla_tpu_torch.ops import ntt_mxu as M
from qtesla_tpu_torch.ops.mxu_tables import get_mxu_tables
from qtesla_tpu_torch.parallel import sharded_classes as C
from qtesla_tpu_torch.parallel import sharded_mxu as S
from qtesla_tpu_torch.parallel.sharded_mxu_tables import (
    class_boundary_plan, fourstep_fold_tables, fourstep_mxu_plans)
from qtesla_tpu_torch.utils.timing import time_cuda
names = {names!r}
mt = get_mxu_tables("qtesla-iii-speed")
gen = torch.Generator(device="cuda")
gen.manual_seed(20261016)
x, y = (torch.randint(0, mt.q, (32768, mt.n), generator=gen, device="cuda",
                      dtype=torch.int64).to(torch.uint32) for _ in range(2))
plans = fourstep_mxu_plans("qtesla-iii-speed", 32, {sp})
cp = class_boundary_plan("qtesla-iii-speed", 32, {sp})
sx = S.to_shards(x, plans)
wide = torch.cat([sx.view(torch.int32)] * cp.Dout, dim=-1).view(torch.uint32)
spec = x[0].clone()
# the folded operand of a spectrum from the plain forward on the host: the
# patched B6 of a level below 5 does not compute one
fold = M.fold_operand(M.ntt_mxu(x[:1].cpu(), mt).to("cuda"), mt)
# B15's operand: the folded tables of that spectrum, built on the host
sfold = (S.fold_sp_operand(*fourstep_fold_tables(plans, spec.cpu().numpy()),
                           plans, "cuda")
         if "sp_seg2_folded" in names else None)
runs = {{
    "polymul_mxu": lambda: M.polymul_mxu(x, y, mt),
    "polymul_fixed_mxu": lambda: M.polymul_fixed_mxu(x, y[:1], mt),
    "polymul_fixed_folded_mxu": lambda: M.polymul_fixed_folded_mxu(x, fold,
                                                                   mt),
    "ntt_mxu": lambda: M.ntt_mxu(x, mt),
    "intt_mxu": lambda: M.intt_mxu(x, mt),
    "sp_seg1": lambda: S.sp_seg1(sx, plans),
    "sp_seg2": lambda: S.sp_seg2(sx, sx, plans),
    "sp_seg3": lambda: S.sp_seg3(sx, plans),
    "sp_seg2_fixed": lambda: S.sp_seg2_fixed(sx, spec, plans),
    "sp_seg2_fwd": lambda: S.sp_seg2_fwd(sx, plans),
    "sp_seg2_folded": lambda: S.sp_seg2_folded(sx, sfold, plans),
    "sp_seg1_classes": lambda: C.sp_seg1_classes(sx, plans, cp),
    "sp_seg2_classes": lambda: C.sp_seg2_classes(wide, wide, plans, cp),
}}
out = {{}}
for name in names:
    out[name] = time_cuda(runs[name], warmup=3, repeats=20).samples_ms
lib = build.load_library()
report = [l.strip() for l in lib.log.splitlines() if "spill" in l
          and "0 bytes spill stores, 0 bytes spill loads" not in l]
print(json.dumps({{"ms": out, "spills": len(report)}}))
"""


_PASS_RUN = """
import json, sys
sys.path.insert(0, {copy!r})
import torch
from qtesla_tpu_torch.utils import build
assert build.__file__.startswith({copy!r}), build.__file__
build.NVCC_FLAGS = build.NVCC_FLAGS + ("-DQT_ABL={level}",)
from qtesla_tpu_torch.ops import ntt_fused as F
from qtesla_tpu_torch.ops import ntt_pairings as P
from qtesla_tpu_torch.ops import passes as Ps
from qtesla_tpu_torch.ops.tables import get_tables
from qtesla_tpu_torch.params import register_param_set
from qtesla_tpu_torch.utils.timing import time_cuda
gen = torch.Generator(device="cuda")
out = {{}}
for logn, q, B, kinds in {rings!r}:
    n = 1 << logn
    name = f"abl-n{{n}}"
    register_param_set(name, n, q)
    tbl = get_tables(name)
    gen.manual_seed(n)
    x, y = (torch.randint(0, q, (B, n), generator=gen, device="cuda",
                          dtype=torch.int64).to(torch.uint32)
            for _ in range(2))
    spec = x[0].clone()
    for kind in kinds:
        plan = Ps.kernel_plan(n, kind)
        fn = {{"B1": lambda: F.polymul_fused(x, y, tbl, plan=plan),
              "B4": lambda: F.polymul_fixed_fused(x, spec, tbl, plan=plan),
              "B2": lambda: F.ntt_fused(x, tbl, plan=plan),
              "B3": lambda: F.intt_fused(x, tbl, plan=plan)}}.get(
            kind, lambda: P.polymul_pairing(x, y, tbl, kind, plan=plan))
        out[f"{{kind}} 2^{{logn}} C{{plan.cluster}}"] = time_cuda(
            fn, warmup=3, repeats=20).samples_ms
    del x, y, spec
    torch.cuda.empty_cache()
lib = build.load_library()
print(json.dumps({{"ms": out, "log": lib.log}}))
"""


def _ptxas(log: str) -> list[str]:
    """One line a pass kernel of nvcc's ``-Xptxas -v`` log: the mangled
    entry, its registers and spills."""
    lines, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif entry and ("pass_kernel" in entry) and (
                "spill" in line or "Used" in line):
            lines.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return lines


def main_passes(tree: Path) -> int:
    """The ``--passes`` run: every level of ``PASS_LEVELS`` in a process of
    its own, then each kernel's phases."""
    copy = Path("build/ablation").resolve() / (tree.name + "-passes")
    if copy.exists():
        shutil.rmtree(copy)
    shutil.copytree(tree / "qtesla_tpu_torch", copy / "qtesla_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    patched = patch_sources(copy / "qtesla_tpu_torch" / "csrc", passes=True)
    print(f"patched {patched} under {copy}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    medians = {}
    for level in PASS_LEVELS:
        proc = subprocess.run(
            [sys.executable, "-c", _PASS_RUN.format(
                copy=str(copy), level=level, rings=PASS_RINGS)],
            cwd=copy, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"level {level} failed:\n{proc.stderr}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        medians[level] = {k: statistics.median(v)
                          for k, v in res["ms"].items()}
        print(f"level {level}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in medians[level].items()) +
            f" ms [{smi}]", flush=True)
        if level == PASS_LEVELS[-1]:
            for line in _ptxas(res["log"]):
                print(f"ptxas {line}")
    for name in medians[PASS_LEVELS[0]]:
        steps = [medians[lv][name] for lv in PASS_LEVELS]
        adds = [steps[0]] + [b - a for a, b in zip(steps, steps[1:])]
        print(f"{name}: load/store {adds[0]:.4f}, butterflies "
              f"{adds[1]:+.4f}, twiddle reads {adds[2]:+.4f}, exchanges in "
              f"a block {adds[3]:+.4f}, crossing exchanges {adds[4]:+.4f}; "
              f"whole {steps[-1]:.4f} ms [{smi}]")
    return 0


def main(argv: list[str]) -> int:
    if argv[:1] == ["--passes"] and len(argv) == 2:
        return main_passes(Path(argv[1]).resolve())
    sp = 4
    if argv[:1] == ["--sp"] and len(argv) > 1:
        sp, argv = int(argv[1]), argv[2:]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    tree, names = Path(argv[0]).resolve(), argv[1:]
    copy = Path("build/ablation").resolve() / tree.name
    if copy.exists():
        shutil.rmtree(copy)
    shutil.copytree(tree / "qtesla_tpu_torch", copy / "qtesla_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    patched = patch_sources(copy / "qtesla_tpu_torch" / "csrc")
    print(f"patched {patched} under {copy}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    medians = {}
    for level in LEVELS:
        proc = subprocess.run(
            [sys.executable, "-c", _RUN.format(copy=str(copy), level=level,
                                               names=names, sp=sp)],
            cwd=copy, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"level {level} failed:\n{proc.stderr}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        medians[level] = {k: statistics.median(v)
                          for k, v in res["ms"].items()}
        print(f"level {level}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in medians[level].items()) +
            f" ms ({res['spills']} kernels spill) [{smi}]", flush=True)
    for name in names:
        steps = [medians[lv][name] for lv in LEVELS]
        adds = [steps[0]] + [b - a for a, b in zip(steps, steps[1:])]
        print(f"{name}: load/store {adds[0]:.4f}, wide/pointwise "
              f"{adds[1]:+.4f}, split {adds[2]:+.4f}, products (register "
              f"tables) {adds[3]:+.4f}, table reads {adds[4]:+.4f}, "
              f"recombination {adds[5]:+.4f}; whole {steps[5]:.4f} ms "
              f"[{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
