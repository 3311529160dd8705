"""Time the digit-matmul kernels of two source trees in turns, on one card.

    python -m qtesla_tpu_torch.utils.ab_timing [--sp K] OLD_TREE NEW_TREE

Each tree is a checkout of this repository (for example a parent commit
unpacked with ``git archive``, or a copy with one constant of a CUDA source
changed).  In the order old, new, new, old a fresh Python process imports
that tree's ``qtesla_tpu_torch``, builds its kernels into that tree's
``build/`` and times, at qtesla-iii-speed, B = 32768, on the same seeded
operands (CUDA events, 3 warmup then 20 timed calls each): B5-B9, or with
``--sp K`` the sequence-parallel segments B11-B16 at model axis K (shards
(K, 32768, 1024 / K); B13-B15 where both trees have them, against the
spectrum of y's first row; the class-boundary B17 and B18, B18 on B17's
output after the exchange, where the tree has them).  It prints each run's
medians and, per kernel, the median of each tree's 40 calls and the new/old
ratio.  It needs a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

__all__ = ["main"]

MXU_KERNELS = ("polymul_mxu", "polymul_fixed_mxu", "ntt_mxu", "intt_mxu",
               "polymul_fixed_folded_mxu")
SP_KERNELS = ("sp_seg1", "sp_seg2", "sp_seg3", "sp_seg2_fixed", "sp_seg2_fwd",
              "sp_seg2_folded", "sp_seg1_classes", "sp_seg2_classes")

_RUN = """
import functools, importlib.util, json, sys
sys.path.insert(0, {tree!r})
import torch
from qtesla_tpu_torch.ops import ntt_mxu as M
from qtesla_tpu_torch.ops.mxu_tables import get_mxu_tables
from qtesla_tpu_torch.utils.timing import time_cuda
assert M.__file__.startswith({tree!r}), M.__file__
mt = get_mxu_tables("qtesla-iii-speed")
gen = torch.Generator(device="cuda")
gen.manual_seed(20261016)
x, y = (torch.randint(0, mt.q, (32768, mt.n), generator=gen, device="cuda",
                      dtype=torch.int64).to(torch.uint32) for _ in range(2))
if {sp}:
    from qtesla_tpu_torch.parallel import sharded_mxu as S
    from qtesla_tpu_torch.parallel.sharded_mxu_tables import (
        fourstep_mxu_plans)
    args = plans = fourstep_mxu_plans("qtesla-iii-speed", 32, {sp})
    sx, sy = (S.to_shards(t, plans) for t in (x, y))
    vx, vy = (S.a2a_fwd(S.sp_seg1(t, plans), plans) for t in (sx, sy))
    w = S.a2a_inv(S.sp_seg2(vx, vy, plans), plans)
    runs = {{"sp_seg1": (S.sp_seg1, sx), "sp_seg2": (S.sp_seg2, vx, vy),
            "sp_seg3": (S.sp_seg3, w)}}
    if hasattr(S, "sp_seg2_fixed"):
        from qtesla_tpu_torch.parallel.sharded_mxu_tables import (
            fourstep_fold_tables)
        aspec = S.fixed_spectrum(y[0], plans)
        fold = S.fold_sp_operand(*fourstep_fold_tables(
            plans, aspec.cpu().numpy()), "cuda")
        runs.update({{"sp_seg2_fixed": (S.sp_seg2_fixed, vx, aspec),
                     "sp_seg2_fwd": (S.sp_seg2_fwd, vx),
                     "sp_seg2_folded": (S.sp_seg2_folded, vx, fold)}})
    if importlib.util.find_spec("qtesla_tpu_torch.parallel.sharded_classes"):
        from qtesla_tpu_torch.parallel import sharded_classes as C
        from qtesla_tpu_torch.parallel.sharded_mxu_tables import (
            class_boundary_plan)
        cp = class_boundary_plan("qtesla-iii-speed", 32, {sp})
        ux, uy = (C.a2a_fwd_classes(C.sp_seg1_classes(t, plans, cp), plans,
                                    cp.Dout) for t in (sx, sy))
        runs.update({{
            "sp_seg1_classes": (functools.partial(C.sp_seg1_classes, cp=cp),
                                sx),
            "sp_seg2_classes": (functools.partial(C.sp_seg2_classes, cp=cp),
                                ux, uy)}})
else:
    args = mt
    spec = M.ntt_mxu(y[:1], mt)
    op = M.fold_operand(spec, mt)
    runs = {{"polymul_mxu": (M.polymul_mxu, x, y), "polymul_fixed_mxu":
            (M.polymul_fixed_mxu, x, spec), "ntt_mxu": (M.ntt_mxu, x),
            "intt_mxu": (M.intt_mxu, x), "polymul_fixed_folded_mxu":
            (M.polymul_fixed_folded_mxu, x, op)}}
out = {{}}
for name, (fn, *ops) in runs.items():
    out[name] = time_cuda(fn, *ops, args, warmup=3, repeats=20).samples_ms
print(json.dumps(out))
"""


def _run(tree: Path, sp: int) -> dict:
    proc = subprocess.run([sys.executable, "-c",
                           _RUN.format(tree=str(tree), sp=sp)],
                          cwd=tree, capture_output=True, text=True,
                          check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"timing in {tree} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv: list[str]) -> int:
    sp = 0
    if argv[:1] == ["--sp"] and len(argv) > 1:
        sp, argv = int(argv[1]), argv[2:]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"old": Path(argv[0]).resolve(), "new": Path(argv[1]).resolve()}
    runs = []
    for which in ("old", "new", "new", "old"):
        res = _run(trees[which], sp)
        runs.append((which, res))
        print(f"{which} ({trees[which]}): " + ", ".join(
            f"{k} {statistics.median(v):.4f}" for k, v in res.items()) +
            " ms", flush=True)
    # the kernels both trees have
    kernels = [k for k in (SP_KERNELS if sp else MXU_KERNELS)
               if all(k in res for _, res in runs)]
    samples = {t: {k: [] for k in kernels} for t in trees}
    for which, res in runs:
        for k in kernels:
            samples[which][k].extend(res[k])
    for k in kernels:
        old, new = (statistics.median(samples[t][k]) for t in ("old", "new"))
        print(f"{k}: old {old:.4f} ms, new {new:.4f} ms, new/old "
              f"{new / old:.4f} (medians of 40 calls each)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
