"""Time the kernels of two source trees in turns, on one card.

    python -m qtesla_tpu_torch.utils.ab_timing [--rounds N] \
        [--sp K | --butterfly] OLD_TREE NEW_TREE

Each tree is a checkout of this repository (for example a parent commit
unpacked with ``git archive``, or a copy with one constant of a CUDA source
changed).  In the order old, new, new, old a fresh Python process imports
that tree's ``qtesla_tpu_torch``, builds its kernels into that tree's
``build/`` and times, at qtesla-iii-speed, B = 32768, on the same seeded
operands (CUDA events, 3 warmup then 20 timed calls each): B5-B9 (B6 also
on one row, the size of its launches on the main path), or with
``--sp K`` the sequence-parallel segments B11-B16 at model axis K (shards
(K, 32768, 1024 / K); B13-B15 where both trees have them, against the
spectrum of y's first row, B14 also on one row a shard, the size of its
launches on the main path, warm and cold (``time_cuda(cold=True)``); the
class-boundary B17 and B18, B18 on B17's output after the exchange, where
the tree has them; and the folded SP
path at model axis K, ``multiply(x, *prepare(a))``, and its prepare, whose
host work the events span), or with
``--butterfly`` the butterfly kernels B1-B4 (B4 against the spectrum of
y's first row, B3 on x) and the five pairings B10.  ``--rounds N`` runs the
order old, new, new, old N times (default 1).  It prints each run's
medians and, per kernel, the median and the least of each tree's 40 N
calls and the new/old ratio of the medians.  It needs a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

__all__ = ["main"]

MXU_KERNELS = ("polymul_mxu", "polymul_fixed_mxu", "ntt_mxu", "ntt_mxu B=1",
               "intt_mxu", "polymul_fixed_folded_mxu")
BUTTERFLY_KERNELS = ("polymul_fused", "polymul_fixed_fused", "ntt_fused",
                     "intt_fused", *(f"polymul_pairing_{p}" for p in (
                         "gs_ct", "ct_ct", "gs_gs", "ct_gs", "stockham")))
SP_KERNELS = ("sp_seg1", "sp_seg2", "sp_seg3", "sp_seg2_fixed", "sp_seg2_fwd",
              "sp_seg2_fwd B=1", "sp_seg2_fwd B=1 cold", "sp_seg2_folded",
              "sp_seg1_classes", "sp_seg2_classes", "folded SP path",
              "folded SP prepare")

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
if {butterfly}:
    from qtesla_tpu_torch.ops import ntt_fused as F
    from qtesla_tpu_torch.ops import ntt_pairings as P
    from qtesla_tpu_torch.ops.tables import get_tables
    args = tbl = get_tables("qtesla-iii-speed")
    spec = F.ntt_fused(y[:1], tbl)
    runs = {{"polymul_fused": (F.polymul_fused, x, y),
            "polymul_fixed_fused": (F.polymul_fixed_fused, x, spec),
            "ntt_fused": (F.ntt_fused, x), "intt_fused": (F.intt_fused, x),
            **{{f"polymul_pairing_{{p}}": (
                functools.partial(P.polymul_pairing, pairing=p), x, y)
               for p in P.PAIRINGS}}}}
elif {sp}:
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
        import inspect
        aspec = S.fixed_spectrum(y[0], plans)
        # a tree before B15's compact operand takes no plans
        pair = fourstep_fold_tables(plans, aspec.cpu().numpy())
        fold = (S.fold_sp_operand(*pair, plans, "cuda") if "plans" in
                inspect.signature(S.fold_sp_operand).parameters
                else S.fold_sp_operand(*pair, "cuda"))
        one = vx[:, :1].contiguous()
        runs.update({{"sp_seg2_fixed": (S.sp_seg2_fixed, vx, aspec),
                     "sp_seg2_fwd": (S.sp_seg2_fwd, vx),
                     "sp_seg2_fwd B=1": (S.sp_seg2_fwd, one),
                     "sp_seg2_fwd B=1 cold": (S.sp_seg2_fwd, one),
                     "sp_seg2_folded": (S.sp_seg2_folded, vx, fold)}})
        from qtesla_tpu_torch.parallel import make_mesh
        xprep, xmul = S.polymul_fixed_folded_fourstep_mxu_fn(
            "qtesla-iii-speed", make_mesh(model={sp}))
        op = xprep(y[0])
        runs.update({{"folded SP path": (lambda t, _: xmul(t, *op), x),
                     "folded SP prepare": (lambda a, _: xprep(a), y[0])}})
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
            "ntt_mxu B=1": (M.ntt_mxu, x[:1]),
            "intt_mxu": (M.intt_mxu, x), "polymul_fixed_folded_mxu":
            (M.polymul_fixed_folded_mxu, x, op)}}
out = {{}}
for name, (fn, *ops) in runs.items():
    out[name] = time_cuda(fn, *ops, args, warmup=3, repeats=20,
                          cold=name.endswith(" cold")).samples_ms
print(json.dumps(out))
"""


def _run(tree: Path, sp: int, butterfly: bool) -> dict:
    proc = subprocess.run([sys.executable, "-c",
                           _RUN.format(tree=str(tree), sp=sp,
                                       butterfly=butterfly)],
                          cwd=tree, capture_output=True, text=True,
                          check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"timing in {tree} failed:\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv: list[str]) -> int:
    rounds = 1
    if argv[:1] == ["--rounds"] and len(argv) > 1:
        rounds, argv = int(argv[1]), argv[2:]
    sp, butterfly = 0, argv[:1] == ["--butterfly"]
    if butterfly:
        argv = argv[1:]
    elif argv[:1] == ["--sp"] and len(argv) > 1:
        sp, argv = int(argv[1]), argv[2:]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"old": Path(argv[0]).resolve(), "new": Path(argv[1]).resolve()}
    runs = []
    for which in ("old", "new", "new", "old") * rounds:
        res = _run(trees[which], sp, butterfly)
        runs.append((which, res))
        print(f"{which} ({trees[which]}): " + ", ".join(
            f"{k} {statistics.median(v):.4f}" for k, v in res.items()) +
            " ms", flush=True)
    # the kernels both trees have
    kernels = [k for k in (BUTTERFLY_KERNELS if butterfly else
                           SP_KERNELS if sp else MXU_KERNELS)
               if all(k in res for _, res in runs)]
    samples = {t: {k: [] for k in kernels} for t in trees}
    for which, res in runs:
        for k in kernels:
            samples[which][k].extend(res[k])
    for k in kernels:
        old, new = (statistics.median(samples[t][k]) for t in ("old", "new"))
        least = [min(samples[t][k]) for t in ("old", "new")]
        print(f"{k}: old {old:.4f} ms, new {new:.4f} ms, new/old "
              f"{new / old:.4f} (medians of {len(samples['old'][k])} calls "
              f"each; least {least[0]:.4f} and {least[1]:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
