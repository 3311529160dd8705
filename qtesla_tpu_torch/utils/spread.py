"""Time kernels in turns inside one process, round after round.

    python -m qtesla_tpu_torch.utils.spread [--rounds N] KERNEL...

At qtesla-iii-speed, B = 32768, on seeded operands (the SP segments at
model axis 4, on the spectral shards of x), each of N rounds
(default 4) times each named kernel (keys of ``KERNELS`` below) in the
order given, CUDA events, 3 warmup then 20 timed calls.  It prints, per
kernel, each round's median and the quantiles 0, 25, 50, 75 and 100 % of
all its calls.  An A/B median hides a kernel whose rounds jump between two
states while the kernels timed between them hold theirs; this shows it.
It needs a CUDA device.
"""

from __future__ import annotations

import statistics
import subprocess
import sys

__all__ = ["main", "KERNELS"]

KERNELS = ("ntt_fused", "intt_fused", "sp_seg2", "sp_seg2_fixed",
           "sp_seg2_fwd", "sp_seg2_folded")


def _runs() -> dict:
    import torch

    from ..ops import ntt_fused as F
    from ..ops.tables import get_tables
    from ..parallel import sharded_mxu as S
    from ..parallel.sharded_mxu_tables import (fourstep_fold_tables,
                                               fourstep_mxu_plans)

    tbl = get_tables("qtesla-iii-speed")
    plans = fourstep_mxu_plans("qtesla-iii-speed", 32, 4)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20261016)
    x = torch.randint(0, tbl.q, (32768, tbl.n), generator=gen, device="cuda",
                      dtype=torch.int64).to(torch.uint32)
    vx = S.a2a_fwd(S.sp_seg1(S.to_shards(x, plans), plans), plans)
    aspec = S.fixed_spectrum(x[0], plans)
    fold = S.fold_sp_operand(*fourstep_fold_tables(plans,
                                                   aspec.cpu().numpy()),
                             plans, "cuda")
    return {"ntt_fused": (F.ntt_fused, x, tbl),
            "intt_fused": (F.intt_fused, x, tbl),
            "sp_seg2": (S.sp_seg2, vx, vx, plans),
            "sp_seg2_fixed": (S.sp_seg2_fixed, vx, aspec, plans),
            "sp_seg2_fwd": (S.sp_seg2_fwd, vx, plans),
            "sp_seg2_folded": (S.sp_seg2_folded, vx, fold, plans)}


def main(argv: list[str]) -> int:
    rounds = 4
    if argv[:1] == ["--rounds"] and len(argv) > 1:
        rounds, argv = int(argv[1]), argv[2:]
    if not argv or any(k not in KERNELS for k in argv):
        print(__doc__, file=sys.stderr)
        return 2
    from .timing import time_cuda

    runs = _runs()
    samples = {k: [] for k in argv}
    for _ in range(rounds):
        for k in argv:
            fn, *args = runs[k]
            samples[k].append(time_cuda(fn, *args, warmup=3,
                                        repeats=20).samples_ms)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    for k, per_round in samples.items():
        calls = sorted(t for r in per_round for t in r)
        quant = [calls[round(f * (len(calls) - 1))]
                 for f in (0, 0.25, 0.5, 0.75, 1)]
        print(f"{k}: round medians " + " ".join(
            f"{statistics.median(r):.4f}" for r in per_round)
            + " ms; quantiles 0/25/50/75/100 % " + " ".join(
                f"{t:.4f}" for t in quant) + f" ms [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
