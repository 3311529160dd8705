"""Time the pass kernels' sweep form on the card: each kind's whole call
and each of its launches alone.

    python -m qtesla_tpu_torch.utils.sweep_timing [--rings 18:128,20:32,25:4]
        [--kinds B1,B2,gs_ct,stockham] [--calls 10]

For each ring (log2 n and rows B; q the largest prime the registry takes
there) and each kind (``passes.SWEEP_KINDS``) under its sweep plan
(``passes.sweep_plan``): the median of ``--calls`` CUDA-event-timed calls
through the kernel's wrapper after two warmup calls, then each launch of
the call alone (the launcher called with that launch's number, on the
scratch rows the call left), the same way.  Each line names the card and
its power limit (nvidia-smi).  Without a card it exits 1.  The operands
are seeded and random; no result is checked here (``chip_smoke.py`` and
``tests/test_torch_device.py`` do that).
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys

import torch

from ..ops import ntt as N
from ..ops import ntt_fused as F
from ..ops import ntt_pairings as P
from ..ops import passes as Ps
from ..ops.tables import get_tables
from ..params import register_param_set

# the largest prime the registry takes at each log2 n of a ring
PRIMES = {18: 1056440321, 19: 1053818881, 20: 1012924417, 21: 998244353,
          25: 469762049}


def _median_ms(fn, calls: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _call(kind: str, tbl, x, y, spec, plan):
    """The wrapper's call of ``kind`` under ``plan``."""
    if kind == "B1":
        return lambda: F.polymul_fused(x, y, tbl, plan=plan)
    if kind == "B4":
        return lambda: F.polymul_fixed_fused(x, spec, tbl, plan=plan)
    if kind == "B2":
        return lambda: F.ntt_fused(x, tbl, plan=plan)
    if kind == "B3":
        return lambda: F.intt_fused(x, tbl, plan=plan)
    return lambda: P.polymul_pairing(x, y, tbl, kind, plan=plan)


def time_ring(logn: int, B: int, kinds, calls: int, device_line: str,
              log=print) -> None:
    from .build import load_library

    n, q = 1 << logn, PRIMES[logn]
    name = f"sweep-timing-n{n}"
    register_param_set(name, n, q)
    tbl = get_tables(name)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(n)
    x, y = (torch.randint(0, q, (B, n), generator=gen, device="cuda",
                          dtype=torch.int64).to(torch.uint32)
            for _ in range(2))
    spec = F.ntt_fused(y[:1], tbl)
    lib = load_library().cdll
    ps = tbl.ps
    for kind in kinds:
        plan = Ps.sweep_plan(n, kind)
        whole = _median_ms(_call(kind, tbl, x, y, spec, plan), calls)
        nops = Ps.SWEEP_KINDS[kind][2]
        tw = (N.twiddles(tbl, x.device) if kind.startswith("B")
              else P.pairing_twiddles(tbl, x.device))
        out = torch.empty_like(x)
        scratch = [torch.zeros((B, nops, n), dtype=torch.uint32,
                               device="cuda") for _ in range(2)]
        second = spec if kind == "B4" else y
        stream = torch.cuda.current_stream().cuda_stream

        def launch(i):
            err = lib.qt_pass_sweep(
                x.data_ptr(), second.data_ptr(), out.data_ptr(),
                scratch[0].data_ptr(), scratch[1].data_ptr(), tw.data_ptr(),
                B, n, logn, q, ps.r32, ps.r32_shoup, ps.one_shoup,
                ctypes.addressof(plan), i, stream)
            if err:
                raise RuntimeError(f"qt_pass_sweep {kind} launch {i}: {err}")

        parts = []
        for i in range(plan.sweeps):
            what = "+".join(s for s, on in (("fwd", plan.fwd[i]),
                                             ("inv", plan.inv[i])) if on)
            ms = _median_ms(lambda: launch(i), calls)
            parts.append(f"[{plan.lo[i]},{plan.hi[i]}) {what} {ms:.4f}")
        log(f"n=2^{logn} q={q} B={B} {kind}: call {whole:.4f} ms "
            f"(median of {calls}); launches alone: {'; '.join(parts)} ms "
            f"[{device_line}]")
        del out, scratch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rings", default="18:128,20:32,25:4",
                    help="log2(n):rows, comma separated")
    ap.add_argument("--kinds", default=",".join(Ps.SWEEP_KINDS))
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args(argv)
    rings = [tuple(int(v) for v in r.split(":"))
             for r in args.rings.split(",")]
    kinds = args.kinds.split(",")
    for logn, _ in rings:
        if logn not in PRIMES:
            ap.error(f"no prime for 2^{logn}; choose from {sorted(PRIMES)}")
    for kind in kinds:
        if kind not in Ps.SWEEP_KINDS:
            ap.error(f"unknown kind {kind!r}")
    if not torch.cuda.is_available():
        print("sweep_timing: no CUDA device; the sweep kernels run on the "
              "card only", file=sys.stderr)
        return 1
    device_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    for logn, B in rings:
        time_ring(logn, B, kinds, args.calls, device_line)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
