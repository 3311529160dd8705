"""Time the pass kernels' sweep form on the card: each kind's whole call
and each of its launches alone, beside the bytes each must move.

    python -m qtesla_tpu_torch.utils.sweep_timing [--rings 18:128,20:32,25:4]
        [--kinds B1,B2,gs_ct,stockham] [--calls 10]

For each ring (log2 n and rows B, n = 2^18 to 2^25, every ring the sweep
form runs; q the largest prime the registry takes there) and each kind
(``passes.SWEEP_KINDS``) under its sweep plan (``passes.sweep_plan``): the
median of ``--calls`` CUDA-event-timed calls through the kernel's wrapper
after two warmup calls (``timing.time_cuda``), then each launch of the
call alone (the launcher called with that launch's number, on the scratch
rows the call left), the same way.  Beside the call: its one-pass bound
(each operand read once, z written once, the kind's table once) and its
sweep floor (``passes.sweep_launch_bytes`` summed: each launch reads and
writes each row it carries once), both over 3.35 TB/s; beside each
launch: its bytes, its share of the floor and its rate.  Each line names
the card and its power limit (nvidia-smi).  Without a card it exits 1.
The operands are seeded and random; no result is checked here
(``chip_smoke.py`` and ``tests/test_torch_device.py`` do that).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import torch

from ..ops import ntt as N
from ..ops import ntt_fused as F
from ..ops import ntt_pairings as P
from ..ops import passes as Ps
from ..ops.tables import get_tables
from ..params import register_param_set
from .timing import time_cuda

# the largest prime the registry takes at each log2 n of a ring
PRIMES = {18: 1056440321, 19: 1053818881, 20: 1012924417, 21: 998244353,
          22: 998244353, 23: 754974721, 24: 469762049, 25: 469762049}
# device memory's rate (H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12


def one_pass_bytes(kind: str, n: int, B: int) -> int:
    """Bytes one pass over the data moves: each operand read once, z
    written once, the kind's table read once ((4, n) merged-psi rows, (8,
    n) pairing rows; B4's spectrum)."""
    nops = Ps.SWEEP_KINDS[kind][2]
    table = 32 * n if not kind.startswith("B") else 16 * n
    return 4 * B * n * (nops + 1) + table + (4 * n if kind == "B4" else 0)


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
        whole = time_cuda(_call(kind, tbl, x, y, spec, plan), warmup=2,
                          repeats=calls).median_ms
        nops = Ps.SWEEP_KINDS[kind][2]
        pairing = not kind.startswith("B")
        tw = (P.pairing_twiddles(tbl, x.device) if pairing
              else N.twiddles(tbl, x.device))
        pw = N.sweep_powers(tbl, pairing, x.device)
        out = torch.empty_like(x)
        scratch = [torch.zeros((B, nops, n), dtype=torch.uint32,
                               device="cuda") for _ in range(2)]
        second = spec if kind == "B4" else y
        stream = torch.cuda.current_stream().cuda_stream

        def launch(i):
            err = lib.qt_pass_sweep(
                x.data_ptr(), second.data_ptr(), out.data_ptr(),
                scratch[0].data_ptr(), scratch[1].data_ptr(), tw.data_ptr(),
                pw.data_ptr(), B, n, logn, q, ps.r32, ps.r32_shoup,
                ps.one_shoup, ctypes.addressof(plan), i, stream)
            if err:
                raise RuntimeError(f"qt_pass_sweep {kind} launch {i}: {err}")

        floor = sum(Ps.sweep_launch_bytes(plan, i, B)
                    for i in range(plan.sweeps))
        floor_ms = floor / HBM_BYTES_PER_S * 1e3
        one_ms = one_pass_bytes(kind, n, B) / HBM_BYTES_PER_S * 1e3
        parts = []
        for i in range(plan.sweeps):
            what = "+".join(s for s, on in (("fwd", plan.fwd[i]),
                                             ("inv", plan.inv[i])) if on)
            ms = time_cuda(launch, i, warmup=2, repeats=calls).median_ms
            nbytes = Ps.sweep_launch_bytes(plan, i, B)
            parts.append(f"[{plan.lo[i]},{plan.hi[i]}) {what} {ms:.4f} ms, "
                         f"{nbytes} B ({nbytes / floor * 100:.1f} % of the "
                         f"floor), {nbytes / ms / 1e6:.1f} GB/s")
        log(f"n=2^{logn} q={q} B={B} {kind}: call {whole:.4f} ms (median "
            f"of {calls}); one-pass bound {one_ms:.4f} ms, sweep floor "
            f"{floor_ms:.4f} ms ({floor} B, {floor_ms / whole * 100:.1f} % "
            f"of the call); launches alone: {'; '.join(parts)} "
            f"[{device_line}]", flush=True)
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
