"""Registration-space sweep: every kernel of the port on many runtime
registered (n, q) pairs across the modulus range.

    python -m qtesla_tpu_torch.utils.fuzz_params --n N --per-decade K
        [--sp] [--device cuda|cpu] [--seed S]

The port's counterpart of ``scripts/fuzz_params.py``.  The planners make
discrete decisions that flip at modulus-magnitude thresholds (plane counts
and bases of the digit splits, lazy or canonical forward input, class
groupings, the fold plan's split), so the sweep takes the primes q = c 2n
+ 1 of each bit size (``primes_for_n``, the same choice as the JAX
script's, with the port's own primality test) and gives every decision
region a representative.  For each prime it registers (n, q), prints the
plan (digit classes D, the forward split Df@base, the inverse split
Di@base, whether the forward input is lazy, the fold plan's Din@base) and
runs on three rows, row 0 all q - 1 in both operands, against a random
constant:

- B1-B4 (``ops/ntt_fused.py``), B5-B9 (``ops/ntt_mxu.py``) and the five
  B10 pairings (``ops/ntt_pairings.py``), each against its plain twin, the
  products against B1 (B5, B10), B4 (B8, B9), B2 (B6) and x back through
  B3 and B7;
- with ``--sp``, at model axis 2 and n1 = 2^(log2(n) // 2) where the
  four-step split takes it, B11-B16 (``parallel/sharded_mxu.py``) against
  their twins and the SP path against B1, and B17 and B18
  (``parallel/sharded_classes.py``) where the plan has at most 3 digit
  classes, the class path against B1;
- two rows of B1 against the C++ oracle (``utils/native.py``; the big-int
  schoolbook where it does not build).

On a CUDA device every wrapper launches its kernel; on the CPU the
wrappers run their twins, so the sweep checks the planners and the twins
against each other and the oracle.  ``sweep`` is the same check as a
function (``chip_smoke.py`` calls it on the card).  Exit status 1 if any
prime mismatches.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback

import numpy as np
import torch

from .. import params as PARAMS
from ..ops import ntt_fused as F
from ..ops import ntt_mxu as M
from ..ops import ntt_pairings as P
from ..ops.mxu_tables import fold_plan, get_mxu_tables
from ..ops.tables import get_tables

__all__ = ["primes_for_n", "plan_line", "check_prime", "sweep", "main"]


def primes_for_n(n: int, per_decade: int, bits=range(15, 31)) -> list[int]:
    """NTT-friendly primes q = c 2n + 1 spread across magnitudes: for each
    bit size the smallest ``per_decade`` primes of that size
    (``scripts/fuzz_params.py``'s choice)."""
    out = []
    for b in bits:
        found = 0
        c = ((1 << (b - 1)) // (2 * n)) + 1
        while found < per_decade:
            q = c * 2 * n + 1
            if q >= 1 << b:
                break
            if PARAMS._is_prime(q):
                out.append(q)
                found += 1
            c += 1
    return out


def plan_line(mt) -> str:
    """The plan's decisions: D, Df@fwd_base, Di@inv_base, the forward's
    input lazy or not, the fold plan's Din@base."""
    fp = fold_plan(mt)
    return (f"D={mt.D} Df={mt.Df}@{mt.fwd_base} Di={mt.Di}@{mt.inv_base} "
            f"lazy={mt.fwd_lazy} fold Din={fp.Din}@{fp.base}")


def _oracle(x: np.ndarray, y: np.ndarray, name: str) -> np.ndarray:
    from . import native

    ps = PARAMS.get_params(name)
    if native.native_available():
        return native.negacyclic_schoolbook(x, y, ps.q)
    from ..oracle import negacyclic_schoolbook

    return np.stack([negacyclic_schoolbook(a, b, ps).astype(np.uint32)
                     for a, b in zip(x, y)])


def _sp_checks(name: str, x, y, a, ref, device, out: list) -> str:
    """B11-B16 (and B17, B18 at most 3 classes) at model axis 2 against
    their twins, the SP and class paths against B1; what ran."""
    from ..parallel import make_mesh
    from ..parallel import sharded_classes as C
    from ..parallel import sharded_mxu as S
    from ..parallel.sharded_mxu_tables import (class_boundary_plan,
                                               fourstep_fold_tables,
                                               fourstep_mxu_plans)

    n = x.shape[-1]
    n1, k = 1 << (n.bit_length() - 1 >> 1), 2
    if n1 % 2 or (n // n1) % 2 or n // n1 > 128:
        return "sp=no split"
    try:
        plans = fourstep_mxu_plans(name, n1, k)
    except ValueError as e:
        return f"sp=no split ({e})"
    mesh = make_mesh(model=k, device=device)
    sx, sy = (S.to_shards(t, plans) for t in (x, y))
    vx, vy = (S.sp_seg1(t, plans) for t in (sx, sy))
    out.append(("sp_seg1", vx, S.seg1_plain(sx, plans)))
    vx, vy = (S.a2a_fwd(t, plans) for t in (vx, vy))
    w = S.sp_seg2(vx, vy, plans)
    out.append(("sp_seg2", w, S.seg2_plain(vx, vy, plans)))
    w = S.a2a_inv(w, plans)
    for folded in (False, True):
        out.append((f"sp_seg3{' p3x' if folded else ''}",
                    S.sp_seg3(w, plans, folded=folded),
                    S.seg3_plain(w, plans, folded=folded)))
    out.append(("SP path == B1",
                S.polymul_fourstep_mxu(x, y, plans), ref))
    aspec = S.fixed_spectrum(a[0], plans)
    out.append(("sp_seg2_fwd", S.sp_seg2_fwd(vx, plans),
                S.seg2_fwd_plain(vx, plans)))
    out.append(("sp_seg2_fixed", S.sp_seg2_fixed(vx, aspec, plans),
                S.seg2_fixed_plain(vx, aspec, plans)))
    op = S.fold_sp_operand(*fourstep_fold_tables(plans,
                                                 aspec.cpu().numpy()),
                           plans, device)
    out.append(("sp_seg2_folded", S.sp_seg2_folded(vx, op, plans),
                S.seg2_folded_plain(vx, op, plans)))
    ran = f"sp=k{k} n1={n1} B11-B16"
    if get_mxu_tables(name).D <= 3:
        cp = class_boundary_plan(name, n1, k)
        ux, uy = (C.sp_seg1_classes(t, plans, cp) for t in (sx, sy))
        out.append(("sp_seg1_classes", ux,
                    C.seg1_classes_plain(sx, plans, cp)))
        ux, uy = (C.a2a_fwd_classes(t, plans, cp.Dout) for t in (ux, uy))
        out.append(("sp_seg2_classes", C.sp_seg2_classes(ux, uy, plans, cp),
                    C.seg2_classes_plain(ux, uy, plans, cp)))
        out.append(("class path == B1",
                    C.polymul_fourstep_mxu_classes_fn(name, mesh)(x, y), ref))
        ran += " B17-B18"
    return ran


def check_prime(n: int, q: int, device: torch.device, sp: bool,
                rng: np.random.Generator) -> tuple[str, list[str]]:
    """Register (n, q) and run every kernel on three rows; the plan line
    and the names of the checks that differ."""
    name = f"fuzz-{n}-{q}"
    if name not in PARAMS.PARAM_SETS:
        PARAMS.register_param_set(name, n, q)
    tbl = get_tables(name)
    mt = get_mxu_tables(name)

    def dev(v):
        return torch.from_numpy(v).to(device)

    xy = rng.integers(0, q, (2, 3, n), dtype=np.uint32)
    xy[:, 0] = q - 1
    x, y = dev(xy[0]), dev(xy[1])
    a = dev(rng.integers(0, q, (1, n), dtype=np.uint32))
    lazy = rng.integers(0, 2 * q, (3, n), dtype=np.uint32)
    lazy[0] = 2 * q - 1
    pw = rng.integers(0, mt.pw_bound, (3, n), dtype=np.uint32)
    pw[0] = mt.pw_bound - 1
    lazy, pw = dev(lazy), dev(pw)
    ref = F.polymul_fused(x, y, tbl)
    spec = F.ntt_fused(a, tbl)
    b4 = F.polymul_fixed_fused(x, spec, tbl)
    X = F.ntt_fused(x, tbl)
    checks = [
        ("polymul_fused", ref, F.polymul_plain(x, y, tbl)),
        ("ntt_fused", X, F.ntt_plain(x, tbl)),
        ("intt_fused", F.intt_fused(lazy, tbl), F.intt_plain(lazy, tbl)),
        ("B3(B2(x)) == x", F.intt_fused(X, tbl), x),
        ("polymul_fixed_fused", b4, F.polymul_fixed_plain(x, spec, tbl)),
        ("polymul_mxu", M.polymul_mxu(x, y, mt),
         M.polymul_mxu_plain(x, y, mt)),
        ("B5 == B1", M.polymul_mxu(x, y, mt), ref),
        ("ntt_mxu", M.ntt_mxu(x, mt), M.ntt_mxu_plain(x, mt)),
        ("B6 == B2", M.ntt_mxu(x, mt), X),
        ("intt_mxu", M.intt_mxu(pw, mt), M.intt_mxu_plain(pw, mt)),
        ("B7(B6(x)) == x", M.intt_mxu(M.ntt_mxu(x, mt), mt), x),
        ("polymul_fixed_mxu", M.polymul_fixed_mxu(x, spec, mt),
         M.polymul_fixed_mxu_plain(x, spec, mt)),
        ("B8 == B4", M.polymul_fixed_mxu(x, spec, mt), b4),
    ]
    op = M.fold_operand(spec, mt)
    z9 = M.polymul_fixed_folded_mxu(x, op, mt)
    checks += [("polymul_fixed_folded_mxu", z9,
                M.polymul_fixed_folded_mxu_plain(x, op, mt)),
               ("B9 == B4", z9, b4)]
    for p in P.PAIRINGS:
        z = P.polymul_pairing(x, y, tbl, p)
        checks += [(f"polymul_pairing_{p}", z,
                    P.polymul_pairing_plain(x, y, tbl, p)),
                   (f"B10 {p} == B1", z, ref)]
    line = plan_line(mt)
    if sp:
        line += " " + _sp_checks(name, x, y, a, ref, device, checks)
    want = _oracle(xy[0, :2], xy[1, :2], name)
    checks.append(("B1 == oracle", ref[:2], torch.from_numpy(want)))
    bad = [what for what, got, exp in checks
           if not torch.equal(got.cpu(), exp.cpu())]
    return line, bad


def sweep(n: int, qs: list[int], device, sp: bool = False, seed: int = 0,
          log=print) -> int:
    """``check_prime`` for every q of ``qs`` at row length n; the
    mismatching primes' count.  A prime whose planner or kernel raises
    counts as a mismatch."""
    rng = np.random.default_rng(seed)
    device = torch.device(device)
    log(f"n={n}: sweeping {len(qs)} primes on {device}, {qs[0]} "
        f"({qs[0].bit_length()}b) .. {qs[-1]} ({qs[-1].bit_length()}b)")
    failures = 0
    for q in qs:
        start = time.perf_counter()
        try:
            line, bad = check_prime(n, q, device, sp, rng)
        except Exception:           # a refusal is a finding of the sweep
            line, bad = traceback.format_exc().strip(), ["raised"]
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        failures += bool(bad)
        log(f"  q={q:>11} ({q.bit_length():>2}b): "
            f"{'FAIL ' + ', '.join(bad) if bad else 'ok  '} {line} "
            f"({time.perf_counter() - start:.2f} s)")
    log(f"n={n}: {'FAILURES: %d' % failures if failures else 'all ok'}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--per-decade", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sp", action="store_true",
                    help="also the SP kernels B11-B16 and, at most 3 "
                         "classes, B17 and B18 (model axis 2)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("fuzz_params: no CUDA device; pass --device cpu for the "
              "twins", file=sys.stderr)
        return 2
    qs = primes_for_n(args.n, args.per_decade)
    return 1 if sweep(args.n, qs, args.device, args.sp, args.seed) else 0


if __name__ == "__main__":
    sys.exit(main())
