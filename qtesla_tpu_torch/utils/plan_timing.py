"""Time the planners of the digit-matmul paths at one ring: seconds and
peak host memory of each step.

    python -m qtesla_tpu_torch.utils.plan_timing [--log2n 21] [--q 998244353]
        [--k 4] [--device cuda]

Steps, in one process, in this order, each planned on ``--device`` (where
the planners' elementwise passes run and the tables are built): the MXU
plan (``get_mxu_tables``), its kernel-layout tables there
(``ntt_mxu.device_tables``), B9's prepare of one constant
(``ntt_mxu.fold_operand``); then, with the MXU plan dropped, the SP plan at
model axis ``--k`` and n1 = ``distributed.sp_n1(n)``
(``fourstep_mxu_plans``), its tables there (``sharded_mxu.device_tables``)
and one constant's folded segment-2 tables (``fourstep_fold_blocks``, the
table part of the folded SP prepare).  Each
line gives the step's seconds (host clock, the device synchronised) and
the largest resident set of the process during it and before it
(``PeakRss``: sampled every 5 ms from /proc/self/statm), and the card's
name and power limit
(nvidia-smi).  The constant is seeded and random.  ``--device cpu`` runs
the same steps on the CPU (for a rehearsal at a small ring); a CUDA device
that is not there exits 1.
"""

from __future__ import annotations

import argparse
import gc
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from ..ops import mxu_tables as MT
from ..ops import ntt_mxu as M
from ..params import register_param_set
from ..parallel import distributed as Dist
from ..parallel import sharded_mxu as S
from ..parallel import sharded_mxu_tables as ST

_PAGE = os.sysconf("SC_PAGE_SIZE")


def rss_bytes() -> int:
    """The resident set of this process now."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * _PAGE


class PeakRss:
    """The largest resident set of this process while the block runs
    (``peak``, bytes; ``base`` the set when it began), sampled every
    ``interval`` s on a thread of its own; the samples miss a peak shorter
    than the interval."""

    def __init__(self, interval: float = 0.005):
        self.interval, self.peak = interval, 0
        self._stop = threading.Event()

    def _sample(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, rss_bytes())
            self._stop.wait(self.interval)

    def start(self) -> "PeakRss":
        self.peak = self.base = rss_bytes()
        self._stop.clear()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> int:
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_bytes())
        return self.peak

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def timed(what: str, device: torch.device, fn, *args):
    """``fn(*args)`` with its seconds (the device synchronised) and peak
    resident set printed; returns its result."""
    with PeakRss() as rss:
        start = time.perf_counter()
        out = fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize()
        s = time.perf_counter() - start
    print(f"{what}: {s:.2f} s, peak host RSS {rss.peak / 2**30:.2f} GiB "
          f"({rss.base / 2**30:.2f} GiB before it)", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log2n", type=int, default=21)
    ap.add_argument("--q", type=int, default=998244353)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("plan_timing: no CUDA device", file=sys.stderr)
        return 1
    label = "cpu"
    if dev.type == "cuda":
        label = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    n, q = 1 << args.log2n, args.q
    name = f"plan-n{n}-q{q}"
    register_param_set(name, n, q)
    print(f"plan_timing n={n} q={q} k={args.k} on {dev} [{label}], "
          f"{os.cpu_count()} host cores, {torch.get_num_threads()} torch "
          f"threads; MXU tables at least {MT.table_bytes(n, q)} bytes",
          flush=True)
    rng = np.random.default_rng(n)
    mt = timed("MXU plan (get_mxu_tables)", dev, MT.get_mxu_tables, name,
               None, dev)
    timed("MXU tables on the device (device_tables)", dev,
          M.device_tables, mt, dev)
    spec = torch.from_numpy(rng.integers(0, q, n, dtype=np.uint32)).to(dev)
    timed("B9 prepare (fold_operand)", dev, M.fold_operand, spec, mt)
    del mt
    for fn in (M.device_tables, MT.get_mxu_tables, MT.fold_plan,
               MT.lane_packed):
        fn.cache_clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    n1 = Dist.sp_n1(n)
    print(f"SP n1={n1}: tables at least "
          f"{ST.sp_table_bytes(n, q, n1, args.k)} bytes", flush=True)
    plans = timed(f"SP plan k={args.k} (fourstep_mxu_plans)", dev,
                  ST.fourstep_mxu_plans, name, n1, args.k, dev)
    timed("SP tables on the device (device_tables)", dev, S.device_tables,
          plans, dev)
    aspec = torch.from_numpy(rng.integers(0, q, n, dtype=np.uint32)).to(dev)
    timed("SP fold tables (fourstep_fold_blocks)", dev,
          ST.fourstep_fold_blocks, plans, aspec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
