"""Timing on the card, and the benchmark harness of the CLI.

Counterpart of ``qtesla_tpu/utils/timing.py``: ``BenchResult``,
``measure``, ``measure_streamed``, ``benchmark_polymul``,
``benchmark_polymul_streamed``, ``benchmark_reduction`` and the
``benchmark_sp_local*`` / ``benchmark_ulysses_local`` family, with the same
statistics (min, median, mean, std over the recorded per-call times) and
the same ``line()``.  Every result also names the device it ran on
(``device``: the card's name and power limit, or ``"cpu"``) and its clock
(``clock``): ``"cuda-events"`` where a pair of CUDA events on the current
stream bracketed the calls, ``"host"`` where ``time.perf_counter`` did,
after the call returned (the CPU, and the transfer-inclusive bracket).  A
time taken on the host's clock is never reported under a device's name.
``calls`` counts the timed calls that actually ran.

``time_cuda(fn, *args)`` runs ``warmup`` untimed calls, then ``repeats``
calls each bracketed by a pair of CUDA events on the current stream, and
reports the min and median per-call time over the calls it actually ran.
With ``cold=True`` each timed call is preceded, outside its events, by a
read of ``COLD_BYTES`` (more than twice the H100's 50 MB L2; a read, so
that the lines it leaves are clean and the call writes none back), so that
no operand is left in L2 by the call before, and by a sleep of the card of
about 2 ms, so that the host has queued the whole call before the card
reaches it and the events read the card's time, not the host's.  It
refuses to time anything but a CUDA device: a time measured on the CPU is
never reported under a device metric's name.

Nothing here builds a kernel or queries a device when it is imported.
"""

from __future__ import annotations

import functools
import os
import re
import statistics
import subprocess
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

__all__ = ["Timing", "time_cuda", "COLD_BYTES", "BenchResult", "measure",
           "measure_streamed", "device_label", "benchmark_polymul",
           "benchmark_polymul_streamed", "benchmark_reduction",
           "benchmark_sp_local", "benchmark_sp_local_classes",
           "benchmark_sp_local_fixed", "benchmark_sp_local_fixed_folded",
           "benchmark_ulysses_local", "REDUCTION_OPS"]

COLD_BYTES = 128 << 20
_SLEEP_CYCLES = 4_000_000        # about 2 ms at the H100's 1.98 GHz


@dataclass(frozen=True)
class Timing:
    min_ms: float
    median_ms: float
    calls: int                 # timed calls actually run (warmup excluded)
    warmup: int
    samples_ms: tuple[float, ...]


def time_cuda(fn: Callable, *args, warmup: int = 3, repeats: int = 20,
              cold: bool = False) -> Timing:
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device")
    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    for _ in range(warmup):
        fn(*args)
    scratch = (torch.zeros(COLD_BYTES, dtype=torch.uint8, device="cuda")
               if cold else None)
    torch.cuda.synchronize()
    pairs = []
    for _ in range(repeats):
        if cold:
            scratch.max()
            torch.cuda._sleep(_SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    samples = tuple(s.elapsed_time(e) for s, e in pairs)
    return Timing(min(samples), statistics.median(samples), len(samples),
                  warmup, samples)


# ----------------------------------------------------------------------
# The harness.
# ----------------------------------------------------------------------

@dataclass
class BenchResult:
    name: str
    iters: int
    mean_s: float
    min_s: float
    std_s: float
    items_per_iter: int = 1
    median_s: float = 0.0
    device: str = "cpu"        # device_label() of where the calls ran
    clock: str = "host"        # "cuda-events" or "host"
    calls: int = 0             # timed calls actually run
    samples_s: tuple[float, ...] = ()     # the per-call times recorded

    @classmethod
    def from_times(cls, times, *, name: str, iters: int,
                   items_per_iter: int = 1, device: str = "cpu",
                   clock: str = "host", calls: int | None = None
                   ) -> "BenchResult":
        """Statistics over per-call times: the MIN is the headline (a
        hiccup only inflates a time), the median the central tendency."""
        times = [float(t) for t in times]
        return cls(
            name=name, iters=iters, mean_s=statistics.fmean(times),
            min_s=min(times), median_s=statistics.median(times),
            std_s=statistics.stdev(times) if len(times) > 1 else 0.0,
            items_per_iter=items_per_iter, device=device, clock=clock,
            calls=len(times) if calls is None else calls,
            samples_s=tuple(times))

    @property
    def mean_ms(self) -> float:
        return self.mean_s * 1e3

    @property
    def throughput(self) -> float:
        """items/s from the median per-call time."""
        return self.items_per_iter / (self.median_s or self.mean_s)

    @property
    def throughput_best(self) -> float:
        """items/s from the min per-call time (the statistic of the JSON
        rows and of ``line()``)."""
        return self.items_per_iter / self.min_s

    def line(self) -> str:
        """One diagnostic line: JAX's, then the device and the clock."""
        med = (self.median_s or self.mean_s) * 1e3
        return (f"{self.name}: {med:.3f} ms/iter "
                f"(min {self.min_s * 1e3:.3f}, mean {self.mean_ms:.3f}, "
                f"std {self.std_s * 1e3:.3f}) "
                f"-> {self.throughput_best:,.0f} items/s "
                f"[{self.device}, {self.clock}]")


@functools.lru_cache(maxsize=None)
def _smi_line(index: int) -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    line = out.stdout.strip()
    return line if out.returncode == 0 and line else None


def device_label(device) -> str:
    """"cpu", or the card's name and power limit as nvidia-smi prints them
    (``name, power.limit``), or its name alone where nvidia-smi does not
    answer."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    return _smi_line(index) or torch.cuda.get_device_name(index)


def _device_of(values) -> torch.device:
    """The device of the first tensor among ``values`` (the CPU if none)."""
    for v in values:
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


class _Clock:
    """Brackets on one device: CUDA events on the current stream, or the
    host's clock after the work returned."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.name = "cuda-events" if self.cuda else "host"

    def start(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def seconds(self, start) -> float:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        return time.perf_counter() - start

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


def _trace_name(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.=-]+", "_", name).strip("_") or "trace"


def measure(fn: Callable, *args, warmup: int = 3, iters: int = 10,
            items_per_iter: int = 1, name: str = "bench",
            trace_dir: str | None = None, chain: bool = False,
            repeats: int = 3) -> BenchResult:
    """Time fn(*args) on the device of its first tensor argument.

    chain=False: ``warmup`` untimed calls, then ``iters`` calls, each timed
    on its own and waited for (host dispatch included, as the reference's
    per-loop timing, NTT.cu:2034-2081).

    chain=True: fn's output is fed back as its LAST argument, ``iters``
    calls enqueued back to back from the arguments given, and each time is
    that of the run divided by ``iters``.  ``warmup`` is ignored: one
    untimed chained run warms up, then ``repeats`` timed runs.

    On a CUDA device the bracket is a pair of CUDA events on the current
    stream; on the CPU the host's clock after the calls returned.  Every
    timed call is counted in ``calls`` (``iters * repeats`` chained,
    ``iters`` otherwise).  Times are warm: nothing flushes L2 between
    calls, so at small batches the host's launches may be what is timed
    (``time_cuda(cold=True)`` reads the card's time).  ``trace_dir`` writes
    a ``torch.profiler`` trace of the timed calls (after the warmup) there,
    as ``<name>.json``.
    """
    if iters < 1 or (chain and repeats < 1):
        raise ValueError("iters and repeats must be >= 1")
    clock = _Clock(_device_of(args))
    head = args[:-1]

    def run_chain():
        c = args[-1]
        for _ in range(iters):
            c = fn(*head, c)
        return c

    if chain:
        run_chain()
    else:
        for _ in range(warmup):
            fn(*args)
    clock.sync()
    prof = None
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if clock.cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    times = []
    try:
        if chain:
            for _ in range(repeats):
                t0 = clock.start()
                run_chain()
                times.append(clock.seconds(t0) / iters)
        else:
            for _ in range(iters):
                t0 = clock.start()
                fn(*args)
                times.append(clock.seconds(t0))
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                trace_dir, _trace_name(name) + ".json"))
    return BenchResult.from_times(
        times, name=name, iters=iters, items_per_iter=items_per_iter,
        device=device_label(_device_of(args)), clock=clock.name,
        calls=iters * repeats if chain else iters)


def measure_streamed(fn: Callable, *host_args, warmup: int = 2,
                     iters: int = 10, items_per_iter: int = 1,
                     name: str = "bench", device="cuda") -> BenchResult:
    """Transfer-INCLUSIVE timing on the host's clock: each iteration copies
    the numpy operands to ``device`` (``torch.from_numpy(a).to(device)``,
    from pageable host memory, so each copy is staged by the driver), runs
    fn and copies the whole result back to numpy.  The reference's
    headline bracket (NTT.cu:2036-2079: cudaMemcpy H2D + kernels + D2H in
    the timed loop): what a call costs when its operands arrive from host
    RAM, the case ``measure(chain=True)`` excludes."""
    device = torch.device(device)

    def one():
        dev = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in host_args)
        return fn(*dev).cpu().numpy()

    for _ in range(warmup):
        one()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        one()
        times.append(time.perf_counter() - t0)
    return BenchResult.from_times(times, name=name, iters=iters,
                                  items_per_iter=items_per_iter,
                                  device=device_label(device), clock="host")


def _operands(q: int, shape, seed: int):
    """Two numpy uint32 arrays of residues below q, drawn in order from
    ``np.random.default_rng(seed)``, as the JAX harness draws them."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, q, shape, dtype=np.uint32) for _ in range(2)]


def _on(device, *arrays):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def benchmark_polymul_streamed(param_set: str, algo: str = "merged",
                               batch: int = 4096, iters: int = 10,
                               warmup: int = 2, seed: int = 0,
                               device="cuda") -> BenchResult:
    """Streamed (transfer-inclusive) negacyclic polymul throughput: the
    operands start in host RAM every iteration and the product is fetched
    back (``measure_streamed``)."""
    from ..models import polymul_fn
    from ..params import get_params

    ps = get_params(param_set)
    x, y = _operands(ps.q, (batch, ps.n), seed)
    return measure_streamed(
        polymul_fn(param_set, algo), x, y, warmup=warmup, iters=iters,
        items_per_iter=batch, device=device,
        name=f"polymul_streamed[{param_set},{algo},B={batch}]")


def benchmark_polymul(param_set: str, algo: str = "merged",
                      batch: int = 4096, iters: int = 20,
                      warmup: int = 3, seed: int = 0,
                      trace_dir: str | None = None,
                      chain: bool = True, device="cuda") -> BenchResult:
    """Steady-state batched negacyclic polymul throughput on ``device``
    (the reference's polymuls/s, NTT.cu:2083), device-resident operands.
    Chained by default: z_{i+1} = polymul(x, z_i)."""
    from ..models import polymul_fn
    from ..params import get_params

    ps = get_params(param_set)
    x, y = _on(device, *_operands(ps.q, (batch, ps.n), seed))
    return measure(polymul_fn(param_set, algo), x, y, warmup=warmup,
                   iters=iters, items_per_iter=batch, chain=chain,
                   name=f"polymul[{param_set},{algo},B={batch}]",
                   trace_dir=trace_dir)


REDUCTION_OPS = ("addmod", "mulhi", "shoup", "barrett")


def benchmark_reduction(param_set: str, op: str = "shoup",
                        size: int = 1 << 22, iters: int = 50,
                        seed: int = 0, device="cuda") -> BenchResult:
    """Element throughput of one modular-reduction primitive (the
    reference's red_assembly / test_reduction experiment, NTT.cu:282-377)
    as the port's plain ops compute it: torch elementwise operations on
    int64 tensors holding uint32 values (``ops/modmul.py``), chained.  The
    JAX package times XLA's elementwise ops here; this is likewise no
    kernel of the port: the CUDA kernels take their high words with the
    native ``__umulhi``, which these rows do not time."""
    from ..ops import modmul as mm
    from ..params import get_params

    if op not in REDUCTION_OPS:
        raise ValueError(f"unknown reduction op {op!r}; available: "
                         f"{', '.join(REDUCTION_OPS)}")
    ps = get_params(param_set)
    q = ps.q
    xh, wh = _operands(q, size, seed)
    wsh = ((wh.astype(np.uint64) << 32) // q).astype(np.int64)  # w < 2^30
    x, w = (torch.from_numpy(a.astype(np.int64)).to(device) for a in (xh, wh))
    wsh = torch.from_numpy(wsh).to(device)
    fn = {"shoup": lambda a, b: mm.shoup_mulmod(b, w, wsh, q),
          "barrett": lambda a, b: mm.mulmod_barrett(
              a, b, q, ps.r32, ps.r32_shoup, ps.one_shoup),
          "addmod": lambda a, b: mm.add_mod(a, b, q),
          "mulhi": mm._mulhi32}[op]
    return measure(fn, x, x, warmup=2, iters=iters, chain=True,
                   items_per_iter=size,
                   name=f"reduction[{param_set},{op},{size},"
                        f"torch elementwise int64]")


def _local(fn, args, *, name: str, items: int, iters: int,
           warmup: int) -> BenchResult:
    """One shard's local work: cold on the card (``time_cuda(cold=True)``:
    L2 flushed and the host queued ahead before each call, so the card's
    time is read), chained on the CPU's host clock."""
    device = _device_of(args)
    if device.type == "cuda":
        t = time_cuda(fn, *args, warmup=warmup, repeats=iters, cold=True)
        return BenchResult.from_times(
            [s / 1e3 for s in t.samples_ms], name=name, iters=iters,
            items_per_iter=items, device=device_label(device),
            clock="cuda-events", calls=t.calls)
    return measure(fn, *args, warmup=warmup, iters=iters, chain=True,
                   items_per_iter=items, name=name)


def benchmark_sp_local(param_set: str, k: int, batch: int = 16384,
                       iters: int = 400, warmup: int = 2, seed: int = 0,
                       n1: int | None = None, device="cuda"):
    """One shard's local work of the two-operand four-step SP path (B11 on
    both operands, B12, B16; ``local_pipeline_fn``) on its (batch, n/k)
    shard, without the exchanges: the surface of the SP cost per shard,
    k * t_local / t_single.  Returns (BenchResult, plans)."""
    from ..parallel.sharded_mxu import local_pipeline_fn
    from ..params import get_params

    ps = get_params(param_set)
    pipe, plans = local_pipeline_fn(param_set, k, n1)
    x, y = _on(device, *_operands(ps.q, (batch, plans.nloc), seed))
    r = _local(pipe, (x, y), iters=iters, warmup=warmup, items=batch,
               name=f"sp_local[{param_set},k={k},B={batch}]")
    return r, plans


def benchmark_ulysses_local(param_set: str, k: int, batch: int = 16384,
                            iters: int = 400, warmup: int = 2,
                            seed: int = 0, device="cuda") -> BenchResult:
    """One shard's local work of the Ulysses SP path: the unmodified
    single-device pipeline on its batch/k full rows, B1 (``"fused"``) on
    the card and the merged pipeline on the CPU."""
    from ..models import polymul_fn
    from ..params import get_params

    if batch % k:
        raise ValueError(f"batch {batch} must divide by k={k}")
    ps = get_params(param_set)
    algo = "fused" if torch.device(device).type == "cuda" else "merged"
    Bl = batch // k
    x, y = _on(device, *_operands(ps.q, (Bl, ps.n), seed))
    return _local(polymul_fn(param_set, algo), (x, y), iters=iters,
                  warmup=warmup, items=Bl,
                  name=f"ulysses_local[{param_set},k={k},B={batch}]")


def benchmark_sp_local_classes(param_set: str, k: int, batch: int = 16384,
                               iters: int = 400, warmup: int = 2,
                               seed: int = 0, n1: int | None = None,
                               device="cuda"):
    """One shard's local work of the class-sum boundary SP path (B17 on
    both operands, B18, B16; ``local_pipeline_classes_fn``), without the
    exchanges.  Returns (BenchResult, plans, class plan)."""
    from ..parallel.sharded_classes import local_pipeline_classes_fn
    from ..params import get_params

    ps = get_params(param_set)
    pipe, plans, cp = local_pipeline_classes_fn(param_set, k, n1)
    x, y = _on(device, *_operands(ps.q, (batch, plans.nloc), seed))
    r = _local(pipe, (x, y), iters=iters, warmup=warmup, items=batch,
               name=f"sp_local_classes[{param_set},k={k},B={batch}]")
    return r, plans, cp


def _fixed_local(param_set, k, batch, iters, warmup, seed, device, folded):
    from ..parallel.sharded_mxu import fold_sp_operand, local_fixed_pipeline_fn
    from ..parallel.sharded_mxu_tables import fourstep_fold_tables
    from ..params import get_params

    ps = get_params(param_set)
    pipe, plans = local_fixed_pipeline_fn(param_set, k)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, ps.q, (batch, plans.nloc), dtype=np.uint32)
    spec = rng.integers(0, ps.q, (k, plans.nloc), dtype=np.uint32)
    const = (fold_sp_operand(*fourstep_fold_tables(plans, spec), plans,
                             device) if folded
             else torch.from_numpy(spec).to(device))
    tag = "sp_local_fixed_folded" if folded else "sp_local_fixed"
    r = _local(lambda c: pipe(c, const), _on(device, x), iters=iters,
               warmup=warmup, items=batch,
               name=f"{tag}[{param_set},k={k},B={batch}]")
    return r, plans


def benchmark_sp_local_fixed(param_set: str, k: int, batch: int = 16384,
                             iters: int = 400, warmup: int = 2,
                             seed: int = 0, device="cuda"):
    """One shard's local work of the fixed-operand SP path (B11 on x, B13
    against the constant's spectrum row, B16; ``local_fixed_pipeline_fn``),
    without the exchanges: the verifier's SP surface.  Returns
    (BenchResult, plans)."""
    return _fixed_local(param_set, k, batch, iters, warmup, seed, device,
                        folded=False)


def benchmark_sp_local_fixed_folded(param_set: str, k: int,
                                    batch: int = 16384, iters: int = 400,
                                    warmup: int = 2, seed: int = 0,
                                    device="cuda"):
    """One shard's local work of the folded fixed-operand SP path (B11, B15
    against the constant's folded tables, B16 under p3x), without the
    exchanges.  Returns (BenchResult, plans)."""
    return _fixed_local(param_set, k, batch, iters, warmup, seed, device,
                        folded=True)
