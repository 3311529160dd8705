"""CUDA-event timing of a callable on the card.

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
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Callable

import torch

__all__ = ["Timing", "time_cuda", "COLD_BYTES"]

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
