"""The port's timing harness (``qtesla_tpu_torch/utils/timing.py``) against
the JAX package's (``qtesla_tpu/utils/timing.py``), on the CPU.

- ``BenchResult.from_times`` on one list of samples gives JAX's min,
  median, mean and std, throughputs and the same ``line()`` prefix; the
  port's line ends with the device and the clock.
- ``measure(chain=True)`` feeds each output back as the last argument and
  runs one warm chained run plus exactly ``iters * repeats`` timed calls;
  ``measure(chain=False)`` runs ``warmup + iters``; both count the timed
  calls in ``calls`` and time on the host's clock on the CPU.
- ``trace_dir`` writes a ``torch.profiler`` trace.
- ``measure_streamed`` stages numpy operands to the device and back every
  iteration.
- ``time_cuda`` refuses the CPU.
- The benchmark functions run on the CPU at small sizes, each naming the
  CPU and the host's clock: ``benchmark_polymul`` (its operands are JAX's,
  drawn from the same seed), the streamed form, ``benchmark_reduction`` for
  every op (the chained result equal to the op applied ``iters`` times in
  numpy), and the one-shard local benchmarks of the SP paths and Ulysses.

Times are checked for their form only."""

import os

import numpy as np
import pytest
import torch

from qtesla_tpu.utils import timing as JT
from qtesla_tpu_torch.utils import timing as T

SAMPLES = [0.0417, 0.0032, 0.0031, 0.00335]


def test_bench_result_statistics_equal_jax():
    kw = dict(name="o", iters=400, items_per_iter=16384)
    j = JT.BenchResult.from_times(SAMPLES, **kw)
    t = T.BenchResult.from_times(SAMPLES, **kw)
    for f in ("min_s", "median_s", "mean_s", "std_s", "iters",
              "items_per_iter"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.throughput == j.throughput
    assert t.throughput_best == j.throughput_best
    assert t.line().startswith(j.line())
    assert t.line().endswith("[cpu, host]")
    assert (t.device, t.clock, t.calls) == ("cpu", "host", len(SAMPLES))


class _Counting:
    """fn(head, c) -> a new tensor c + 1, recording what each call got."""

    def __init__(self):
        self.got = []

    def __call__(self, head, c):
        out = c + 1
        self.got.append((c, out))
        return out


@pytest.mark.parametrize("iters,repeats", [(1, 1), (3, 2), (5, 3)])
def test_measure_chain_feeds_output_back(iters, repeats):
    fn = _Counting()
    head, tail = torch.zeros(4), torch.zeros(4)
    r = T.measure(fn, head, tail, warmup=7, iters=iters, repeats=repeats,
                  items_per_iter=4, chain=True)
    assert len(fn.got) == iters * (repeats + 1)     # warm run + timed runs
    assert r.calls == iters * repeats and len(r.samples_s) == repeats
    for run in range(repeats + 1):
        calls = fn.got[run * iters:(run + 1) * iters]
        assert calls[0][0] is tail                  # each run starts afresh
        for (_, prev_out), (now_in, _) in zip(calls, calls[1:]):
            assert now_in is prev_out
        assert torch.equal(calls[-1][1], tail + iters)
    assert (r.clock, r.device) == ("host", "cpu")
    assert r.throughput_best >= r.throughput > 0


@pytest.mark.parametrize("warmup", [0, 2])
def test_measure_unchained_runs_warmup_plus_iters(warmup):
    calls = []
    x = torch.ones(8)
    r = T.measure(lambda a: calls.append(a) or a + 1, x, warmup=warmup,
                  iters=4, name="w")
    assert len(calls) == warmup + 4 and all(c is x for c in calls)
    assert r.calls == r.iters == 4 and len(r.samples_s) == 4
    assert r.mean_s > 0 and r.clock == "host"


def test_measure_trace_dir_writes_a_trace(tmp_path):
    d = tmp_path / "trace"
    x = torch.ones(4, 8)
    r = T.measure(torch.add, x, x, warmup=1, iters=2, chain=True,
                  trace_dir=str(d), name="t[x=1]")
    assert r.mean_s > 0
    files = os.listdir(d)
    assert files and all(f.endswith(".json") for f in files)
    assert (d / files[0]).stat().st_size > 0


def test_measure_streamed_copies_every_iteration():
    seen = []
    xh = np.arange(12, dtype=np.uint32).reshape(3, 4)

    def fn(x):
        seen.append(x)
        return x * 2

    r = T.measure_streamed(fn, xh, warmup=1, iters=3, items_per_iter=3,
                           device="cpu")
    assert len(seen) == 4 and len({id(s) for s in seen}) == 4
    assert all(s.dtype == torch.uint32 and torch.equal(
        s, torch.from_numpy(xh)) for s in seen)
    assert (r.clock, r.device, r.calls) == ("host", "cpu", 3)


def test_time_cuda_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        T.time_cuda(torch.add, torch.ones(2), torch.ones(2))


def test_device_label_of_the_cpu():
    assert T.device_label("cpu") == "cpu"


def test_benchmark_polymul_on_the_cpu():
    r = T.benchmark_polymul("smallprime", "merged", batch=8, iters=2,
                            seed=3, device="cpu")
    assert r.name == "polymul[smallprime,merged,B=8]"
    assert (r.device, r.clock, r.calls) == ("cpu", "host", 2 * 3)
    assert r.items_per_iter == 8
    s = T.benchmark_polymul_streamed("smallprime", "stockham", batch=8,
                                     iters=2, seed=3, device="cpu")
    assert s.name == "polymul_streamed[smallprime,stockham,B=8]"
    assert (s.device, s.clock, s.calls) == ("cpu", "host", 2)


@pytest.mark.parametrize("op", T.REDUCTION_OPS)
def test_benchmark_reduction_on_the_cpu(op, monkeypatch):
    """The timed function is the op, chained: the last timed run's output
    equals the op applied iters times in Python integers."""
    from qtesla_tpu_torch.params import get_params
    ps = get_params("smallprime")
    q, size, iters, seed = ps.q, 64, 3, 5
    outs = []
    real = T.measure

    def spy(fn, *args, **kw):
        def rec(*a):
            out = fn(*a)
            outs.append(out)
            return out
        return real(rec, *args, **kw)

    monkeypatch.setattr(T, "measure", spy)
    r = T.benchmark_reduction("smallprime", op, size=size, iters=iters,
                              seed=seed, device="cpu")
    assert r.name == f"reduction[smallprime,{op},{size},torch elementwise " \
                     f"int64]"
    assert (r.device, r.clock, r.calls) == ("cpu", "host", iters * 3)
    rng = np.random.default_rng(seed)
    x, w = (rng.integers(0, q, size, dtype=np.uint32).astype(object)
            for _ in range(2))
    c = x.copy()
    for _ in range(iters):
        c = {"addmod": lambda b: (x + b) % q,
             "mulhi": lambda b: (x * b) >> 32,
             "shoup": lambda b: (b * w) % q,
             "barrett": lambda b: (x * b) % q}[op](c)
    assert outs[-1].tolist() == [int(v) for v in c]


def test_benchmark_reduction_unknown_op():
    with pytest.raises(ValueError, match="unknown reduction op"):
        T.benchmark_reduction("smallprime", "montgomery", size=8,
                              device="cpu")


@pytest.mark.parametrize("bench,name", [
    (T.benchmark_sp_local, "sp_local"),
    (T.benchmark_sp_local_classes, "sp_local_classes"),
    (T.benchmark_sp_local_fixed, "sp_local_fixed"),
    (T.benchmark_sp_local_fixed_folded, "sp_local_fixed_folded"),
    (T.benchmark_ulysses_local, "ulysses_local"),
])
def test_local_benchmarks_on_the_cpu(bench, name):
    out = bench("smallprime", 2, batch=4, iters=2, warmup=1, device="cpu")
    r = out if isinstance(out, T.BenchResult) else out[0]
    assert r.name == f"{name}[smallprime,k=2,B=4]"
    assert (r.device, r.clock, r.calls) == ("cpu", "host", 2 * 3)
    assert r.min_s > 0
