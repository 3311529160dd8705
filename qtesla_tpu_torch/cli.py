"""Command-line interface of the port.

Counterpart of ``qtesla_tpu/cli.py``: the same subcommands, flags,
defaults, printed lines, JSON keys and exit codes.

    python -m qtesla_tpu_torch.cli info
    python -m qtesla_tpu_torch.cli correctness [--param-set S] [--algo A]
                                               [-r SEED] [--random]
    python -m qtesla_tpu_torch.cli speed [--param-set S] [--algo A]
                                         [--batch B] [--iters N] [--fixed]
                                         [--streamed] [--json]
    python -m qtesla_tpu_torch.cli sweep [--param-set S] [--batches ...]
    python -m qtesla_tpu_torch.cli scaling [--global-batch B] [--model K]
    python -m qtesla_tpu_torch.cli microbench [--size N]

JAX's platform (``JAX_PLATFORMS``) becomes the global ``--device``: the card
(``cuda``) by default.  Without a card the CLI exits non-zero naming the
flag; it never carries on on the CPU by itself.  ``--device cpu`` runs the
plain pipelines on the CPU and refuses the kernel algos (``fused``,
``mxu``, ``mxu-folded``, ``<pairing>_kernel``), whose plain twins would
otherwise run under the kernel's name; ``all`` leaves them out there.

``--distributed`` joins the ranks (``parallel.distributed.init_distributed``
on torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``
and ``LOCAL_RANK``, or on ``--init-method``) before anything else runs, one
rank a card, as the JAX CLI calls ``jax.distributed``; ``--backend`` names
the transport (gloo where ranks share a card: NCCL refuses two ranks on one
device).  ``scaling`` then counts one device a rank:

    torchrun --nproc_per_node=2 -m qtesla_tpu_torch.cli --distributed \\
        --backend gloo scaling --algo fused --model 2 --global-batch 32768

Every time is printed with the device it was taken on and its clock
(``utils/timing.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

_WARM_BATCH = 4096


def _parameter_banner(name: str) -> str:
    from .params import get_params
    ps = get_params(name)
    return (f"{ps.name}: n={ps.n} q={ps.q} (logq={ps.q.bit_length()}) "
            f"g={ps.g} psi={ps.psi} omega={ps.omega} n_inv={ps.n_inv}")


def _device_line(device: torch.device) -> str:
    """The device, how many there are, and the ranks under --distributed."""
    from .parallel import distributed as D
    from .utils.timing import device_label
    line = f"device: {device_label(device)}  "
    line += (f"cards: {torch.cuda.device_count()}" if device.type == "cuda"
             else f"host cores: {os.cpu_count()}")
    if D.joined():
        import torch.distributed as dist
        line += (f"  ranks: {D.world_size()} (rank {dist.get_rank()}, "
                 f"backend {dist.get_backend()})")
    return line


def cmd_info(args) -> int:
    from .params import available_param_sets
    print(_device_line(args.device))
    for name in available_param_sets():
        print(_parameter_banner(name))
    return 0


def _kernels() -> list[str]:
    from .ops.ntt_pairings import PAIRINGS
    return ["fused", "mxu"] + [p + "_kernel" for p in sorted(PAIRINGS)]


def _every() -> list[str]:
    """JAX's list: the plain pipelines sorted, then Nussbaumer, then the
    kernel algos (the port's ALGORITHMS also holds the kernel names)."""
    from .models import ALGORITHMS
    kernels = _kernels()
    plain = [a for a in ALGORITHMS if a not in kernels and a != "nussbaumer"]
    return sorted(plain) + ["nussbaumer"] + kernels


def _refuse_kernels(bad: list[str], device: torch.device) -> None:
    if bad and device.type != "cuda":
        raise SystemExit(
            f"algo(s) {bad} are CUDA kernels; this device is "
            f"{device.type!r} — use the plain pipelines (e.g. "
            f"merged/stockham) or run on the card (--device cuda)")


def _algos(arg: str, device) -> list[str]:
    device = torch.device(device)
    kernels, every = _kernels(), _every()
    if arg == "all":
        if device.type == "cuda":
            return every
        # the kernels run only on the card; 'all' on the CPU skips them
        return [a for a in every if a not in kernels]
    algos = arg.split(",")
    for a in algos:
        if a not in every:
            raise SystemExit(f"unknown algo {a!r}; choose from "
                             f"{every} or 'all'")
    _refuse_kernels([a for a in algos if a in kernels], device)
    return algos


def cmd_correctness(args) -> int:
    """Oracle and known-answer checks (reference -cpu group and the GPU
    round-trip tests, NTT.cu:1495-1817)."""
    from .models import polymul_negacyclic
    from .oracle import all_ones_square_closed_form
    from .params import get_params
    from .utils import native

    ps = get_params(args.param_set)
    print(_parameter_banner(ps.name))
    rng = np.random.default_rng(args.seed)
    if args.random:
        x = rng.integers(0, ps.q, (args.batch, ps.n), dtype=np.uint32)
        y = rng.integers(0, ps.q, (args.batch, ps.n), dtype=np.uint32)
    else:
        # the reference's deterministic ramp fixture (NTT.cu:10-11)
        x = np.zeros((args.batch, ps.n), dtype=np.uint32)
        x[:, :ps.n // 2] = (ps.n // 2 - np.arange(ps.n // 2)) % ps.q
        y = x.copy()

    # ground truth: the native C++ oracle where it builds, else big ints
    if native.native_available():
        want = native.negacyclic_schoolbook(x, y, ps.q)
        oracle_name = "C++ schoolbook"
    else:
        from .oracle import negacyclic_schoolbook
        want = np.stack([negacyclic_schoolbook(x[b], y[b], ps)
                         for b in range(args.batch)]).astype(np.uint32)
        oracle_name = "python schoolbook"

    dev = args.device
    xt, yt = (torch.from_numpy(a).to(dev) for a in (x, y))
    failures = 0
    for algo in _algos(args.algo, dev):
        z = polymul_negacyclic(xt, yt, ps, algo=algo).cpu().numpy()
        ok = (z == want).all()
        failures += (not ok)
        print(f"  {algo:10s} vs {oracle_name}: "
              f"{'Identical.' if ok else 'INCORRECT RESULT'}")
    # known-answer fixture per algorithm (reference NTT.cu:1822: all-ones
    # operands whose negacyclic square has a closed form)
    ones = torch.ones((args.batch, ps.n), dtype=torch.uint32, device=dev)
    want1 = all_ones_square_closed_form(ps)
    for algo in _algos(args.algo, dev):
        z1 = polymul_negacyclic(ones, ones, ps, algo=algo).cpu().numpy()
        ok = (z1[0].astype(np.uint64) == want1).all()
        failures += (not ok)
        print(f"  {algo:10s} all-ones closed form: "
              f"{'Identical.' if ok else 'INCORRECT'}")
    return 1 if failures else 0


def _speed_row(tag: str, r, batch: int) -> dict:
    """One JSON result row of `speed`: JAX's keys, then the device and the
    clock the time was taken on."""
    return {"algo": tag, "batch": batch,
            "min_ms_per_iter": r.min_s * 1e3,
            "median_ms_per_iter": (r.median_s or r.mean_s) * 1e3,
            "polymuls_per_s": r.throughput_best,
            "device": r.device, "clock": r.clock}


def _row_line(r, batch: int) -> str:
    """``r.line()``, and at B <= 4096 on the card that it was timed warm:
    back-to-back calls there may time the host's launches, not the card."""
    warm = r.clock == "cuda-events" and batch <= _WARM_BATCH
    return "  " + r.line() + (
        "  (timed warm: at this batch the host's launches may be what was "
        "timed)" if warm else "")


def cmd_speed(args) -> int:
    """Steady-state throughput (reference -speedcpu/-speedgpu groups)."""
    from .utils.timing import benchmark_polymul, device_label
    dev = args.device
    print(f"device: {device_label(dev)}")
    print(_parameter_banner(args.param_set))
    if args.streamed and args.trace_dir:
        print("  NOTE: --trace-dir is ignored in --streamed mode (the "
              "transfer-inclusive loop is host-driven; profile the "
              "device-resident path instead)")
    if args.fixed:
        from .models import polymul_fixed_fn
        from .params import get_params
        from .utils.timing import measure, measure_streamed
        ps = get_params(args.param_set)
        rng = np.random.default_rng(args.seed)
        # fixed-operand pairs exist for 'mxu', 'mxu-folded' and 'fused' (the
        # card) and 'merged'; 'mxu-folded' exists only as a fixed pair, so
        # it is parsed here rather than in _algos
        toks = [t.strip() for t in args.algo.split(",")]
        folded = [t for t in toks if t == "mxu-folded"]
        _refuse_kernels(folded, dev)
        rest = ",".join(t for t in toks if t != "mxu-folded")
        requested = (_algos(rest, dev) if rest else []) + folded
        fixed_algos = [a for a in requested if a in ("mxu", "mxu-folded",
                                                     "fused", "merged")]
        if "mxu" in fixed_algos and "mxu-folded" not in fixed_algos:
            fixed_algos.append("mxu-folded")
        for a in requested:
            if a not in fixed_algos:
                print(f"  {a:10s} SKIP (no fixed-operand variant; "
                      "available: mxu, mxu-folded, fused, merged)")
        if not fixed_algos:
            return 1
        out = []
        for algo in fixed_algos:
            prep, mul = polymul_fixed_fn(ps.name, algo)
            A = prep(torch.from_numpy(
                rng.integers(0, ps.q, (1, ps.n), dtype=np.uint32)).to(dev))
            if algo != "mxu-folded":
                A = A[0]        # (1, n) spectrum -> (n,); folded prep
                                # returns a FoldedOperand
            xh = rng.integers(0, ps.q, (args.batch, ps.n), dtype=np.uint32)
            if args.streamed:
                # the verifier's transfer-inclusive bracket: A stays on the
                # device, each iteration stages a fresh batch from host RAM
                # and fetches the product back (NTT.cu:2036-2079)
                r = measure_streamed(lambda c, mul=mul, A=A: mul(c, A), xh,
                                     warmup=2, iters=args.iters,
                                     items_per_iter=args.batch, device=dev,
                                     name=f"polymul_fixed_streamed[{ps.name},"
                                          f"{algo},B={args.batch}]")
                tag = f"fixed_streamed/{algo}"
            else:
                x = torch.from_numpy(xh).to(dev)
                r = measure(lambda _, c, mul=mul, A=A: mul(c, A), x, x,
                            warmup=2, iters=args.iters,
                            items_per_iter=args.batch, chain=True,
                            trace_dir=args.trace_dir,
                            name=f"polymul_fixed[{ps.name},{algo},"
                                 f"B={args.batch}]")
                tag = f"fixed/{algo}"
            out.append(_speed_row(tag, r, args.batch))
            print(_row_line(r, args.batch))
        if args.json:
            print(json.dumps(out))
        return 0
    out = []
    if args.streamed:
        from .utils.timing import benchmark_polymul_streamed
        for algo in _algos(args.algo, dev):
            r = benchmark_polymul_streamed(args.param_set, algo,
                                           batch=args.batch,
                                           iters=args.iters, seed=args.seed,
                                           device=dev)
            out.append(_speed_row(f"streamed/{algo}", r, args.batch))
            print(_row_line(r, args.batch))
        if args.json:
            print(json.dumps(out))
        return 0
    for algo in _algos(args.algo, dev):
        r = benchmark_polymul(args.param_set, algo, batch=args.batch,
                              iters=args.iters, seed=args.seed,
                              trace_dir=args.trace_dir, device=dev)
        out.append(_speed_row(algo, r, args.batch))
        print(_row_line(r, args.batch))
    if args.json:
        print(json.dumps(out))
    return 0


def cmd_sweep(args) -> int:
    """Batch-size sweep (the reference's repeated headline benchmark,
    main.cu:213-225, generalised)."""
    from .utils.timing import benchmark_polymul
    print(_parameter_banner(args.param_set))
    batches = [int(b) for b in args.batches.split(",")]
    for algo in _algos(args.algo, args.device):
        for b in batches:
            r = benchmark_polymul(args.param_set, algo, batch=b,
                                  iters=args.iters, seed=args.seed,
                                  device=args.device)
            print(_row_line(r, b))
    return 0


def _shared_caveat(device: torch.device, ranks: int, cards: int,
                   backend: str | None) -> str:
    where = (f"{ranks} rank{'s' * (ranks > 1)} on the host's CPU cores"
             if device.type != "cuda"
             else f"{ranks} ranks sharing {cards} card{'s' * (cards > 1)}")
    via = ("; gloo carries the exchanges through host memory"
           if backend == "gloo" else "")
    turns = ("; the ranks' calls take turns on the card, so an aggregate "
             "over ranks is no rate the card reaches"
             if device.type == "cuda" else "")
    return (f"{where}{via}: validates the sharded code path and relative "
            f"overhead, NOT NCCL or NVLink scaling{turns}")


def cmd_scaling(args) -> int:
    """Data-parallel scaling efficiency over the devices, one card a rank
    under --distributed (the BASELINE.md north-star harness: polymuls/s at
    1 device vs d devices).

    Two batch policies, as in JAX:
      --batch-per-device B : the global batch grows with d (weak scaling);
        scaling_eff = agg(d) / (agg(1) * d).
      --global-batch B     : the global batch is FIXED and split over d;
        overhead_eff = agg(d) / agg(1), the honest statistic where the
        devices share one card or the host's cores.

    DP runs at d = 1, 2, 4, ... up to the world size, a d below it on a mesh
    over the first d ranks (the others wait at a barrier).  --model k adds
    the four-step SP row and, for B >= devices, the Ulysses row, on every
    rank.  A time is the slowest rank's (an all_reduce MAX of each rank's
    per-call times).  Every JSON row carries ``virtual_devices``: true when
    the ranks outnumber the cards or run on the CPU, with ``host_cores``
    and a ``caveat`` then, so that a row can never be read as NCCL or
    NVLink scaling.  Rank 0 prints the rows and the JSON; every other rank
    one line naming itself."""
    import torch.distributed as dist

    from .parallel import distributed as D
    from .parallel import (make_mesh, polymul_dp_fn,
                           polymul_fourstep_sharded_fn, polymul_ulysses_fn)
    from .params import get_params
    from .utils.timing import BenchResult, device_label, measure

    ps = get_params(args.param_set)
    dev = args.device
    _algos(args.algo, dev)
    joined = D.joined()
    ndev = D.world_size()
    rank = dist.get_rank() if joined else 0
    lead = rank == 0

    def say(*a):
        if lead:
            print(*a, flush=True)

    say(_parameter_banner(ps.name))
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    virtual = ndev > cards
    cores = os.cpu_count() or 1
    backend = dist.get_backend() if joined else None
    caveat = _shared_caveat(dev, ndev, cards, backend)
    say(f"device: {device_label(dev)}  devices: {ndev}"
        + (f"  (SHARED: {caveat})" if virtual else ""))
    fixed_global = args.global_batch or 0
    rng = np.random.default_rng(args.seed)

    def annotate(row, r):
        row["virtual_devices"] = virtual
        if virtual:
            row["host_cores"] = cores
            row["caveat"] = caveat
        row["device"], row["clock"] = r.device, r.clock
        return row

    # ranks outnumbering the host's cores contend: as JAX does for virtual
    # devices, emit d in {1, 2} only, with min-of-5 statistics
    contended = virtual and ndev > cores
    repeats = 5 if contended else 3

    def operands(B):
        return (rng.integers(0, ps.q, (B, ps.n), dtype=np.uint32)
                for _ in range(2))

    def timed(fn, mesh, layout, x, y, name):
        """This rank's time of ``fn`` on its shard (None off the mesh);
        across ranks the slowest rank's per-call times."""
        r = None
        if mesh is not None:
            rows = D.process_rows(mesh, x.shape[0], layout)
            xs, ys = (D.global_batch(mesh, torch.from_numpy(t[rows]), layout)
                      for t in (x, y))
            r = measure(fn, xs, ys, warmup=2, iters=args.iters,
                        items_per_iter=x.shape[0], chain=True,
                        repeats=repeats, name=name)
        if joined:
            D.barrier(name, timeout_s=600)
            secs = D.slowest(r.samples_s if r else [0.0] * repeats)
            if r is not None:
                r = BenchResult.from_times(
                    secs, name=r.name, iters=r.iters,
                    items_per_iter=r.items_per_iter, device=r.device,
                    clock=r.clock, calls=r.calls)
        return r

    def stat(r):
        # min-based under contention (repeatability), median otherwise
        return r.throughput_best if contended else r.throughput

    out = []
    base = None
    d = 1
    dmax = min(ndev, 2) if contended else ndev
    while d <= dmax:
        B = fixed_global if fixed_global else args.batch_per_device * d
        if B % d:
            d *= 2
            continue
        x, y = operands(B)
        mesh = (D.make_global_mesh(1, ranks=range(d)) if joined
                else make_mesh(device=dev))
        fn = (polymul_dp_fn(ps.name, mesh, algo=args.algo)
              if mesh is not None else None)
        r = timed(fn, mesh, "dp", x, y, f"dp[d={d},B={B},{args.algo}]")
        if lead:
            tput = stat(r)
            if base is None:
                base = tput
            row = {"mode": "dp", "devices": d, "batch": B,
                   "polymuls_per_s": tput}
            if fixed_global:
                row["overhead_eff"] = tput / base
                say(f"  {r.line()}  overhead-eff {row['overhead_eff']:5.1%}")
            else:
                row["scaling_eff"] = tput / (base * d)
                say(f"  {r.line()}  scaling-eff {row['scaling_eff']:5.1%}")
            out.append(annotate(row, r))
        d *= 2
    if args.model > 1:
        if ndev < args.model or ndev % args.model:
            say(f"  fourstep SP skipped: model={args.model} needs a "
                f"divisible device count, have {ndev}")
        else:
            mesh = D.make_global_mesh(args.model)
            B = (fixed_global if fixed_global
                 else args.batch_per_device * mesh.data)
            x, y = operands(B)
            fn = polymul_fourstep_sharded_fn(ps.name, mesh)
            r = timed(fn, mesh, "sp", x, y,
                      f"fourstep[data={mesh.data},model={args.model},B={B}]")
            # vs the DP aggregate at the same device count
            denom = base if fixed_global else (base or 0) * ndev
            if lead:
                rel = stat(r) / denom if base else 0.0
                out.append(annotate({
                    "mode": "fourstep_sp", "devices": ndev,
                    "model": args.model, "batch": B,
                    "polymuls_per_s": stat(r), "vs_dp_eff": rel}, r))
                say(f"  {r.line()}  vs-dp {rel:5.1%}")
            # Ulysses SP (parallel/ulysses.py): batch<->position exchange
            # around the unmodified single-device pipeline, the SP strategy
            # for B >= devices
            if B >= ndev:
                fnu = polymul_ulysses_fn(ps.name, mesh, local=args.algo)
                ru = timed(fnu, mesh, "ulysses", x, y,
                           f"ulysses[data={mesh.data},model={args.model},"
                           f"B={B}]")
                if lead:
                    relu = stat(ru) / denom if base else 0.0
                    out.append(annotate({
                        "mode": "ulysses_sp", "devices": ndev,
                        "model": args.model, "batch": B,
                        "polymuls_per_s": stat(ru), "vs_dp_eff": relu}, ru))
                    say(f"  {ru.line()}  vs-dp {relu:5.1%}")
    if args.json:
        say(json.dumps(out))
    if not lead:
        print(f"rank {rank} of {ndev}: done; rank 0 prints the rows",
              flush=True)
    return 0


def cmd_microbench(args) -> int:
    """Modular-reduction primitive throughput (reference red_assembly /
    -speedgpu 7, NTT.cu:282-377, main.cu:211-212), as the port's plain
    torch elementwise ops on int64 compute it (no kernel)."""
    from .utils.timing import REDUCTION_OPS, benchmark_reduction
    print(_parameter_banner(args.param_set))
    for op in REDUCTION_OPS:
        r = benchmark_reduction(args.param_set, op, size=args.size,
                                iters=args.iters, seed=args.seed,
                                device=args.device)
        print(f"  {op:8s}: {r.min_s * 1e6:8.1f} us/iter best -> "
              f"{r.throughput_best / 1e9:6.2f} Gelem/s "
              f"(torch elementwise, int64) [{r.device}, {r.clock}]")
    return 0


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qtesla_tpu_torch",
        description="qTESLA negacyclic polynomial multiplication on an "
                    "NVIDIA GPU (PyTorch and hand-written CUDA kernels)")
    p.add_argument("--device", default="cuda",
                   help="where to run: 'cuda' (the card, the default) or "
                        "'cpu' (the plain pipelines; kernel algos refused)")
    p.add_argument("--distributed", action="store_true",
                   help="join the ranks before anything runs, one rank a "
                        "card (init_distributed on torchrun's MASTER_ADDR / "
                        "MASTER_PORT / WORLD_SIZE / RANK / LOCAL_RANK, or "
                        "--init-method)")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="with --distributed: the transport (default NCCL "
                        "on the card, gloo on the CPU; ranks sharing one "
                        "card need gloo)")
    p.add_argument("--init-method", default=None,
                   help="with --distributed: the rendezvous URL (e.g. "
                        "file:///tmp/rdv) in place of MASTER_ADDR / "
                        "MASTER_PORT")
    p.add_argument("--register", action="append", default=[],
                   metavar="NAME:n:q",
                   help="register an extra parameter set at runtime "
                        "(power-of-two n, prime q = 1 mod 2n; repeatable) "
                        "— e.g. --register qtesla3s-8192:8192:8404993; "
                        "the CLI equivalent of params.register_param_set, "
                        "replacing the reference's compile-time ladder "
                        "(main.cu:18-65)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sub.add_parser("info", help="parameter banner for all registered sets")

    def common(sp, batch_default):
        sp.add_argument("--param-set", default="qtesla-iii-speed")
        sp.add_argument("--algo", default="merged",
                        help="algorithm name, comma list, or 'all'")
        sp.add_argument("--batch", type=int, default=batch_default)
        sp.add_argument("-r", "--seed", type=int, default=0)

    c = sub.add_parser("correctness", help="oracle + known-answer checks")
    common(c, 4)
    c.add_argument("--random", action="store_true",
                   help="random operands instead of the ramp fixture")

    s = sub.add_parser("speed", help="steady-state throughput benchmark")
    common(s, 4096)
    s.add_argument("--iters", type=int, default=20)
    s.add_argument("--fixed", action="store_true",
                   help="fixed-operand workload (constant polynomial, "
                        "precomputed spectrum)")
    s.add_argument("--streamed", action="store_true",
                   help="transfer-inclusive bracket: operands staged from "
                        "host RAM and result fetched back every iteration "
                        "(the reference's PCIe-inclusive timing, "
                        "NTT.cu:2036-2079)")
    s.add_argument("--json", action="store_true")
    s.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace here")

    w = sub.add_parser("sweep", help="batch-size scaling sweep")
    common(w, 0)
    w.add_argument("--batches", default="1024,4096,16384,65536")
    w.add_argument("--iters", type=int, default=10)

    g = sub.add_parser("scaling",
                       help="multi-device DP/SP scaling efficiency")
    g.add_argument("--param-set", default="qtesla-iii-speed")
    g.add_argument("--algo", default="merged")
    g.add_argument("--batch-per-device", type=int, default=4096)
    g.add_argument("--global-batch", type=int, default=0,
                   help="fix the GLOBAL batch (split over the devices) "
                        "instead of growing it per device — the honest "
                        "mode where devices share a card or the host's "
                        "cores (see cmd_scaling)")
    g.add_argument("--iters", type=int, default=10)
    g.add_argument("--model", type=int, default=1,
                   help="also run the four-step SP pipeline at this "
                        "model-axis size")
    g.add_argument("--json", action="store_true")
    g.add_argument("-r", "--seed", type=int, default=0)

    m = sub.add_parser("microbench",
                       help="modular-reduction primitive throughput")
    m.add_argument("--param-set", default="qtesla-iii-speed")
    m.add_argument("--size", type=int, default=1 << 22)
    m.add_argument("--iters", type=int, default=50)
    m.add_argument("-r", "--seed", type=int, default=0)
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    for spec in args.register:
        try:
            nm, nn, qq = spec.rsplit(":", 2)
            from .params import register_param_set
            register_param_set(nm, n=int(nn), q=int(qq))
        except ValueError as e:
            raise SystemExit(f"--register {spec!r}: {e}") from e
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is visible: the CLI runs on the "
                         "card unless told otherwise; pass --device cpu to "
                         "run the plain pipelines on the CPU")
    if args.distributed:
        from .parallel import distributed as D
        D.init_distributed(args.init_method, backend=args.backend,
                           device=device)
        device = D.rank_device()
    args.device = device
    rc = {"info": cmd_info, "correctness": cmd_correctness,
          "speed": cmd_speed, "sweep": cmd_sweep, "scaling": cmd_scaling,
          "microbench": cmd_microbench}[args.cmd](args)
    if args.distributed:
        import torch.distributed as dist
        D.barrier("cli done", timeout_s=600)
        dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    sys.exit(main())
