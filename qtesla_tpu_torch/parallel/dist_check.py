"""A rank of a multi-process check of the sharded paths, and its launcher.

    python -m qtesla_tpu_torch.parallel.dist_check --init-method URL \\
        --world-size W --rank R --inputs in.npz --out out.npz \\
        [--device cpu|cuda] [--backend gloo|nccl] [--model K] \\
        [--paths P ...] [--gather] [--repeats N] [--mode ok|die|detect]

Each rank joins the group (``init_distributed``), reads the global batch
(``x``, ``y`` (B, n) and the constant ``a`` (n,), uint32, and the set's
``name``) from ``in.npz``, takes its shard of the rows it holds
(``global_batch``), runs the paths it is asked for on it and writes to
``out.npz``: each path's output shard (``z:<path>``), with ``--gather``
also its process's rows (``rows:<path>``, ``local_shard``), and on a CUDA
rank the launches of the counted run (every path once, counts reset just
before; ``launches:<kernel>``), each path's peak device memory in that run
(``peak:<path>``) and with ``--repeats`` its median time over that many
calls after one warmup (``ms:<path>``, CUDA events).  It compares nothing:
the caller assembles the shards (``assemble``) and compares.

Paths (the DP ones on ``make_mesh(data=W)``, the others on the mesh of
``--model`` ranks a model group):

- ``dp:<algo>``, ``fixed_dp:<algo>``: ``polymul_dp_fn`` /
  ``polymul_fixed_dp_fn`` with that algo, layout "dp";
- ``sp:<chunks>``: ``polymul_fourstep_mxu_fn(chunks=...)`` (B11, B12, B16);
- ``fixed_sp``, ``folded_sp``: the fixed SP pairs (B11, B14; B11, B13 or
  B15, B16); with ``jspec`` (a prepared spectrum (n,)) among the inputs,
  ``fixed_sp`` also multiplies against its row (``zj:fixed_sp``) and
  writes its own row (``prep:fixed_sp``);
- ``classes``: ``polymul_fourstep_mxu_classes_fn`` (B17, B18, B16);
- ``ulysses``, ``fixed_ulysses``: layout "ulysses";
- ``fourstep_jnp``: ``polymul_fourstep_sharded_fn(local="jnp")``;
- ``sp_fn:<batch_hint>``: ``polymul_sp_fn``, in the layout of the path
  ``sp_strategy`` picks;
- ``exchange``: the SP path's forward exchange alone on x's "sp" shard,
  (B, n1, n2/k) -> (B, n1/k, n2), one ``all_to_all``: rank d's output is
  rows k1 in [d n1/k, (d+1) n1/k) of x seen as (B, n1, n2).

Modes ``die`` and ``detect`` inject a fault: after a first barrier that
every rank passes, a ``die`` rank leaves without a word and a ``detect``
rank expects its next ``barrier`` (timeout ``--timeout``) to raise,
writing ``detected``, ``seconds``, ``missing`` and ``live``
(``live_processes()``).

``launch`` starts the W ranks as fresh interpreters, waits for each at
most ``timeout`` seconds, kills what is left in any case, and raises if a
rank failed.  Importing this module runs nothing.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

__all__ = ["PATHS_OF_TEST", "layout_of", "assemble", "launch", "main"]

_REPO = Path(__file__).resolve().parents[2]
# the strategy polymul_sp_fn takes -> the layout its function reads
_SP_LAYOUT = {"dp": "dp", "ulysses": "ulysses", "fourstep": "sp"}
# every path of the 2-rank model = 2 run of the tests
PATHS_OF_TEST = ("dp:merged", "fixed_dp:merged", "sp:1", "sp:2",
                 "fixed_sp", "folded_sp", "classes", "ulysses",
                 "fixed_ulysses", "fourstep_jnp")


def layout_of(path: str, data: int, model: int) -> str:
    """The layout of ``path``'s operands on a mesh of data x model ranks
    (its DP forms on data * model x 1)."""
    kind, _, arg = path.partition(":")
    if kind in ("dp", "fixed_dp"):
        return "dp"
    if kind in ("ulysses", "fixed_ulysses"):
        return "ulysses"
    if kind == "sp_fn":
        from .ulysses import sp_strategy
        from .mesh import Mesh
        return _SP_LAYOUT[sp_strategy(Mesh(data, model, None), int(arg))]
    return "sp"


def assemble(shards: list, layout: str, data: int, model: int,
             n1: int | None = None) -> np.ndarray:
    """The global rows (B, n) from the ranks' shards in rank order, rank r
    of data index r // model and model index r % model: "dp" rows in rank
    order; "sp" and "ulysses" the model group's columns (or positions) of
    each data index's rows."""
    if layout == "dp" or model == 1:
        return np.concatenate(shards)
    out = []
    for i in range(data):
        group = shards[i * model:(i + 1) * model]
        B, nloc = group[0].shape
        n = nloc * model
        m1 = 1 if layout == "ulysses" else (n1 or 1 << (
            (n.bit_length() - 1) // 2))
        parts = np.stack([g.reshape(B, m1, -1) for g in group], axis=2)
        out.append(parts.reshape(B, n))
    return np.concatenate(out)


def launch(world: int, inputs: Path, out_dir: Path, init_method: str,
           args=(), modes=None, timeout: float = 120.0,
           env: dict | None = None) -> list[dict]:
    """Run ``world`` ranks of this module (rank r writes
    ``out_dir/rank<r>.npz``); each rank's arguments are ``args`` plus its
    mode (``modes[r]``, default "ok").  Waits at most ``timeout`` seconds for
    each, kills every rank still running whatever happens, and raises
    RuntimeError with a failed rank's output.  Returns each rank's outputs,
    with its console text under "log"."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(_REPO), env.get("PYTHONPATH")) if p)
    procs = []
    try:
        for r in range(world):
            cmd = [sys.executable, "-m",
                   "qtesla_tpu_torch.parallel.dist_check", "--init-method", init_method, "--world-size", str(world),
                   "--rank", str(r), "--inputs", str(inputs),
                   "--out", str(out_dir / f"rank{r}.npz"),
                   "--mode", (modes or ["ok"] * world)[r], *map(str, args)]
            procs.append(subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True, cwd=_REPO, env=env))
        deadline = time.monotonic() + timeout
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{log}")
        out = out_dir / f"rank{r}.npz"
        if not out.exists():        # a rank of mode "die" writes nothing
            outs.append({"log": log})
            continue
        with np.load(out) as f:
            outs.append({k: f[k] for k in f.files} | {"log": log})
    return outs


# ----------------------------------------------------------------------
# The rank.
# ----------------------------------------------------------------------

def _path(path: str, name: str, mesh):
    """(prepare, run) of ``path``: ``prepare(a)`` makes its constant from a
    (n,) (None where the path multiplies two operands), ``run(xs, ys,
    const)`` its output shard from the rank's shards."""
    from . import sharded_mxu as S
    from .sharded import (polymul_dp_fn, polymul_fixed_dp_fn,
                          polymul_fourstep_sharded_fn)
    from .sharded_classes import polymul_fourstep_mxu_classes_fn
    from .ulysses import (polymul_fixed_ulysses_fn, polymul_sp_fn,
                          polymul_ulysses_fn)

    def product(fn):
        return None, lambda xs, ys, const: fn(xs, ys)

    def fixed(pair, full_row=False, unpack=False):
        prep, mul = pair
        return ((lambda a: prep(a[None])) if full_row else prep,
                (lambda xs, ys, c: mul(xs, *c)) if unpack
                else (lambda xs, ys, c: mul(xs, c)))

    kind, _, arg = path.partition(":")
    if kind == "dp":
        return product(polymul_dp_fn(name, mesh, arg))
    if kind == "fixed_dp":
        return fixed(polymul_fixed_dp_fn(name, mesh, arg), full_row=True)
    if kind == "sp":
        return product(S.polymul_fourstep_mxu_fn(name, mesh,
                                                 chunks=int(arg)))
    if kind == "fixed_sp":
        return fixed(S.polymul_fixed_fourstep_mxu_fn(name, mesh))
    if kind == "folded_sp":
        return fixed(S.polymul_fixed_folded_fourstep_mxu_fn(name, mesh),
                     unpack=True)
    if kind == "classes":
        return product(polymul_fourstep_mxu_classes_fn(name, mesh))
    if kind == "ulysses":
        return product(polymul_ulysses_fn(name, mesh))
    if kind == "fixed_ulysses":
        return fixed(polymul_fixed_ulysses_fn(name, mesh))
    if kind == "fourstep_jnp":
        return product(polymul_fourstep_sharded_fn(name, mesh, local="jnp"))
    if kind == "sp_fn":
        return product(polymul_sp_fn(name, mesh, batch_hint=int(arg)))
    if kind == "exchange":
        return product(lambda xs, ys: _forward_exchange(xs, mesh))
    raise ValueError(f"unknown path {path!r}")


def _forward_exchange(xs, mesh):
    from .distributed import all_to_all, sp_n1
    B, nloc = xs.shape
    n1 = sp_n1(nloc * mesh.model)
    return all_to_all(xs.reshape(B, n1, nloc // n1), mesh.model_group, 1,
                      2).reshape(B, nloc)


def _fault(args, D) -> int:
    """Modes "die" and "detect"."""
    D.barrier("joined", timeout_s=args.timeout)
    if args.mode == "die":
        print(f"rank {args.rank} leaves", flush=True)
        os._exit(0)
    start = time.monotonic()
    try:
        D.barrier("probe", timeout_s=args.timeout)
    except D.BarrierTimeout as e:
        seconds = time.monotonic() - start
        np.savez(args.out, detected=1, seconds=seconds,
                 missing=np.array(e.missing, dtype=np.int64),
                 live=np.array(D.live_processes(), dtype=np.int64))
        print(f"rank {args.rank} detected {e.missing} missing after "
              f"{seconds:.2f} s: {e}", flush=True)
        # no teardown: it would wait on the rank that is gone, and a rank
        # that is relaunched exits this way
        os._exit(0)
    np.savez(args.out, detected=0)
    print("the barrier passed with a rank gone", flush=True)
    os._exit(1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--init-method", required=True)
    p.add_argument("--world-size", type=int, required=True)
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--inputs", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--backend", default=None)
    p.add_argument("--model", type=int, default=2)
    p.add_argument("--paths", nargs="*", default=list(PATHS_OF_TEST))
    p.add_argument("--gather", action="store_true")
    p.add_argument("--repeats", type=int, default=0)
    p.add_argument("--timeout", type=float, default=5.0)
    p.add_argument("--mode", choices=("ok", "die", "detect"), default="ok")
    args = p.parse_args(argv)

    import torch
    import torch.distributed as dist

    from . import distributed as D
    from .mesh import make_mesh

    torch.set_num_threads(1)
    D.init_distributed(args.init_method, args.world_size, args.rank,
                       backend=args.backend, device=args.device)
    if args.mode != "ok":
        return _fault(args, D)

    with np.load(args.inputs) as f:
        inputs = {k: f[k] for k in f.files}
    name = str(inputs["name"])
    x, y = (torch.from_numpy(inputs[k]) for k in ("x", "y"))
    world, model = args.world_size, args.model
    data = world // model
    dp_mesh = make_mesh(data=world)
    mesh = (make_mesh(data=data, model=model) if data > 1
            else D.make_global_mesh(model))
    a = torch.from_numpy(inputs["a"]).to(mesh.device)
    cuda = mesh.device.type == "cuda"
    print(f"rank {args.rank}: {name} B={x.shape[0]} on {mesh.device} "
          f"({dist.get_backend()}), mesh {data} x {model}, model index "
          f"{mesh.model_index}", flush=True)

    runs = {}
    for path in args.paths:
        layout = layout_of(path, data, model)
        m = dp_mesh if layout == "dp" and not path.startswith("sp_fn") \
            else mesh
        rows = D.process_rows(m, x.shape[0], layout)
        xs, ys = (D.global_batch(m, t[rows], layout) for t in (x, y))
        runs[path] = (*_path(path, name, m), xs, ys, m, layout)

    kernels = _kernels() if cuda else {}
    for k in kernels.values():
        k.launches = 0
    results, consts = {}, {}
    D.barrier("counted run", timeout_s=600)
    for path, (prepare, run, xs, ys, m, layout) in runs.items():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        consts[path] = const = prepare(a) if prepare else None
        results[f"z:{path}"] = run(xs, ys, const)
        if cuda:
            torch.cuda.synchronize()
            results[f"peak:{path}"] = torch.cuda.max_memory_allocated()
    for kname, k in kernels.items():
        results[f"launches:{kname}"] = k.launches
    if "fixed_sp" in runs:
        results["prep:fixed_sp"] = consts["fixed_sp"]
    if "fixed_sp" in runs and "jspec" in inputs:
        from .sharded_mxu_tables import fourstep_mxu_plans, rank_spectrum
        _, run, xs, ys, m, _ = runs["fixed_sp"]
        n = a.shape[0]
        plans = fourstep_mxu_plans(name, 1 << ((n.bit_length() - 1) // 2),
                                   model)
        row = torch.from_numpy(rank_spectrum(inputs["jspec"], plans,
                                             m.model_index)).to(m.device)
        results["zj:fixed_sp"] = run(xs, ys, row)
    if args.gather:
        for path, (_, _, _, _, m, layout) in runs.items():
            results[f"rows:{path}"] = D.local_shard(results[f"z:{path}"], m,
                                                    layout)
    if args.repeats:
        from ..utils.timing import time_cuda
        for path, (_, run, xs, ys, _, _) in runs.items():
            D.barrier(f"time {path}", timeout_s=600)
            results[f"ms:{path}"] = time_cuda(
                run, xs, ys, consts[path], warmup=1,
                repeats=args.repeats).median_ms
    D.barrier("done", timeout_s=600)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "qtesla_tpu"))
    if loaded:
        raise RuntimeError(f"a rank loaded jax or the JAX package: {loaded}")
    np.savez(args.out, **{k: v.cpu().numpy() if torch.is_tensor(v) else v
                          for k, v in results.items()})
    dist.destroy_process_group()
    return 0


def _kernels() -> dict:
    """Every kernel's registry entry, by name."""
    from ..ops import ntt_fused, ntt_mxu, ntt_mxu_split, ntt_pairings
    from . import sharded_classes, sharded_mxu, sp_column_split
    return {name: k for mod in (ntt_fused, ntt_mxu, ntt_mxu_split,
                                ntt_pairings, sharded_mxu, sharded_classes,
                                sp_column_split)
            for name, k in mod.KERNELS.items()}


if __name__ == "__main__":
    sys.exit(main())
