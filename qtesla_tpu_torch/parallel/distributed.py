"""Execution across processes: one process per card, joined by
``torch.distributed``.

Counterpart of ``qtesla_tpu/parallel/distributed.py`` (l.29-141):
``init_distributed``, ``make_global_mesh``, ``global_batch``,
``local_shard``, ``barrier`` and ``live_processes``.  JAX runs one process
per host with the host's devices inside it; the port runs one process (a
rank) per card, the PyTorch idiom.  So the model axis, which JAX keeps
inside one process (ICI), spans ranks here: rank r of a (data, model) mesh
has data index r // model and model index r % model (hosts-major, as JAX's
l.59-73), so the model axis spans consecutive ranks, the cards of one node
and its NVLink where the ranks were launched node by node.  The stacked
form, a model axis of k shards on one card in one process
(``mesh.make_mesh(model=k)``), stays as it was.

On a mesh across ranks every JAX ``lax.all_to_all(split_axis, concat_axis,
tiled=True)`` of the sharded paths is ``all_to_all``: a contiguous
permutation that puts the destination's block on dim 0 (``send_blocks``),
one ``dist.all_to_all_single`` over the model group on an int32 view (NCCL
and gloo take no uint32), and the inverse placement (``recv_blocks``).
``local_shard`` gathers a model group's shards with one ``all_gather``.

Layouts of a process's rows (``global_batch``, ``local_shard``):

- ``"dp"``: the batch split over data x model; a rank's shard is its rows;
- ``"sp"``: the batch split over data, the columns j2 of each row seen as
  (n1, n2) split over model, JAX's ``P("data", None, "model")``; rank d of
  a model group holds ``rows.reshape(B, n1, n2)[:, :, d n2/k:(d+1) n2/k]``
  flat as (B, n/k);
- ``"ulysses"``: the batch split over data, the positions split over model
  (JAX's Ulysses ``P("data", "model", None)``): rank d holds positions
  [d n/k, (d+1) n/k) of every row, ``"sp"`` with n1 = 1.

Failures are detected, not hidden: ``barrier`` is a ``monitored_barrier`` on
a gloo side group (it exists only on gloo), which raises on every survivor
within its timeout and names the ranks that did not arrive.

Recovery is stateless: every table the paths use regenerates from (n, q)
and nothing needs a checkpoint.  Recovering from a detected failure is to
tear the group down (or exit), let the launcher relaunch on the ranks that
remain, call ``init_distributed`` with the new world size and ranks, and
compute the batch in flight again.  ``barrier`` is the detection half; the
launcher owns the restart.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from datetime import timedelta

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "make_global_mesh", "global_batch",
           "local_shard", "process_rows", "barrier", "live_processes",
           "BarrierTimeout", "Pending", "all_to_all", "send_blocks",
           "recv_blocks", "joined", "world_size", "rank_coords",
           "mesh_groups", "slowest", "rank_device", "LAYOUTS"]

LAYOUTS = ("dp", "sp", "ulysses")


@dataclass
class _Process:
    """What ``init_distributed`` set up in this process: the device its
    ranks compute on, the gloo group of the barriers, the meshes made so
    far (their groups are made once, by every rank in the same order) and
    the ranks the last barrier heard from."""

    device: torch.device
    side: object
    meshes: dict = field(default_factory=dict)
    live: list | None = None


_process: _Process | None = None


class BarrierTimeout(RuntimeError):
    """A rank did not reach a ``barrier`` in time; ``missing`` names the
    ranks that did not (empty where this rank cannot tell: only rank 0, the
    monitor, hears from every rank)."""

    def __init__(self, message: str, missing: list[int]):
        super().__init__(message)
        self.missing = missing


def _env_int(name: str, value: int | None) -> int:
    if value is not None:
        return int(value)
    if name not in os.environ:
        raise ValueError(f"{name} is not set and no value was given: pass "
                         f"it to init_distributed or launch with torchrun")
    return int(os.environ[name])


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None, rank: int | None = None,
                     backend: str | None = None, timeout_s: float = 600.0,
                     device=None) -> None:
    """Join this process to the group of ranks.

    Arguments default to torchrun's variables: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (``tcp://addr:port``), ``WORLD_SIZE``, ``RANK`` and
    ``LOCAL_RANK``.  ``device`` is where the rank computes: the card unless
    it names another (the CPU tests pass ``"cpu"``); a CUDA rank takes card
    ``LOCAL_RANK % device_count`` (``torch.cuda.set_device``).  ``backend``
    None is NCCL for a CUDA rank and gloo for a CPU rank; a backend given
    always wins (one card shared by two ranks needs gloo: NCCL refuses two
    ranks on one device).  A gloo side group over every rank is made for
    ``barrier``.  A second call in a process that has joined does nothing.
    """
    global _process
    if dist.is_initialized():
        return
    world_size = _env_int("WORLD_SIZE", world_size)
    rank = _env_int("RANK", rank)
    if init_method is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        if not (addr and port):
            raise ValueError("no init_method given and MASTER_ADDR / "
                             "MASTER_PORT are not set")
        init_method = f"tcp://{addr}:{port}"
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank needs a CUDA device; pass "
                               "device='cpu' for a rank on the CPU")
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    timeout = timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)
    _process = _Process(dev, dist.new_group(backend="gloo", timeout=timeout))


def joined() -> bool:
    """Whether this process has joined a group (``init_distributed``)."""
    return _process is not None and dist.is_initialized()


def world_size() -> int:
    """The number of ranks of the group this process joined."""
    return dist.get_world_size(group=None) if joined() else 1


def _joined() -> _Process:
    if not joined():
        raise RuntimeError("this process has not joined a group of ranks: "
                           "call init_distributed first")
    return _process


def rank_coords(rank: int, model: int) -> tuple[int, int]:
    """(data index, model index) of ``rank``, hosts-major."""
    return rank // model, rank % model


def mesh_groups(world: int, model: int) -> tuple[list, list]:
    """The ranks of each model group (``model`` consecutive ranks, one per
    data index) and of each data group (one per model index)."""
    data = world // model
    return ([[i * model + j for j in range(model)] for i in range(data)],
            [[i * model + j for i in range(data)] for j in range(model)])


def make_global_mesh(model: int = 1, ranks=None):
    """The (data, model) mesh over ``ranks`` (every rank by default; a list
    of distinct ranks of the group, e.g. the first d), hosts-major: the
    rank at position p of ``ranks`` has data index p // model and model
    index p % model, so each model group is ``model`` consecutive entries.
    ``model`` must divide the number of ranks.  Every rank of the group
    must call it with the same arguments, in the same order as the other
    ranks (it makes process groups, which every rank joins, member or not);
    a rank outside ``ranks`` gets None.  A second call returns the same
    mesh."""
    from .mesh import Mesh

    proc = _joined()
    world, rank = dist.get_world_size(), dist.get_rank()
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if (not ranks or len(set(ranks)) != len(ranks)
            or any(not 0 <= r < world for r in ranks)):
        raise ValueError(f"mesh ranks {ranks} must be distinct ranks of the "
                         f"group of {world}")
    if model < 1 or len(ranks) % model:
        raise ValueError(f"model={model} must divide the number of mesh "
                         f"ranks {len(ranks)} ({ranks})")
    key = (model, tuple(ranks))
    if key in proc.meshes:
        return proc.meshes[key]
    data = len(ranks) // model
    model_ranks, data_ranks = (
        [[ranks[p] for p in g] for g in groups]
        for groups in mesh_groups(len(ranks), model))
    # every rank makes every group of more than one rank, in one order
    model_made = [dist.new_group(r) for r in model_ranks if model > 1]
    data_made = [dist.new_group(r) for r in data_ranks if data > 1]
    mesh = None
    if rank in ranks:
        i, j = rank_coords(ranks.index(rank), model)
        mesh = Mesh(data, model, proc.device,
                    model_made[i] if model_made else None,
                    data_made[j] if data_made else None, i, j)
    proc.meshes[key] = mesh
    return mesh


def slowest(seconds) -> list[float]:
    """Element-wise the largest of every rank's ``seconds`` (one list of the
    same length on every rank; a rank with nothing to report passes
    zeros): one ``all_reduce`` MAX over the gloo side group, so that a
    time reported is the slowest rank's.  Every rank must call it; outside
    a group it returns ``seconds``."""
    if not joined():
        return [float(s) for s in seconds]
    t = torch.tensor([float(s) for s in seconds], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_process.side)
    return t.tolist()


def rank_device() -> torch.device:
    """The device this process's rank computes on (``init_distributed``)."""
    return _joined().device


def _default_n1(n: int) -> int:
    return 1 << ((n.bit_length() - 1) // 2)


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; available: "
                         f"{', '.join(LAYOUTS)}")


def process_rows(mesh, batch: int, layout: str = "dp") -> slice:
    """The rows of a global batch of ``batch`` rows that this process
    holds: under "dp" the rank's share of data x model parts, under "sp"
    and "ulysses" its data index's share (the model group holds the same
    rows).  The batch must split evenly."""
    _check_layout(layout)
    parts, index = ((mesh.data * mesh.model,
                     mesh.data_index * mesh.model + mesh.model_index)
                    if layout == "dp" else (mesh.data, mesh.data_index))
    if batch % parts:
        raise ValueError(f"a batch of {batch} rows does not split into "
                         f"{parts} equal parts")
    step = batch // parts
    return slice(index * step, (index + 1) * step)


def _columns(mesh, n: int, layout: str, n1: int | None) -> tuple[int, int]:
    """(n1, n2/k) of a model shard's columns: "ulysses" is n1 = 1."""
    n1 = 1 if layout == "ulysses" else (n1 or _default_n1(n))
    k = mesh.model
    if n % n1 or (n // n1) % k:
        raise ValueError(f"model axis {k} must divide n2 = {n // n1} "
                         f"(n={n}, n1={n1})")
    return n1, n // n1 // k


def global_batch(mesh, local_rows: torch.Tensor, layout: str = "dp",
                 n1: int | None = None) -> torch.Tensor:
    """This rank's shard of its process's rows (B, n): under "dp" the rows
    themselves, under "sp" the columns j2 of model index d (n1 the
    four-step's, by default 2^(log2(n) // 2)), under "ulysses" the
    positions of model index d, each (B, n/k) and contiguous, on the mesh's
    device."""
    _check_layout(layout)
    x = local_rows.to(mesh.device)
    if layout == "dp" or mesh.model == 1:
        return x
    B, n = x.shape
    n1, w = _columns(mesh, n, layout, n1)
    d = mesh.model_index
    return x.reshape(B, n1, -1)[:, :, d * w:(d + 1) * w].reshape(
        B, n1 * w).contiguous()


def local_shard(z: torch.Tensor, mesh, layout: str = "dp",
                n1: int | None = None) -> torch.Tensor:
    """The inverse of ``global_batch``: this process's rows (B, n) from the
    rank's shard z.  Under "sp" and "ulysses" the model group's shards are
    gathered with one ``all_gather``; an unknown layout raises (JAX's
    l.95-101 refuses a sharding it cannot read back the same way)."""
    _check_layout(layout)
    if layout == "dp" or mesh.model == 1:
        return z
    k = mesh.model
    B, nloc = z.shape
    n1, w = _columns(mesh, nloc * k, layout, n1)
    parts = [torch.empty((B, nloc), dtype=torch.int32, device=z.device)
             for _ in range(k)]
    dist.all_gather(parts, _int32(z).contiguous(), group=mesh.model_group)
    return torch.stack(parts).reshape(k, B, n1, w).permute(1, 2, 0, 3).reshape(
        B, nloc * k).view(z.dtype)


def barrier(name: str = "barrier", timeout_s: float = 60.0) -> None:
    """Fail-fast rendezvous of every rank: a ``monitored_barrier`` on the
    gloo side group.  Every rank must arrive within ``timeout_s``, or every
    survivor raises ``BarrierTimeout``; on rank 0, the monitor, it names
    the ranks that did not arrive.  Put it around collective work, so that
    a dead or wedged rank shows as an error and not as a collective that
    never returns.  Outside a group it does nothing."""
    if not joined():
        return
    world, rank = dist.get_world_size(), dist.get_rank()
    try:
        dist.monitored_barrier(group=_process.side,
                               timeout=timedelta(seconds=timeout_s),
                               wait_all_ranks=True)
    except RuntimeError as e:
        found = re.search(r"Ranks? ([\d, ]+) failed to pass monitoredBarrier",
                          str(e))
        missing = (sorted(int(r) for r in found.group(1).split(",")) if found
                   else [])
        _process.live = ([r for r in range(world) if r not in missing]
                         if found else [rank])
        who = (f"ranks {missing} did not arrive" if found else
               f"rank 0, the monitor, did not release rank {rank}")
        raise BarrierTimeout(f"barrier {name!r} failed within {timeout_s} s: "
                             f"{who} ({e})", missing) from e
    _process.live = list(range(world))


def live_processes() -> list[int]:
    """The ranks that answered this process's last ``barrier``: after a
    failed one, every rank it did not name (only this rank where it could
    name none); before any, every rank (joining was a rendezvous of all);
    [0] outside a group.  A survivor reads it to learn which ranks to
    relaunch without."""
    if not joined():
        return [0]
    if _process.live is None:
        return list(range(dist.get_world_size()))
    return list(_process.live)


# ----------------------------------------------------------------------
# The exchange across ranks.
# ----------------------------------------------------------------------

def _int32(v: torch.Tensor) -> torch.Tensor:
    if v.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"the exchange takes uint32 or int32 values, got "
                        f"{v.dtype}")
    return v.view(torch.int32)


def send_blocks(v: torch.Tensor, k: int, split_axis: int) -> torch.Tensor:
    """v split into k blocks along ``split_axis``, block j (the one for rank
    j of the group) on dim 0: (k, ..., size/k, ...), contiguous int32."""
    v = _int32(v)
    shape = v.shape
    if shape[split_axis] % k:
        raise ValueError(f"axis {split_axis} of {tuple(shape)} does not "
                         f"split into {k} blocks")
    v = v.reshape(*shape[:split_axis], k, shape[split_axis] // k,
                  *shape[split_axis + 1:])
    return v.movedim(split_axis, 0).contiguous()


def recv_blocks(r: torch.Tensor, concat_axis: int) -> torch.Tensor:
    """The blocks received from ranks 0..k-1, (k, ...) on dim 0, joined in
    rank order along ``concat_axis`` of one block; contiguous."""
    out = r.movedim(0, concat_axis)
    shape = out.shape
    return out.reshape(*shape[:concat_axis],
                       shape[concat_axis] * shape[concat_axis + 1],
                       *shape[concat_axis + 2:]).contiguous()


class Pending:
    """An exchange in flight: ``wait()`` waits for it (the current CUDA
    stream waits for NCCL's) and returns its result.  ``Pending.ready(t)``
    is one already done, what the stacked form's permutations give."""

    def __init__(self, work, finish):
        self._work, self._finish = work, finish

    @classmethod
    def ready(cls, t: torch.Tensor) -> "Pending":
        return cls(None, lambda: t)

    def then(self, fn) -> "Pending":
        """The same exchange, its result passed through ``fn``."""
        return Pending(self._work, lambda: fn(self._finish()))

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._finish()


def all_to_all(v: torch.Tensor, group, split_axis: int, concat_axis: int,
               async_op: bool = False):
    """JAX's ``lax.all_to_all(v, axis, split_axis, concat_axis,
    tiled=True)`` over the ranks of ``group``: v (uint32 or int32) split
    into one block per rank along ``split_axis``, block j sent to group rank
    j, the blocks received joined in rank order along ``concat_axis``.  One
    ``dist.all_to_all_single`` on an int32 view; with ``async_op`` a
    ``Pending`` whose ``wait()`` gives the result, else the result."""
    k = dist.get_world_size(group)
    send = send_blocks(v, k, split_axis)
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=group, async_op=async_op)
    pending = Pending(work if async_op else None,
                      lambda: recv_blocks(recv, concat_axis).view(v.dtype))
    return pending if async_op else pending.wait()
