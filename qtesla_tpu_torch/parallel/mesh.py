"""The (data, model) layout of the sharded paths.

Counterpart of ``qtesla_tpu/parallel/mesh.py::make_mesh`` (l.20).  A mesh
takes one of two forms:

- stacked, on one device in one process: the model axis's k shards are the
  leading axis of one tensor there, and the exchanges between them are
  layout permutations (``parallel/sharded.py``, ``sharded_mxu.py``,
  ``ulysses.py``); ``data`` is 1;
- across ranks, one process per card (``distributed.make_global_mesh``):
  this rank holds one shard, its model group (``model`` consecutive ranks)
  exchanges with ``torch.distributed`` (``distributed.all_to_all``), and
  the data axis spans the model groups.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Mesh", "make_mesh", "on_mesh"]


@dataclass(frozen=True)
class Mesh:
    """A (data, model) layout.  Stacked on ``device`` when ``model_group``
    is None; across ranks otherwise: this rank is shard ``model_index`` of
    its model group (the process group of ``model`` ranks) and part
    ``data_index`` of the data axis (``data_group``, the ranks of its model
    index; None where ``data`` is 1), computing on ``device``."""

    data: int
    model: int
    device: torch.device
    model_group: object = None
    data_group: object = None
    data_index: int = 0
    model_index: int = 0

    @property
    def across_ranks(self) -> bool:
        """Whether the model axis spans ranks (one shard in this process)."""
        return self.model_group is not None


def make_mesh(data: int | None = None, model: int = 1,
              device=None) -> Mesh:
    """A (data, model) layout.  ``data`` None or 1 is the stacked form on
    one device: the card unless ``device`` names another (the tests pass
    ``"cpu"``).  ``data`` > 1 is the mesh across every rank of the group
    this process joined (``distributed.make_global_mesh``, on the device
    ``init_distributed`` chose): data * model must be the world size, and
    outside a group it raises."""
    if data is None:
        data = 1
    if model < 1:
        raise ValueError(f"model axis must be >= 1, got {model}")
    if data == 1:
        return Mesh(1, model, torch.device("cuda" if device is None
                                           else device))
    from . import distributed as D
    if not D.joined():
        raise ValueError(f"a data axis of {data} spans processes: join them "
                         f"with init_distributed first")
    world = D.world_size()
    if data * model != world:
        raise ValueError(f"mesh {data} x {model} needs {data * model} ranks; "
                         f"the group has {world}")
    mesh = D.make_global_mesh(model)
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"the ranks compute on {mesh.device}, not {device}")
    return mesh


def on_mesh(mesh: Mesh, *tensors) -> None:
    """Raise unless every operand is a tensor on the mesh's device."""
    dev = mesh.device
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected a torch.Tensor, got {type(t)}")
        if t.device.type != dev.type or (dev.index is not None
                                         and t.device.index != dev.index):
            raise ValueError(f"operands on {t.device}, mesh on {dev}")
