"""The (data, model) layout of the sharded paths.

Counterpart of ``qtesla_tpu/parallel/mesh.py::make_mesh`` (l.20).  The port
holds the model axis on one device: its k shards are the leading axis of one
tensor there, and the exchanges between them are layout permutations
(``parallel/sharded.py``, ``sharded_mxu.py``, ``ulysses.py``).  Every
sharded path runs on such a mesh, with ``data = 1``.  Only a data axis of
more than one, across devices or processes, is missing: it needs
``torch.distributed`` and is ROADMAP queue A item 13.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Mesh", "make_mesh", "on_mesh"]


@dataclass(frozen=True)
class Mesh:
    """A model axis of ``model`` shards held on ``device``; ``data`` is 1."""

    data: int
    model: int
    device: torch.device


def make_mesh(data: int | None = None, model: int = 1,
              device=None) -> Mesh:
    """A (data, model) layout on one device: the card unless ``device``
    names another (the tests pass ``"cpu"``).  ``data`` may be None or 1."""
    if data is None:
        data = 1
    if data != 1:
        raise ValueError(f"a data axis of {data} needs one process per "
                         f"device (torch.distributed): ROADMAP.md queue A "
                         f"item 13")
    if model < 1:
        raise ValueError(f"model axis must be >= 1, got {model}")
    return Mesh(1, model, torch.device("cuda" if device is None else device))


def on_mesh(mesh: Mesh, *tensors) -> None:
    """Raise unless every operand is a tensor on the mesh's device."""
    dev = mesh.device
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"expected a torch.Tensor, got {type(t)}")
        if t.device.type != dev.type or (dev.index is not None
                                         and t.device.index != dev.index):
            raise ValueError(f"operands on {t.device}, mesh on {dev}")
