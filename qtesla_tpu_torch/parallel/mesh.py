"""The (data, model) layout of the sharded paths.

Counterpart of ``qtesla_tpu/parallel/mesh.py::make_mesh`` (l.20).  The port
holds the model axis on one device: its k shards are the leading axis of one
tensor there, and the exchanges between them are layout permutations
(``parallel/sharded_mxu.py``).  A data axis across devices or processes
needs ``torch.distributed`` and is ROADMAP queue A item 13.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Mesh", "make_mesh"]


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
