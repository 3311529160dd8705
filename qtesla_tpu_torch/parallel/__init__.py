"""Sharded paths of the port: the sequence-parallel (four-step) polymul with
its model axis held on one device (``sharded.py``, ``sharded_mxu.py``, and
the planner ``sharded_mxu_tables.py``)."""

from .mesh import Mesh, make_mesh  # noqa: F401
from .sharded import polymul_fourstep_sharded_fn  # noqa: F401
from .sharded_mxu import (local_pipeline_fn,  # noqa: F401
                          polymul_fourstep_mxu_fn)
