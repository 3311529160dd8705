"""Sharded paths of the port: the sequence-parallel (four-step) polymul with
its model axis held on one device (``sharded.py``, ``sharded_mxu.py``, its
class-sum boundary ``sharded_classes.py``, and the planner
``sharded_mxu_tables.py``)."""

from .mesh import Mesh, make_mesh  # noqa: F401
from .sharded import polymul_fourstep_sharded_fn  # noqa: F401
from .sharded_classes import (  # noqa: F401
    local_pipeline_classes_fn,
    polymul_fourstep_mxu_classes_fn,
)
from .sharded_mxu import (  # noqa: F401
    local_fixed_pipeline_fn,
    local_pipeline_fn,
    polymul_fixed_folded_fourstep_mxu_fn,
    polymul_fixed_fourstep_mxu_fn,
    polymul_fourstep_mxu_fn,
)
