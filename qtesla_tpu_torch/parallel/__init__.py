"""Sharded paths of the port, each on a (data, model) mesh (``mesh.py``):
stacked, with the model axis on one device, or across ranks, one process
per card joined by ``torch.distributed`` (``distributed.py``: the global
mesh, the layouts of a process's rows, the exchange across ranks, the
fail-fast barrier).  Data parallelism and the plain-torch four-step
(``sharded.py``), Ulysses and the sequence-parallel dispatcher
(``ulysses.py``), the digit-matmul four-step (``sharded_mxu.py``), its
class-sum boundary (``sharded_classes.py``) and its planner
(``sharded_mxu_tables.py``)."""

from .distributed import (  # noqa: F401
    barrier,
    global_batch,
    init_distributed,
    live_processes,
    local_shard,
    make_global_mesh,
)
from .mesh import Mesh, make_mesh  # noqa: F401
from .sharded import (  # noqa: F401
    intt_fourstep_sharded_fn,
    ntt_fourstep_sharded_fn,
    polymul_dp_fn,
    polymul_fixed_dp_fn,
    polymul_fourstep_sharded_fn,
)
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
from .ulysses import (  # noqa: F401
    polymul_fixed_ulysses_fn,
    polymul_sp_fn,
    polymul_ulysses_fn,
    sp_strategy,
)
