from ..parallel import (local_pipeline_fn, make_mesh,  # noqa: F401
                        polymul_fourstep_mxu_fn, polymul_fourstep_sharded_fn)
from .polymul import (  # noqa: F401
    ALGORITHMS,
    NegacyclicPolymul,
    intt,
    ntt,
    polymul_fixed_fn,
    polymul_fn,
    polymul_negacyclic,
)
