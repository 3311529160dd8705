from ..parallel import (  # noqa: F401
    local_fixed_pipeline_fn,
    local_pipeline_classes_fn,
    local_pipeline_fn,
    make_mesh,
    polymul_fixed_folded_fourstep_mxu_fn,
    polymul_fixed_fourstep_mxu_fn,
    polymul_fourstep_mxu_classes_fn,
    polymul_fourstep_mxu_fn,
    polymul_fourstep_sharded_fn,
)
from .polymul import (  # noqa: F401
    ALGORITHMS,
    NegacyclicPolymul,
    intt,
    ntt,
    polymul_fixed_fn,
    polymul_fn,
    polymul_negacyclic,
)
