from .polymul import (  # noqa: F401
    ALGORITHMS,
    NegacyclicPolymul,
    intt,
    ntt,
    polymul_fixed_fn,
    polymul_fn,
    polymul_negacyclic,
)
