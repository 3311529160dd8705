"""qtesla_tpu_torch: the PyTorch / CUDA port of ``qtesla_tpu``.

Batched negacyclic polynomial multiplication for qTESLA on an NVIDIA Hopper
GPU: plain PyTorch for the host side and the reference paths, hand-written
CUDA kernels (``csrc/``) for the fused transforms.  It imports torch and
numpy, and nothing of jax or the JAX package: its parameter registry
(``params.py``) and big-int oracle (``oracle.py``) are its own copies.
"""

from .oracle import polymul_negacyclic_oracle  # noqa: F401
from .params import (ParamSet, available_param_sets,  # noqa: F401
                     get_params, register_param_set)
from .parallel import (  # noqa: F401
    local_pipeline_fn,
    make_mesh,
    polymul_fixed_folded_fourstep_mxu_fn,
    polymul_fixed_fourstep_mxu_fn,
    polymul_fourstep_mxu_classes_fn,
    polymul_fourstep_mxu_fn,
    polymul_fourstep_sharded_fn,
)

__version__ = "0.1.0"
