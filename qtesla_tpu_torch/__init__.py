"""qtesla_tpu_torch: the PyTorch / CUDA port of ``qtesla_tpu``.

Batched negacyclic polynomial multiplication for qTESLA on an NVIDIA Hopper
GPU: plain PyTorch for the host side and the reference paths, hand-written
CUDA kernels (``csrc/``) for the fused transforms.  It imports torch and
numpy, never jax; from the JAX package it reuses only the jax-free parameter
registry (``qtesla_tpu.params``) and big-int oracle (``qtesla_tpu.oracle``).
"""

from qtesla_tpu.oracle import polymul_negacyclic_oracle  # noqa: F401
from qtesla_tpu.params import (ParamSet, available_param_sets,  # noqa: F401
                               get_params, register_param_set)

__version__ = "0.1.0"
