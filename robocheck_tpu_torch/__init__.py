"""robocheck_tpu_torch — the collision checker on PyTorch and CUDA.

A port of `robocheck_tpu` (JAX on a TPU) to PyTorch with a hand-written CUDA
kernel for NVIDIA Hopper (sm_90a): batch-validate rigid-body robot
configurations against an obstacle mesh (pose -> mesh-box broad phase ->
gated triangle-triangle narrow phase -> float64 resolution of flagged
rows), for any mesh size (`make_checker`), and the sampling and gradient
planners that use it (`planner`). It imports torch and numpy and nothing of JAX or of
`robocheck_tpu`.
"""

from .core.types import Mesh
from .io.conf import read_conf_file
from .io.obj import load_obj
from .kernels.chunked import ChunkedMegaKernelChecker, make_checker
from .kernels.megakernel import MegaKernelChecker

__all__ = ["Mesh", "load_obj", "read_conf_file", "MegaKernelChecker",
           "ChunkedMegaKernelChecker", "make_checker"]
