"""robocheck_tpu_torch — the collision checker on PyTorch and CUDA.

A port of `robocheck_tpu` (JAX on a TPU) to PyTorch with a hand-written CUDA
kernel for NVIDIA Hopper (sm_90a): batch-validate rigid-body robot
configurations against an obstacle mesh (pose -> mesh-box broad phase ->
gated triangle-triangle narrow phase -> float64 resolution of flagged
rows), for any mesh size (`make_checker`), sharded over the ranks of a
process group (`parallel.sharding`), the dense reference pipeline
(`CollisionWorld`), and the sampling and gradient planners that use them
(`planner`). It imports torch and numpy and nothing of JAX or of
`robocheck_tpu`.
"""

from .core.types import Mesh, PaddedMesh
from .io.conf import read_conf_file, write_conf_file
from .io.obj import load_obj, save_obj
from .kernels.chunked import ChunkedMegaKernelChecker, make_checker
from .kernels.megakernel import MegaKernelChecker
from .ops.pipeline import CheckResult, CollisionWorld, PipelineConfig

__all__ = ["Mesh", "PaddedMesh", "load_obj", "save_obj", "read_conf_file",
           "write_conf_file", "MegaKernelChecker", "ChunkedMegaKernelChecker",
           "make_checker", "CollisionWorld", "PipelineConfig", "CheckResult"]
