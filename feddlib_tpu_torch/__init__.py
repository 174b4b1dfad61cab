"""feddlib_tpu_torch — the PyTorch/CUDA port of feddlib_tpu for NVIDIA Hopper.

A second package beside the JAX one (feddlib_tpu), which stays the
reference: host setup (meshes, partitions, maps, sparsity patterns, GDSW
coarse spaces) is numpy/scipy, device work is PyTorch, and every Pallas
TPU kernel on a ported path is a hand-written CUDA kernel for sm_90a
(csrc/), built at first use.  The package never imports jax or feddlib_tpu.

Every constructor and entry point takes `device=`, default "cuda"; pass
device="cpu" to run on the CPU, where each kernel wrapper runs its plain
PyTorch version.  Dtypes are explicit: float64 for assembly, the CSR
operator and the outer refinement, float32 inside the padded solve loop,
bfloat16 for the optional low-precision stores.
"""

__version__ = "0.1.0"

from feddlib_tpu_torch.utils.config import ParameterList, load_xml_parameters  # noqa: E402
from feddlib_tpu_torch.la.map import IndexMap  # noqa: E402
from feddlib_tpu_torch.la.csr import CsrMatrix  # noqa: E402
from feddlib_tpu_torch.mesh.mesh import Mesh  # noqa: E402
from feddlib_tpu_torch.fe.domain import Domain  # noqa: E402
from feddlib_tpu_torch.bc import BCBuilder  # noqa: E402

__all__ = [
    "ParameterList",
    "load_xml_parameters",
    "IndexMap",
    "CsrMatrix",
    "Mesh",
    "Domain",
    "BCBuilder",
]
