from feddlib_tpu_torch.problems.base import NonLinearProblem, Problem
from feddlib_tpu_torch.problems.fsi import FSI, oscillation_stats
from feddlib_tpu_torch.problems.geometry import Geometry
from feddlib_tpu_torch.problems.laplace import Laplace
from feddlib_tpu_torch.problems.linelas import LinElas
from feddlib_tpu_torch.problems.misc import LaplaceBlocks, LinElasFirstOrder
from feddlib_tpu_torch.problems.navier_stokes import NavierStokes
from feddlib_tpu_torch.problems.nonlin_elasticity import (Elasticity,
                                                          NonLinElasticity)
from feddlib_tpu_torch.problems.stokes import Stokes
from feddlib_tpu_torch.problems.tpm import TPM, NonLinTPM

__all__ = ["Problem", "NonLinearProblem", "Laplace", "LinElas", "Stokes",
           "NavierStokes", "NonLinElasticity", "Elasticity", "LaplaceBlocks",
           "LinElasFirstOrder", "Geometry", "FSI", "oscillation_stats", "TPM",
           "NonLinTPM"]
