from feddlib_tpu_torch.problems.base import Problem
from feddlib_tpu_torch.problems.laplace import Laplace

__all__ = ["Problem", "Laplace"]
