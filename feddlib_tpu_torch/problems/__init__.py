from feddlib_tpu_torch.problems.base import Problem
from feddlib_tpu_torch.problems.laplace import Laplace
from feddlib_tpu_torch.problems.linelas import LinElas

__all__ = ["Problem", "Laplace", "LinElas"]
