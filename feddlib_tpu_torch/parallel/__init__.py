from feddlib_tpu_torch.parallel.spmd import (
    DeviceAxis, HaloPlan, DistributedCsr, distribute_vector, collect_vector)

__all__ = ["DeviceAxis", "HaloPlan", "DistributedCsr",
           "distribute_vector", "collect_vector"]
