from feddlib_tpu_torch.precond.schwarz import SchwarzPreconditioner, grow_overlap

__all__ = ["SchwarzPreconditioner", "grow_overlap"]
