from feddlib_tpu_torch.fe.domain import Domain

__all__ = ["Domain"]
