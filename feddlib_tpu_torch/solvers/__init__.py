from feddlib_tpu_torch.solvers.krylov import cg, gmres, solve, KrylovResult

__all__ = ["cg", "gmres", "solve", "KrylovResult"]
