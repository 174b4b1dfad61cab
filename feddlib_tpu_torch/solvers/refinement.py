"""Mixed-precision iterative refinement — f64 accuracy from an f32 inner
solve.  Counterpart of feddlib_tpu/solvers/refinement.py
(`iterative_refinement`):

    x = 0
    repeat:  r = b − A x        (f64)
             d ≈ A⁻¹ r          (f32 preconditioned Krylov)
             x = x + d          (f64)
    until ‖r‖/‖b‖ ≤ tol

Each pass contracts the error by about the inner tolerance, so a few passes
reach 1e-8 while the inner iterations run in f32."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from feddlib_tpu_torch.solvers.krylov import KrylovResult


def iterative_refinement(A64: Callable, inner_solve: Callable,
                         b: torch.Tensor, tol: float = 1e-8,
                         max_passes: int = 8,
                         x0: Optional[torch.Tensor] = None) -> KrylovResult:
    """A64: f64 matvec.  inner_solve(r32) → approximate correction in f32
    (a tensor or a KrylovResult; converted and accumulated in f64)."""
    b = b.to(torch.float64)
    x = torch.zeros_like(b) if x0 is None else x0.to(torch.float64)
    bnorm = float(torch.linalg.norm(b))
    bnorm = 1.0 if bnorm == 0 else bnorm
    total_inner = 0
    r = b - A64(x)
    rnorm = float(torch.linalg.norm(r))
    rel = rnorm / bnorm
    passes = 0
    while rel > tol and passes < max_passes:
        scale = 1.0 if rnorm == 0 else rnorm
        d = inner_solve((r / scale).to(torch.float32))
        if isinstance(d, KrylovResult):
            total_inner += d.iters
            d = d.x
        x = x + d.to(torch.float64) * scale
        r = b - A64(x)
        rnorm = float(torch.linalg.norm(r))
        rel = rnorm / bnorm
        passes += 1
    return KrylovResult(x, total_inner, rel, rel <= tol, passes=passes)
