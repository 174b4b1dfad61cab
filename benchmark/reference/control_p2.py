"""The control of a P2 elasticity cell: the reference of `fem_p2.py` put in
the program's place and computed one precision below the configuration's
float64, in float32 throughout, as `control.py` does for the P1 cells.
Its answers are judged exactly as the program's are, and have to come out
as not correct.

The solve is Jacobi-preconditioned conjugate gradients in float32 on the
system with identity Dirichlet rows (`control._free_operator`), run until
the f32 residual reaches `tol` or has not fallen below its best for
`window` iterations, and its best iterate is kept: the P2 operator's
residual swings for hundreds of iterations before it falls, so the
control's 50-iteration stall rule of the P1 cells would stop it at the
start."""

from __future__ import annotations

import torch

from benchmark.reference import control, fem_p2


def pcg_best(apply, b, diag, tol=1e-7, window=2000, maxiter=40000):
    """Jacobi PCG in b's dtype; returns the iterate of least residual."""
    x = torch.zeros_like(b)
    r = b.clone()
    z = r / diag
    p = z.clone()
    rz = torch.dot(r, z)
    bnorm = float(torch.linalg.norm(b)) or 1.0
    best, best_x, since = float("inf"), x, 0
    for _ in range(maxiter):
        Ap = apply(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rel = float(torch.linalg.norm(r)) / bnorm
        if rel < best:
            best, best_x, since = rel, x, 0
        else:
            since += 1
        if rel <= tol or since >= window:
            break
        z = r / diag
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return best_x


class LinElasP2:
    """float32 solutions of the clamped P2 elasticity system A x = b, in
    the node order of `fem_p2.LinElasP2`."""

    def __init__(self, cells: int, mu: float, lam: float, axis: int = 0,
                 side: int = 0, device="cpu"):
        self.sys = fem_p2.LinElasP2(cells, mu, lam, axis, side,
                                    dtype=torch.float32, device=device)
        free = ~self.sys.D
        self.apply = control._free_operator(self.sys.A, free)
        self.diag = control._diag(self.sys.A, free)

    def solve(self, b) -> torch.Tensor:
        """x for b (numpy or a tensor), float32 on this device."""
        bt = torch.as_tensor(b, device=self.sys.m.device).to(torch.float32)
        return pcg_best(self.apply, bt, self.diag)
