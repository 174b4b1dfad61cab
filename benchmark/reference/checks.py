"""The comparisons that decide `correct`, on the reference of `fem.py`.

- Linear solves: the f64 relative residual ||b - A x|| / ||b|| of each
  answer judged, on the Dirichlet Laplace matrix assembled here again.
  The configuration states its limit (its solver tolerance).
- Time steps: each step n of the BDF scheme solves
      R_n(u) = F(u) + (b0/dt) M u - M sum_i (a_i/dt) u^(n-i) - f_n = 0
  on the free dofs, u = 0 on the clamped ones, with BDF1 for the first
  step from rest and BDF2 after it.  The number judged is the step's
  Newton criterion, ||R_n(u^n)|| / ||R_n(u^(n-1))||, recomputed here from
  the program's states (the reference follows the program step by step,
  teacher-forced: the history terms are the program's previous answers,
  and the start u^0 = 0 and the first BDF1 step are judged too).  The
  configuration states its limit (its Newton tolerance).
"""

from __future__ import annotations

import torch

from benchmark.reference import fem

BDF = {1: (1.0, (1.0,)), 2: (1.5, (2.0, -0.5))}


def laplace_relres(points, elements, dirichlet, answers, device="cpu"):
    """Relative residuals of `answers`, a list of (b, x) numpy pairs."""
    m = fem.P1Mesh(points, elements, device=device)
    A = fem.laplace_matrix(m)
    D = torch.as_tensor(dirichlet, device=m.device)
    out = []
    for b, x in answers:
        bt = torch.as_tensor(b, dtype=torch.float64, device=m.device)
        xt = torch.as_tensor(x, dtype=torch.float64, device=m.device)
        out.append(fem.laplace_relres(A, D, bt, xt))
    return out


class Bdf:
    """The BDF residuals of a Neo-Hooke solid under a body force."""

    def __init__(self, points, elements, dirichlet, mu, lam, dt,
                 dtype=torch.float64, device="cpu"):
        self.m = fem.P1Mesh(points, elements, dtype=dtype, device=device)
        self.M = fem.mass_matrix(self.m)
        self.D = torch.as_tensor(dirichlet, device=self.m.device)
        self.mu, self.lam, self.dt = mu, lam, dt
        self.dtype = dtype

    def vec(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.m.device)

    def order(self, n: int) -> int:
        return min(2, n)

    def residual(self, u, history, f, order) -> torch.Tensor:
        """R(u) for a step whose previous states are `history` (newest
        last) and whose load is f."""
        b0, al = BDF[order]
        acc = sum(a / self.dt * history[-(i + 1)] for i, a in enumerate(al))
        r = (fem.neo_hooke_force(self.m, u, self.mu, self.lam)
             + fem.matvec(self.M, b0 / self.dt * u - acc) - f)
        return fem.with_dirichlet(r, u, self.D)

    def ratios(self, states, loads):
        """Newton criterion of each step: states [u^1..u^N], loads
        [f_1..f_N] (numpy or tensors)."""
        hist = [torch.zeros_like(self.vec(states[0]))]
        out = []
        for n, (u, f) in enumerate(zip(states, loads), start=1):
            u, f = self.vec(u), self.vec(f)
            k = self.order(n)
            r1 = self.residual(u, hist, f, k)
            r0 = self.residual(hist[-1], hist, f, k)
            out.append(float(torch.linalg.norm(r1) / torch.linalg.norm(r0)))
            hist = (hist + [u])[-2:]
        return out
