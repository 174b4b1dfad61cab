"""The control: the reference put in the program's place and computed one
precision below the configuration's float64, in float32 throughout (the
step that would tempt a later change: drop the f64 refinement).  Its
answers are judged by `checks.py` exactly as the program's are, and have
to come out as not correct.  It is planted in the program's place under a
whole run of the harness (`benchmark/tests/faults.py`), which judges it.

Linear solves are Jacobi-preconditioned conjugate gradients in float32 on
the system with identity Dirichlet rows, run until the f32 residual stops
falling; Newton steps solve their tangent systems the same way.
"""

from __future__ import annotations

import torch

from benchmark.reference import checks, fem


def pcg(apply, b, diag, tol=1e-7, maxiter=20000):
    """Jacobi PCG in b's dtype; stops at the relative residual `tol` or
    when 50 iterations in a row have not lowered the best residual."""
    x = torch.zeros_like(b)
    r = b.clone()
    z = r / diag
    p = z.clone()
    rz = torch.dot(r, z)
    bnorm = float(torch.linalg.norm(b)) or 1.0
    best, stall = float("inf"), 0
    for _ in range(maxiter):
        Ap = apply(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rel = float(torch.linalg.norm(r)) / bnorm
        if rel <= tol:
            break
        stall = 0 if rel < 0.999 * best else stall + 1
        best = min(best, rel)
        if stall >= 50:
            break
        z = r / diag
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x


def _free_operator(A, free):
    """x -> A (x on the free dofs) on the free dofs, x on the others: the
    symmetric form of the identity Dirichlet rows (the loads vanish
    there)."""
    def apply(x):
        return torch.where(free, fem.matvec(A, x * free), x)
    return apply


def _diag(A, free):
    crow, col, val = A.crow_indices(), A.col_indices(), A.values()
    rows = torch.repeat_interleave(
        torch.arange(len(crow) - 1, device=val.device), crow.diff())
    d = torch.zeros(len(crow) - 1, dtype=val.dtype, device=val.device)
    d.index_add_(0, rows[rows == col], val[rows == col])
    return torch.where(free, d, torch.ones_like(d))


class Laplace:
    """float32 solutions of the Dirichlet Laplace system A x = b."""

    def __init__(self, points, elements, dirichlet, device="cpu"):
        m = fem.P1Mesh(points, elements, dtype=torch.float32, device=device)
        A = fem.laplace_matrix(m)
        self.device = m.device
        free = ~torch.as_tensor(dirichlet, device=m.device)
        self.apply, self.diag = _free_operator(A, free), _diag(A, free)

    def solve(self, b) -> torch.Tensor:
        """x for b (numpy or a tensor), float32 on this device."""
        bt = torch.as_tensor(b, device=self.device).to(torch.float32)
        return pcg(self.apply, bt, self.diag)


class Bdf:
    """Newton over the BDF steps of `checks.Bdf`, in `dtype` throughout
    (float32 for the control; the tests also run it in float64), from
    rest, keeping its own history: `step(f)` returns u^n for the next
    step's load f_n."""

    def __init__(self, points, elements, dirichlet, mu, lam, dt, tol=1e-6,
                 max_its=10, dtype=torch.float32, device="cpu"):
        self.bdf = checks.Bdf(points, elements, dirichlet, mu, lam, dt,
                              dtype=dtype, device=device)
        self.mu, self.lam, self.dt = mu, lam, dt
        self.tol, self.max_its, self.dtype = tol, max_its, dtype
        self.hist = [torch.zeros(self.bdf.m.n_nodes * 3, dtype=dtype,
                                 device=self.bdf.m.device)]
        self.n = 0

    def step(self, f) -> torch.Tensor:
        bdf, free = self.bdf, ~self.bdf.D
        self.n += 1
        f = bdf.vec(f)
        k = bdf.order(self.n)
        b0 = checks.BDF[k][0]
        u = self.hist[-1].clone()
        r = bdf.residual(u, self.hist, f, k)
        r0 = float(torch.linalg.norm(r))
        ptol = 1e-7 if self.dtype == torch.float32 else 1e-12
        for _ in range(self.max_its):
            K = fem.neo_hooke_tangent(bdf.m, u, self.mu, self.lam) + \
                (b0 / self.dt) * bdf.M
            u = u + pcg(_free_operator(K, free), -r, _diag(K, free),
                        tol=ptol)
            r = bdf.residual(u, self.hist, f, k)
            if float(torch.linalg.norm(r)) <= self.tol * r0:
                break
        self.hist = (self.hist + [u])[-2:]
        return u


def bdf_states(points, elements, dirichlet, mu, lam, dt, loads, tol=1e-6,
               max_its=10, dtype=torch.float32, device="cpu"):
    """The states [u^1..u^N] of `Bdf` for the loads [f_1..f_N], as numpy
    f64."""
    ctl = Bdf(points, elements, dirichlet, mu, lam, dt, tol=tol,
              max_its=max_its, dtype=dtype, device=device)
    return [ctl.step(f).double().cpu().numpy() for f in loads]
