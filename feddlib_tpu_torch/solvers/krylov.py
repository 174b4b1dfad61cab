"""Krylov solvers — CG and restarted GMRES on device tensors.

Counterpart of feddlib_tpu/solvers/krylov.py.  The loops are Python loops
over device tensors: the vectors, the matrix-vector products and the Gram–
Schmidt dots stay on the device, and each iteration makes ONE host sync —
GMRES copies the new Hessenberg column to the host, where the Givens
rotations, the residual estimate and the convergence test run in the
vector dtype; CG reads back its residual norm.

Conventions (as in the JAX package):
- `A`, `M` are callables x→y; preconditioning is on the RIGHT unless
  `gmres(left=True)`;
- `axis` (a parallel/spmd.py DeviceAxis) makes every dot and norm a psum
  over the ranks of its process group, as the JAX loops' `axis_name`
  does inside shard_map; without one the dots are this process's;
- `solve(kind, A_fn, A_ops, b, M_fn=..., M_ops=...)` keeps the
  `(fn, operands)` operator protocol of `solve_jit`: fn(ops, x) → y.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


@dataclass
class KrylovResult:
    x: torch.Tensor
    iters: int
    relres: float
    converged: bool
    # per-iteration relative residuals [iters+1] (index 0 = initial), only
    # when requested with record_history=True
    history: Optional[np.ndarray] = None
    # refinement passes (set by iterative_refinement)
    passes: Optional[int] = None

    def __iter__(self):  # allow x, info unpacking
        yield self.x
        yield self

    def print_history(self, label: str = "Krylov", every: int = 1,
                      file=None) -> None:
        """Belos-style iteration log (OutputFrequency = `every`)."""
        import sys

        f = file or sys.stdout
        if self.history is None:
            print(f"{label}: no history recorded", file=f)
            return
        h = np.asarray(self.history)
        for k, v in enumerate(h):
            if k % every == 0 or k == len(h) - 1:
                print(f"{label} Iter {k:4d}: ||r||/||b|| = {v:.6e}", file=f)


def _identity(x):
    return x


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.dot(a, a))


def _make_reducers(axis=None):
    """(dot, norm, allsum): this process's dot and norm, summed over the
    ranks of `axis`'s process group when it has one (JAX
    `_make_reducers(axis_name)`); allsum sums a tensor of partial dots."""
    if axis is None or axis.group is None:
        return torch.dot, _norm, _identity
    allsum = axis.allsum

    def dot(a, b):
        return allsum(torch.dot(a, b))

    def norm(a):
        return torch.sqrt(dot(a, a))

    return dot, norm, allsum


def solve(kind: str, A_fn, A_ops, b, x0=None, M_fn=None, M_ops=(),
          tol: float = 1e-8, maxiter: int = 1000, restart: int = 100,
          left: bool = False, record_history: bool = False) -> KrylovResult:
    """Run CG or GMRES with operators in (fn, operands) form."""
    def A(x):
        return A_fn(A_ops, x)

    M = (lambda x: M_fn(M_ops, x)) if M_fn is not None else _identity
    if kind == "cg":
        return cg(A, b, x0=x0, M=M, tol=tol, maxiter=maxiter,
                  record_history=record_history)
    return gmres(A, b, x0=x0, M=M, tol=tol, restart=restart,
                 maxiter=maxiter, left=left, record_history=record_history)


# ---------------------------------------------------------------------------
# CG
# ---------------------------------------------------------------------------

def cg(A: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       M: Optional[Callable] = None, tol: float = 1e-8, maxiter: int = 1000,
       record_history: bool = False) -> KrylovResult:
    """Preconditioned conjugate gradients (M ≈ A⁻¹, SPD)."""
    M = M or _identity
    x0 = torch.zeros_like(b) if x0 is None else x0
    x, it, relres, hist = cg_loop(A, M, b, x0, tol, maxiter,
                                  record=record_history)
    return KrylovResult(x, it, relres, relres <= tol,
                        np.asarray(hist) if record_history else None)


def cg_loop(A, M, b, x0, tol, maxiter, record=False, axis=None):
    dot, norm, _ = _make_reducers(axis)
    x = x0
    r = b - A(x0)
    z = M(r)
    p = z
    bnorm = float(norm(b))
    bnorm = 1.0 if bnorm == 0 else bnorm
    rz = dot(r, z)
    rel = float(norm(r)) / bnorm
    hist = [rel] if record else None
    k = 0
    while rel > tol and k < maxiter:
        Ap = A(p)
        alpha = rz / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
        rel = float(norm(r)) / bnorm  # the iteration's one host sync
        if record:
            hist.append(rel)
    return x, k, rel, hist


# ---------------------------------------------------------------------------
# restarted GMRES with DGKS reorthogonalisation
# ---------------------------------------------------------------------------

def gmres(A: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
          M: Optional[Callable] = None, tol: float = 1e-8,
          restart: int = 100, maxiter: int = 1000, left: bool = False,
          record_history: bool = False) -> KrylovResult:
    """Restarted GMRES(m), right-preconditioned by default; `left=True`
    runs it on M A x = M b, its residuals those of the preconditioned
    system (as in the JAX package).

    Orthogonalisation: classical Gram–Schmidt with one DGKS correction pass
    (Belos' default "DGKS")."""
    M = M or _identity
    x0 = torch.zeros_like(b) if x0 is None else x0
    x, total, relres, hist = gmres_loop(A, M, b, x0, tol, restart, maxiter,
                                        record=record_history, left=left)
    return KrylovResult(x, total, relres, relres <= tol,
                        np.asarray(hist) if record_history else None)


def gmres_loop(A, M, b, x0, tol, restart, maxiter, record=False,
               left=False, axis=None):
    _, norm, allsum = _make_reducers(axis)
    n = b.shape[0]
    m = min(restart, maxiter)
    hdt = np.dtype(str(b.dtype).replace("torch.", ""))  # host Givens dtype

    bnorm = float(norm(M(b) if left else b))
    bnorm = 1.0 if bnorm == 0 else bnorm

    hist = [] if record else None

    def residual(x):
        r = b - A(x)
        return M(r) if left else r

    def arnoldi_cycle(x, total):
        r = residual(x)
        beta_d = norm(r)
        beta = hdt.type(float(beta_d))
        V = torch.empty((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / torch.where(beta_d == 0, torch.ones_like(beta_d), beta_d)
        H = np.zeros((m + 1, m), hdt)
        cs = np.zeros(m, hdt)
        sn = np.zeros(m, hdt)
        g = np.zeros(m + 1, hdt)
        g[0] = beta
        j, res = 0, beta
        while j < m and res / bnorm > tol:
            w = M(A(V[j])) if left else A(M(V[j]))
            Vj = V[: j + 1]
            h1 = allsum(Vj @ w)
            w = w - Vj.T @ h1
            h2 = allsum(Vj @ w)
            w = w - Vj.T @ h2
            wnorm = norm(w)
            V[j + 1] = w / torch.where(wnorm == 0, torch.ones_like(wnorm),
                                       wnorm)
            # the iteration's one host sync: the new Hessenberg column
            col = torch.cat([h1 + h2, wnorm[None]]).cpu().numpy().astype(hdt)
            H_col = np.zeros(m + 1, hdt)
            H_col[: j + 2] = col
            for i in range(j):
                hi = cs[i] * H_col[i] + sn[i] * H_col[i + 1]
                hip = -sn[i] * H_col[i] + cs[i] * H_col[i + 1]
                H_col[i], H_col[i + 1] = hi, hip
            a_, b_ = H_col[j], H_col[j + 1]
            rnorm = np.sqrt(a_ * a_ + b_ * b_)
            if rnorm == 0:
                c_new, s_new = hdt.type(1.0), hdt.type(0.0)
            else:
                c_new, s_new = a_ / rnorm, b_ / rnorm
            H_col[j], H_col[j + 1] = rnorm, 0.0
            cs[j], sn[j] = c_new, s_new
            gj = g[j]
            g[j], g[j + 1] = c_new * gj, -s_new * gj
            H[:, j] = H_col
            res = abs(g[j + 1])
            j += 1
            if record:
                hist.append(float(res / bnorm))
        y = np.zeros(m, hdt)
        for i in range(j - 1, -1, -1):
            num = g[i] - H[i] @ y
            y[i] = num / (H[i, i] if H[i, i] != 0 else 1.0)
        dx = V[:j].T @ torch.as_tensor(y[:j], device=b.device)
        return x + (dx if left else M(dx)), j, float(res)

    x = x0
    total = 0
    res = float(norm(residual(x0)))
    if record:
        hist.append(res / bnorm)
    while res / bnorm > tol and total < maxiter:
        x, j, res = arnoldi_cycle(x, total)
        total += j
    return x, total, res / bnorm, hist
