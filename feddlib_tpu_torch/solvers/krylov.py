"""Krylov solvers — CG and restarted GMRES on device tensors.

Counterpart of feddlib_tpu/solvers/krylov.py.  The loops are Python loops
over device tensors: the vectors, the matrix-vector products and the Gram–
Schmidt dots stay on the device, and each iteration makes ONE host sync —
GMRES copies the new Hessenberg column to the host, where the Givens
rotations, the residual estimate and the convergence test run in the
vector dtype; CG reads back its residual norm.

GMRES's Arnoldi step (`arnoldi_step`: w = A(M(V[j])), both DGKS passes,
the norm and V[j+1]) is one function of (V, j).  The eager loop calls it
op by op.  Given an `ArnoldiPlan`, the loop instead replays the step as a
CUDA graph, captured once per step index j on first need, that also
copies the column into a pinned host buffer; the host then waits on one
event an iteration and runs the same Givens update.  The arithmetic is
the eager loop's, kernel for kernel on the same shapes.  Only the mixed-
precision solve makes a plan (solvers/linear.py `_arnoldi_plan`), and
only for operators that outlive a solve on a CUDA device.

Conventions (as in the JAX package):
- `A`, `M` are callables x→y; preconditioning is on the RIGHT unless
  `gmres(left=True)`;
- `axis` (a parallel/spmd.py DeviceAxis) makes every dot and norm a psum
  over the ranks of its process group, as the JAX loops' `axis_name`
  does inside shard_map; without one the dots are this process's;
- `solve(kind, A_fn, A_ops, b, M_fn=..., M_ops=...)` keeps the
  `(fn, operands)` operator protocol of `solve_jit`: fn(ops, x) → y.

Spans (utils/timers.py): `krylov.gmres` / `krylov.cg` around a loop;
while the registry is observed (`timers.observed()`: a subscriber or a
running profiler) also `operator.apply` around each A(x), `precond.apply`
around each M(x) where a preconditioner is given and `krylov.sync` around
GMRES's host copy (a replay's event wait).  A replayed step opens no span
inside it, and a loop with a plan opens no `precond.apply` at all.  Counters `krylov.iterations` and `krylov.cycles` (restarts;
one for CG); with a plan also `krylov.graph_captures` (one a step graph
captured) and `krylov.graph_replays` (one a replayed iteration).
"""

from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from feddlib_tpu_torch.utils import timers


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


_NO_SPAN = nullcontext()


def _no_span(name: str):
    return _NO_SPAN


def _spanned(name: str, fn: Callable) -> Callable:
    def call(x):
        with timers.timer(name):
            return fn(x)
    return call


def _iteration_spans(A, M):
    """(A, M, span) for one loop: while the registry is observed, A and M
    each call a span (M only where it is a preconditioner) and `span` is
    `timers.timer`; unobserved, the bare operators and no span, so that an
    iteration costs nothing untraced.  Decided once a loop."""
    M = M or _identity
    if not timers.observed():
        return A, M, _no_span
    return (_spanned("operator.apply", A),
            M if M is _identity else _spanned("precond.apply", M),
            timers.timer)


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
          left: bool = False, record_history: bool = False,
          plan: Optional["ArnoldiPlan"] = None) -> KrylovResult:
    """Run CG or GMRES with operators in (fn, operands) form; GMRES
    replays its Arnoldi steps from `plan` where one is given."""
    def A(x):
        return A_fn(A_ops, x)

    M = (lambda x: M_fn(M_ops, x)) if M_fn is not None else _identity
    if kind == "cg":
        return cg(A, b, x0=x0, M=M, tol=tol, maxiter=maxiter,
                  record_history=record_history)
    return gmres(A, b, x0=x0, M=M, tol=tol, restart=restart,
                 maxiter=maxiter, left=left, record_history=record_history,
                 plan=plan)


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
    with timers.timer("krylov.cg"):
        return _cg_loop(A, M, b, x0, tol, maxiter, record, axis)


def _cg_loop(A, M, b, x0, tol, maxiter, record, axis):
    dot, norm, _ = _make_reducers(axis)
    A, M, _ = _iteration_spans(A, M)
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
    timers.count("krylov.cycles")
    timers.count("krylov.iterations", k)
    return x, k, rel, hist


# ---------------------------------------------------------------------------
# restarted GMRES with DGKS reorthogonalisation
# ---------------------------------------------------------------------------

def gmres(A: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
          M: Optional[Callable] = None, tol: float = 1e-8,
          restart: int = 100, maxiter: int = 1000, left: bool = False,
          record_history: bool = False,
          plan: Optional["ArnoldiPlan"] = None) -> KrylovResult:
    """Restarted GMRES(m), right-preconditioned by default; `left=True`
    runs it on M A x = M b, its residuals those of the preconditioned
    system (as in the JAX package).  With `plan` (right preconditioning
    only) the Arnoldi steps replay the plan's graphs of A and M.

    Orthogonalisation: classical Gram–Schmidt with one DGKS correction pass
    (Belos' default "DGKS")."""
    M = M or _identity
    x0 = torch.zeros_like(b) if x0 is None else x0
    x, total, relres, hist = gmres_loop(A, M, b, x0, tol, restart, maxiter,
                                        record=record_history, left=left,
                                        plan=plan)
    return KrylovResult(x, total, relres, relres <= tol,
                        np.asarray(hist) if record_history else None)


def gmres_loop(A, M, b, x0, tol, restart, maxiter, record=False,
               left=False, axis=None, plan=None):
    with timers.timer("krylov.gmres"):
        return _gmres_loop(A, M, b, x0, tol, restart, maxiter, record, left,
                           axis, plan)


def arnoldi_step(A, M, V, j, norm, allsum, left=False):
    """Step j of Arnoldi: w = A(M(V[j])) (M(A(V[j])) with `left`),
    classical Gram–Schmidt against V[:j+1] with one DGKS pass, and
    V[j+1] = w / ||w||.  Returns the Hessenberg column [h1 + h2, ||w||]
    (j + 2 values) on V's device."""
    w = M(A(V[j])) if left else A(M(V[j]))
    Vj = V[: j + 1]
    h1 = allsum(Vj @ w)
    w = w - Vj.T @ h1
    h2 = allsum(Vj @ w)
    w = w - Vj.T @ h2
    wnorm = norm(w)
    V[j + 1] = w / torch.where(wnorm == 0, torch.ones_like(wnorm), wnorm)
    return torch.cat([h1 + h2, wnorm[None]])


class ArnoldiPlan:
    """The right-preconditioned Arnoldi step of one operator pair A, M
    (callables x→y on CUDA tensors, whose operands outlive the plan) as
    CUDA graphs, one per step index j so that V[:j+1] keeps its exact
    shape.

    The plan owns the basis V [m+1, n] and a pinned host buffer for the
    Hessenberg column.  `launch(j)` replays the graph of step j, capturing
    it first where it has none; the graph runs `arnoldi_step` and copies
    the column into the buffer, and `column(j)` waits on one event and
    reads it.  All graphs of a plan share one memory pool (no tensor a
    graph makes outlives it) and replay on the caller's stream.  Nothing
    touches the device before the first `vectors` call."""

    def __init__(self, A: Callable, M: Callable):
        self.A, self.M = A, M
        self.V = None

    def vectors(self, m: int, b: torch.Tensor) -> torch.Tensor:
        """The basis for GMRES(m) on vectors like `b`, made on the first
        call and kept across cycles and solves: the plan's operators fix
        n, dtype and device, and its solves' parameters m."""
        if self.V is None:
            self.V = torch.empty((m + 1, b.shape[0]), dtype=b.dtype,
                                 device=b.device)
            self.col = torch.empty(m + 1, dtype=b.dtype, pin_memory=True)
            self.host = self.col.numpy()
            self.graphs = [None] * m
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(b.device)
            self.ready = torch.cuda.Event()
        assert self.V.shape == (m + 1, b.shape[0])
        return self.V

    def _step(self, j: int) -> None:
        col = arnoldi_step(self.A, self.M, self.V, j, _norm, _identity)
        self.col[: j + 2].copy_(col, non_blocking=True)

    def _capture(self, j: int):
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.V.device)
        with torch.cuda.stream(self.stream):
            if not any(self.graphs):
                # warm up on the capture stream (its library handles and
                # workspaces) before the plan's first capture; the replay
                # rewrites the same V[j+1]
                self._step(j)
                self.stream.synchronize()
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                self._step(j)
            finally:
                graph.capture_end()
        timers.count("krylov.graph_captures")
        return graph

    def launch(self, j: int) -> None:
        graph = self.graphs[j]
        if graph is None:
            graph = self.graphs[j] = self._capture(j)
        graph.replay()
        self.ready.record()

    def column(self, j: int) -> np.ndarray:
        """Step j's Hessenberg column, once its replay has written it."""
        self.ready.synchronize()
        return self.host[: j + 2]


def _gmres_loop(A, M, b, x0, tol, restart, maxiter, record, left, axis,
                plan):
    if plan is not None and (left or axis is not None):
        raise ValueError("an ArnoldiPlan replays right-preconditioned "
                         "steps of one process")
    _, norm, allsum = _make_reducers(axis)
    # with a plan M runs inside the replayed graphs, out of any span's
    # sight, so its one eager M(dx) a cycle opens no `precond.apply` either
    A, M_spanned, span = _iteration_spans(A, M)
    M = M_spanned if plan is None else M
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
        V = (torch.empty((m + 1, n), dtype=b.dtype, device=b.device)
             if plan is None else plan.vectors(m, b))
        V[0] = r / torch.where(beta_d == 0, torch.ones_like(beta_d), beta_d)
        H = np.zeros((m + 1, m), hdt)
        cs = np.zeros(m, hdt)
        sn = np.zeros(m, hdt)
        g = np.zeros(m + 1, hdt)
        g[0] = beta
        j, res = 0, beta
        while j < m and res / bnorm > tol:
            if plan is None:
                hcol = arnoldi_step(A, M, V, j, norm, allsum, left)
                # the iteration's one host sync: the new Hessenberg column
                with span("krylov.sync"):
                    col = hcol.cpu().numpy()
            else:
                plan.launch(j)
                with span("krylov.sync"):  # the replay's one event wait
                    col = plan.column(j)
            col = col.astype(hdt)
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
        timers.count("krylov.cycles")
        timers.count("krylov.iterations", j)
        if plan is not None:
            timers.count("krylov.graph_replays", j)
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
