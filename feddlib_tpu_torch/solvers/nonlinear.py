"""NonLinearSolver — Newton and fixed-point drivers.

Counterpart of feddlib_tpu/solvers/nonlinear.py.  Criteria and defaults
follow the reference: relNonLinTol = 1e-6, MaxNonLinIts = 10, criterion
"Residual" (relative residual ‖F‖/‖F₀‖) or "Update" (‖δ‖), optionally
combined ("Combo" OR / AND) with the NOX-style weighted RMS test of the
update ("Use WRMS").  "Cancel MaxNonLinIts" raises if the cap is hit.

Newton step: solve J(u) δ = −F(u), u ← u + δ, with a backtracking line
search that halves the step while the residual is not finite or more than
doubles.  Dirichlet handling follows the reference's residual convention:
F = u − g on constrained dofs and J has identity rows there, so δ = g − u
restores the BC exactly each step.

Spans (utils/timers.py): `newton.solve` around `solve`, and inside it
`newton.residual` around each residual evaluation, `newton.tangent`
around each reassembly (both synchronised) and `newton.linear_solve`
around each linear solve; counters `newton.iterations` and
`newton.backtracks` (line-search halvings).
"""

from __future__ import annotations

import math

import torch

from feddlib_tpu_torch.utils import timers


class NonLinearSolver:
    def __init__(self, method: str = "Newton"):
        if method not in ("Newton", "FixedPoint"):
            raise ValueError(f"unknown nonlinear method {method!r}")
        self.method = method
        self.linear_iters = []
        self.final_criterion = None

    def solve(self, problem, t: float = 0.0) -> int:
        """Iterate to convergence; returns the nonlinear iteration count.
        `linear_iters` holds the Krylov iterations of each step."""
        with timers.timer("newton.solve"):
            return self._iterate(problem, t)

    @staticmethod
    def _residual(problem, t):
        with timers.timer("newton.residual", sync=True):
            return problem.calculate_residual(t)

    def _iterate(self, problem, t):
        pl = problem.parameter_list
        tol = float(pl.get("relNonLinTol", 1e-6))
        abs_tol = float(pl.get("absNonLinTol", 0.0))
        max_its = int(pl.get("MaxNonLinIts", 10))
        criterion = pl.get("Criterion", "Residual")
        cancel = bool(pl.get("Cancel MaxNonLinIts", False))
        use_wrms = bool(pl.get("Use WRMS", False))
        wrms_rtol = float(pl.get("WRMS rtol", 1e-6))
        wrms_atol = float(pl.get("WRMS atol", 1e-8))
        combo = pl.get("Combo", "OR")
        line_search = bool(pl.get("Use Line Search", True))

        problem.init_vectors()
        # BC-consistent initial guess so ‖F₀‖ is meaningful
        problem.solution = problem.bc_builder.apply_to_rhs(problem.solution, t)
        r = self._residual(problem, t)
        norm0 = problem.residual_norm(r)
        self.linear_iters = []
        if norm0 == 0.0:
            return 0
        its = 0
        crit = 1.0
        converged = False
        rnorm_prev = norm0
        while not converged and its < max_its:
            with timers.timer("newton.tangent", sync=True):
                problem.reassemble(self.method)
            with timers.timer("newton.linear_solve"):
                delta, lin_its = problem.linear_solver.solve_system(
                    problem, r.scale(-1.0))
            self.linear_iters.append(lin_its)
            base = problem.solution
            step = 1.0
            problem.solution = base.axpy(step, delta)
            r = self._residual(problem, t)
            rnorm = problem.residual_norm(r)
            if line_search:
                tries = 0
                while (not math.isfinite(rnorm)
                       or rnorm > 2.0 * rnorm_prev) and tries < 12:
                    step *= 0.5
                    problem.solution = base.axpy(step, delta)
                    r = self._residual(problem, t)
                    rnorm = problem.residual_norm(r)
                    tries += 1
                    timers.count("newton.backtracks")
            rnorm_prev = rnorm if math.isfinite(rnorm) else rnorm_prev
            its += 1
            timers.count("newton.iterations")
            if criterion == "Update":
                crit = float(delta.norm2())
                converged = crit <= tol
            else:
                crit = rnorm / norm0
                converged = crit <= tol or (abs_tol > 0 and rnorm <= abs_tol)
            if use_wrms:
                # ‖δ_i / (atol + rtol·|u_i|)‖_rms ≤ 1  (NOX NormWRMS)
                num, ndof = 0.0, 0
                for d, u in zip(delta.blocks, problem.solution.blocks):
                    w = d / (wrms_atol + wrms_rtol * torch.abs(u))
                    num += float(torch.dot(w, w))
                    ndof += u.shape[0]
                wrms_ok = (num / max(ndof, 1)) ** 0.5 <= 1.0
                converged = (converged or wrms_ok) if combo == "OR" \
                    else (converged and wrms_ok)
        self.final_criterion = crit
        if cancel and its >= max_its and not converged:
            raise RuntimeError(
                f"Newton hit MaxNonLinIts={max_its} (criterion {crit:.2e})")
        return its
