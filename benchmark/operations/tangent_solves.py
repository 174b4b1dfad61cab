"""Operation `tangent_solves`: one tangent of a loaded hyperelastic solid,
kept, and a stream of fresh loads solved against it, as modified Newton
and linearised buckling do.

Set-up: one BDF time step of the configuration's problem (Newton, one
mixed-precision solve an iteration) under the traffic's `setup_load` at
step 1, as the first step of `bdf2_steps`; then the system the next
(BDF2) step's first Newton iteration solves is frozen: the tangent at the
state u1 after the step plus (beta0 / dt) M, beta0 = 1.5 of BDF2, with
identity Dirichlet rows.  The window is `solve_stream`'s loop of
`LinearSolver.solve_system` on that system.  The check judges every
window answer (past `max_answers` a seeded sample with the one of most
iterations) by ||b - K x|| / ||b|| <= the traffic's `check.relres` (the
configuration's solver tolerance) on the reference's own matrix,
(beta0 / dt) M + the Neo-Hooke tangent at the program's u1
(`reference/fem.py`)."""

from __future__ import annotations

import numpy as np

from benchmark import operation, plugins
from benchmark.reference import checks, fem

BETA0 = checks.BDF[2][0]


class Loop(plugins.load("operations", "solve_stream").Loop):
    def _setup_step(self):
        from feddlib_tpu_torch.fe import ops
        from feddlib_tpu_torch.la.block import BlockVector
        from feddlib_tpu_torch.solvers.timestepping import (DAESolverInTime,
                                                            TimeProblem)

        run, prob = self.run, self.sys.prob
        spec = self.traffic["setup_load"]
        body = plugins.load("loads", spec["kind"]).Loads(
            self.sys.points, None, spec, run.seed, run.config)
        unit = [float(v) for v in body.direction]
        f1 = ops.assemble_rhs(prob.variables[0][0], lambda x: unit, 3) \
            * (body.amplitude * body.factor(1))
        self.dt = dt = float(self.traffic["dt"])
        tp = TimeProblem(prob)
        DAESolverInTime(tp, dt, dt, rhs_func=lambda t: BlockVector([f1])
                        ).advance_nonlinear_bdf(order=2)
        prob.reassemble("Newton")
        frozen = prob.bc_builder.apply_to_system(
            tp.combined_system(BETA0 / dt, 1.0))
        prob.bc_system = lambda: frozen
        self.state = prob.solution[0].detach().clone()

    def run_loop(self, seconds: float) -> None:
        self._setup_step()
        super().run_loop(seconds)

    def release(self) -> None:
        self.state = self.state.double().cpu().numpy()
        super().release()

    def check(self, device):
        import torch

        n = len(self.answers)
        cap = int(self.traffic["check"]["max_answers"])
        idx = np.arange(n)
        if n > cap:  # a seeded sample, with the solve of most iterations
            longest = int(np.argmax([op["gmres"] for op in self.run.ops]))
            rng = np.random.default_rng([int(self.run.seed) % 2**63, 5])
            idx = np.union1d(rng.choice(n, cap - 1, replace=False),
                             [longest])
        s = self.sys
        mu, lam = operation.problem(self.run).lame(self.run.config)
        bdf = checks.Bdf(s.points, s.elements, s.dirichlet, mu, lam, self.dt,
                         device=device)
        K = fem.neo_hooke_tangent(bdf.m, bdf.vec(self.state), mu, lam)
        finite = bool(np.isfinite(self.state).all())
        rel = []
        for i in idx:
            b, x = bdf.vec(self.loads.load(int(i))), bdf.vec(self.answers[i])
            finite = finite and bool(torch.isfinite(x).all())
            y = fem.matvec(K, x) + fem.matvec(bdf.M, BETA0 / self.dt * x)
            r = b - fem.with_dirichlet(y, x, bdf.D)
            rel.append(float(torch.linalg.norm(r) / torch.linalg.norm(b)))
        limit = float(self.traffic["check"]["relres"])
        worst = operation.worst(rel) if finite else float("inf")
        failed = sum(not r <= limit for r in rel) if finite else len(rel)
        return [("answers_judged", float(len(idx)), 1.0, ">="),
                ("relres_max", worst, limit, "<=")], failed
