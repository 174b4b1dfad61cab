"""Operation `jacobian_solves`: the Newton Jacobian of a steady flow at its
converged state, kept, and a stream of fresh momentum loads solved against
it, as Newton with a kept preconditioner and linear-stability, resolvent
and adjoint analyses do.

Set-up: Newton from the Dirichlet data at rest (the configuration's
`relNonLinTol`, one mixed-precision solve an iteration: the preconditioner
is built at the first and its operator refreshed at the others); then the
Jacobian at the converged state, with its identity Dirichlet rows, is
frozen, and the first warm-up solve refreshes the kept preconditioner's
operator to it.  The window is `solve_stream`'s loop of
`LinearSolver.solve_system` on that system, each load a velocity field
(the traffic's load kind on the velocity nodes) with zero pressure rows.

The check judges every window answer (past `max_answers` a seeded sample
with the one of most iterations) by ||b - J x|| / ||b|| <= the
configuration's `guarantees.relres` on the reference's own Jacobian at the
program's converged state, and that state by the reference's relative
Newton residual <= `guarantees.newton_criterion`."""

from __future__ import annotations

import numpy as np

from benchmark import operation, plugins, tracing


class Loop(plugins.load("operations", "solve_stream").Loop):
    def _setup(self):
        import torch

        from feddlib_tpu_torch.solvers.nonlinear import NonLinearSolver

        prob = self.sys.prob
        newton = NonLinearSolver("Newton")
        self.newton_its = newton.solve(prob)
        prob.reassemble("Newton")
        frozen = prob.bc_system()
        prob.bc_system = lambda: frozen
        self.state = prob.solution.concat().detach().clone()
        self.zero_p = torch.zeros(prob.block_sizes()[1],
                                  dtype=torch.float64, device=self.run.device)

    def solve(self, b):
        import torch

        from feddlib_tpu_torch.la.block import BlockVector

        prob = self.sys.prob
        with tracing.span("solve"):
            x, its = prob.linear_solver.solve_system(
                prob, BlockVector([b, self.zero_p]))
        return torch.cat([x[0], x[1]]), its

    def run_loop(self, seconds: float) -> None:
        self._setup()
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
        kind = operation.problem(self.run)
        cfg = self.run.config
        ref = kind.reference(cfg, device)
        order = kind.order(self.sys, cfg, ref)
        state = ref.to_mine(order, self.state)
        finite = bool(np.isfinite(self.state).all())
        crit = ref.newton_criterion(state) if finite else float("inf")
        J = ref.jacobian(state)
        zero_p = np.zeros(ref.n_p)
        rel = []
        for i in idx:
            b = ref.to_mine(order, np.concatenate(
                [self.loads.load(int(i)), zero_p]))
            x = ref.to_mine(order, self.answers[int(i)])
            finite = finite and bool(torch.isfinite(x).all())
            rel.append(ref.relres(J, b, x))
        g = cfg["guarantees"]
        limit = float(g["relres"])
        worst = operation.worst(rel) if finite else float("inf")
        failed = sum(not r <= limit for r in rel) if finite else len(rel)
        return [("answers_judged", float(len(idx)), 1.0, ">="),
                ("relres_max", worst, limit, "<="),
                ("newton_criterion", crit, float(g["newton_criterion"]),
                 "<=")], failed
