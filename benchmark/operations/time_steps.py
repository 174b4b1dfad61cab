"""Operation `time_steps`: BDF time steps of a nonlinear problem, one after
another, through `DAESolverInTime` (Newton in each step, one mixed-precision
solve per Newton iteration).  The first `setup_steps` steps are set-up (the
first builds the preconditioner).  The check judges every step of the run,
the set-up's too, by the problem kind's `step_criteria` against the
configuration's `guarantees.newton_criterion`, and prints beside each
step's reading the criterion that the program's own Newton loop ended on
(the last over the first residual norm it took), so that the two can be
compared."""

from __future__ import annotations

import sys
import time

import numpy as np

from benchmark import operation, tracing


class Loop:
    def __init__(self, run, system, traffic):
        from feddlib_tpu_torch.fe import ops
        from feddlib_tpu_torch.solvers.timestepping import (DAESolverInTime,
                                                            TimeProblem)

        self.run, self.sys, self.traffic = run, system, traffic
        self.loads = operation.loads(run, system, traffic)
        prob = system.prob
        unit = [float(v) for v in self.loads.direction]
        self.f_unit = ops.assemble_rhs(prob.variables[0][0],
                                       lambda x: unit, 3)
        self.dt = float(traffic["dt"])
        self.tp = TimeProblem(prob)
        self.drv = DAESolverInTime(self.tp, self.dt, self.dt * 1e9,
                                   rhs_func=self.rhs, observer=self.observe)
        self.states = []
        self.setup_counts = []
        self._newton = self._gmres = 0
        self._norms = []
        self._instrument()

    def _instrument(self):
        """Spans around the calls into the program's layers, the counts of
        linear solves (one a Newton iteration) and their iterations, and
        the residual norms the Newton loop takes."""
        prob, tp = self.sys.prob, self.tp
        solve_system = prob.linear_solver.solve_system
        residual_norm = prob.residual_norm

        def linear_solve(problem, b):
            with tracing.span("linear_solve"):
                x, its = solve_system(problem, b)
            self._newton += 1
            self._gmres += its
            return x, its

        def norm(r):
            v = residual_norm(r)
            self._norms.append(v)
            return v

        def spanned(name, fn):
            def call(*a, **k):
                with tracing.span(name):
                    return fn(*a, **k)
            return call

        prob.linear_solver.solve_system = linear_solve
        prob.residual_norm = norm
        prob.calculate_residual = spanned("residual", prob.calculate_residual)
        prob.reassemble = spanned("tangent", prob.reassemble)
        tp.combined_system = spanned("combined_system", tp.combined_system)

    def rhs(self, t: float):
        from feddlib_tpu_torch.la.block import BlockVector

        n = round(t / self.dt)
        return BlockVector([self.f_unit * (self.loads.amplitude
                                           * self.loads.factor(n))])

    def run_loop(self, seconds: float) -> None:
        self.seconds = seconds
        self.t_last = time.perf_counter()
        order = {"BDF1": 1, "BDF2": 2}[self.traffic["scheme"]]
        self.drv.advance_nonlinear_bdf(order=order)

    def observe(self, t: float, sol) -> None:
        run = self.run
        operation.sync(run.device)
        now = time.perf_counter()
        self.states.append(sol[0].clone())
        norms = self._norms
        rec = {"seconds": now - self.t_last, "newton": self._newton,
               "gmres": self._gmres,
               "criterion": (norms[-1] / norms[0]
                             if len(norms) > 1 and norms[0] else None)}
        self._newton = self._gmres = 0
        self._norms = []
        self.t_last = now
        n, setup = len(self.states), int(self.traffic["setup_steps"])
        if n <= setup:
            self.setup_counts.append(rec)
        if n < setup:
            return
        if n == setup:
            run.window_started()
            run.op_index = 0
            self.t0 = now
            return
        run.ops.append(rec)
        run.op_index = len(run.ops)
        run.after_op(now - self.t0)
        if now - self.t0 >= self.seconds:
            self.drv.t_end = t  # the loop ends after this whole step
            self.window_s = now - self.t0

    def end_to_end(self) -> dict:
        return {"step_s": self.window_s / len(self.run.ops)}

    def release(self) -> None:
        self.states = [u.double().cpu().numpy() for u in self.states]
        self.f_unit = self.tp = self.drv = self.sys.prob = None

    def check(self, device):
        cfg = self.run.config
        densities = [self.loads.density(n)
                     for n in range(1, len(self.states) + 1)]
        ratios = operation.problem(self.run).step_criteria(
            self.sys, cfg, self.dt, self.states, densities, device)
        counts = self.setup_counts + self.run.ops
        for n, r in enumerate(ratios, start=1):
            c = counts[n - 1] if n - 1 < len(counts) else {}
            print(f"step {n}: newton {c.get('newton')} gmres "
                  f"{c.get('gmres')} criterion {r!r} (the program's "
                  f"{c.get('criterion')!r})", file=sys.stderr)
        finite = all(np.isfinite(u).all() for u in self.states)
        limit = float(cfg["guarantees"]["newton_criterion"])
        worst = operation.worst(ratios) if finite else float("inf")
        # failed operations: the window's steps (the set-up's are judged
        # too, and a failure there makes the run not correct)
        window = ratios[len(self.setup_counts):]
        failed = (sum(not r <= limit for r in window) if finite
                  else len(window))
        return [("steps_judged", float(len(ratios)), 2.0, ">="),
                ("newton_criterion_max", worst, limit, "<=")], failed
