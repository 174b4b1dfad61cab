"""Operation `solve_stream`: solve the fixed assembled operator for one
fresh load after another, through `LinearSolver.solve_system` (the
`_solve_mixed` path that `Problem.solve` takes).  The check judges every
window answer, or a seeded sample with the one of most iterations, by the
problem kind's `relres` against the configuration's `guarantees.relres`."""

from __future__ import annotations

import statistics
import time

import numpy as np

from benchmark import operation, tracing


class Loop:
    def __init__(self, run, system, traffic):
        import torch

        self.run, self.sys, self.traffic = run, system, traffic
        self.loads = operation.loads(run, system, traffic)
        dev = run.device
        self.modes = torch.as_tensor(self.loads.modes, device=dev)
        self.noise = torch.as_tensor(self.loads.noise, device=dev)
        self.answers = []

    def rhs(self, i: int):
        import torch

        a, w = self.loads.coefficients(i)
        dev = self.run.device
        return (self.modes @ torch.as_tensor(a, device=dev)
                + self.noise @ torch.as_tensor(w, device=dev))

    def solve(self, b):
        from feddlib_tpu_torch.la.block import BlockVector

        prob = self.sys.prob
        with tracing.span("solve"):
            x, its = prob.linear_solver.solve_system(prob, BlockVector([b]))
        return x[0], its

    def run_loop(self, seconds: float) -> None:
        run, dev = self.run, self.run.device
        for k in range(int(self.traffic["warmup_ops"])):
            self.solve(self.rhs(operation.WARMUP_INDEX + k))
        operation.sync(dev)
        run.window_started()
        t0 = time.perf_counter()
        i = 0
        while True:
            b = self.rhs(i)
            run.op_index = i
            t = time.perf_counter()
            x, its = self.solve(b)
            operation.sync(dev)
            t1 = time.perf_counter()
            run.ops.append({"seconds": t1 - t, "gmres": its,
                            "ir_passes": getattr(self.sys.prob,
                                                 "last_passes", None)})
            self.answers.append(x)
            run.after_op(t1 - t0)
            i += 1
            if t1 - t0 >= seconds:
                break
        self.window_s = t1 - t0

    def end_to_end(self) -> dict:
        lat = [op["seconds"] for op in self.run.ops]
        p90 = (statistics.quantiles(lat, n=10, method="inclusive")[-1]
               if len(lat) > 1 else lat[0])
        return {"solve_ms": self.window_s / len(lat) * 1e3,
                "solve_ms_p90": p90 * 1e3}

    def release(self) -> None:
        self.answers = [x.double().cpu().numpy() for x in self.answers]
        self.modes = self.noise = self.sys.prob = None

    def check(self, device):
        n = len(self.answers)
        cap = int(self.traffic["check"]["max_answers"])
        idx = np.arange(n)
        if n > cap:  # a seeded sample, with the solve of most iterations
            longest = int(np.argmax([op["gmres"] for op in self.run.ops]))
            rng = np.random.default_rng([int(self.run.seed) % 2**63, 5])
            idx = np.union1d(rng.choice(n, cap - 1, replace=False),
                             [longest])
        pairs = [(self.loads.load(int(i)), self.answers[int(i)])
                 for i in idx]
        finite = all(np.isfinite(x).all() for _, x in pairs)
        rel = operation.problem(self.run).relres(self.sys, self.run.config,
                                                 pairs, device)
        limit = float(self.run.config["guarantees"]["relres"])
        worst = operation.worst(rel) if finite else float("inf")
        failed = sum(not r <= limit for r in rel) if finite else len(rel)
        return [("answers_judged", float(len(idx)), 1.0, ">="),
                ("relres_max", worst, limit, "<=")], failed
