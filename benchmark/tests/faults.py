"""Faults planted underneath an otherwise whole run of the harness, for the
tests that `correct` comes out false, and the control (the reference in
float32, `reference/control.py`) planted in the program's place:

    python3 -m benchmark.tests.faults <fault> --workload <cell> --seed <n> \\
        --seconds <s> --trace 0 [--rehearse]

runs `benchmark.run` with the fault in place and prints what it prints.
The tests run it at the configurations' rehearsal sizes on the CPU; on the
card it runs at the cell's own size.
"""

from __future__ import annotations

import sys
from types import SimpleNamespace

from benchmark import plugins, run
from benchmark.reference import control, fem


def altered_answer(ctx):
    """An answer altered where it is produced."""
    from feddlib_tpu_torch.solvers.linear import LinearSolver

    inner = LinearSolver.solve_system

    def solve_system(self, problem, b):
        x, its = inner(self, problem, b)
        x[0][len(x[0]) // 2] += 1e-3 * float(x[0].abs().max())
        return x, its

    LinearSolver.solve_system = solve_system


def stale_step(ctx):
    """A step that returns its state unchanged."""
    from feddlib_tpu_torch.solvers.nonlinear import NonLinearSolver

    def solve(self, problem, t=0.0):
        self.linear_iters = []
        return 0

    NonLinearSolver.solve = solve


def altered_state(ctx):
    """A state altered where it is produced."""
    from feddlib_tpu_torch.solvers.nonlinear import NonLinearSolver

    inner = NonLinearSolver.solve

    def solve(self, problem, t=0.0):
        its = inner(self, problem, t)
        problem.solution[0][-1] += 1e-4
        return its

    NonLinearSolver.solve = solve


def control_solves(ctx):
    """The control's float32 solve in place of `solve_system`."""
    from feddlib_tpu_torch.la.block import BlockVector
    from feddlib_tpu_torch.solvers.linear import LinearSolver

    def solve_system(self, problem, b):
        if "ctl" not in ctx.state:
            s = ctx.system
            ctx.state["ctl"] = control.Laplace(s.points, s.elements,
                                               s.dirichlet, b[0].device)
        x = ctx.state["ctl"].solve(b[0])
        return BlockVector([x.to(b[0].dtype)]), 0

    LinearSolver.solve_system = solve_system


def control_steps(ctx):
    """The control's float32 Newton step, on its own BDF history, in place
    of the program's Newton loop; the load is the traffic's, made by the
    reference."""
    from feddlib_tpu_torch.solvers.nonlinear import NonLinearSolver

    dt = float(ctx.traffic["dt"])

    def solve(self, problem, t=0.0):
        if "ctl" not in ctx.state:
            s = ctx.system
            mu, lam = ctx.problem.lame(ctx.config)
            nodes = s.points.shape[0]
            ctx.state["ctl"] = control.Bdf(
                s.points, s.elements, s.dirichlet, mu, lam, dt,
                device=problem.solution[0].device)
            ctx.state["loads"] = plugins.load(
                "loads", ctx.traffic["load"]["kind"]).Loads(
                    s.points, s.dirichlet.reshape(nodes, -1).all(axis=1),
                    ctx.traffic["load"], ctx.seed, ctx.config)
        ctl = ctx.state["ctl"]
        f = fem.body_force(ctl.bdf.m,
                           ctx.state["loads"].density(round(t / dt)))
        problem.solution[0] = ctl.step(f).to(problem.solution[0].dtype)
        self.linear_iters = []
        return 1

    NonLinearSolver.solve = solve


# each fault, by the operations whose cells can have it
FAULTS = {
    "altered_answer": {"solve_stream": altered_answer},
    "stale_step": {"time_steps": stale_step},
    "altered_state": {"time_steps": altered_state},
    "control_f32": {"solve_stream": control_solves,
                    "time_steps": control_steps},
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    fault, run_args = argv[0], argv[1:]
    args = run._parser().parse_args(run_args)
    spec = run.load_json(run.ROOT, "BENCHMARK.json")
    cell = run.find_cell(spec, args.workload)
    config = run.load_json(run.HERE, "configs", cell["config"] + ".json")
    traffic = run.load_json(run.HERE, "traffic", cell["traffic"] + ".json")
    plant = FAULTS[fault].get(traffic["operation"])
    if plant is None:
        print(f"faults: {fault} is not a fault of {args.workload}",
              file=sys.stderr)
        return 2
    ctx = SimpleNamespace(config=config, traffic=traffic, seed=args.seed,
                          system=None, state={},
                          problem=plugins.load("problems",
                                               config["problem"]))
    build = ctx.problem.build

    def built(cfg, device):
        ctx.system = build(cfg, device)
        return ctx.system

    ctx.problem.build = built
    if run.ROOT not in sys.path:
        sys.path.insert(0, run.ROOT)
    plant(ctx)
    return run.main(run_args)


if __name__ == "__main__":
    sys.exit(main())
