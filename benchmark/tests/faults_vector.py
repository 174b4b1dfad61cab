"""The faults of `faults.py` for the vector cells (operations
`vector_solve_stream` and `tangent_solves`), each vector cell's float32
control planted in the program's place (the P2 cell's
`reference/control_p2.py`; for the tangent cell the P1 control's float32
PCG of `reference/control.py` on the reference's frozen tangent), and the
program's own answers rounded to float32 (what the storage precision
alone costs, below any float32 solve):

    python3 -m benchmark.tests.faults_vector <fault> --workload <cell> \\
        --seed <n> --seconds <s> --trace 0 [--rehearse]

runs `benchmark.run` through `faults.main` with these faults added.
"""

from __future__ import annotations

import sys

from benchmark import plugins
from benchmark.reference import checks, control, fem
from benchmark.tests import faults


def control_p2_solves(ctx):
    """The P2 control's float32 solve in place of `solve_system`; loads and
    answers cross between the program's node order and the reference's by
    the nodes' lattice keys."""
    import torch

    from feddlib_tpu_torch.la.block import BlockVector
    from feddlib_tpu_torch.solvers.linear import LinearSolver

    build = ctx.problem.build

    def built(cfg, device):  # the configuration as run (rehearsal sizes)
        ctx.state["cfg"] = cfg
        return build(cfg, device)

    def solve_system(self, problem, b):
        if "ctl" not in ctx.state:
            ctl = ctx.problem.reference(ctx.state["cfg"], b[0].device,
                                        control=True)
            ctx.state["ctl"] = ctl
            ctx.state["order"] = ctl.sys.m.order_of(ctx.system.points)
        ctl, order = ctx.state["ctl"], ctx.state["order"]
        x = ctl.solve(ctl.sys.to_mine(order, b[0].cpu().numpy()))
        x = x.double().cpu().numpy().reshape(-1, 3)[order].reshape(-1)
        return BlockVector([torch.as_tensor(x, dtype=b[0].dtype,
                                            device=b[0].device)]), 0

    ctx.problem.build = built
    LinearSolver.solve_system = solve_system


def control_tangent_solves(ctx):
    """The tangent cell's float32 control: after the program's set-up step,
    each load is solved by `control.pcg` in float32 throughout on the
    reference's own frozen system, (beta0 / dt) M + the Neo-Hooke tangent
    at the program's state after that step, with identity Dirichlet
    rows."""
    import torch

    from feddlib_tpu_torch.la.block import BlockVector
    from feddlib_tpu_torch.solvers.linear import LinearSolver

    loop = plugins.load("operations", "tangent_solves").Loop
    setup = loop._setup_step

    def setup_then_plant(self):
        setup(self)
        s, dt = ctx.system, self.dt
        mu, lam = ctx.problem.lame(ctx.config)
        bdf = checks.Bdf(s.points, s.elements, s.dirichlet, mu, lam, dt,
                         dtype=torch.float32, device=self.state.device)
        K = (fem.neo_hooke_tangent(bdf.m, bdf.vec(self.state), mu, lam)
             + (checks.BDF[2][0] / dt) * bdf.M)
        free = ~bdf.D
        apply, diag = control._free_operator(K, free), control._diag(K, free)

        def solve_system(_, problem, b):
            x = control.pcg(apply, b[0].to(torch.float32), diag)
            return BlockVector([x.to(b[0].dtype)]), 0

        LinearSolver.solve_system = solve_system

    loop._setup_step = setup_then_plant


def rounded_f32(ctx):
    """The program's own answer, stored in float32."""
    from feddlib_tpu_torch.solvers.linear import LinearSolver

    inner = LinearSolver.solve_system

    def solve_system(self, problem, b):
        x, its = inner(self, problem, b)
        x[0].copy_(x[0].float())
        return x, its

    LinearSolver.solve_system = solve_system


FAULTS = {
    "altered_answer": {"vector_solve_stream": faults.altered_answer,
                       "tangent_solves": faults.altered_answer},
    "control_f32": {"vector_solve_stream": control_p2_solves,
                    "tangent_solves": control_tangent_solves},
    "rounded_f32": {"vector_solve_stream": rounded_f32,
                    "tangent_solves": rounded_f32},
}


def main(argv=None) -> int:
    for fault, plants in FAULTS.items():
        faults.FAULTS.setdefault(fault, {}).update(plants)
    return faults.main(argv)


if __name__ == "__main__":
    sys.exit(main())
