"""Problem kind `navier_stokes_p2p1`: steady incompressible Navier–Stokes
in Taylor–Hood (P2 velocity, P1 pressure) tetrahedra on the unit cube, the
lid-driven cavity: u = the configuration's lid velocity on z = 1, no slip
on the other walls, every boundary P2 node fixed, the pressure free.  It
runs through the port's `NavierStokes` on the P2 domain that
`Domain.p2_domain` builds from the benchmark's P1 mesh, with the pressure
on that P1 mesh.  The reference (`reference/fem_ns.py`) builds its own
nodes and matrices; the states reach it through the nodes' lattice keys.

`build` stops, before any assembly, a program whose mixed-precision solve
has no two-level branch for a multi-field system (no
`solvers.linear.block_cluster_operators`): at this size the one-level
fallback would not finish a run."""

from __future__ import annotations

import numpy as np

from benchmark import inputs, systems
from benchmark.reference import fem_ns


def build(cfg: dict, device) -> systems.System:
    import torch

    from feddlib_tpu_torch.problems import NavierStokes
    from feddlib_tpu_torch.solvers import linear

    if not hasattr(linear, "block_cluster_operators"):
        raise SystemExit("benchmark: this program's mixed-precision solve "
                         "has no two-level branch for a block system")
    dom_p, _, elements, _ = systems.domain(cfg, device)
    dom_u = dom_p.p2_domain()
    points = dom_u.mesh.points
    flags = inputs.point_flags(points, {})
    dom_u.mesh.point_flags = flags
    prob = NavierStokes(dom_u, dom_p, parameter_list=systems.params(cfg),
                        device=device)
    prob.assemble()
    lid = [float(v) for v in cfg["lid"]["velocity"]]

    def bc(x, t):
        on = (x[2] == 1.0).to(x.dtype)
        return torch.stack([on * c for c in lid])

    prob.add_bc(bc, 1, 0)
    return systems.System(prob, points, elements, np.repeat(flags == 1, 3))


def reference(cfg: dict, device) -> fem_ns.Cavity:
    p = cfg["parameters"]
    return fem_ns.Cavity(int(cfg["mesh"]["cells"]), float(p["Viscosity"]),
                         float(p.get("Density", 1.0)),
                         cfg["lid"]["velocity"], device=device)


def order(system: systems.System, cfg: dict, ref: fem_ns.Cavity):
    """The reference's ids of the program's velocity nodes (the P2 nodes
    of `system.points`) and pressure nodes (the benchmark's P1 mesh, on
    which `build` put the pressure)."""
    p1_points, _ = inputs.cube_mesh(cfg["mesh"]["cells"])
    return ref.order_of(system.points, p1_points)
