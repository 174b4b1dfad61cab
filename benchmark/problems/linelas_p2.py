"""Problem kind `linelas_p2`: linear elasticity on the unit cube in
quadratic (P2, ten-node) tetrahedra, clamped on the flagged face (every P2
node there, vertex and midpoint), through the port's `LinElas` on the P2
domain that `Domain.p2_domain` builds from the benchmark's P1 mesh.  The
reference (`reference/fem_p2.py`) builds its own P2 nodes and matrix; the
answers reach it through the nodes' lattice keys."""

from __future__ import annotations

import numpy as np

from benchmark import inputs, systems
from benchmark.reference import fem, fem_p2


def build(cfg: dict, device) -> systems.System:
    from feddlib_tpu_torch.problems import LinElas

    p1, _, elements, _ = systems.domain(cfg, device)
    dom = p1.p2_domain()
    points = dom.mesh.points
    flags = inputs.point_flags(points, cfg["mesh"].get("faces", {}))
    dom.mesh.point_flags = flags
    flag = int(cfg["dirichlet_flag"])
    prob = LinElas(dom, parameter_list=systems.params(cfg), device=device)
    prob.assemble()
    prob.add_bc(lambda x, t: 0.0, flag, 0)
    return systems.System(prob, points, elements, np.repeat(flags == flag, 3))


def lame(cfg: dict):
    p = cfg["parameters"]
    return fem.lame(float(p["E"]), float(p["Poisson Ratio"]))


def clamped_face(cfg: dict):
    """(axis, side) of the face that carries the Dirichlet flag."""
    flag = int(cfg["dirichlet_flag"])
    (face,) = [k for k, v in cfg["mesh"]["faces"].items() if int(v) == flag]
    return "xyz".index(face[0]), int(face[1])


def reference(cfg: dict, device, control: bool = False):
    """The reference's system of the configuration (`control=True`: the
    float32 control's solver)."""
    from benchmark.reference import control_p2

    cls = control_p2.LinElasP2 if control else fem_p2.LinElasP2
    return cls(int(cfg["mesh"]["cells"]), *lame(cfg), *clamped_face(cfg),
               device=device)


def relres(system: systems.System, cfg: dict, pairs, device):
    """Relative residuals ||b - A x|| / ||b|| of (b, x) numpy pairs, given
    in the program's node order, on the reference's own matrix."""
    ref = reference(cfg, device)
    order = ref.m.order_of(system.points)
    return [ref.relres(ref.to_mine(order, b), ref.to_mine(order, x))
            for b, x in pairs]
