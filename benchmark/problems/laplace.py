"""Problem kind `laplace`: -Laplace u = f on the unit cube, u = 0 on the
flagged boundary, through the port's `Laplace` problem."""

from __future__ import annotations

from benchmark import systems
from benchmark.reference import checks


def build(cfg: dict, device) -> systems.System:
    from feddlib_tpu_torch.problems.laplace import Laplace

    dom, points, elements, flags = systems.domain(cfg, device)
    flag = int(cfg["dirichlet_flag"])
    prob = Laplace(dom, parameter_list=systems.params(cfg), device=device)
    prob.assemble()
    prob.add_bc(lambda x, t: 0.0, flag, 0)
    return systems.System(prob, points, elements, flags == flag)


def relres(system: systems.System, cfg: dict, pairs, device):
    """Relative residuals ||b - A x|| / ||b|| of (b, x) numpy pairs on the
    reference's own Dirichlet Laplace matrix."""
    return checks.laplace_relres(system.points, system.elements,
                                 system.dirichlet, pairs, device)
