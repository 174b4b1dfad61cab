"""Problem kind `neo_hooke`: a compressible Neo-Hooke solid on the unit
cube, clamped where flagged, through the port's `NonLinElasticity`; the
body load is the traffic's."""

from __future__ import annotations

import numpy as np

from benchmark import systems
from benchmark.reference import checks, fem


def build(cfg: dict, device) -> systems.System:
    from feddlib_tpu_torch.problems import NonLinElasticity

    dom, points, elements, flags = systems.domain(cfg, device)
    flag = int(cfg["dirichlet_flag"])
    prob = NonLinElasticity(dom, parameter_list=systems.params(cfg),
                            device=device)
    prob.assemble()
    prob.add_bc(lambda x, t: 0.0, flag, 0)
    return systems.System(prob, points, elements,
                          np.repeat(flags == flag, 3))


def lame(cfg: dict):
    p = cfg["parameters"]
    return fem.lame(float(p["E"]), float(p["Poisson Ratio"]))


def step_criteria(system: systems.System, cfg: dict, dt: float, states,
                  densities, device):
    """The Newton criterion of each BDF step (`checks.Bdf.ratios`) of the
    states [u^1..u^N] under uniform body forces of the given densities
    [3-vectors], on the reference's own force, mass and load."""
    mu, lam = lame(cfg)
    bdf = checks.Bdf(system.points, system.elements, system.dirichlet,
                     mu, lam, dt, device=device)
    loads = [fem.body_force(bdf.m, d) for d in densities]
    return bdf.ratios(states, loads)
