"""The system under test and what a problem kind shares: the port's problem
for a configuration, built from the benchmark's own mesh arrays.  Each
problem kind is a file `benchmark/problems/<problem>.py` (found by the
configuration's `problem`) with

- `build(cfg, device) -> System`, and
- the reference's side of the checks that its operations call (for
  example `relres` for a stream of linear solves, `step_criteria` for
  time steps).

Only `build` imports the program (`feddlib_tpu_torch`); the reference
never does.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark import inputs


@dataclass
class System:
    prob: object
    points: np.ndarray
    elements: np.ndarray
    dirichlet: np.ndarray  # [n_dofs] bool, the constrained dofs

    def mixed_cache(self):
        """The mixed-precision solve's built operators and preconditioner
        (None before the first solve)."""
        return getattr(self.prob, "_mixed_cache", None)


def domain(cfg: dict, device):
    """(the port's Domain, points, elements, point flags) of the
    configuration's mesh, made by `inputs.cube_mesh`."""
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.mesh.mesh import Mesh

    points, elements = inputs.cube_mesh(cfg["mesh"]["cells"])
    flags = inputs.point_flags(points, cfg["mesh"].get("faces", {}))
    mesh = Mesh(3, "P1", points, flags, elements,
                np.zeros(len(elements), dtype=np.int32))
    return Domain(mesh, device=device), points, elements, flags


def params(cfg: dict):
    """The configuration's `parameters` as the port's ParameterList."""
    from feddlib_tpu_torch.utils.config import ParameterList

    return ParameterList("Problem", dict(cfg["parameters"]))
