"""Load kind `body_force`: a uniform body force of `amplitude` per unit
volume whose size follows the profile sin^2(pi n / `period_steps`) of the
time step n (it rises from rest, peaks and comes back within each period),
in one of `directions`, drawn by the seed.  The directions are images of
one another under a symmetry of the configuration (for the cube clamped on
x = 0: the swap of y and z, which maps the mesh onto itself), so every seed
does the same work on a load case of its own."""

from __future__ import annotations

import math

import numpy as np

from benchmark.inputs import rng


class Loads:
    def __init__(self, points, dirichlet, spec: dict, seed: int, cfg: dict):
        dirs = np.asarray(spec["directions"], dtype=np.float64)
        d = dirs[rng(seed, 3).integers(len(dirs))]
        self.direction = d / np.linalg.norm(d)
        self.amplitude = float(spec["amplitude"])
        self.period = float(spec["period_steps"])

    def factor(self, step: int) -> float:
        """The load's size at time step `step` (1, 2, ...) as a share of
        `amplitude`."""
        return math.sin(math.pi * step / self.period) ** 2

    def density(self, step: int) -> np.ndarray:
        """The force per unit volume [3] at time step `step`."""
        return self.amplitude * self.factor(step) * self.direction
