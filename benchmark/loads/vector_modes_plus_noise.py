"""Load kind `vector_modes_plus_noise`: request i's nodal 3-vector field
(dof node * 3 + component) is built like `modes_plus_noise`'s, per
component: the sine modes with every k up to `max_mode`, seeded
amplitudes damped by 1 / |k|^2, scaled by h^3, plus a combination of
`noise_pool` seeded noise fields of that component scaled to
`noise_share` of the smooth part's norm; zero on every clamped dof.  Every
seed gets loads of the same make-up."""

from __future__ import annotations

import numpy as np

from benchmark import plugins

D = 3


class Loads(plugins.load("loads", "modes_plus_noise").Loads):
    """`modes` [3N, 3K] and `noise` [3N, 3Q]: each column one component's
    mode or noise field, zero in the other two components."""

    def __init__(self, points, dirichlet, spec: dict, seed: int, cfg: dict):
        q = int(spec["noise_pool"])
        super().__init__(points, dirichlet, dict(spec, noise_pool=D * q),
                         seed, cfg)
        n, k = self.modes.shape
        modes = np.zeros((n, D, D, k))
        noise = np.zeros((n, D, D, q))
        for c in range(D):
            modes[:, c, c] = self.modes
            noise[:, c, c] = self.noise[:, c * q:(c + 1) * q]
        self.modes = modes.reshape(n * D, D * k)
        self.noise = noise.reshape(n * D, D * q)
        self.damp = np.tile(self.damp, D)
        self.gram_modes = self.modes.T @ self.modes
        self.gram_noise = self.noise.T @ self.noise
