"""Load kind `modes_plus_noise`: request i's nodal vector is
b_i = h^3 (sum_k a_k phi_k + noise), phi_k the sine modes
sin(kx pi x) sin(ky pi y) sin(kz pi z) with every k up to `max_mode`, a_k
drawn from the seed and damped by 1 / |k|^2, plus a combination of
`noise_pool` seeded noise fields scaled to `noise_share` of the smooth
part's norm; zero on the Dirichlet boundary.  Every seed gets loads of the
same make-up, so the work per solve does not drift with the seed."""

from __future__ import annotations

import math

import numpy as np

from benchmark.inputs import rng


class Loads:
    """load(i): request i's nodal vector (numpy f64), the same for the
    same seed; `modes` [N, K] and `noise` [N, Q] with `coefficients(i)`
    build it on a device without the host."""

    def __init__(self, points, dirichlet, spec: dict, seed: int, cfg: dict):
        h = 1.0 / float(cfg["mesh"]["cells"])
        kmax = int(spec["max_mode"])
        ks = np.array([(a, b, c) for a in range(1, kmax + 1)
                       for b in range(1, kmax + 1)
                       for c in range(1, kmax + 1)], dtype=np.float64)
        self.damp = 1.0 / (ks ** 2).sum(axis=1)
        s = [np.sin(np.pi * np.outer(points[:, d], ks[:, d]))
             for d in range(3)]
        free = (~dirichlet).astype(np.float64)[:, None]
        self.modes = (s[0] * s[1] * s[2]) * free * h ** 3  # [N, K]
        pool = rng(seed, 1).standard_normal(
            (points.shape[0], int(spec["noise_pool"])))
        self.noise = pool * free * h ** 3
        self.share = float(spec["noise_share"])
        self.seed = int(seed)
        # Gram matrices: the norms of a request's two parts without forming it
        self.gram_modes = self.modes.T @ self.modes
        self.gram_noise = self.noise.T @ self.noise

    def coefficients(self, i: int):
        """(mode amplitudes [K], noise weights [Q]) of request i."""
        r = rng(self.seed, 2, int(i))
        a = r.standard_normal(self.modes.shape[1]) * self.damp
        w = r.standard_normal(self.noise.shape[1])
        smooth = math.sqrt(a @ self.gram_modes @ a)
        return a, w * (self.share * smooth / math.sqrt(w @ self.gram_noise @ w))

    def load(self, i: int) -> np.ndarray:
        a, w = self.coefficients(i)
        return self.modes @ a + self.noise @ w
