"""Inputs the benchmark makes and hands to both sides: the mesh of a
configuration, and the seeded random streams from which the load kinds
(`benchmark/loads/<kind>.py`) draw the loads of a traffic mix.

The mesh is the unit cube cut into n^3 cells of six tetrahedra each (the
Kuhn split along the diagonal of each cell), positively oriented.  Points
on the boundary get flag 1; a configuration may give a face a flag of its
own (the clamped face of the solid).  Nothing here imports the program.

A traffic mix is a data file (`benchmark/traffic/<mix>.json`); its
`load` object names a load kind, the one general generator of such loads,
which reads the rest of the object as its parameters.
"""

from __future__ import annotations

import numpy as np

# the six tetrahedra of the unit cell, as corner ids c = ix + 2 iy + 4 iz;
# all share the diagonal 0-7
_KUHN = np.array([[0, 1, 3, 7], [0, 1, 5, 7], [0, 2, 3, 7],
                  [0, 2, 6, 7], [0, 4, 5, 7], [0, 4, 6, 7]], dtype=np.int64)


def cube_mesh(cells: int):
    """(points [N, 3] f64, elements [E, 4] int64) of the unit cube with
    `cells`^3 cells of six tetrahedra, node id (i*(n+1) + j)*(n+1) + k."""
    n = int(cells)
    g = np.linspace(0.0, 1.0, n + 1)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    i, j, k = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                          indexing="ij")
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    corners = np.stack([((i + (c & 1)) * (n + 1) + j + ((c >> 1) & 1))
                        * (n + 1) + k + ((c >> 2) & 1) for c in range(8)],
                       axis=1)
    elements = corners[:, _KUHN].reshape(-1, 4)
    p = points[elements]
    e1, e2, e3 = (p[:, a] - p[:, 0] for a in (1, 2, 3))
    neg = np.einsum("ei,ei->e", np.cross(e1, e2), e3) < 0
    elements[neg, 2], elements[neg, 3] = (elements[neg, 3].copy(),
                                          elements[neg, 2].copy())
    return points, elements


def point_flags(points: np.ndarray, faces: dict) -> np.ndarray:
    """Flag 1 on the boundary, 0 inside; then each face named in `faces`
    ("x0", "x1", ..., "z1" -> flag) gets its flag, in the dict's order."""
    on_b = np.any(np.isclose(points, 0.0) | np.isclose(points, 1.0), axis=1)
    flags = on_b.astype(np.int32)
    for key, flag in faces.items():
        axis = "xyz".index(key[0])
        flags[np.isclose(points[:, axis], float(key[1]))] = int(flag)
    return flags


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of the seed (any whole number >= 0)."""
    return np.random.default_rng([int(seed) % 2**63, *stream])
