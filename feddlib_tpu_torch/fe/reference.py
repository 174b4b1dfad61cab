"""Reference-element basis tables and quadrature rules.

Reference: FE::getPhi / getDPhi / getQuadratureValues
(core/FE/FE_def.hpp:6730, :6846, :6023) hard-code P1/P2 simplex bases and
symmetric Gauss rules (tri to degree 7, tet to ~6).  Here the tables are
numpy (host, setup-phase); assembly kernels consume them as static constants
baked into jitted element kernels — quadrature loops unroll at trace time.

Local node ordering (must match feddlib_tpu_torch.mesh.p2):
  P1 tri [v0,v1,v2];   P2 tri [v0,v1,v2, m01,m12,m02]
  P1 tet [v0..v3];     P2 tet [v0..v3, m01,m12,m02,m03,m13,m23]
Barycentric: l0 = 1-x-y(-z), l1 = x, l2 = y, l3 = z.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

# ---------------------------------------------------------------------------
# basis evaluation
# ---------------------------------------------------------------------------


def n_basis(dim: int, fe_type: str) -> int:
    return {("P0", 2): 1, ("P0", 3): 1,
            ("P1", 2): 3, ("P1", 3): 4,
            ("P2", 2): 6, ("P2", 3): 10}[(fe_type, dim)]


def eval_phi(dim: int, fe_type: str, pts: np.ndarray) -> np.ndarray:
    """Basis values at reference points.  pts [nq, dim] → [nq, n_nodes]."""
    pts = np.atleast_2d(pts)
    x = pts[:, 0]
    y = pts[:, 1] if dim >= 2 else 0.0
    z = pts[:, 2] if dim >= 3 else 0.0
    if dim == 2:
        lam = [1.0 - x - y, x, y]
    else:
        lam = [1.0 - x - y - z, x, y, z]
    if fe_type == "P0":
        return np.ones((len(pts), 1))
    if fe_type == "P1":
        return np.stack(lam, axis=1)
    if fe_type == "P2":
        verts = [l * (2 * l - 1) for l in lam]
        if dim == 2:
            mids = [4 * lam[0] * lam[1], 4 * lam[1] * lam[2], 4 * lam[0] * lam[2]]
        else:
            mids = [
                4 * lam[0] * lam[1], 4 * lam[1] * lam[2], 4 * lam[0] * lam[2],
                4 * lam[0] * lam[3], 4 * lam[1] * lam[3], 4 * lam[2] * lam[3],
            ]
        return np.stack(verts + mids, axis=1)
    raise ValueError(f"unknown fe_type {fe_type!r}")


def eval_grad_phi(dim: int, fe_type: str, pts: np.ndarray) -> np.ndarray:
    """Reference gradients at points. pts [nq, dim] → [nq, n_nodes, dim]."""
    pts = np.atleast_2d(pts)
    nq = len(pts)
    x = pts[:, 0]
    y = pts[:, 1] if dim >= 2 else None
    z = pts[:, 2] if dim >= 3 else None
    one = np.ones(nq)
    zero = np.zeros(nq)
    if dim == 2:
        lam = [1.0 - x - y, x, y]
        dlam = [np.stack([-one, -one], 1), np.stack([one, zero], 1),
                np.stack([zero, one], 1)]
    else:
        lam = [1.0 - x - y - z, x, y, z]
        dlam = [
            np.stack([-one, -one, -one], 1),
            np.stack([one, zero, zero], 1),
            np.stack([zero, one, zero], 1),
            np.stack([zero, zero, one], 1),
        ]
    if fe_type == "P0":
        return np.zeros((nq, 1, dim))
    if fe_type == "P1":
        return np.stack(dlam, axis=1)
    if fe_type == "P2":
        verts = [(4 * l - 1)[:, None] * dl for l, dl in zip(lam, dlam)]

        def edge(i, j):
            return 4 * (lam[i][:, None] * dlam[j] + lam[j][:, None] * dlam[i])

        if dim == 2:
            mids = [edge(0, 1), edge(1, 2), edge(0, 2)]
        else:
            mids = [edge(0, 1), edge(1, 2), edge(0, 2),
                    edge(0, 3), edge(1, 3), edge(2, 3)]
        return np.stack(verts + mids, axis=1)
    raise ValueError(f"unknown fe_type {fe_type!r}")


# ---------------------------------------------------------------------------
# quadrature
# ---------------------------------------------------------------------------

_SQ15 = np.sqrt(15.0)

# triangle rules: (points [nq,2], weights [nq]) — weights sum to area 1/2
_TRI_RULES = {}
_TRI_RULES[1] = (np.array([[1 / 3, 1 / 3]]), np.array([0.5]))
_TRI_RULES[2] = (
    np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]]),
    np.full(3, 1 / 6),
)
_TRI_RULES[3] = (
    np.array([[1 / 3, 1 / 3], [0.6, 0.2], [0.2, 0.6], [0.2, 0.2]]),
    np.array([-27 / 96, 25 / 96, 25 / 96, 25 / 96]),
)
_a4, _b4 = 0.445948490915965, 0.091576213509771
_TRI_RULES[4] = (
    np.array([
        [_a4, _a4], [1 - 2 * _a4, _a4], [_a4, 1 - 2 * _a4],
        [_b4, _b4], [1 - 2 * _b4, _b4], [_b4, 1 - 2 * _b4],
    ]),
    np.array([0.223381589678011] * 3 + [0.109951743655322] * 3) / 2.0,
)
_a5, _b5 = 0.470142064105115, 0.101286507323456
_TRI_RULES[5] = (
    np.array([
        [1 / 3, 1 / 3],
        [_a5, _a5], [1 - 2 * _a5, _a5], [_a5, 1 - 2 * _a5],
        [_b5, _b5], [1 - 2 * _b5, _b5], [_b5, 1 - 2 * _b5],
    ]),
    np.concatenate([
        [9 / 80],
        np.full(3, (155 + _SQ15) / 2400),
        np.full(3, (155 - _SQ15) / 2400),
    ]),
)

# tetrahedron rules — weights sum to volume 1/6
_TET_RULES = {}
_TET_RULES[1] = (np.array([[0.25, 0.25, 0.25]]), np.array([1 / 6]))
_ta = (5 - np.sqrt(5.0)) / 20
_tb = (5 + 3 * np.sqrt(5.0)) / 20
_TET_RULES[2] = (
    np.array([
        [_ta, _ta, _ta], [_tb, _ta, _ta], [_ta, _tb, _ta], [_ta, _ta, _tb],
    ]),
    np.full(4, 1 / 24),
)
_TET_RULES[3] = (
    np.array([
        [0.25, 0.25, 0.25],
        [0.5, 1 / 6, 1 / 6], [1 / 6, 0.5, 1 / 6],
        [1 / 6, 1 / 6, 0.5], [1 / 6, 1 / 6, 1 / 6],
    ]),
    np.array([-4 / 5, 9 / 20, 9 / 20, 9 / 20, 9 / 20]) / 6.0,
)
# Keast 14-point rule, degree 5 (weights relative to unit-volume tet, /6 here)
_k_a1, _k_w1 = 0.3108859192633005, 0.1126879257180162
_k_a2, _k_w2 = 0.0927352503108912, 0.0734930431163619
_k_a3, _k_w3 = 0.0455037041256497, 0.0425460207770812


def _tet14():
    pts, wts = [], []
    for a, w in ((_k_a1, _k_w1), (_k_a2, _k_w2)):
        b = 1 - 3 * a
        group = [[a, a, a], [b, a, a], [a, b, a], [a, a, b]]
        pts += group
        wts += [w] * 4
    a = _k_a3
    b = 0.5 - a
    group = [
        [a, a, b], [a, b, a], [b, a, a],
        [a, b, b], [b, a, b], [b, b, a],
    ]
    pts += group
    wts += [_k_w3] * 6
    return np.array(pts), np.array(wts) / 6.0


_TET_RULES[5] = _tet14()
_TET_RULES[4] = _TET_RULES[5]


def _gauss_legendre_01(n):
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1), 0.5 * w


def _collapsed_rule(dim: int, degree: int):
    """Duffy/collapsed-coordinates tensor rule, exact for any degree.
    Fallback for degrees beyond the hard-coded symmetric rules."""
    n = (degree + dim) // 2 + 1
    u, wu = _gauss_legendre_01(n)
    if dim == 2:
        U, V = np.meshgrid(u, u, indexing="ij")
        WU, WV = np.meshgrid(wu, wu, indexing="ij")
        x = U
        y = V * (1 - U)
        w = WU * WV * (1 - U)
        return np.stack([x.ravel(), y.ravel()], 1), w.ravel()
    U, V, W = np.meshgrid(u, u, u, indexing="ij")
    WU, WV, WW = np.meshgrid(wu, wu, wu, indexing="ij")
    x = U
    y = V * (1 - U)
    z = W * (1 - U) * (1 - V)
    w = WU * WV * WW * (1 - U) ** 2 * (1 - V)
    return np.stack([x.ravel(), y.ravel(), z.ravel()], 1), w.ravel()


@lru_cache(maxsize=None)
def quadrature(dim: int, degree: int):
    """(points [nq, dim], weights [nq]) integrating degree-`degree`
    polynomials exactly over the reference simplex."""
    table = _TRI_RULES if dim == 2 else _TET_RULES
    for d in sorted(table):
        if d >= degree:
            pts, wts = table[d]
            return pts.copy(), wts.copy()
    return _collapsed_rule(dim, degree)


def determine_degree(dim: int, fe_type: str, op: str = "grad") -> int:
    """Quadrature degree for an operator, mirroring FE::determineDegree
    (FE_def.hpp:5431): product of two basis factors, each differentiated or
    not.  op: 'grad' (grad·grad), 'phi' (phi·phi mass), 'conv' (phi·grad·phi).
    """
    p = {"P0": 0, "P1": 1, "P2": 2}[fe_type]
    if op == "grad":
        return max(2 * (p - 1), 1)
    if op == "phi":
        return 2 * p
    if op == "conv":
        return max(p + p + (p - 1), 1)
    raise ValueError(op)
