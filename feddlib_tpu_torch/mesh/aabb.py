"""AABB tree for element point location — a host copy of
feddlib_tpu/mesh/aabb.py (numpy only, no device work).

Median splits over the element bounding boxes; `locate_points` combines
the tree walk with barycentric inside tests.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class AABBTree:
    def __init__(self, points: np.ndarray, elements: np.ndarray,
                 leaf_size: int = 16):
        self.points = points
        self.elements = elements
        nv = elements.shape[1]
        coords = points[elements]  # [E, nv, dim]
        self.lo = coords.min(axis=1)
        self.hi = coords.max(axis=1)
        self.leaf_size = leaf_size
        # flat tree arrays
        self.nodes_lo: List[np.ndarray] = []
        self.nodes_hi: List[np.ndarray] = []
        self.children: List[tuple] = []  # (left, right) or (-1, -1) leaf
        self.leaf_elems: List[Optional[np.ndarray]] = []
        order = np.arange(len(elements))
        self._build(order)

    def _build(self, ids: np.ndarray) -> int:
        idx = len(self.nodes_lo)
        lo = self.lo[ids].min(axis=0)
        hi = self.hi[ids].max(axis=0)
        self.nodes_lo.append(lo)
        self.nodes_hi.append(hi)
        self.children.append((-1, -1))
        self.leaf_elems.append(None)
        if len(ids) <= self.leaf_size:
            self.leaf_elems[idx] = ids
            return idx
        centers = 0.5 * (self.lo[ids] + self.hi[ids])
        axis = int(np.argmax(hi - lo))
        order = np.argsort(centers[:, axis], kind="stable")
        half = len(ids) // 2
        left = self._build(ids[order[:half]])
        right = self._build(ids[order[half:]])
        self.children[idx] = (left, right)
        return idx

    def query_candidates(self, p: np.ndarray) -> np.ndarray:
        """Element ids whose AABB contains point p."""
        stack = [0]
        out = []
        while stack:
            n = stack.pop()
            if np.any(p < self.nodes_lo[n]) or np.any(p > self.nodes_hi[n]):
                continue
            l, r = self.children[n]
            if l < 0:
                ids = self.leaf_elems[n]
                inside = np.all((p >= self.lo[ids]) & (p <= self.hi[ids]),
                                axis=1)
                out.append(ids[inside])
            else:
                stack.append(l)
                stack.append(r)
        return (np.concatenate(out) if out
                else np.array([], dtype=np.int64))

    def locate_points(self, pts: np.ndarray, tol: float = 1e-10) -> np.ndarray:
        """Containing element id per query point (−1 if outside the mesh);
        barycentric inside test (reference findElemsForPoints,
        Mesh_decl.hpp:121)."""
        out = np.full(len(pts), -1, dtype=np.int64)
        dim = pts.shape[1]
        for i, p in enumerate(pts):
            for e in self.query_candidates(p):
                verts = self.points[self.elements[e]]
                lam = _barycentric(verts[: dim + 1], p)
                if lam.min() >= -tol:
                    out[i] = e
                    break
        return out


def _barycentric(verts: np.ndarray, p: np.ndarray) -> np.ndarray:
    T = (verts[1:] - verts[0]).T
    try:
        xi = np.linalg.solve(T, p - verts[0])
    except np.linalg.LinAlgError:
        return np.array([-1.0])
    return np.concatenate([[1.0 - xi.sum()], xi])
