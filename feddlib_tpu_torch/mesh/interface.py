"""FSI fluid–solid interface matching — a host copy of
feddlib_tpu/mesh/interface.py (numpy only, no device work).

Host-side: given two meshes and the set of interface flags, match boundary
nodes with equal flags by coordinates (vectorised lexsort matching with a
tolerance), and compute each mesh node's distance to the interface (used to
scale the harmonic mesh-motion extension, Geometry problem)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from feddlib_tpu_torch.mesh.mesh import Mesh


@dataclass
class MeshInterface:
    """Matched interface between two meshes.

    nodes_a / nodes_b: [n_iface] node ids into mesh A / B such that
    points_a[nodes_a[i]] == points_b[nodes_b[i]] (within tol)."""

    nodes_a: np.ndarray
    nodes_b: np.ndarray
    flags: np.ndarray  # interface flag per matched node

    @property
    def n_nodes(self) -> int:
        return len(self.nodes_a)


def determine_interface(mesh_a: Mesh, mesh_b: Mesh,
                        flags: Sequence[int], tol: float = 1e-9
                        ) -> MeshInterface:
    """Match nodes of both meshes carrying the given flags by coordinates."""
    na_l, nb_l, fl_l = [], [], []
    for flag in flags:
        ia = np.nonzero(mesh_a.point_flags == flag)[0]
        ib = np.nonzero(mesh_b.point_flags == flag)[0]
        if len(ia) == 0 and len(ib) == 0:
            continue
        pa = mesh_a.points[ia]
        pb = mesh_b.points[ib]
        # quantized lexicographic matching
        qa = np.round(pa / tol).astype(np.int64)
        qb = np.round(pb / tol).astype(np.int64)
        key_a = _pack(qa)
        key_b = _pack(qb)
        order_b = np.argsort(key_b, kind="stable")
        pos = np.searchsorted(key_b[order_b], key_a)
        pos = np.clip(pos, 0, len(ib) - 1 if len(ib) else 0)
        ok = len(ib) > 0 and key_b[order_b][pos] == key_a
        ok = np.asarray(ok, dtype=bool)
        if not ok.all():
            missing = int((~ok).sum())
            raise ValueError(
                f"interface flag {flag}: {missing} nodes of mesh A have no "
                f"coordinate match in mesh B (tol={tol})")
        na_l.append(ia)
        nb_l.append(ib[order_b][pos])
        fl_l.append(np.full(len(ia), flag, dtype=np.int32))
    if not na_l:
        raise ValueError("no interface nodes found for the given flags")
    return MeshInterface(np.concatenate(na_l), np.concatenate(nb_l),
                        np.concatenate(fl_l))


def _pack(q: np.ndarray) -> np.ndarray:
    key = np.zeros(len(q), dtype=np.int64)
    for d in range(q.shape[1]):
        key = key * 73856093 + q[:, d]  # hashed lexicographic key
    return key


def distances_to_interface(mesh: Mesh, interface_points: np.ndarray
                           ) -> np.ndarray:
    """Euclidean distance of every mesh node to the closest interface node
    (reference: calculateDistancesToInterfaceParallel,
    MeshInterface_def.hpp:445); brute-force blocked — interface sets are
    small."""
    pts = mesh.points
    out = np.full(len(pts), np.inf)
    block = 4096
    for s in range(0, len(pts), block):
        d = np.linalg.norm(pts[s:s + block, None, :]
                           - interface_points[None, :, :], axis=2)
        out[s:s + block] = d.min(axis=1)
    return out
