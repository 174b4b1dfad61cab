"""P2 mesh from a P1 mesh via the global edge list.

Reference: MeshUnstructured::buildP2ofP1MeshEdge
(core/Mesh/MeshUnstructured_def.hpp:129) — P2 nodes are edge midpoints with
globally consistent ids from the unique edge list; surface entities are
upgraded to P2 as well.  Here the construction is serial/vectorised on the
host; partitioning happens afterwards, so the parallel edge-id negotiation of
the reference (EdgeElements.cpp:249) is unnecessary.

P2 local node ordering (matches the basis tables in feddlib_tpu_torch.fe.reference):
  2D triangle: [v0, v1, v2, m01, m12, m02]   (midpoint opposite ordering
    follows the reference's P2 basis: node 3 on edge (0,1), 4 on (1,2),
    5 on (0,2))
  3D tet: [v0..v3, m01, m12, m02, m03, m13, m23]
"""

from __future__ import annotations

import numpy as np

from feddlib_tpu_torch.mesh.mesh import Mesh

# local edge order used for P2 midpoints (vertex index pairs)
P2_EDGE_ORDER = {
    2: [(0, 1), (1, 2), (0, 2)],
    3: [(0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3)],
}
# surface entity P2 edges: 2D surface is an edge (1 midpoint); 3D surface is
# a triangle (3 midpoints ordered like the 2D element)
_SURF_EDGE_ORDER = {2: [(0, 1)], 3: [(0, 1), (1, 2), (0, 2)]}


def build_p2_mesh(p1: Mesh) -> Mesh:
    if p1.fe_type != "P1":
        raise ValueError("build_p2_mesh expects a P1 mesh")
    dim = p1.dim
    v = p1.elements[:, : p1.vertices_per_element]
    pair_list = P2_EDGE_ORDER[dim]
    ee = np.stack([np.sort(v[:, list(p)], axis=1) for p in pair_list], axis=1)
    flat = ee.reshape(-1, 2)
    edges, inv = np.unique(flat, axis=0, return_inverse=True)
    elem_edge = inv.reshape(ee.shape[:2])  # [n_elems, n_loc_edges]

    n_p1 = p1.n_points
    midpoints = 0.5 * (p1.points[edges[:, 0]] + p1.points[edges[:, 1]])
    points = np.concatenate([p1.points, midpoints], axis=0)

    # midpoint flag: boundary flag if the edge lies on a flagged surface,
    # else interior (0).  The reference assigns via P2 surface upgrade
    # (MeshUnstructured_decl.hpp:63-85); we match flags through surface edges.
    mid_flags = np.zeros(len(edges), dtype=np.int32)
    elements = np.concatenate([v, n_p1 + elem_edge], axis=1)

    surfaces = p1.surfaces
    sflags = p1.surface_flags
    new_surfaces = None
    if surfaces is not None and len(surfaces):
        sp = _SURF_EDGE_ORDER[dim]
        sv = surfaces
        se = np.stack([np.sort(sv[:, list(p)], axis=1) for p in sp], axis=1)
        se_flat = se.reshape(-1, 2)
        # locate surface edges in the global edge list
        key = edges[:, 0] * (n_p1 + 1) + edges[:, 1]
        skey = se_flat[:, 0] * (n_p1 + 1) + se_flat[:, 1]
        pos = np.searchsorted(key, skey)
        pos = np.clip(pos, 0, len(key) - 1)
        ok = key[pos] == skey
        if not np.all(ok):
            raise RuntimeError("surface edge not found in element edge list")
        surf_edge = pos.reshape(se.shape[:2])
        new_surfaces = np.concatenate([sv, n_p1 + surf_edge], axis=1)
        # propagate surface flags to midpoints (min over incident surfaces,
        # mirroring the reference's preference for the smaller=stronger flag)
        sentinel = np.iinfo(np.int32).max
        tmp = np.full(len(edges), sentinel, dtype=np.int32)
        np.minimum.at(tmp, surf_edge.ravel(),
                      np.repeat(sflags, surf_edge.shape[1]).astype(np.int32))
        mid_flags = np.where(tmp == sentinel, 0, tmp).astype(np.int32)

    point_flags = np.concatenate([p1.point_flags, mid_flags])
    return Mesh(
        dim,
        "P2",
        points,
        point_flags,
        elements,
        p1.element_flags.copy(),
        surfaces=new_surfaces,
        surface_flags=None if sflags is None else sflags.copy(),
        lines=p1.lines,
        line_flags=p1.line_flags,
        p2_edges=edges,
    )
