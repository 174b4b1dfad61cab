"""Serial (global) mesh container.

The reference's Mesh hierarchy (core/Mesh/Mesh_decl.hpp:24) mixes the global
mesh, its partitioned per-rank view, and the maps.  TPU-natively we separate:

- `Mesh` (this file): the *global* simplicial mesh as flat numpy arrays —
  points, elements, flags, surface sub-entities.  Host-side, setup-phase.
- `feddlib_tpu_torch.mesh.partition.MeshPartition`: per-device element/node
  ownership + repeated/unique index maps + halo plans.
- `feddlib_tpu_torch.fe.domain.Domain`: mesh + FE space + dof maps (user handle).

Element node ordering follows the MEDIT/reference convention (1-based in the
file, 0-based here).  Surface entities (edges in 2D, triangles in 3D) carry
boundary flags used by BCBuilder; the reference attaches them to volume
elements as recursive sub-elements (core/FE/FiniteElement.hpp:33-60) — we
keep them as flat arrays plus a precomputed surface→element link.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# number of vertices of the geometric simplex per dimension
VERTS_PER_ELEM = {1: 2, 2: 3, 3: 4}
# nodes per element per (dim, fe type); Q types are quads/hexes
# (MeshStructured_decl.hpp:71-101 Q1/Q2/Q2-20 variants)
NODES_PER_ELEM = {
    (2, "P1"): 3,
    (2, "P2"): 6,
    (3, "P1"): 4,
    (3, "P2"): 10,
    (2, "Q1"): 4,
    (2, "Q2"): 9,
    (3, "Q1"): 8,
    (3, "Q2"): 27,
    (3, "Q2-20"): 20,
}


@dataclass
class Mesh:
    """Global mesh: flat arrays, host-resident (numpy)."""

    dim: int
    fe_type: str  # "P1" | "P2"
    points: np.ndarray  # [n_points, dim] float64
    point_flags: np.ndarray  # [n_points] int32 boundary/volume flags
    elements: np.ndarray  # [n_elems, nodes_per_elem] int64 node ids
    element_flags: np.ndarray  # [n_elems] int32
    # boundary sub-entities: edges (dim=2) or triangles (dim=3), vertex ids
    surfaces: Optional[np.ndarray] = None  # [n_surf, dim] int64
    surface_flags: Optional[np.ndarray] = None  # [n_surf] int32
    # 3D only: flagged 1D line entities (Edges block of the .mesh file)
    lines: Optional[np.ndarray] = None  # [n_lines, 2]
    line_flags: Optional[np.ndarray] = None
    # P2 bookkeeping: edge (vertex pair) that generated each P2 midpoint node
    p2_edges: Optional[np.ndarray] = None  # [n_p2_nodes, 2] int64
    # reference configuration for ALE mesh motion (Mesh_decl.hpp:116 moveMesh)
    ref_points: Optional[np.ndarray] = field(default=None, repr=False)

    def __post_init__(self):
        self.points = np.asarray(self.points, dtype=np.float64)
        self.point_flags = np.asarray(self.point_flags, dtype=np.int32)
        self.elements = np.asarray(self.elements, dtype=np.int64)
        self.element_flags = np.asarray(self.element_flags, dtype=np.int32)

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    @property
    def n_elements(self) -> int:
        return self.elements.shape[0]

    @property
    def nodes_per_element(self) -> int:
        return NODES_PER_ELEM[(self.dim, self.fe_type)]

    @property
    def vertices_per_element(self) -> int:
        if self.fe_type.startswith("Q"):
            return 2 ** self.dim  # quad/hex corners (geometry is Q1)
        return VERTS_PER_ELEM[self.dim]

    # -- ALE mesh motion (reference: Mesh::moveMesh, Mesh_decl.hpp:116) -----
    def save_reference_configuration(self) -> None:
        self.ref_points = self.points.copy()

    def move(self, displacement: np.ndarray) -> None:
        """points = reference points + displacement ([n_points, dim])."""
        if self.ref_points is None:
            self.save_reference_configuration()
        self.points = self.ref_points + np.asarray(displacement).reshape(
            self.n_points, self.dim
        )

    # -- derived topology ---------------------------------------------------
    def element_edges(self) -> np.ndarray:
        """All (sorted) vertex-pair edges per element, shape [n_elems, n_loc_edges, 2].

        Local edge order matches the P2 midpoint convention (see
        feddlib_tpu_torch.mesh.p2): 2D tri (0,1),(0,2),(1,2); 3D tet
        (0,1),(0,2),(0,3),(1,2),(1,3),(2,3).
        """
        v = self.elements[:, : self.vertices_per_element]
        # MUST match feddlib_tpu_torch.mesh.p2.P2_EDGE_ORDER — P2 midpoints and
        # refinement both index edges by this local order
        if self.dim == 2:
            pairs = [(0, 1), (1, 2), (0, 2)]
        else:
            pairs = [(0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3)]
        e = np.stack([v[:, list(p)] for p in pairs], axis=1)
        return np.sort(e, axis=2)

    def unique_edges(self) -> tuple[np.ndarray, np.ndarray]:
        """Global unique edge list + per-element edge ids.

        Returns (edges [n_edges, 2] sorted-unique, elem_edge_ids
        [n_elems, n_loc_edges]).  Reference: EdgeElements global edge lists
        (core/FE/EdgeElements.cpp:249 sortUniqueAndSetGlobalIDsParallel),
        built here serially with lexsort-unique.
        """
        ee = self.element_edges()
        flat = ee.reshape(-1, 2)
        edges, inv = np.unique(flat, axis=0, return_inverse=True)
        return edges, inv.reshape(ee.shape[:2])

    def surface_to_element_map(self) -> np.ndarray:
        """For each surface entity, the id of a volume element containing all
        its vertices (reference: MeshPartitioner::setSurfacesToElements,
        MeshPartitioner_def.hpp:582).  Vectorised via sorted-key matching on
        facet keys."""
        if self.surfaces is None or len(self.surfaces) == 0:
            return np.zeros(0, dtype=np.int64)
        v = self.elements[:, : self.vertices_per_element]
        nv = self.vertices_per_element
        # all facets of all elements
        if self.dim == 2:
            facets_loc = [(0, 1), (0, 2), (1, 2)]
        else:
            facets_loc = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]
        fac = np.stack([np.sort(v[:, list(f)], axis=1) for f in facets_loc], axis=1)
        fac_flat = fac.reshape(-1, self.dim)
        owner = np.repeat(np.arange(self.n_elements, dtype=np.int64), len(facets_loc))
        key = np.zeros(len(fac_flat), dtype=np.int64)
        skey = np.zeros(len(self.surfaces), dtype=np.int64)
        s_sorted = np.sort(self.surfaces, axis=1)
        for d in range(self.dim):
            key = key * self.n_points + fac_flat[:, d]
            skey = skey * self.n_points + s_sorted[:, d]
        order = np.argsort(key, kind="stable")
        pos = np.searchsorted(key[order], skey)
        pos = np.clip(pos, 0, len(order) - 1)
        found = key[order][pos] == skey
        out = np.full(len(self.surfaces), -1, dtype=np.int64)
        out[found] = owner[order][pos[found]]
        return out

    def dual_graph(self) -> tuple[np.ndarray, np.ndarray]:
        """Element dual graph (elements adjacent iff sharing >= dim vertices,
        i.e. a facet — METIS_PartMeshDual ncommon semantics for simplices,
        MeshPartitioner_def.hpp:258-324).  Returns CSR (indptr, indices)."""
        v = self.elements[:, : self.vertices_per_element]
        if self.dim == 2:
            facets_loc = [(0, 1), (0, 2), (1, 2)]
        else:
            facets_loc = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]
        fac = np.stack([np.sort(v[:, list(f)], axis=1) for f in facets_loc], axis=1)
        fac_flat = fac.reshape(-1, self.dim)
        owner = np.repeat(np.arange(self.n_elements, dtype=np.int64), len(facets_loc))
        key = np.zeros(len(fac_flat), dtype=np.int64)
        for d in range(self.dim):
            key = key * (self.n_points + 1) + fac_flat[:, d]
        order = np.argsort(key, kind="stable")
        ks, os_ = key[order], owner[order]
        # interior facets appear exactly twice
        same = ks[:-1] == ks[1:]
        a, b = os_[:-1][same], os_[1:][same]
        src = np.concatenate([a, b])
        dst = np.concatenate([b, a])
        order2 = np.lexsort((dst, src))
        src, dst = src[order2], dst[order2]
        indptr = np.zeros(self.n_elements + 1, dtype=np.int64)
        np.add.at(indptr, src + 1, 1)
        np.cumsum(indptr, out=indptr)
        return indptr, dst


def reorder_mesh_rcm(mesh: Mesh) -> tuple["Mesh", np.ndarray]:
    """Bandwidth-reducing node renumbering: reverse Cuthill–McKee on the
    node-adjacency graph.  Returns (new_mesh, perm) with
    new.points[i] = points[perm[i]].

    The reference inherits whatever numbering the .mesh file ships
    (MeshFileReader keeps file order); the TPU SpMV formats want a banded
    node pattern — DIA/block-DIA coverage and SELL/block-SELL window
    locality (spill) are both functions of the numbering.  Renumbering at
    the MESH level makes every operator assembled downstream banded at
    ZERO per-apply cost (a per-apply permutation gather would cost more
    than the SpMV itself on TPU).  Deterministic (scipy RCM on a
    deterministic adjacency)."""
    import scipy.sparse as sps
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    el = mesh.elements
    nv = el.shape[1]
    rows = np.repeat(el, nv, axis=1).ravel()
    cols = np.tile(el, (1, nv)).ravel()
    adj = sps.csr_matrix(
        (np.ones(len(rows), np.int8), (rows, cols)),
        shape=(mesh.n_points, mesh.n_points))
    perm = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True))
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(len(perm))

    def remap(a):
        return None if a is None else iperm[a]

    new = Mesh(
        dim=mesh.dim, fe_type=mesh.fe_type,
        points=mesh.points[perm].copy(),
        point_flags=mesh.point_flags[perm].copy(),
        elements=iperm[mesh.elements],
        element_flags=mesh.element_flags.copy(),
        surfaces=remap(mesh.surfaces),
        surface_flags=None if mesh.surface_flags is None
        else mesh.surface_flags.copy(),
        lines=remap(mesh.lines),
        line_flags=None if mesh.line_flags is None
        else mesh.line_flags.copy(),
        p2_edges=remap(mesh.p2_edges),
        ref_points=None if mesh.ref_points is None
        else mesh.ref_points[perm].copy(),
    )
    return new, perm
