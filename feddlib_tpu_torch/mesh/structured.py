"""In-memory structured mesh generation (reference: MeshStructured,
core/Mesh/MeshStructured_def.hpp:283 buildMesh2D, :622 buildMesh3D).

The reference generates per-rank subcubes directly; TPU-natively we generate
the global mesh on the host (cheap, setup-phase) and let the partitioner
shard it — identical results, simpler code, and the partition is then uniform
with the unstructured path.

2D: unit-square-like rectangle [x0,x1]×[y0,y1], n×m cells, each split into 2
triangles.  3D: box split into 6 tets per hex (Kuhn triangulation — matches
the reference's structured tet splitting in spirit; node ordering is
positively oriented).  Boundary nodes get flag 1, interior flag 0; boundary
facets are emitted as surface entities with flag 1 (the reference assigns
finer-grained flags per face via setStructuredMeshFlags — callers needing
per-face flags can re-flag with `flag_boxed_boundary`).
"""

from __future__ import annotations

import numpy as np

from feddlib_tpu_torch.mesh.mesh import Mesh


def build_structured_mesh(
    dim: int,
    n_cells,
    lower=None,
    upper=None,
    fe_type: str = "P1",
) -> Mesh:
    if isinstance(n_cells, int):
        n_cells = (n_cells,) * dim
    lower = np.array(lower if lower is not None else [0.0] * dim, dtype=np.float64)
    upper = np.array(upper if upper is not None else [1.0] * dim, dtype=np.float64)
    if dim == 2:
        mesh = _rect_2d(n_cells, lower, upper)
    elif dim == 3:
        mesh = _box_3d(n_cells, lower, upper)
    else:
        raise ValueError(f"dim {dim} unsupported")
    if fe_type == "P2":
        from feddlib_tpu_torch.mesh.p2 import build_p2_mesh

        mesh = build_p2_mesh(mesh)
    return mesh


def _rect_2d(n_cells, lower, upper) -> Mesh:
    nx, ny = n_cells
    xs = np.linspace(lower[0], upper[0], nx + 1)
    ys = np.linspace(lower[1], upper[1], ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel()], axis=1)

    def nid(i, j):
        return i * (ny + 1) + j

    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    i, j = i.ravel(), j.ravel()
    p00, p10 = nid(i, j), nid(i + 1, j)
    p01, p11 = nid(i, j + 1), nid(i + 1, j + 1)
    # split each quad along the (p00,p11) diagonal
    t1 = np.stack([p00, p10, p11], axis=1)
    t2 = np.stack([p00, p11, p01], axis=1)
    elements = np.concatenate([t1, t2], axis=0)

    flags = np.zeros(len(points), dtype=np.int32)
    on_b = (
        (np.isclose(points[:, 0], lower[0]))
        | (np.isclose(points[:, 0], upper[0]))
        | (np.isclose(points[:, 1], lower[1]))
        | (np.isclose(points[:, 1], upper[1]))
    )
    flags[on_b] = 1

    surfaces, sflags = _boundary_edges_2d(nx, ny, nid)
    return Mesh(2, "P1", points, flags, elements,
                np.zeros(len(elements), dtype=np.int32),
                surfaces=surfaces, surface_flags=sflags)


def _boundary_edges_2d(nx, ny, nid):
    edges = []
    for i in range(nx):  # bottom/top
        edges.append((nid(i, 0), nid(i + 1, 0)))
        edges.append((nid(i, ny), nid(i + 1, ny)))
    for j in range(ny):  # left/right
        edges.append((nid(0, j), nid(0, j + 1)))
        edges.append((nid(nx, j), nid(nx, j + 1)))
    e = np.array(edges, dtype=np.int64)
    return e, np.ones(len(e), dtype=np.int32)


# Kuhn triangulation of the unit cube into 6 tets; all share diagonal 0-7.
_KUHN_TETS = np.array([
    [0, 1, 3, 7],
    [0, 1, 5, 7],
    [0, 2, 3, 7],
    [0, 2, 6, 7],
    [0, 4, 5, 7],
    [0, 4, 6, 7],
])


def _box_3d(n_cells, lower, upper) -> Mesh:
    nx, ny, nz = n_cells
    xs = np.linspace(lower[0], upper[0], nx + 1)
    ys = np.linspace(lower[1], upper[1], ny + 1)
    zs = np.linspace(lower[2], upper[2], nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    points = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    corners = np.stack(
        [nid(i + (c & 1), j + ((c >> 1) & 1), k + ((c >> 2) & 1)) for c in range(8)],
        axis=1,
    )  # [n_hex, 8]
    elements = corners[:, _KUHN_TETS].reshape(-1, 4)
    # enforce positive orientation (swap last two nodes where det < 0)
    p = points[elements]
    d = np.linalg.det(p[:, 1:] - p[:, :1])
    neg = d < 0
    elements[neg, 2], elements[neg, 3] = (
        elements[neg, 3].copy(),
        elements[neg, 2].copy(),
    )

    flags = np.zeros(len(points), dtype=np.int32)
    on_b = np.zeros(len(points), dtype=bool)
    for d_ in range(3):
        on_b |= np.isclose(points[:, d_], lower[d_]) | np.isclose(points[:, d_], upper[d_])
    flags[on_b] = 1

    mesh = Mesh(3, "P1", points, flags, elements,
                np.zeros(len(elements), dtype=np.int32))
    mesh.surfaces, mesh.surface_flags = _boundary_tris_3d(mesh)
    return mesh


def _boundary_tris_3d(mesh: Mesh):
    """Extract boundary facets (those appearing in exactly one tet)."""
    v = mesh.elements[:, :4]
    facets_loc = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]
    fac = np.concatenate([np.sort(v[:, list(f)], axis=1) for f in facets_loc], axis=0)
    uniq, inv, counts = np.unique(fac, axis=0, return_inverse=True, return_counts=True)
    boundary = uniq[counts == 1]
    return boundary.astype(np.int64), np.ones(len(boundary), dtype=np.int32)


def build_backward_facing_step(dim: int, h: float = 0.05,
                               fe_type: str = "P1") -> Mesh:
    """Backward-facing-step channel (reference: MeshStructured
    buildMesh2DBFS/3DBFS, MeshStructured_def.hpp:1874/:2332).  Geometry:
    inflow duct [0,1]×[0.5,1] followed by the expanded channel [1,4]×[0,1]
    (×[0,1] in 3D).  Flags: 2 inflow (x=0), 3 outflow (x=4), 1 walls."""
    n = max(int(round(0.5 / h)), 1)

    def cells(length):
        return max(int(round(length / (0.5 / n))), 1)

    if dim == 2:
        duct = build_structured_mesh(2, (cells(1.0), n), lower=[0, 0.5],
                                     upper=[1, 1])
        chan = build_structured_mesh(2, (cells(3.0), 2 * n), lower=[1, 0],
                                     upper=[4, 1])
    else:
        duct = build_structured_mesh(3, (cells(1.0), n, 2 * n),
                                     lower=[0, 0.5, 0], upper=[1, 1, 1])
        chan = build_structured_mesh(3, (cells(3.0), 2 * n, 2 * n),
                                     lower=[1, 0, 0], upper=[4, 1, 1])
    mesh = merge_meshes(duct, chan)
    # re-flag: everything boundary = 1, then inflow/outflow faces
    mesh.point_flags[mesh.point_flags > 0] = 1
    mesh.point_flags[np.isclose(mesh.points[:, 0], 0.0)] = 2
    mesh.point_flags[np.isclose(mesh.points[:, 0], 4.0)] = 3
    if mesh.surfaces is not None:
        sf = mesh.points[mesh.surfaces][:, :, 0]
        mesh.surface_flags[:] = 1
        mesh.surface_flags[np.all(np.isclose(sf, 0.0), axis=1)] = 2
        mesh.surface_flags[np.all(np.isclose(sf, 4.0), axis=1)] = 3
    if fe_type == "P2":
        from feddlib_tpu_torch.mesh.p2 import build_p2_mesh

        mesh = build_p2_mesh(mesh)
    return mesh


def merge_meshes(a: Mesh, b: Mesh, tol: float = 1e-9) -> Mesh:
    """Glue two conforming meshes: coincident points (within tol) are
    identified; boundary facets that become interior are dropped."""
    if a.dim != b.dim:
        raise ValueError("dimension mismatch")
    qa = np.round(a.points / tol).astype(np.int64)
    qb = np.round(b.points / tol).astype(np.int64)
    key_a = _hash_rows(qa)
    key_b = _hash_rows(qb)
    order = np.argsort(key_a, kind="stable")
    pos = np.searchsorted(key_a[order], key_b)
    pos = np.clip(pos, 0, len(order) - 1)
    match = key_a[order][pos] == key_b
    b_to_merged = np.empty(b.n_points, dtype=np.int64)
    b_to_merged[match] = order[pos[match]]
    new_ids = a.n_points + np.arange((~match).sum())
    b_to_merged[~match] = new_ids
    points = np.concatenate([a.points, b.points[~match]])
    flags = np.concatenate([a.point_flags, b.point_flags[~match]])
    # matched points: keep the max flag (interface points become interior 0
    # only if both sides say 0 — caller re-flags anyway)
    elements = np.concatenate([a.elements, b_to_merged[b.elements]])
    eflags = np.concatenate([a.element_flags, b.element_flags])
    mesh = Mesh(a.dim, "P1", points, flags, elements, eflags)
    # regenerate the boundary from facet counts
    if a.dim == 2:
        edges, elem_edge = mesh.unique_edges()
        cnt = np.zeros(len(edges), dtype=int)
        np.add.at(cnt, elem_edge.ravel(), 1)
        mesh.surfaces = edges[cnt == 1]
        mesh.surface_flags = np.ones(len(mesh.surfaces), dtype=np.int32)
    else:
        from feddlib_tpu_torch.mesh.structured import _boundary_tris_3d

        mesh.surfaces, mesh.surface_flags = _boundary_tris_3d(mesh)
    # interior points that were boundary in the halves: reset flags by
    # membership in boundary facets
    on_b = np.zeros(mesh.n_points, dtype=bool)
    if mesh.surfaces is not None and len(mesh.surfaces):
        on_b[np.unique(mesh.surfaces)] = True
    mesh.point_flags = np.where(on_b, np.maximum(mesh.point_flags, 1),
                                0).astype(np.int32)
    return mesh


def _hash_rows(q: np.ndarray) -> np.ndarray:
    key = np.zeros(len(q), dtype=np.int64)
    for d in range(q.shape[1]):
        key = key * 1000003 + q[:, d]
    return key


def flag_boxed_boundary(mesh: Mesh, lower, upper, face_flags: dict) -> None:
    """Re-assign per-face boundary flags for a box mesh.

    face_flags maps e.g. "x0"/"x1"/"y0"/"y1"/"z0"/"z1" → int flag, applied in
    dict order (later entries win on edges/corners).  Mirrors the role of the
    reference's setStructuredMeshFlags (MeshStructured_def.hpp:2974).
    """
    names = ["x", "y", "z"][: mesh.dim]
    for key, flag in face_flags.items():
        axis = names.index(key[0])
        val = lower[axis] if key[1] == "0" else upper[axis]
        sel = np.isclose(mesh.points[:, axis], val)
        mesh.point_flags[sel] = flag
        if mesh.surfaces is not None and len(mesh.surfaces):
            s_on = np.all(np.isclose(mesh.points[mesh.surfaces][:, :, axis], val), axis=1)
            mesh.surface_flags[s_on] = flag
