"""MEDIT/Inria `.mesh` format reader/writer.

The reference parses Vertices/Triangles/Tetrahedra/Edges blocks with flags
(core/Mesh/MeshFileReader.hpp:12-27, readEntity); the bundled meshes
(e.g. the reference square.mesh) use:

    MeshVersionFormatted 1
    Dimension 2|3
    Vertices\n N\n  x y z flag        (z present even in 2D)
    Edges\n N\n  v0 v1 flag           (1-based)
    Triangles\n N\n  v0 v1 v2 flag
    Tetrahedra\n N\n  v0 v1 v2 v3 flag
    End

In 2D: Triangles are volume elements, Edges are boundary surfaces.
In 3D: Tetrahedra are volume elements, Triangles are boundary surfaces,
Edges are flagged line entities.

`read_mesh` parses with the native host library (feddlib_tpu_torch/native)
and, as the JAX package does, hands a file whose native parse has no
dimension 2 or 3 (not MEDIT, unreadable, malformed) to the numpy parser,
`read_mesh_plain`, whose error is the caller's.
"""

from __future__ import annotations

import numpy as np

from feddlib_tpu_torch import native
from feddlib_tpu_torch.mesh.mesh import Mesh

_BLOCKS = ("Vertices", "Edges", "Triangles", "Quadrilaterals", "Tetrahedra", "Hexahedra")


def _tokenize(path: str):
    with open(path) as f:
        for line in f:
            line = line.split("#")[0]
            for tok in line.split():
                yield tok


def read_mesh(path: str, fe_type: str = "P1") -> Mesh:
    """Read a MEDIT file through the native parser; RuntimeError if the
    native library cannot be built."""
    r = native.read_medit(path)
    if r is not None and r["dim"] in (2, 3):
        return _mesh_from_native(r, fe_type)
    return read_mesh_plain(path, fe_type)


def read_mesh_plain(path: str, fe_type: str = "P1") -> Mesh:
    """The numpy parser ('#' starts a comment; Quadrilaterals and
    Hexahedra blocks are read and skipped)."""
    toks = _tokenize(path)
    dim = None
    blocks: dict[str, np.ndarray] = {}
    try:
        while True:
            tok = next(toks)
            if tok == "Dimension":
                dim = int(next(toks))
            elif tok == "MeshVersionFormatted":
                next(toks)
            elif tok in _BLOCKS:
                n = int(next(toks))
                if tok == "Vertices":
                    ncol = 4  # x y z flag (z kept even for 2D meshes)
                    data = np.fromiter(
                        (float(next(toks)) for _ in range(n * ncol)),
                        dtype=np.float64,
                        count=n * ncol,
                    ).reshape(n, ncol)
                    blocks[tok] = data
                else:
                    nvert = {"Edges": 2, "Triangles": 3, "Quadrilaterals": 4,
                             "Tetrahedra": 4, "Hexahedra": 8}[tok]
                    ncol = nvert + 1
                    data = np.fromiter(
                        (int(next(toks)) for _ in range(n * ncol)),
                        dtype=np.int64,
                        count=n * ncol,
                    ).reshape(n, ncol)
                    blocks[tok] = data
            elif tok == "End":
                break
    except StopIteration:
        pass

    if dim is None or "Vertices" not in blocks:
        raise ValueError(f"{path}: not a valid MEDIT .mesh file")

    verts = blocks["Vertices"]
    points = verts[:, :dim].copy()
    point_flags = verts[:, 3].astype(np.int32)

    if dim == 2:
        if "Triangles" not in blocks:
            raise ValueError(f"{path}: 2D mesh without Triangles")
        tri = blocks["Triangles"]
        elements = tri[:, :3] - 1
        element_flags = tri[:, 3].astype(np.int32)
        surfaces = surface_flags = None
        if "Edges" in blocks:
            e = blocks["Edges"]
            surfaces = e[:, :2] - 1
            surface_flags = e[:, 2].astype(np.int32)
        mesh = Mesh(dim, "P1", points, point_flags, elements, element_flags,
                    surfaces=surfaces, surface_flags=surface_flags)
    elif dim == 3:
        if "Tetrahedra" not in blocks:
            raise ValueError(f"{path}: 3D mesh without Tetrahedra")
        tet = blocks["Tetrahedra"]
        elements = tet[:, :4] - 1
        element_flags = tet[:, 4].astype(np.int32)
        surfaces = surface_flags = lines = line_flags = None
        if "Triangles" in blocks:
            t = blocks["Triangles"]
            surfaces = t[:, :3] - 1
            surface_flags = t[:, 3].astype(np.int32)
        if "Edges" in blocks:
            e = blocks["Edges"]
            lines = e[:, :2] - 1
            line_flags = e[:, 2].astype(np.int32)
        mesh = Mesh(dim, "P1", points, point_flags, elements, element_flags,
                    surfaces=surfaces, surface_flags=surface_flags,
                    lines=lines, line_flags=line_flags)
    else:
        raise ValueError(f"{path}: unsupported dimension {dim}")

    return _with_fe_type(mesh, fe_type)


def _mesh_from_native(r: dict, fe_type: str) -> Mesh:
    dim = r["dim"]
    points = r["vertices"][:, :dim].copy()
    pflags = r["vertex_flags"].copy()
    if dim == 2:
        if not len(r["triangles"]):
            raise ValueError("2D mesh without Triangles")
        mesh = Mesh(2, "P1", points, pflags, r["triangles"],
                    r["triangle_flags"],
                    surfaces=r["edges"] if len(r["edges"]) else None,
                    surface_flags=(r["edge_flags"] if len(r["edges"])
                                   else None))
    else:
        if not len(r["tetrahedra"]):
            raise ValueError("3D mesh without Tetrahedra")
        mesh = Mesh(3, "P1", points, pflags, r["tetrahedra"],
                    r["tetrahedra_flags"],
                    surfaces=r["triangles"] if len(r["triangles"]) else None,
                    surface_flags=(r["triangle_flags"]
                                   if len(r["triangles"]) else None),
                    lines=r["edges"] if len(r["edges"]) else None,
                    line_flags=r["edge_flags"] if len(r["edges"]) else None)
    return _with_fe_type(mesh, fe_type)


def _with_fe_type(mesh: Mesh, fe_type: str) -> Mesh:
    if fe_type == "P2":
        from feddlib_tpu_torch.mesh.p2 import build_p2_mesh

        mesh = build_p2_mesh(mesh)
    elif fe_type != "P1":
        raise ValueError(f"unsupported fe_type {fe_type!r} for mesh reading")
    return mesh


def write_mesh(mesh: Mesh, path: str) -> None:
    """Write the P1 (vertex) part of a mesh back to MEDIT format."""
    nv = mesh.vertices_per_element
    with open(path, "w") as f:
        f.write("MeshVersionFormatted 1\n\n")
        f.write(f"Dimension {mesh.dim}\n\n")
        f.write(f"Vertices\n{mesh.n_points}\n")
        for p, fl in zip(mesh.points, mesh.point_flags):
            coords = list(p) + [0.0] * (3 - mesh.dim)
            f.write(" ".join(f"{c:.9f}" for c in coords) + f" {fl}\n")
        vol_name = "Triangles" if mesh.dim == 2 else "Tetrahedra"
        f.write(f"\n{vol_name}\n{mesh.n_elements}\n")
        for e, fl in zip(mesh.elements[:, :nv], mesh.element_flags):
            f.write(" ".join(str(i + 1) for i in e) + f" {fl}\n")
        if mesh.surfaces is not None and len(mesh.surfaces):
            surf_name = "Edges" if mesh.dim == 2 else "Triangles"
            f.write(f"\n{surf_name}\n{len(mesh.surfaces)}\n")
            for s, fl in zip(mesh.surfaces, mesh.surface_flags):
                f.write(" ".join(str(i + 1) for i in s) + f" {fl}\n")
        f.write("\nEnd\n")
