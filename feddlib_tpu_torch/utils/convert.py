"""Carry the JAX package's assembled state into the port.

The system has no weights; what crosses between the two packages is the
assembled state — a CSR matrix, a mesh, a partition — given as numpy
arrays, so both packages can build every operator from the same matrix and
the same clusters.  Copy a jax array with `np.array(a, copy=True)` first:
`np.asarray` of a jax array is read-only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from feddlib_tpu_torch.la.csr import CsrMatrix, SparsityPattern
from feddlib_tpu_torch.mesh.mesh import Mesh
from feddlib_tpu_torch.mesh.partition import MeshPartition


def csr_from_numpy(indptr, indices, data, shape, device="cuda",
                   dtype=torch.float64) -> CsrMatrix:
    """CsrMatrix from CSR arrays (indices sorted within each row)."""
    pat = SparsityPattern.from_csr(np.asarray(indptr), np.asarray(indices),
                                   int(shape[1]))
    if pat.n_rows != int(shape[0]):
        raise ValueError(f"indptr gives {pat.n_rows} rows, shape {shape}")
    return CsrMatrix(pat, torch.as_tensor(np.array(data, copy=True)),
                     dtype=dtype, device=device)


def mesh_from_numpy(points, elements, point_flags, element_flags=None,
                    fe_type: str = "P1", surfaces=None, surface_flags=None,
                    lines=None, line_flags=None,
                    p2_edges: Optional[np.ndarray] = None) -> Mesh:
    """Mesh from its arrays (dim from the points' width)."""
    points = np.array(points, dtype=np.float64, copy=True)
    elements = np.array(elements, dtype=np.int64, copy=True)
    if element_flags is None:
        element_flags = np.zeros(len(elements), np.int32)
    return Mesh(points.shape[1], fe_type, points,
                np.array(point_flags, dtype=np.int32, copy=True), elements,
                np.array(element_flags, dtype=np.int32, copy=True),
                surfaces=None if surfaces is None else np.array(surfaces),
                surface_flags=(None if surface_flags is None
                               else np.array(surface_flags)),
                lines=None if lines is None else np.array(lines),
                line_flags=None if line_flags is None else np.array(line_flags),
                p2_edges=None if p2_edges is None else np.array(p2_edges))
    return mesh


def partition_from_numpy(mesh: Mesh, elem_part,
                         n_parts: Optional[int] = None) -> MeshPartition:
    """MeshPartition (element lists, repeated and unique node maps) from a
    given element → part assignment."""
    elem_part = np.array(elem_part, dtype=np.int32, copy=True)
    n = int(n_parts if n_parts is not None else elem_part.max() + 1)
    return MeshPartition(mesh, n, elem_part=elem_part)
