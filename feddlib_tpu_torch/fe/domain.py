"""Domain — user-facing handle tying mesh + FE space.

Counterpart of feddlib_tpu/fe/domain.py for P1/P2 simplex and Q1/Q2/Q2-20
quad/hex meshes.  The mesh stays on the host as numpy arrays; the element
vertex coordinates used by assembly are built once on the domain's device,
element-first for the chunked kernels and element-last for the fast ones
(fe/fast_assembly.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from feddlib_tpu_torch.mesh.io import read_mesh
from feddlib_tpu_torch.mesh.mesh import Mesh
from feddlib_tpu_torch.mesh.p2 import build_p2_mesh
from feddlib_tpu_torch.mesh.structured import build_structured_mesh
from feddlib_tpu_torch.utils import timers
from feddlib_tpu_torch.utils.device import resolve_device


def _check_fe_type(fe_type: str) -> None:
    if fe_type not in ("P1", "P2"):
        raise ValueError(f"unsupported fe_type {fe_type!r} (P1 or P2)")


class Domain:
    def __init__(self, mesh: Mesh, parent_p1: Optional["Domain"] = None,
                 device="cuda"):
        self.mesh = mesh
        self.parent_p1 = parent_p1
        self.device = resolve_device(device)
        self._vert_coords = None
        self._vert_coords_T = None
        self._patterns = {}  # cache: op-key → SparsityPattern
        self._device_dofs = {}  # cache: (dofs per node, device) → ids

    # -- constructors --------------------------------------------------------
    @classmethod
    def structured(cls, dim: int, n_cells, fe_type: str = "P1",
                   device="cuda", **kw) -> "Domain":
        _check_fe_type(fe_type)
        p1 = cls(build_structured_mesh(dim, n_cells, fe_type="P1", **kw),
                 device=device)
        return p1 if fe_type == "P1" else p1.p2_domain()

    @classmethod
    def structured_hex(cls, dim: int, n_cells, fe_type: str = "Q1",
                       device="cuda", **kw) -> "Domain":
        """Structured quad/hex domain (Q1 | Q2 | Q2-20)."""
        from feddlib_tpu_torch.fe.hex import build_hex_mesh

        if fe_type not in ("Q1", "Q2", "Q2-20"):
            raise ValueError(f"unsupported hex fe_type {fe_type!r}")
        return cls(build_hex_mesh(dim, n_cells, fe_type=fe_type, **kw),
                   device=device)

    @classmethod
    def from_file(cls, path: str, fe_type: str = "P1",
                  device="cuda") -> "Domain":
        """Domain from a MEDIT .mesh file."""
        _check_fe_type(fe_type)
        p1 = cls(read_mesh(path, fe_type="P1"), device=device)
        return p1 if fe_type == "P1" else p1.p2_domain()

    def p2_domain(self) -> "Domain":
        """P2 domain from this P1 domain (same device)."""
        if self.fe_type != "P1":
            raise ValueError("p2_domain() requires a P1 domain")
        return Domain(build_p2_mesh(self.mesh), parent_p1=self,
                      device=self.device)

    # -- properties ---------------------------------------------------------
    @property
    def dim(self) -> int:
        return self.mesh.dim

    @property
    def fe_type(self) -> str:
        return self.mesh.fe_type

    @property
    def n_nodes(self) -> int:
        return self.mesh.n_points

    @property
    def n_elements(self) -> int:
        return self.mesh.n_elements

    def n_dofs(self, dofs_per_node: int = 1) -> int:
        return self.n_nodes * dofs_per_node

    @property
    def is_hex(self) -> bool:
        return self.fe_type.startswith("Q")

    def n_basis(self) -> int:
        if self.is_hex:
            from feddlib_tpu_torch.fe.hex import hex_n_basis

            return hex_n_basis(self.fe_type, self.dim)
        from feddlib_tpu_torch.fe import reference as ref

        return ref.n_basis(self.dim, self.fe_type)

    # -- assembly inputs ----------------------------------------------------
    def vert_coords(self) -> torch.Tensor:
        """[E, dim+1, dim] f64 vertex coordinates of each element (geometry
        is affine-P1 even for P2 spaces), gathered on the device from the
        uploaded points and connectivity."""
        if self._vert_coords is None:
            nv = self.mesh.vertices_per_element
            pts = torch.as_tensor(self.mesh.points, dtype=torch.float64,
                                  device=self.device)
            conn = torch.as_tensor(
                self.mesh.elements[:, :nv].astype(np.int64),
                device=self.device)
            self._vert_coords = pts[conn]
        return self._vert_coords

    def vert_coords_T(self) -> torch.Tensor:
        """[nv*dim, E] f64 element-last vertex coordinates: row v*dim + i is
        coordinate i of local vertex v across all elements — the layout the
        element-last kernels of fe/fast_assembly.py read."""
        if self._vert_coords_T is None:
            nv = self.mesh.vertices_per_element
            ptsT = torch.as_tensor(np.ascontiguousarray(self.mesh.points.T),
                                   dtype=torch.float64, device=self.device)
            connT = torch.as_tensor(np.ascontiguousarray(
                self.mesh.elements[:, :nv].T.astype(np.int64)),
                device=self.device)                  # [nv, E]
            vcT = ptsT[:, connT]                     # [dim, nv, E]
            self._vert_coords_T = vcT.transpose(0, 1).reshape(
                nv * self.dim, -1).contiguous()      # [nv*dim, E]
        return self._vert_coords_T

    def invalidate_geometry(self) -> None:
        """Call after mesh motion (ALE): drops the coordinate caches, both
        layouts, so the next assembly gathers the moved points.  The
        symbolic patterns depend on the connectivity alone and stay."""
        self._vert_coords = None
        self._vert_coords_T = None

    def elem_nodes(self) -> np.ndarray:
        return self.mesh.elements

    def elem_dofs(self, dofs_per_node: int = 1) -> np.ndarray:
        from feddlib_tpu_torch.fe.assembly import vector_dof_ids

        if dofs_per_node == 1:
            return self.mesh.elements
        return vector_dof_ids(self.mesh.elements, dofs_per_node)

    def device_dofs(self, dofs_per_node: int = 1, device=None
                    ) -> torch.Tensor:
        """`elem_dofs(dofs_per_node)` as an int64 [E, nloc] tensor on
        `device` (the domain's by default), built and uploaded once per
        device: the gather index of nodal values (1) and the NodeWise dof
        ids of vector assembly (dim)."""
        from feddlib_tpu_torch.la.csr import _device_key

        key = (dofs_per_node, _device_key(device or self.device))
        ids = self._device_dofs.get(key)
        if ids is None:
            ids = torch.as_tensor(
                self.elem_dofs(dofs_per_node).astype(np.int64),
                device=key[1])
            self._device_dofs[key] = ids
        return ids

    # -- pattern cache ------------------------------------------------------
    def pattern(self, key, build):
        """The sparsity pattern cached under `key`; a miss calls `build()`
        (the symbolic phase of an assembly: its COO and the native
        `SparsityPattern.from_coo`) inside the synchronised span
        `fe.pattern` (utils/timers.py)."""
        pat = self._patterns.get(key)
        if pat is None:
            with timers.timer("fe.pattern", sync=True):
                pat = build()
            self._patterns[key] = pat
        return pat

    def __repr__(self):
        return (f"Domain(dim={self.dim}, {self.fe_type}, "
                f"nodes={self.n_nodes}, elems={self.n_elements}, "
                f"device={self.device})")
