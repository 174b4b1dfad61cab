"""Geometry (mesh motion) problem — counterpart of
feddlib_tpu/problems/geometry.py: the harmonic extension of the interface
displacement into the fluid mesh ('Model': 'Laplace', optionally scaled by
the nodes' distance to the interface) or a pseudo-elastic extension
('Elasticity').  `solve_motion` runs unpreconditioned GMRES, as the JAX
package does."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from feddlib_tpu_torch.fe import assembly as asm
from feddlib_tpu_torch.fe import ops
from feddlib_tpu_torch.fe.domain import Domain
from feddlib_tpu_torch.la.block import BlockMatrix
from feddlib_tpu_torch.la.csr import CsrMatrix
from feddlib_tpu_torch.precond.facsi import _rows_to_identity
from feddlib_tpu_torch.problems.base import Problem
from feddlib_tpu_torch.solvers.krylov import gmres


class Geometry(Problem):
    def __init__(self, domain: Domain, parameter_list=None,
                 distances: Optional[np.ndarray] = None, device="cuda"):
        super().__init__(parameter_list, device=device)
        self.add_variable(domain, domain.dim, "g")
        self.model = self.parameter_list.get("Model", "Laplace")
        self.distances = distances  # node distances to the FSI interface
        self.last_iters = None
        self.last_relres = None

    def assemble(self) -> None:
        dom, dofs, _ = self.variables[0]
        if self.model == "Elasticity":
            mu, lam = ops.lame_parameters(
                float(self.parameter_list.get("E", 1.0)),
                float(self.parameter_list.get("Poisson Ratio", 0.3)))
            K = ops.assemble_lin_elasticity(dom, mu, lam)
        elif self.distances is not None:
            K = self._assemble_scaled_laplace(dom)
        else:
            K = ops.assemble_laplace_vec(dom)
        self.system = BlockMatrix([dom.n_dofs(dofs)])
        self.system.add_block(0, 0, K)
        self.init_vectors()

    def pipeline_blocks(self):
        """The harmonic-extension kinds of the device pipeline."""
        dom = self.variables[0][0]
        if self.model == "Elasticity":
            mu, lam = ops.lame_parameters(
                float(self.parameter_list.get("E", 1.0)),
                float(self.parameter_list.get("Poisson Ratio", 0.3)))
            return [(0, 0, "lin_elasticity", {"mu": mu, "lam": lam})]
        if self.distances is not None:
            nv = dom.mesh.vertices_per_element
            d_elem = self.distances[dom.mesh.elements[:, :nv]].mean(axis=1)
            return [(0, 0, "laplace_vec_scaled",
                     {"elem_data": 1.0 / np.maximum(d_elem, 1e-3)})]
        return [(0, 0, "laplace_vec", {})]

    def _assemble_scaled_laplace(self, dom: Domain) -> CsrMatrix:
        """Harmonic extension with stiffness ∝ 1/dist(x, Γ): elements near
        the interface move almost rigidly, the far ones absorb the
        deformation."""
        dim = dom.dim
        nv = dom.mesh.vertices_per_element
        d_elem = self.distances[dom.mesh.elements[:, :nv]].mean(axis=1)
        scale = torch.as_tensor(1.0 / np.maximum(d_elem, 1e-3),
                                dtype=torch.float64, device=dom.device)
        K = asm.elem_laplace(dom.vert_coords(), dim, dom.fe_type)
        K = K * scale[:, None, None]
        eye = torch.eye(dim, dtype=torch.float64, device=dom.device)
        Kv = asm.vectorize_elem_mat(torch.einsum("eab,ij->eabij", K, eye))
        n = dom.n_dofs(dim)
        pat = dom.pattern(("square", dim), lambda: asm.scatter_pattern(
            dom.elem_dofs(dim), dom.elem_dofs(dim), n, n))
        m = CsrMatrix(pat, device=dom.device)
        m.assemble(Kv.reshape(-1))
        return m

    def solve_motion(self, interface_nodes: np.ndarray,
                     interface_disp: np.ndarray,
                     boundary_flags=(1,)) -> np.ndarray:
        """Mesh displacement for the given interface node displacements
        ([n_iface, dim]), the outer boundary (`boundary_flags`) held fixed.
        Returns the full field [n_nodes, dim] on the host; the GMRES
        iterations and relative residual are kept in `last_iters` and
        `last_relres`."""
        dom = self.variables[0][0]
        dim = dom.dim
        n = dom.n_dofs(dim)
        A = self.system.get_block(0, 0)
        mask = np.zeros(n, dtype=bool)
        vals = np.zeros(n)
        for flag in boundary_flags:
            nodes = np.nonzero(dom.mesh.point_flags == flag)[0]
            for c in range(dim):
                mask[nodes * dim + c] = True
        for c in range(dim):
            mask[interface_nodes * dim + c] = True
            vals[interface_nodes * dim + c] = interface_disp[:, c]
        Ab = _rows_to_identity(A, mask)
        rhs = torch.as_tensor(np.where(mask, vals, 0.0), dtype=torch.float64,
                              device=A.device)
        res = gmres(Ab.matvec, rhs,
                    tol=float(self.parameter_list.get(
                        "Convergence Tolerance", 1e-8)),
                    maxiter=int(self.parameter_list.get(
                        "Maximum Iterations", 2000)))
        self.last_iters, self.last_relres = res.iters, res.relres
        return res.x.cpu().numpy().reshape(dom.n_nodes, dim)

