"""Stokes problem — counterpart of feddlib_tpu/problems/stokes.py: A =
stress or vector Laplace, B/Bᵀ, and for equal-order spaces the P1–P1
Bochev–Dohrmann stabilization block C; velocity and pressure mass matrices
for the block preconditioners."""

from __future__ import annotations

from typing import Callable

from feddlib_tpu_torch.fe import ops
from feddlib_tpu_torch.fe.domain import Domain
from feddlib_tpu_torch.la.block import BlockMatrix
from feddlib_tpu_torch.problems.base import Problem


class Stokes(Problem):
    def __init__(self, domain_u: Domain, domain_p: Domain,
                 parameter_list=None, device="cuda"):
        super().__init__(parameter_list, device=device)
        self.add_variable(domain_u, domain_u.dim, "u")
        self.add_variable(domain_p, 1, "p")
        self.viscosity = float(self.parameter_list.get("Viscosity", 1.0))
        self.sym_stress = bool(self.parameter_list.get("Symmetric Gradient",
                                                       False))

    def assemble(self) -> None:
        dom_u, dom_p = self.variables[0][0], self.variables[1][0]
        A = (ops.assemble_stress(dom_u, self.viscosity) if self.sym_stress
             else ops.assemble_laplace_vec(dom_u, self.viscosity))
        B, BT = ops.assemble_divergence(dom_u, dom_p)
        self.system = BlockMatrix(self.block_sizes())
        self.system.add_block(0, 0, A)
        self.system.add_block(0, 1, BT)
        self.system.add_block(1, 0, B)
        if dom_u.fe_type == dom_p.fe_type:  # equal order needs stabilization
            self.system.add_block(1, 1, ops.assemble_bd_stabilization(dom_p))
        self.init_vectors()

    def pipeline_blocks(self):
        """Block kernels of the device-resident distributed pipeline."""
        dom_u, dom_p = self.variables[0][0], self.variables[1][0]
        kind = "stress" if self.sym_stress else "laplace_vec"
        blocks = [(0, 0, kind, {"viscosity": self.viscosity}),
                  (0, 1, "divergence_T", {}), (1, 0, "divergence", {})]
        if dom_u.fe_type == dom_p.fe_type:
            blocks.append((1, 1, "bd_stab", {}))
        return blocks

    def assemble_source(self, f: Callable) -> None:
        """Volume force f(x), one value per velocity component."""
        dom_u = self.variables[0][0]
        self.init_vectors()
        self.rhs[0] = ops.assemble_rhs(dom_u, f, dom_u.dim)

    def velocity_mass_matrix(self):
        dom_u = self.variables[0][0]
        return ops.assemble_mass(dom_u, dom_u.dim)

    def pressure_mass_matrix(self):
        return ops.assemble_mass(self.variables[1][0], 1)
