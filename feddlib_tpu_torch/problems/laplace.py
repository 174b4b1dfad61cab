"""Laplace problem — counterpart of feddlib_tpu/problems/laplace.py for a
scalar or vector field on P1/P2 simplices."""

from __future__ import annotations

from typing import Callable

from feddlib_tpu_torch.fe import ops
from feddlib_tpu_torch.fe.domain import Domain
from feddlib_tpu_torch.la.block import BlockMatrix, BlockVector
from feddlib_tpu_torch.problems.base import Problem


class Laplace(Problem):
    def __init__(self, domain: Domain, dofs_per_node: int = 1,
                 parameter_list=None, device="cuda"):
        super().__init__(parameter_list, device=device)
        self.add_variable(domain, dofs_per_node, "u")

    def assemble(self) -> None:
        dom, dofs, _ = self.variables[0]
        K = (ops.assemble_laplace(dom) if dofs == 1
             else ops.assemble_laplace_vec(dom))
        self.system = BlockMatrix([dom.n_dofs(dofs)])
        self.system.add_block(0, 0, K)
        self.init_vectors()

    def pipeline_blocks(self):
        """Block kernels of the device-resident distributed pipeline
        ('Use Device Pipeline', parallel/pipeline.py)."""
        dofs = self.variables[0][1]
        return [(0, 0, "laplace" if dofs == 1 else "laplace_vec", {})]

    def assemble_source(self, f: Callable) -> None:
        """Volume source f(x), x component-first (x[0] is the first
        coordinate of the quadrature points); one value per component for
        a vector field."""
        dom, dofs, _ = self.variables[0]
        self.rhs = BlockVector([ops.assemble_rhs(dom, f, dofs)])

    def assemble_surface_source(self, g: Callable, flag: int) -> None:
        dom, dofs, _ = self.variables[0]
        add = ops.assemble_surface_rhs(dom, g, flag, dofs)
        self.init_vectors()
        self.rhs[0] = self.rhs[0] + add

    def mass_matrix(self):
        dom, dofs, _ = self.variables[0]
        return ops.assemble_mass(dom, dofs)
