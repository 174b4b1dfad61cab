"""Linear elasticity — counterpart of feddlib_tpu/problems/linelas.py
(λ, μ from E, ν)."""

from __future__ import annotations

from typing import Callable

from feddlib_tpu_torch.fe import ops
from feddlib_tpu_torch.fe.domain import Domain
from feddlib_tpu_torch.la.block import BlockMatrix, BlockVector
from feddlib_tpu_torch.problems.base import Problem


class LinElas(Problem):
    def __init__(self, domain: Domain, parameter_list=None, device="cuda"):
        super().__init__(parameter_list, device=device)
        self.add_variable(domain, domain.dim, "d")
        pl = self.parameter_list
        self.E = float(pl.get("E", 1.0))
        self.nu = float(pl.get("Poisson Ratio", 0.3))
        self.mu, self.lam = ops.lame_parameters(self.E, self.nu)

    def assemble(self) -> None:
        dom, dofs, _ = self.variables[0]
        K = ops.assemble_lin_elasticity(dom, self.mu, self.lam)
        self.system = BlockMatrix([dom.n_dofs(dofs)])
        self.system.add_block(0, 0, K)
        self.init_vectors()

    def pipeline_blocks(self):
        return [(0, 0, "lin_elasticity", {"mu": self.mu, "lam": self.lam})]

    def assemble_source(self, f: Callable) -> None:
        """Volume load f(x) → one value per component, x component-first
        (x[0] is the first coordinate of the quadrature points)."""
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
