"""Laplace problem — counterpart of feddlib_tpu/problems/laplace.py for a
scalar field on P1/P2 simplices."""

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
        if dofs != 1:
            raise NotImplementedError(
                "vector Laplace is not ported yet (ROADMAP.md A8)")
        K = ops.assemble_laplace(dom)
        self.system = BlockMatrix([dom.n_dofs(dofs)])
        self.system.add_block(0, 0, K)
        self.init_vectors()

    def assemble_source(self, f: Callable) -> None:
        """Volume source f(x), x component-first (x[0] is the first
        coordinate of the quadrature points)."""
        dom, dofs, _ = self.variables[0]
        self.rhs = BlockVector([ops.assemble_rhs(dom, f, dofs)])
