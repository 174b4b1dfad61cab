"""Small problem variants — counterpart of feddlib_tpu/problems/misc.py:
LaplaceBlocks (two independent diagonal Laplace blocks, the
block-preconditioner demo) and LinElasFirstOrder (the first-order-in-time
form of elastodynamics, blocks (d, v))."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from feddlib_tpu_torch.fe import ops
from feddlib_tpu_torch.fe.domain import Domain
from feddlib_tpu_torch.la.block import BlockMatrix, BlockVector
from feddlib_tpu_torch.la.csr import CsrMatrix, SparsityPattern
from feddlib_tpu_torch.problems.base import Problem


class LaplaceBlocks(Problem):
    """Two decoupled Laplace blocks in one block system."""

    def __init__(self, domain: Domain, parameter_list=None, device="cuda"):
        super().__init__(parameter_list, device=device)
        self.add_variable(domain, 1, "u0")
        self.add_variable(domain, 1, "u1")

    def assemble(self) -> None:
        dom = self.variables[0][0]
        K = ops.assemble_laplace(dom)
        self.system = BlockMatrix(self.block_sizes())
        self.system.add_block(0, 0, K)
        self.system.add_block(1, 1, K)
        self.init_vectors()

    def assemble_source(self, f: Callable) -> None:
        dom = self.variables[0][0]
        b = ops.assemble_rhs(dom, f)
        self.init_vectors()
        self.rhs = BlockVector([b, b])


def _identity_csr(n: int, device="cuda") -> CsrMatrix:
    idx = np.arange(n)
    m = CsrMatrix(SparsityPattern.from_coo(idx, idx, n, n), device=device)
    m.assemble(torch.ones(n, dtype=torch.float64, device=m.device))
    return m


class LinElasFirstOrder(Problem):
    """First-order form of elastodynamics: blocks (d, v) with the steady
    part [[0, −M], [K, 0]] (the d-row couples to v, the v-row to d); the
    time integrator adds the ∂t masses through TimeProblem's block
    masks."""

    def __init__(self, domain: Domain, parameter_list=None, device="cuda"):
        super().__init__(parameter_list, device=device)
        dim = domain.dim
        self.add_variable(domain, dim, "d")
        self.add_variable(domain, dim, "v")
        pl = self.parameter_list
        self.mu, self.lam = ops.lame_parameters(
            float(pl.get("E", 1.0)), float(pl.get("Poisson Ratio", 0.3)))

    def assemble(self) -> None:
        dom = self.variables[0][0]
        K = ops.assemble_lin_elasticity(dom, self.mu, self.lam)
        M = ops.assemble_mass(dom, dom.dim)
        self.system = BlockMatrix(self.block_sizes())
        self.system.add_block(0, 1, M.scale(-1.0))
        self.system.add_block(1, 0, K)
        self.M, self.K = M, K
        self.init_vectors()
