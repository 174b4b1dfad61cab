"""Abstract problem layer — counterpart of feddlib_tpu/problems/base.py.

A Problem owns:
- `variables`: (domain, dofs_per_node, name) per block;
- `system`: BlockMatrix, `rhs`/`solution`: BlockVector;
- `bc_builder`: BCBuilder, applied as row masking on diagonal blocks and row
  zeroing on off-diagonals;
- `preconditioner` + `parameter_list` driving the linear solver;
- `device`: where its tensors live (default "cuda").

NonLinearProblem adds the residual / reassembly hooks that
solvers/nonlinear.py's NonLinearSolver drives.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from feddlib_tpu_torch.bc import BCBuilder
from feddlib_tpu_torch.fe.domain import Domain
from feddlib_tpu_torch.la.block import BlockMatrix, BlockVector
from feddlib_tpu_torch.solvers.linear import LinearSolver, Preconditioner
from feddlib_tpu_torch.utils.config import ParameterList
from feddlib_tpu_torch.utils.device import resolve_device


class Problem:
    def __init__(self, parameter_list: Optional[ParameterList] = None,
                 device="cuda"):
        self.parameter_list = parameter_list or ParameterList("Parameters")
        self.device = resolve_device(device)
        self.variables: List[Tuple[Domain, int, str]] = []
        self.system: Optional[BlockMatrix] = None
        self.rhs: Optional[BlockVector] = None
        self.solution: Optional[BlockVector] = None
        self.bc_builder = BCBuilder()
        self.preconditioner = Preconditioner(self)
        self.linear_solver = LinearSolver()
        self.last_relres = None
        self.last_passes = None
        self._prec_stale = True

    # -- setup --------------------------------------------------------------
    def add_variable(self, domain: Domain, dofs_per_node: int,
                     name: str = "") -> None:
        if domain.device != self.device:
            raise ValueError(f"domain lives on {domain.device}, the problem "
                             f"on {self.device}")
        self.variables.append((domain, dofs_per_node, name))

    @property
    def domains(self) -> List[Domain]:
        return [v[0] for v in self.variables]

    def block_sizes(self) -> List[int]:
        return [d.n_dofs(dofs) for d, dofs, _ in self.variables]

    def total_dofs_per_node(self) -> int:
        return self.variables[0][1]

    def add_bc(self, func, flag, block, bc_type: str = "Dirichlet") -> None:
        dom, dofs, _ = self.variables[block]
        self.bc_builder.add_bc(func, flag, block, dom, bc_type, dofs)

    def init_vectors(self) -> None:
        sizes = self.block_sizes()
        if self.rhs is None:
            self.rhs = BlockVector.zeros(sizes, device=self.device)
        if self.solution is None:
            self.solution = BlockVector.zeros(sizes, device=self.device)

    # -- assembly (subclass) -------------------------------------------------
    def assemble(self) -> None:
        raise NotImplementedError

    # -- boundary application ------------------------------------------------
    def bc_system(self) -> BlockMatrix:
        """System with Dirichlet rows masked (setBoundariesSystem)."""
        return self.bc_builder.apply_to_system(self.system)

    def set_boundaries_rhs(self, t: float = 0.0) -> None:
        self.rhs = self.bc_builder.apply_to_rhs(self.rhs, t)

    def merged_dirichlet_mask(self) -> np.ndarray:
        masks = [self.bc_builder.dirichlet_mask(b, sz)
                 for b, sz in enumerate(self.block_sizes())]
        return np.concatenate(masks)

    # -- solve ---------------------------------------------------------------
    def solve(self) -> int:
        """Monolithic linear solve; returns the Krylov iteration count."""
        self.init_vectors()
        return self.linear_solver.solve(self)


class NonLinearProblem(Problem):
    """Adds the residual / Jacobian machinery NonLinearSolver drives."""

    def __init__(self, parameter_list=None, device="cuda"):
        super().__init__(parameter_list, device=device)
        self.residual: Optional[BlockVector] = None

    def calculate_residual(self, t: float = 0.0) -> BlockVector:
        """Nonlinear residual F(u) with the Dirichlet correction
        residual = u − g on constrained dofs (the reference's "reverse"
        convention)."""
        raise NotImplementedError

    def reassemble(self, mode: str = "Newton") -> None:
        """Update the solution-dependent blocks (N(u), W(u), tangents)."""
        raise NotImplementedError

    def residual_norm(self, r: BlockVector) -> float:
        return float(r.norm2())
