"""Steady Navier–Stokes problem — counterpart of
feddlib_tpu/problems/navier_stokes.py:
- `assemble`: the constant blocks A (viscous), B, Bᵀ and, for equal-order
  spaces, the stabilization C;
- `reassemble("FixedPoint")` adds the convection N(u); `("Newton")` adds
  W(u) as well;
- `calculate_residual`: F_u = [A + N(u)]u + Bᵀp − f, F_p = Bu (+ Cp), with
  the Dirichlet correction residual = u − g on constrained dofs.
The convection uses the current solution in element-local (repeated) form,
a device gather (ops.u_elem_values)."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from feddlib_tpu_torch.fe import ops
from feddlib_tpu_torch.fe.domain import Domain
from feddlib_tpu_torch.la.block import BlockMatrix, BlockVector
from feddlib_tpu_torch.problems.base import NonLinearProblem


class NavierStokes(NonLinearProblem):
    def __init__(self, domain_u: Domain, domain_p: Domain,
                 parameter_list=None, device="cuda"):
        super().__init__(parameter_list, device=device)
        self.add_variable(domain_u, domain_u.dim, "u")
        self.add_variable(domain_p, 1, "p")
        self.viscosity = float(self.parameter_list.get("Viscosity", 1.0))
        self.density = float(self.parameter_list.get("Density", 1.0))
        self.A = None
        self.B = None
        self.BT = None
        self.C = None
        self.source = None
        self._last_mode = "FixedPoint"

    def assemble(self) -> None:
        dom_u, dom_p = self.variables[0][0], self.variables[1][0]
        self.A = ops.assemble_laplace_vec(dom_u, self.viscosity)
        self.B, self.BT = ops.assemble_divergence(dom_u, dom_p)
        if dom_u.fe_type == dom_p.fe_type:
            self.C = ops.assemble_bd_stabilization(dom_p)
        self.init_vectors()
        self.reassemble("FixedPoint")

    def _build_system(self, Auu) -> None:
        self.system = BlockMatrix(self.block_sizes())
        self.system.add_block(0, 0, Auu)
        self.system.add_block(0, 1, self.BT)
        self.system.add_block(1, 0, self.B)
        if self.C is not None:
            self.system.add_block(1, 1, self.C)
        self._prec_stale = True

    def reassemble(self, mode: str = "Newton") -> None:
        self._last_mode = mode
        dom_u = self.variables[0][0]
        u = self.solution[0] if self.solution is not None else None
        if u is None:
            self._build_system(self.A)
            return
        Auu = self.A.add(ops.assemble_advection(dom_u, u * self.density))
        if mode == "Newton":
            Auu = Auu.add(ops.assemble_advection_in_u(dom_u,
                                                      u * self.density))
        self._build_system(Auu)

    def pipeline_blocks(self):
        """The current block composition for the device-resident
        distributed pipeline: it follows the FixedPoint / Newton state of
        the last reassembly, so the pipeline's Jacobian is the serial
        one."""
        dom_u, dom_p = self.variables[0][0], self.variables[1][0]
        blocks = [(0, 0, "laplace_vec", {"viscosity": self.viscosity}),
                  (0, 0, "advection", {"coeff": self.density})]
        if self._last_mode == "Newton":
            blocks.append((0, 0, "advection_in_u", {"coeff": self.density}))
        blocks += [(0, 1, "divergence_T", {}), (1, 0, "divergence", {})]
        if dom_u.fe_type == dom_p.fe_type:
            blocks.append((1, 1, "bd_stab", {}))
        return blocks

    def assemble_source(self, f: Callable) -> None:
        """Volume force f(x), one value per velocity component."""
        dom_u = self.variables[0][0]
        self.source = ops.assemble_rhs(dom_u, f, dom_u.dim)
        self.init_vectors()
        self.rhs[0] = self.source

    def _momentum_residual(self) -> torch.Tensor:
        dom_u = self.variables[0][0]
        u, p = self.solution[0], self.solution[1]
        N = ops.assemble_advection(dom_u, u * self.density)
        Fu = self.A.matvec(u) + N.matvec(u) + self.BT.matvec(p)
        if self.source is not None:
            Fu = Fu - self.source
        return Fu

    def surface_forces(self, flags) -> np.ndarray:
        """Force on the flagged boundaries: minus the sum of the momentum
        residual, without BC row masking, over their nodes (the consistent
        variational drag/lift formula).  Returns the [dim] total force."""
        dom_u = self.variables[0][0]
        nodes = np.nonzero(np.isin(dom_u.mesh.point_flags,
                                   np.asarray(flags)))[0]
        Fn = self._momentum_residual().cpu().numpy().reshape(-1, dom_u.dim)
        # the residual at constrained dofs is the reaction on the fluid;
        # the force on the body is its negative
        return -Fn[nodes].sum(axis=0)

    def drag_lift_coefficients(self, flags, u_mean: float,
                               length: float) -> tuple:
        """(c_d, c_l) with the DFG normalisation 2F/(ρ U² L)."""
        F = self.surface_forces(flags)
        scale = 2.0 / (self.density * u_mean ** 2 * length)
        return float(F[0] * scale), float(F[1] * scale)

    def calculate_residual(self, t: float = 0.0) -> BlockVector:
        """F(u, p) with the fixed-point operator [A + N(u)] (the Newton W
        term belongs to the Jacobian only)."""
        u, p = self.solution[0], self.solution[1]
        Fp = self.B.matvec(u)
        if self.C is not None:
            Fp = Fp + self.C.matvec(p)
        r = BlockVector([self._momentum_residual(), Fp])
        # Dirichlet correction: residual = u − g (the 'reverse' form)
        return self.bc_builder.set_vector_minus_bc(r, self.solution, t)
