"""TPM — two-phase (Biot) poroelasticity; counterpart of
feddlib_tpu/problems/tpm.py.  The quasi-static Biot system is assembled from
the standard mixed kernels:

  momentum:  ∫ σ(u):ε(v) + α (Bᵀ p)·v           = f     (σ linear or hyper)
  mass:      −α/dt B (u−uⁿ) + κ L p + S/dt M (p−pⁿ) = g

with B the (negative) mixed divergence block of the Stokes assembly, L the
pressure Laplacian (permeability κ), M the pressure mass (storativity S).
Implicit Euler in time; u P2 / p P1 by default.  `NonLinTPM` makes the
solid hyperelastic (fe/hyperelastic.py, torch.func) and runs Newton each
step.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from feddlib_tpu_torch.fe import ops
from feddlib_tpu_torch.fe.domain import Domain
from feddlib_tpu_torch.la.block import BlockMatrix, BlockVector
from feddlib_tpu_torch.la.csr import CsrMatrix
from feddlib_tpu_torch.problems.base import Problem
from feddlib_tpu_torch.problems.nonlin_elasticity import assemble_hyper


class TPM(Problem):
    def __init__(self, domain_u: Domain, domain_p: Domain,
                 parameter_list=None, device="cuda"):
        super().__init__(parameter_list, device=device)
        dim = domain_u.dim
        self.add_variable(domain_u, dim, "u")
        self.add_variable(domain_p, 1, "p")
        pl = self.parameter_list
        self.alpha = float(pl.get("Biot Alpha", 1.0))
        self.kappa = float(pl.get("Permeability", 1.0))
        self.storativity = float(pl.get("Storativity", 0.0))
        self.dt = float(pl.get("dt", 0.01))
        mu, lam = ops.lame_parameters(float(pl.get("E", 1.0)),
                                      float(pl.get("Poisson Ratio", 0.3)))
        self.mu, self.lam = mu, lam

    def _coupled_system(self, Kuu: CsrMatrix) -> None:
        dt = self.dt
        S = BlockMatrix(self.block_sizes())
        S.add_block(0, 0, Kuu)
        S.add_block(0, 1, self.BT.scale(self.alpha))
        S.add_block(1, 0, self.B.scale(-self.alpha / dt))
        S.add_block(1, 1, self.Lp.scale(self.kappa).add(
            self.Mp, alpha=1.0, beta=self.storativity / dt))
        self.system = S
        self._prec_stale = True

    def assemble(self) -> None:
        dom_u, dom_p = self.variables[0][0], self.variables[1][0]
        Ku = ops.assemble_lin_elasticity(dom_u, self.mu, self.lam)
        self.B, self.BT = ops.assemble_divergence(dom_u, dom_p)
        self.Lp = ops.assemble_laplace(dom_p)
        self.Mp = ops.assemble_mass(dom_p)
        self._coupled_system(Ku)
        self.init_vectors()

    def pipeline_blocks(self):
        """The linear quasi-static Biot blocks of the device pipeline."""
        return [(0, 0, "lin_elasticity", {"mu": self.mu, "lam": self.lam}),
                (0, 1, "divergence_T", {"coeff": self.alpha}),
                (1, 0, "divergence", {"coeff": -self.alpha / self.dt}),
                (1, 1, "laplace", {"coeff": self.kappa}),
                (1, 1, "mass", {"coeff": self.storativity / self.dt})]

    def assemble_source(self, f: Callable) -> None:
        dom_u = self.variables[0][0]
        self.init_vectors()
        self.rhs[0] = ops.assemble_rhs(dom_u, f, dom_u.dim)

    def step_rhs(self, u_old: torch.Tensor, p_old: torch.Tensor,
                 f_ext: Optional[BlockVector] = None) -> BlockVector:
        """Implicit-Euler history terms of one step."""
        dt = self.dt
        rp = (-self.alpha / dt) * self.B.matvec(u_old) \
            + (self.storativity / dt) * self.Mp.matvec(p_old)
        ru = torch.zeros(self.block_sizes()[0], dtype=torch.float64,
                         device=self.device)
        out = BlockVector([ru, rp])
        if f_ext is not None:
            out = out.axpy(1.0, f_ext)
        return out

    def advance(self, t_end: float, observer: Optional[Callable] = None,
                f_ext: Optional[BlockVector] = None) -> None:
        """Quasi-static consolidation loop."""
        self.init_vectors()
        t = 0.0
        while t < t_end - 1e-12:
            t_new = t + self.dt
            rhs = self.step_rhs(self.solution[0], self.solution[1], f_ext)
            self.rhs = self.bc_builder.apply_to_rhs(rhs, t_new)
            self.solve()
            if observer:
                observer(t_new, self.solution)
            t = t_new


class NonLinTPM(TPM):
    """Finite-strain Biot poroelasticity: a hyperelastic solid with the
    Biot coupling and flow equation of TPM (small-strain divergence
    operator).  Each step runs Newton on

        R_u = F_int(d) + α Bᵀ p − f
        R_p = −α/dt B (d − dⁿ) + κ L p + S/dt M (p − pⁿ) − g
    """

    def __init__(self, domain_u: Domain, domain_p: Domain,
                 parameter_list=None, device="cuda"):
        super().__init__(domain_u, domain_p, parameter_list, device=device)
        self.material = self.parameter_list.get("Material Model",
                                                "Neo-Hooke")
        self.params = (self.mu, self.lam)

    # NonLinearSolver protocol (swapped per step inside advance)
    def calculate_residual(self, t: float = 0.0):
        raise RuntimeError("use NonLinTPM.advance()")

    def reassemble(self, mode: str = "Newton"):
        raise RuntimeError("use NonLinTPM.advance()")

    def residual_norm(self, r) -> float:
        return float(r.norm2())

    def _solid_residual_tangent(self):
        return assemble_hyper(self.variables[0][0], self.solution[0],
                              self.material, self.params)

    def advance(self, t_end: float, observer: Optional[Callable] = None,
                f_ext: Optional[BlockVector] = None) -> None:
        from feddlib_tpu_torch.solvers.nonlinear import NonLinearSolver

        self.init_vectors()
        dt = self.dt
        solver = NonLinearSolver("Newton")
        self.nonlinear_solver = solver
        t = 0.0
        prob = self
        while t < t_end - 1e-12:
            t_new = t + dt
            hist = self.step_rhs(self.solution[0], self.solution[1], None)

            def residual(tt=0.0):
                F_int, _ = prob._solid_residual_tangent()
                u, p = prob.solution[0], prob.solution[1]
                Ru = F_int + prob.alpha * prob.BT.matvec(p)
                Rp = ((-prob.alpha / dt) * prob.B.matvec(u)
                      + prob.kappa * prob.Lp.matvec(p)
                      + (prob.storativity / dt) * prob.Mp.matvec(p)
                      - hist[1])
                if f_ext is not None:
                    Ru = Ru - f_ext[0]
                    Rp = Rp - f_ext[1]
                return prob.bc_builder.set_vector_minus_bc(
                    BlockVector([Ru, Rp]), prob.solution, tt)

            def reassemble(mode="Newton"):
                prob._coupled_system(prob._solid_residual_tangent()[1])

            self.calculate_residual = residual
            self.reassemble = reassemble
            try:
                solver.solve(self, t_new)
            finally:
                del self.calculate_residual, self.reassemble
            if observer:
                observer(t_new, self.solution)
            t = t_new
