"""Nonlinear (hyper)elasticity problem — counterpart of
feddlib_tpu/problems/nonlin_elasticity.py: the consistent tangent and the
internal forces come from fe/hyperelastic.py: the closed form of Neo-Hooke
on 3D P1 elements, `torch.func` autodiff of the strain energy otherwise."""

from __future__ import annotations

from typing import Callable

import torch

from feddlib_tpu_torch.fe import assembly as asm
from feddlib_tpu_torch.fe import ops
from feddlib_tpu_torch.fe.domain import Domain
from feddlib_tpu_torch.fe.hyperelastic import elem_hyper_residual_tangent
from feddlib_tpu_torch.la.block import BlockMatrix, BlockVector
from feddlib_tpu_torch.la.csr import CsrMatrix
from feddlib_tpu_torch.problems.base import NonLinearProblem


def hyper_elem_residual_tangent(dom: Domain, d: torch.Tensor, material,
                                params, tangent=True):
    """Element internal forces and tangents of a hyperelastic solid at the
    NodeWise displacement d, flattened ([E·nloc], [E·nloc²], the second
    None without `tangent`)."""
    de = d.reshape(dom.n_nodes, dom.dim)[dom.device_dofs(1, d.device)]
    R, K = elem_hyper_residual_tangent(dom.vert_coords(), de, dom.dim,
                                       dom.fe_type, material, params, tangent)
    return R.reshape(-1), (K.reshape(-1) if tangent else None)


def assemble_hyper(dom: Domain, d: torch.Tensor, material, params):
    """(F, K): the global internal forces and the consistent tangent
    (CsrMatrix on the domain's square vector pattern) at d."""
    dim = dom.dim
    n = dom.n_dofs(dim)
    Rf, Kf = hyper_elem_residual_tangent(dom, d, material, params)
    pat = dom.pattern(("square", dim), lambda: asm.scatter_pattern(
        dom.elem_dofs(dim), dom.elem_dofs(dim), n, n))
    K = CsrMatrix(pat, device=dom.device)
    K.assemble(Kf)
    return asm.assemble_vector(dom.device_dofs(dim, Rf.device), Rf, n), K


class NonLinElasticity(NonLinearProblem):
    def __init__(self, domain: Domain, parameter_list=None, device="cuda"):
        super().__init__(parameter_list, device=device)
        self.add_variable(domain, domain.dim, "d")
        pl = self.parameter_list
        self.material = pl.get("Material Model", "Neo-Hooke")
        E = float(pl.get("E", 1.0))
        nu = float(pl.get("Poisson Ratio", 0.3))
        mu, lam = ops.lame_parameters(E, nu)
        if self.material == "Mooney-Rivlin":
            c1 = float(pl.get("C1", mu / 4.0))
            c2 = float(pl.get("C2", mu / 4.0))
            kappa = float(pl.get("Kappa", lam + 2 * mu / 3.0))
            self.params = (c1, c2, kappa)
        else:
            self.params = (mu, lam)
        self.source = None

    def _residual_tangent(self, tangent=True):
        return hyper_elem_residual_tangent(self.variables[0][0],
                                           self.solution[0], self.material,
                                           self.params, tangent)

    def assemble(self) -> None:
        self.init_vectors()
        self.reassemble("Newton")

    def pipeline_blocks(self):
        """The consistent-tangent kind of the device pipeline."""
        return [(0, 0, "hyperelastic",
                 {"material": self.material, "mat_params": self.params})]

    def reassemble(self, mode: str = "Newton") -> None:
        dom = self.variables[0][0]
        dim = dom.dim
        n = dom.n_dofs(dim)
        # the key of fe/ops.py's square vector pattern: the tangent, the
        # vector mass and their sum share one SparsityPattern object
        pat = dom.pattern(("square", dim), lambda: asm.scatter_pattern(
            dom.elem_dofs(dim), dom.elem_dofs(dim), n, n))
        _, Kf = self._residual_tangent()
        K = CsrMatrix(pat, device=dom.device)
        K.assemble(Kf)
        self.system = BlockMatrix([n])
        self.system.add_block(0, 0, K)
        self._prec_stale = True

    def internal_forces(self) -> torch.Tensor:
        dom = self.variables[0][0]
        dim = dom.dim
        Rf, _ = self._residual_tangent(tangent=False)
        return asm.assemble_vector(dom.device_dofs(dim, Rf.device), Rf,
                                   dom.n_dofs(dim))

    def assemble_source(self, f: Callable) -> None:
        """Volume load f(x) → one value per component (x component-first,
        as LinElas.assemble_source)."""
        dom = self.variables[0][0]
        self.source = ops.assemble_rhs(dom, f, dom.dim)
        self.init_vectors()
        self.rhs[0] = self.source

    def calculate_residual(self, t: float = 0.0) -> BlockVector:
        F = self.internal_forces()
        if self.source is not None:
            F = F - self.source
        r = BlockVector([F])
        return self.bc_builder.set_vector_minus_bc(r, self.solution, t)


class Elasticity(NonLinearProblem):
    """Facade switching linear/nonlinear elasticity by the parameter
    'Material Model' (reference: problems/specific/Elasticity_decl.hpp)."""

    def __new__(cls, domain, parameter_list=None, device="cuda"):
        from feddlib_tpu_torch.problems.linelas import LinElas

        kind = (parameter_list or {}) and parameter_list.get(
            "Material Model", "linear")
        if kind in ("linear", None, ""):
            return LinElas(domain, parameter_list, device=device)
        return NonLinElasticity(domain, parameter_list, device=device)
