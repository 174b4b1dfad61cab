"""Hyperelastic element kernels via automatic differentiation.

Counterpart of feddlib_tpu/fe/hyperelastic.py.  The strain-energy density
W(F) is written once; `torch.func` gives

    internal force  R_e = ∂E_e/∂d      (torch.func.grad)
    tangent         K_e = ∂²E_e/∂d²    (torch.func.hessian,
                                        forward-over-reverse)

batched over the elements with torch.func.vmap, in float64 on the device
of the inputs.  Total-Lagrangian kinematics: F = I + Σ_a d_a ⊗ ∇X φ_a.

Material forms (parameters E, ν → μ, λ):
- StVK:         W = λ/2 tr(E)² + μ E:E,  E = (FᵀF − I)/2
- Neo-Hooke:    W = μ/2 (I₁ − d) − μ ln J + λ/2 (ln J)²
- Mooney-Rivlin:W = C₁(Ī₁ − 3) + C₂(Ī₂ − 3) + κ/2 (J − 1)²
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch.func import grad, hessian, vmap

from feddlib_tpu_torch.fe import reference as ref
from feddlib_tpu_torch.fe.assembly import small_det, small_inv

f64 = torch.float64


# -- strain energy densities -------------------------------------------------

def stvk_energy(F, mu, lam):
    dim = F.shape[-1]
    E = 0.5 * (F.T @ F - torch.eye(dim, dtype=F.dtype, device=F.device))
    return 0.5 * lam * torch.trace(E) ** 2 + mu * torch.sum(E * E)


def neo_hooke_energy(F, mu, lam):
    dim = F.shape[-1]
    J = small_det(F)
    lnJ = torch.log(J)
    I1 = torch.sum(F * F)
    return 0.5 * mu * (I1 - dim) - mu * lnJ + 0.5 * lam * lnJ ** 2


def mooney_rivlin_energy(F, c1, c2, kappa):
    J = small_det(F)
    C = F.T @ F
    I1 = torch.trace(C)
    I2 = 0.5 * (I1 ** 2 - torch.sum(C * C))
    Jm23 = J ** (-2.0 / 3.0)
    I1b = Jm23 * I1
    I2b = Jm23 ** 2 * I2
    return c1 * (I1b - 3.0) + c2 * (I2b - 3.0) + 0.5 * kappa * (J - 1.0) ** 2


_MATERIALS = {
    "StVK": stvk_energy,
    "Neo-Hooke": neo_hooke_energy,
    "Mooney-Rivlin": mooney_rivlin_energy,
}


def material_energy(name: str) -> Callable:
    if name not in _MATERIALS:
        raise ValueError(f"unknown material {name!r}; have {list(_MATERIALS)}")
    return _MATERIALS[name]


# -- element energy / residual / tangent -------------------------------------


def _element_energy_fn(dim: int, fe_type: str, energy: Callable, params,
                       device):
    """Returns E_e(d_elem, Binv, absdetB) for a single element, with basis
    tables on `device`; quadrature degree follows the reference's choice
    for nonlinear kinematics (2(p−1)+2)."""
    deg = {"P1": 2, "P2": 4}[fe_type]
    qp, qw = ref.quadrature(dim, deg)
    dphi = torch.as_tensor(np.asarray(ref.eval_grad_phi(dim, fe_type, qp)),
                           dtype=f64, device=device)  # [nq, nb, dim]
    qw = torch.as_tensor(np.asarray(qw), dtype=f64, device=device)
    eye = torch.eye(dim, dtype=f64, device=device)

    def elem_energy(d_elem, Binv, adet):
        # physical gradients: ∇X φ_a = Binvᵀ ∇ξ φ_a  → [nq, nb, dim]
        g = torch.einsum("dk,qbd->qbk", Binv, dphi)
        # F_q = I + Σ_a d_a ⊗ g_a
        Fq = eye[None] + torch.einsum("bi,qbk->qik", d_elem, g)
        Wq = vmap(lambda F: energy(F, *params))(Fq)
        return torch.sum(qw * Wq) * adet

    return elem_energy


def _geometry(vert_coords):
    p0 = vert_coords[:, :1, :]
    B = (vert_coords[:, 1:, :] - p0).transpose(1, 2)
    detB = small_det(B)
    return small_inv(B, detB), detB.abs()


def elem_hyper_residual_tangent(vert_coords, d_elem, dim, fe_type, material,
                                params):
    """Batched internal forces and consistent tangents.

    vert_coords [E, dim+1, dim]; d_elem [E, nb, dim] nodal displacements.
    Returns (R [E, nb*dim], K [E, nb*dim, nb*dim]) with NodeWise dof order.
    """
    energy = material_energy(material)
    elem_energy = _element_energy_fn(dim, fe_type, energy, params,
                                     vert_coords.device)
    Binv, adet = _geometry(vert_coords)

    def per_elem(d, Bi, ad):
        f = lambda df: elem_energy(df.reshape(d.shape), Bi, ad)
        flat = d.reshape(-1)
        return grad(f)(flat), hessian(f)(flat)

    return vmap(per_elem)(d_elem, Binv, adet)


def elem_hyper_energy(vert_coords, d_elem, dim, fe_type, material, params):
    """Total strain energy per element [E] (diagnostics)."""
    energy = material_energy(material)
    elem_energy = _element_energy_fn(dim, fe_type, energy, params,
                                     vert_coords.device)
    Binv, adet = _geometry(vert_coords)
    return vmap(elem_energy)(d_elem, Binv, adet)
