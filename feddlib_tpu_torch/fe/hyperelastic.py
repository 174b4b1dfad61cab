"""Hyperelastic element kernels: automatic differentiation, and the closed
form of Neo-Hooke on P1 tetrahedra.

Counterpart of feddlib_tpu/fe/hyperelastic.py.  The strain-energy density
W(F) is written once; `torch.func` gives

    internal force  R_e = ∂E_e/∂d      (torch.func.grad)
    tangent         K_e = ∂²E_e/∂d²    (torch.func.hessian,
                                        forward-over-reverse)

batched over the elements with torch.func.vmap, in float64 on the device
of the inputs.  Total-Lagrangian kinematics: F = I + Σ_a d_a ⊗ ∇X φ_a.

Neo-Hooke on 3D P1 elements (F constant on a tetrahedron) takes its closed
form instead (`neo_hooke_p1`): the kernel of csrc/hyperelastic.cu for CUDA
tensors, its plain version `neo_hooke_p1_plain` for CPU tensors.  Every
other material, element or dimension keeps `torch.func`
(`autodiff_residual_tangent`).  The counters `kernel.neo_hooke_p1` (one a
launch) and `hyper.autodiff_chunks` (one a `torch.func` chunk) of
utils/timers.py show which path ran.

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
from feddlib_tpu_torch.la import _cuda
from feddlib_tpu_torch.utils import timers

f64 = torch.float64
_AUTODIFF_CHUNK = 16384


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


def autodiff_residual_tangent(vert_coords, d_elem, dim, fe_type, material,
                              params, tangent=True):
    """Internal forces and consistent tangents by `torch.func` (grad and,
    with `tangent`, hessian under vmap), for any material and element, in
    chunks of _AUTODIFF_CHUNK elements (which bound `torch.func`'s
    memory); adds one to the counter `hyper.autodiff_chunks` a chunk.
    Arguments and result as `elem_hyper_residual_tangent`."""
    energy = material_energy(material)
    elem_energy = _element_energy_fn(dim, fe_type, energy, params,
                                     vert_coords.device)
    Binv, adet = _geometry(vert_coords)

    def per_elem(d, Bi, ad):
        f = lambda df: elem_energy(df.reshape(d.shape), Bi, ad)
        flat = d.reshape(-1)
        if not tangent:
            return grad(f)(flat)
        return grad(f)(flat), hessian(f)(flat)

    Rs, Ks = [], []
    for s in range(0, vert_coords.shape[0], _AUTODIFF_CHUNK):
        timers.count("hyper.autodiff_chunks")
        c = slice(s, s + _AUTODIFF_CHUNK)
        out = vmap(per_elem)(d_elem[c], Binv[c], adet[c])
        R, K = out if tangent else (out, None)
        Rs.append(R)
        Ks.append(K)
    if len(Rs) == 1:
        return Rs[0], Ks[0]
    return torch.cat(Rs), (torch.cat(Ks) if tangent else None)


def neo_hooke_p1_plain(vert_coords, d_elem, mu, lam, tangent=True):
    """Plain PyTorch version of csrc/hyperelastic.cu: with g_a = B⁻ᵀ∇ξφ_a,
    vol = |det B|/6, F = I + Σ_a d_a ⊗ g_a, J = det F, h_a = F⁻ᵀg_a,

        R_(a,i) = vol [μ (F g_a)_i + (λ ln J − μ) h_(a,i)]
        K_(a,i),(b,k) = vol [μ δ_ik g_a·g_b + λ h_(a,i) h_(b,k)
                             + (μ − λ ln J) h_(a,k) h_(b,i)]

    (the derivatives of W = μ/2 (I₁ − 3) − μ ln J + λ/2 (ln J)²).
    vert_coords, d_elem [E, 4, 3] f64; returns (R [E, 12], K [E, 12, 12]
    or None) in NodeWise order.  J ≤ 0 gives non-finite values."""
    Binv, adet = _geometry(vert_coords)
    E = vert_coords.shape[0]
    g = torch.cat([-Binv.sum(1, keepdim=True), Binv], 1)   # [E, 4, 3]
    vol = adet / 6.0
    eye = torch.eye(3, dtype=f64, device=vert_coords.device)
    F = eye + torch.einsum("eai,eak->eik", d_elem, g)
    J = small_det(F)
    h = torch.einsum("eki,eak->eai", small_inv(F, J), g)
    lnJ = torch.log(J)
    cm, c3 = vol * mu, vol * (mu - lam * lnJ)
    Fg = torch.einsum("eik,eak->eai", F, g)
    R = (cm[:, None, None] * Fg - c3[:, None, None] * h).reshape(E, 12)
    if not tangent:
        return R, None
    gram = torch.einsum("eak,ebk->eab", g, g)
    K = (torch.einsum("e,eab,ik->eaibk", cm, gram, eye)
         + torch.einsum("e,eai,ebk->eaibk", vol * lam, h, h)
         + torch.einsum("e,eak,ebi->eaibk", c3, h, h))
    return R, K.reshape(E, 12, 12)


def neo_hooke_p1(vert_coords, d_elem, mu, lam, tangent=True):
    """`neo_hooke_p1_plain`'s closed form by the kernel of
    csrc/hyperelastic.cu for CUDA tensors (one launch over all elements,
    counter `kernel.neo_hooke_p1`), by the plain version for CPU
    tensors."""
    if vert_coords.device.type == "cpu":
        return neo_hooke_p1_plain(vert_coords, d_elem, mu, lam, tangent)
    vc = vert_coords.contiguous()
    de = d_elem.contiguous()
    _cuda.require_hopper(vc, de)
    _cuda.require(vc, "vert_coords", f64, 3)
    _cuda.require(de, "d_elem", f64, 3)
    E = vc.shape[0]
    if vc.shape[1:] != (4, 3) or de.shape != vc.shape:
        raise ValueError(f"expected [E, 4, 3] inputs, got {tuple(vc.shape)} "
                         f"and {tuple(de.shape)}")
    R = torch.empty(E, 12, dtype=f64, device=vc.device)
    K = (torch.empty(E, 12, 12, dtype=f64, device=vc.device) if tangent
         else None)
    rc = _cuda.lib().fedd_neo_hooke_p1_f64(
        vc.data_ptr(), de.data_ptr(), R.data_ptr(),
        K.data_ptr() if tangent else None, E, float(mu), float(lam),
        int(tangent), _cuda.stream_of(vc))
    _cuda.check(rc, "neo_hooke_p1")
    timers.count("kernel.neo_hooke_p1")
    return R, K


def elem_hyper_residual_tangent(vert_coords, d_elem, dim, fe_type, material,
                                params, tangent=True):
    """Batched internal forces and consistent tangents.

    vert_coords [E, dim+1, dim]; d_elem [E, nb, dim] nodal displacements.
    Returns (R [E, nb*dim], K [E, nb*dim, nb*dim]) with NodeWise dof order;
    K is None without `tangent`.  Neo-Hooke on 3D P1 elements takes the
    closed form (`neo_hooke_p1`), everything else `torch.func`
    (`autodiff_residual_tangent`).
    """
    if material == "Neo-Hooke" and fe_type == "P1" and dim == 3:
        return neo_hooke_p1(vert_coords, d_elem, *params, tangent=tangent)
    return autodiff_residual_tangent(vert_coords, d_elem, dim, fe_type,
                                     material, params, tangent)


def elem_hyper_energy(vert_coords, d_elem, dim, fe_type, material, params):
    """Total strain energy per element [E] (diagnostics)."""
    energy = material_energy(material)
    elem_energy = _element_energy_fn(dim, fe_type, energy, params,
                                     vert_coords.device)
    Binv, adet = _geometry(vert_coords)
    return vmap(elem_energy)(d_elem, Binv, adet)
