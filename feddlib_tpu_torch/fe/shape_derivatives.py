"""Shape derivatives of the ALE Navier–Stokes residual by automatic
differentiation — the geometry-implicit (GI) FSI coupling blocks.

Counterpart of feddlib_tpu/fe/shape_derivatives.py.  The fluid element
residual is written once as a function of the element's geometry dofs,

    R_e(u_e, p_e, g_e) — momentum + continuity on the element with
        coords = ref_coords + g_e (the vertex part moves the affine map) and
        ALE convection  ρ((u − (g_e − g_prev_e)/dt)·∇)u,

and differentiated exactly: ∂R_e/∂g_e comes from `torch.func.jacfwd`
inside `torch.func.vmap` over the elements, in float64 on the device of the
inputs, in chunks of _CHUNK elements, and is scattered into the sparse
(fluid rows × geometry columns) blocks.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from feddlib_tpu_torch.fe import reference as ref
from feddlib_tpu_torch.fe.assembly import scatter_pattern, small_det, small_inv
from feddlib_tpu_torch.la.csr import CsrMatrix

f64 = torch.float64

# elements per chunk: a 3D P2 chunk's jacfwd temporaries stay below a few
# hundred MB on the card
_CHUNK = 16384


def _fluid_elem_residual(dim, fe_u, fe_p, mu, rho, dt, mass_coef):
    """Element residual factory.  Returns
    R(u_e [nb_u,dim], p_e [nb_p], g_e [nb_u,dim], gprev_e, ref_verts,
      u_old_e) → (R_u [nb_u,dim], R_p [nb_p]), with its basis tables on the
    device of ref_verts."""
    deg = max(ref.determine_degree(dim, fe_u, "conv"), 2)
    qp, qw_np = ref.quadrature(dim, deg)
    host = {"phi_u": ref.eval_phi(dim, fe_u, qp),          # [nq, nb_u]
            "dphi_u": ref.eval_grad_phi(dim, fe_u, qp),    # [nq, nb_u, dim]
            "phi_p": ref.eval_phi(dim, fe_p, qp), "qw": qw_np}
    tables = {}
    nv = dim + 1

    def on(device):
        t = tables.get(device)
        if t is None:
            t = {k: torch.as_tensor(np.asarray(v), dtype=f64, device=device)
                 for k, v in host.items()}
            tables[device] = t
        return t

    def residual(u_e, p_e, g_e, gprev_e, ref_verts, u_old_e):
        t = on(ref_verts.device)
        phi_u, dphi_u, phi_p, qw = (t["phi_u"], t["dphi_u"], t["phi_p"],
                                    t["qw"])
        verts = ref_verts + g_e[:nv]          # moved vertex coords
        B = (verts[1:] - verts[:1]).transpose(0, 1)
        detB = small_det(B)
        adet = torch.abs(detB)
        Binv = small_inv(B, detB)
        gu = torch.einsum("dk,qbd->qbk", Binv, dphi_u)  # [nq, nb, dim]
        w_e = (g_e - gprev_e) / dt                       # mesh velocity
        u_q = torch.einsum("qb,bi->qi", phi_u, u_e)
        w_q = torch.einsum("qb,bi->qi", phi_u, w_e)
        uold_q = torch.einsum("qb,bi->qi", phi_u, u_old_e)
        grad_u = torch.einsum("bi,qbk->qik", u_e, gu)   # ∂k u_i
        p_q = torch.einsum("qb,b->q", phi_p, p_e)
        div_u = torch.diagonal(grad_u, dim1=1, dim2=2).sum(-1)

        conv = torch.einsum("qk,qik->qi", u_q - w_q, grad_u) * rho
        # ALE additional convection −ρ(∇·w) u·φ
        div_w = torch.einsum("bi,qbi->q", w_e, gu)
        # momentum: μ ∇u:∇φ + ρ((u−w)·∇u)·φ − ρ(∇·w)u·φ − p div φ
        #           + mass_coef ρ(u−uold)·φ
        Ru = (mu * torch.einsum("q,qik,qak->ai", qw, grad_u, gu)
              + torch.einsum("q,qi,qa->ai", qw, conv, phi_u)
              - rho * torch.einsum("q,q,qi,qa->ai", qw, div_w, u_q, phi_u)
              - torch.einsum("q,q,qai->ai", qw, p_q, gu)
              + mass_coef * rho * torch.einsum("q,qi,qa->ai", qw,
                                               u_q - uold_q, phi_u))
        Rp = -torch.einsum("q,q,qa->a", qw, div_u, phi_p)
        return Ru * adet, Rp * adet

    return residual


def elem_shape_derivative(u_elem, p_elem, g_elem, gprev_elem, ref_verts,
                          uold_elem, dim, fe_u, fe_p, mu, rho, dt,
                          mass_coef):
    """Batched ∂(R_u, R_p)/∂g_e.  Returns (Du [E, nb_u·dim, nb_u·dim],
    Dp [E, nb_p, nb_u·dim]) — fluid-row × geometry-col element blocks."""
    res = _fluid_elem_residual(dim, fe_u, fe_p, mu, rho, dt, mass_coef)

    def per_elem(u_e, p_e, g_e, gp_e, rv, uo_e):
        def f(gflat):
            Ru, Rp = res(u_e, p_e, gflat.reshape(g_e.shape), gp_e, rv, uo_e)
            return torch.cat([Ru.reshape(-1), Rp])

        J = jacfwd(f)(g_e.reshape(-1))
        nbu = u_e.shape[0] * u_e.shape[1]
        return J[:nbu], J[nbu:]

    return vmap(per_elem)(u_elem, p_elem, g_elem, gprev_elem, ref_verts,
                          uold_elem)


def _as(vec, device):
    return torch.as_tensor(vec, dtype=f64, device=device)


def assemble_shape_derivative_blocks(dom_u, dom_p, u, p, g, g_prev, u_old,
                                     mu, rho, dt, mass_coef=0.0
                                     ) -> Tuple[CsrMatrix, CsrMatrix]:
    """Assemble the sparse GI blocks D_ug = ∂F_u/∂g and D_pg = ∂F_p/∂g on
    dom_u's device.  u, g, g_prev, u_old are NodeWise fields on dom_u, p
    on dom_p (tensors or arrays).  The element geometry is the REFERENCE
    configuration (mesh.ref_points, else the points); the current one
    enters through g."""
    dim = dom_u.dim
    dev = dom_u.device
    conn_u = torch.as_tensor(dom_u.elem_nodes(), device=dev)
    conn_p = torch.as_tensor(dom_p.elem_nodes(), device=dev)
    nv = dim + 1
    ref_pts = dom_u.mesh.ref_points if dom_u.mesh.ref_points is not None \
        else dom_u.mesh.points
    ref_verts = _as(ref_pts[dom_u.mesh.elements[:, :nv]], dev)

    def field(vec):
        return _as(vec, dev).reshape(dom_u.n_nodes, dim)[conn_u]

    u_e, g_e, gp_e, uo_e = field(u), field(g), field(g_prev), field(u_old)
    p_e = _as(p, dev)[conn_p]

    E = conn_u.shape[0]
    Du_l, Dp_l = [], []
    for s in range(0, E, _CHUNK):
        sl = slice(s, s + _CHUNK)
        Du, Dp = elem_shape_derivative(
            u_e[sl], p_e[sl], g_e[sl], gp_e[sl], ref_verts[sl], uo_e[sl],
            dim, dom_u.fe_type, dom_p.fe_type, float(mu), float(rho),
            float(dt), float(mass_coef))
        Du_l.append(Du.reshape(-1))
        Dp_l.append(Dp.reshape(-1))

    udofs = dom_u.elem_dofs(dim)
    pdofs = dom_p.elem_nodes()
    n_u, n_p = dom_u.n_dofs(dim), dom_p.n_dofs(1)
    pat_u = dom_u.pattern(("shape_u", dim), lambda: scatter_pattern(
        udofs, udofs, n_u, n_u))
    pat_p = dom_p.pattern(("shape_p", id(dom_u)), lambda: scatter_pattern(
        pdofs, udofs, n_p, n_u))
    Dug = CsrMatrix(pat_u, device=dev)
    Dug.assemble(torch.cat(Du_l))
    Dpg = CsrMatrix(pat_p, device=dev)
    Dpg.assemble(torch.cat(Dp_l))
    return Dug, Dpg
