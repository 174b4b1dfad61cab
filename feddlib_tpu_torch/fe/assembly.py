"""Batched finite-element assembly on P1/P2 simplices: Laplace, mass, linear
elasticity, the Navier–Stokes convection and Newton terms, the mixed
divergence, the Bochev–Dohrmann stabilization, volume and surface loads.

Counterpart of the simplex parts of feddlib_tpu/fe/assembly.py: every step is batched over all elements at once — element geometry
(B, B⁻¹, det B) in closed form, element matrices by einsum over
[elements, quadrature points, basis, dims], and the global scatter through
the COO→CSR slot plan of `SparsityPattern`.  Everything is float64.

Source and load functions get the quadrature points component-first,
x [dim, E, nq] (so x[0] is the first coordinate), where the JAX package
maps a per-point function over the points.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from feddlib_tpu_torch.fe import reference as ref
from feddlib_tpu_torch.la.csr import CsrMatrix, SparsityPattern, scatter_sum

f64 = torch.float64


# ---------------------------------------------------------------------------
# element geometry
# ---------------------------------------------------------------------------

def small_det(B: torch.Tensor) -> torch.Tensor:
    """Batched det of [..., d, d] for d ∈ {2, 3} in closed form."""
    d = B.shape[-1]
    if d == 2:
        return B[..., 0, 0] * B[..., 1, 1] - B[..., 0, 1] * B[..., 1, 0]
    if d == 3:
        return (
            B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
        )
    raise ValueError(f"small_det supports d in (2,3), got {d}")


def small_inv(B: torch.Tensor, det: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Batched cofactor inverse of [..., d, d], d ∈ {2, 3}."""
    d = B.shape[-1]
    if det is None:
        det = small_det(B)
    inv_det = 1.0 / det
    if d == 2:
        a, b = B[..., 0, 0], B[..., 0, 1]
        c, e = B[..., 1, 0], B[..., 1, 1]
        rows = torch.stack([
            torch.stack([e, -b], -1),
            torch.stack([-c, a], -1),
        ], -2)
        return rows * inv_det[..., None, None]
    if d == 3:
        m = B
        c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
        c01 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
        c02 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
        c10 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
        c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
        c12 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
        c20 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
        c21 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
        c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        rows = torch.stack([
            torch.stack([c00, c01, c02], -1),
            torch.stack([c10, c11, c12], -1),
            torch.stack([c20, c21, c22], -1),
        ], -2)
        return rows * inv_det[..., None, None]
    raise ValueError(f"small_inv supports d in (2,3), got {d}")


def element_transforms(vert_coords: torch.Tensor, dim: int):
    """vert_coords [E, dim+1, dim] → (Binv [E, dim, dim], |det B| [E]) for
    the affine maps x = B ξ + p0, B columns p_i − p0."""
    p0 = vert_coords[:, :1, :]
    B = (vert_coords[:, 1:, :] - p0).transpose(1, 2)  # [E, dim, dim]
    detB = small_det(B)
    return small_inv(B, detB), detB.abs()


def _phys_grads(Binv, dphi_ref):
    # [E,dim,dim] x [nq,nb,dim] -> [E,nq,nb,dim];  (Binv^T g)_k = g_d Binv[d,k]
    return torch.einsum("edk,qbd->eqbk", Binv, dphi_ref)


def _tables(dim, fe_type, degree, device):
    qp, qw = ref.quadrature(dim, degree)
    phi = ref.eval_phi(dim, fe_type, qp)
    dphi = ref.eval_grad_phi(dim, fe_type, qp)
    return tuple(torch.as_tensor(np.asarray(a), dtype=f64, device=device)
                 for a in (qp, qw, phi, dphi))


# ---------------------------------------------------------------------------
# element kernels (element matrices [E, nb, nb] or vectors [E, nb])
# ---------------------------------------------------------------------------

def elem_laplace(vert_coords, dim, fe_type):
    """Scalar stiffness ∫ ∇φa·∇φb."""
    _, qw, _, dphi = _tables(dim, fe_type,
                             ref.determine_degree(dim, fe_type, "grad"),
                             vert_coords.device)
    Binv, adet = element_transforms(vert_coords, dim)
    g = _phys_grads(Binv, dphi)  # [E,nq,nb,dim]
    K = torch.einsum("q,eqak,eqbk->eab", qw, g, g)
    return K * adet[:, None, None]


def elem_mass(vert_coords, dim, fe_type):
    """Scalar mass ∫ φa φb."""
    _, qw, phi, _ = _tables(dim, fe_type,
                            ref.determine_degree(dim, fe_type, "phi"),
                            vert_coords.device)
    _, adet = element_transforms(vert_coords, dim)
    M = torch.einsum("q,qa,qb->ab", qw, phi, phi)
    return M[None] * adet[:, None, None]


def elem_stress_sym(vert_coords, dim, fe_type, viscosity=1.0):
    """Symmetric-gradient (stress) form 2μ ∫ ε(u):ε(v) as a vector-valued
    element matrix [E, nb, nb, dim, dim]: entry (a,b,i,j) couples test
    component i with trial component j.  For u = φb e_j, v = φa e_i:
    2 ε(u):ε(v) = ∂i φb ∂j φa + δij ∇φa·∇φb."""
    _, qw, _, dphi = _tables(dim, fe_type,
                             ref.determine_degree(dim, fe_type, "grad"),
                             vert_coords.device)
    Binv, adet = element_transforms(vert_coords, dim)
    g = _phys_grads(Binv, dphi)  # [E,nq,nb,dim]
    gg = torch.einsum("q,eqak,eqbk->eab", qw, g, g)
    cross = torch.einsum("q,eqaj,eqbi->eabij", qw, g, g)  # ∂j φa ∂i φb
    eye = torch.eye(dim, dtype=f64, device=vert_coords.device)
    S = viscosity * (cross + torch.einsum("eab,ij->eabij", gg, eye))
    return S * adet[:, None, None, None, None]


def elem_laplace_vec(vert_coords, dim, fe_type, viscosity=1.0):
    """Vector Laplace μ ∫ ∇u:∇v → diagonal dim-blocks of the scalar
    stiffness, [E, nb, nb, dim, dim]."""
    K = elem_laplace(vert_coords, dim, fe_type) * viscosity
    eye = torch.eye(dim, dtype=f64, device=vert_coords.device)
    return torch.einsum("eab,ij->eabij", K, eye)


def elem_advection(vert_coords, u_elem, dim, fe_type):
    """Convection N(u): ∫ (u·∇φb) φa with u the FE field on the same space.
    u_elem [E, nb, dim] nodal velocity values per element; returns
    [E, nb, nb]."""
    _, qw, phi, dphi = _tables(dim, fe_type,
                               ref.determine_degree(dim, fe_type, "conv"),
                               vert_coords.device)
    Binv, adet = element_transforms(vert_coords, dim)
    g = _phys_grads(Binv, dphi)  # [E,nq,nb,dim]
    u_q = torch.einsum("qb,ebd->eqd", phi, u_elem)  # u at quad points
    N = torch.einsum("q,eqd,eqbd,qa->eab", qw, u_q, g, phi)
    return N * adet[:, None, None]


def elem_ale_divergence(vert_coords, w_elem, dim, fe_type):
    """ALE additional convection ∫ (∇·w) φa φb with w the discrete mesh
    velocity on the same space; the caller expands it to the identity over
    velocity components and scales it by −density, as FSI does.
    w_elem [E, nb, dim] nodal mesh-velocity values; returns [E, nb, nb]."""
    _, qw, phi, dphi = _tables(dim, fe_type,
                               ref.determine_degree(dim, fe_type, "conv"),
                               vert_coords.device)
    Binv, adet = element_transforms(vert_coords, dim)
    g = _phys_grads(Binv, dphi)  # [E,nq,nb,dim]
    div_w = torch.einsum("ebd,eqbd->eq", w_elem, g)  # Σ_b w_b·∇φb
    D = torch.einsum("q,eq,qa,qb->eab", qw, div_w, phi, phi)
    return D * adet[:, None, None]


def elem_advection_in_u(vert_coords, u_elem, dim, fe_type):
    """Newton linearisation W(u): ∫ φa φb ∂u_i/∂x_j — the (∇u)·δu term, a
    dim×dim block per (a, b).  Returns [E, nb, nb, dim, dim]."""
    _, qw, phi, dphi = _tables(dim, fe_type,
                               ref.determine_degree(dim, fe_type, "conv"),
                               vert_coords.device)
    Binv, adet = element_transforms(vert_coords, dim)
    g = _phys_grads(Binv, dphi)
    grad_u = torch.einsum("ebi,eqbj->eqij", u_elem, g)  # [E,nq,dim,dim]
    W = torch.einsum("q,qa,qb,eqij->eabij", qw, phi, phi, grad_u)
    return W * adet[:, None, None, None, None]


def elem_divergence(vert_coords, dim, fe_u, fe_p):
    """Mixed divergence blocks B[a, (b, j)] = −∫ ψa ∂_j φb (pressure test
    ψ, velocity trial φ).  Returns [E, nb_p, nb_u, dim]."""
    deg = max(ref.determine_degree(dim, fe_u, "grad"),
              ref.determine_degree(dim, fe_p, "phi"))
    qp, qw = ref.quadrature(dim, deg)
    psi, dphi, qw = (torch.as_tensor(np.asarray(a), dtype=f64,
                                     device=vert_coords.device)
                     for a in (ref.eval_phi(dim, fe_p, qp),
                               ref.eval_grad_phi(dim, fe_u, qp), qw))
    Binv, adet = element_transforms(vert_coords, dim)
    g = _phys_grads(Binv, dphi)  # [E,nq,nb_u,dim]
    B = -torch.einsum("q,qa,eqbj->eabj", qw, psi, g)
    return B * adet[:, None, None, None]


def elem_bd_stabilization(vert_coords, dim, fe_type):
    """Bochev–Dohrmann P1–P1 pressure stabilization
    C = −∫ (ψa − Π ψa)(ψb − Π ψb), Π the element-mean projector.  Returns
    [E, nb, nb]."""
    _, qw, phi, _ = _tables(dim, fe_type,
                            ref.determine_degree(dim, fe_type, "phi"),
                            vert_coords.device)
    _, adet = element_transforms(vert_coords, dim)
    vol_ref = qw.sum()
    mean = torch.einsum("q,qa->a", qw, phi) / vol_ref
    M = torch.einsum("q,qa,qb->ab", qw, phi, phi)
    C = M - vol_ref * torch.outer(mean, mean)
    return -C[None] * adet[:, None, None]


def elem_lin_elasticity(vert_coords, dim, fe_type, mu=1.0, lam=1.0):
    """Linear elasticity 2μ ε(u):ε(v) + λ div u div v →
    [E, nb, nb, dim, dim]."""
    S = elem_stress_sym(vert_coords, dim, fe_type, viscosity=mu)
    _, qw, _, dphi = _tables(dim, fe_type,
                             ref.determine_degree(dim, fe_type, "grad"),
                             vert_coords.device)
    Binv, adet = element_transforms(vert_coords, dim)
    g = _phys_grads(Binv, dphi)
    # div term: ∫ (∂i φa)(∂j φb) for (test comp i, trial comp j)
    div = torch.einsum("q,eqai,eqbj->eabij", qw, g, g)
    return S + lam * div * adet[:, None, None, None, None]


def _eval_source(f: Callable, xq: torch.Tensor, n_comp: int) -> torch.Tensor:
    """f at the points xq [E, nq, dim] → [E, nq] (n_comp == 1) or
    [E, nq, n_comp].  f gets x component-first [dim, E, nq].  A scalar
    field returns a scalar or something broadcastable to [E, nq]; a vector
    field returns one value per component — a sequence or a tensor whose
    first axis has n_comp entries, each a scalar or broadcastable to
    [E, nq]."""
    fq = f(xq.permute(2, 0, 1))
    shape = xq.shape[:2]

    def at_points(v):
        return torch.broadcast_to(
            torch.as_tensor(v, dtype=f64, device=xq.device), shape)

    if n_comp == 1:
        return at_points(fq)
    if len(fq) != n_comp:
        raise ValueError(f"source returned {len(fq)} components for a "
                         f"field of {n_comp}")
    return torch.stack([at_points(v) for v in fq], dim=-1)


def elem_rhs(vert_coords, dim, fe_type, f: Callable,
             degree: Optional[int] = None, n_comp: int = 1):
    """Volume source ∫ f φa (see _eval_source for f's contract).  Returns
    [E, nb] or, for n_comp > 1, [E, nb, n_comp]."""
    if degree is None:
        degree = {"P1": 2, "P2": 4}[fe_type]
    dev = vert_coords.device
    qp, qw, phi_v, _ = _tables(dim, fe_type, degree, dev)
    _, adet = element_transforms(vert_coords, dim)
    p0 = vert_coords[:, 0, :]
    B = (vert_coords[:, 1:, :] - vert_coords[:, :1, :]).transpose(1, 2)
    xq = p0[:, None, :] + torch.einsum("edk,qk->eqd", B, qp)  # [E,nq,dim]
    fq = _eval_source(f, xq, n_comp)
    if fq.dim() == 2:
        return torch.einsum("q,eq,qa->ea", qw, fq, phi_v) * adet[:, None]
    return (torch.einsum("q,eqc,qa->eac", qw, fq, phi_v)
            * adet[:, None, None])


def elem_surface_rhs(surf_coords, dim, fe_type, g: Callable,
                     degree: int = 3, n_comp: int = 1):
    """Neumann surface load ∫_Γ g φa over boundary entities.
    surf_coords [S, n_surf_nodes, dim] (vertices first); the surface
    reference element is the (dim−1)-simplex.  Returns [S, nb_surf]
    (n_comp == 1) or [S, nb_surf, n_comp]."""
    sdim = dim - 1
    dev = surf_coords.device
    qp, qw = ref.quadrature(sdim, degree) if sdim == 2 else _line_quad(degree)
    phi_v = (ref.eval_phi(sdim, fe_type, qp) if sdim == 2
             else _line_phi(fe_type, qp))
    qp, qw, phi_v = (torch.as_tensor(np.asarray(a), dtype=f64, device=dev)
                     for a in (qp, qw, phi_v))
    p0 = surf_coords[:, 0, :]
    T = (surf_coords[:, 1:sdim + 1, :] - surf_coords[:, :1, :]).transpose(1, 2)
    # surface Jacobian norm: sqrt(det(TᵀT))
    G = torch.einsum("edk,edl->ekl", T, T)
    detG = G[..., 0, 0] if sdim == 1 else small_det(G)
    jac = torch.sqrt(detG.abs())
    xq = p0[:, None, :] + torch.einsum("edk,qk->eqd", T, qp)
    gq = _eval_source(g, xq, n_comp)
    if gq.dim() == 2:
        return torch.einsum("q,eq,qa->ea", qw, gq, phi_v) * jac[:, None]
    return torch.einsum("q,eqc,qa->eac", qw, gq, phi_v) * jac[:, None, None]


def _line_quad(degree):
    n = degree // 2 + 1
    x, w = np.polynomial.legendre.leggauss(n)
    return (0.5 * (x[:, None] + 1)), 0.5 * w


def _line_phi(fe_type, qp):
    x = np.atleast_2d(qp)[:, 0]
    if fe_type == "P1":
        return np.stack([1 - x, x], axis=1)
    if fe_type == "P2":
        return np.stack([(1 - x) * (1 - 2 * x), x * (2 * x - 1),
                         4 * x * (1 - x)], axis=1)
    raise ValueError(fe_type)


# ---------------------------------------------------------------------------
# scatter plans: element matrices → global CSR
# ---------------------------------------------------------------------------

def vector_dof_ids(elem_nodes: np.ndarray, dofs_per_node: int) -> np.ndarray:
    """NodeWise dof ordering: dof = node*dpn + c → [E, nb*dpn]."""
    e = (elem_nodes[:, :, None] * dofs_per_node
         + np.arange(dofs_per_node)[None, None, :])
    return e.reshape(elem_nodes.shape[0], -1)


def scatter_pattern(row_dofs: np.ndarray, col_dofs: np.ndarray,
                    n_rows: int, n_cols: int) -> SparsityPattern:
    """Sparsity pattern for element-matrix scatter.  row_dofs [E, nr],
    col_dofs [E, nc]; COO order is (element, test, trial) row-major, matching
    `elem_mat.reshape(-1)`."""
    E, nr = row_dofs.shape
    nc = col_dofs.shape[1]
    rows = np.broadcast_to(row_dofs[:, :, None], (E, nr, nc)).ravel()
    cols = np.broadcast_to(col_dofs[:, None, :], (E, nr, nc)).ravel()
    return SparsityPattern.from_coo(rows, cols, n_rows, n_cols)


def assemble_matrix(pattern: SparsityPattern,
                    elem_mats: torch.Tensor) -> CsrMatrix:
    """The CSR matrix of element matrices [E, nr, nc] scattered through
    `pattern` (`scatter_pattern`), on the element matrices' device (in a
    fixed order on the card: `CsrMatrix.assemble`)."""
    m = CsrMatrix(pattern, device=elem_mats.device)
    m.assemble(elem_mats.reshape(-1))
    return m


def vectorize_elem_mat(elem_mat_blocks: torch.Tensor) -> torch.Tensor:
    """[E, nb_r, nb_c, dim_r, dim_c] → [E, nb_r*dim_r, nb_c*dim_c] with
    NodeWise interleaving (node-major, component-minor)."""
    E, nr, nc, dr, dc = elem_mat_blocks.shape
    return elem_mat_blocks.permute(0, 1, 3, 2, 4).reshape(E, nr * dr, nc * dc)


def assemble_vector(dof_ids, elem_vecs: torch.Tensor,
                    n_dofs: int) -> torch.Tensor:
    """Scatter-add element vectors [E, nloc] (node ids) or [E, nloc, comp]
    (NodeWise dofs node*comp + c) into a global vector (in a fixed order
    on the card: `la.csr.scatter_sum`).  `dof_ids` is a host array, or an
    int64 tensor on the vectors' device with one id per value of
    `elem_vecs` (`Domain.device_dofs`), which is used as it is."""
    if isinstance(dof_ids, torch.Tensor):
        return scatter_sum(elem_vecs.reshape(-1), dof_ids.reshape(-1),
                           n_dofs)
    ids = np.asarray(dof_ids)
    if elem_vecs.dim() == 3:
        c = elem_vecs.shape[2]
        ids = ids[:, :, None] * c + np.arange(c)[None, None, :]
    idx = torch.as_tensor(ids.reshape(-1), device=elem_vecs.device)
    return scatter_sum(elem_vecs.reshape(-1), idx, n_dofs)
