"""Batched finite-element assembly for P1/P2 simplex Laplace and the rhs.

Counterpart of the parts of feddlib_tpu/fe/assembly.py that scalar Laplace
needs: every step is batched over all elements at once — element geometry
(B, B⁻¹, det B) in closed form, element matrices by einsum over
[elements, quadrature points, basis, dims], and the global scatter through
the COO→CSR slot plan of `SparsityPattern`.  Everything is float64.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from feddlib_tpu_torch.fe import reference as ref
from feddlib_tpu_torch.la.csr import SparsityPattern

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


def elem_rhs(vert_coords, dim, fe_type, f: Callable,
             degree: Optional[int] = None):
    """Volume source ∫ f φa for a scalar field.  `f(x)` gets the physical
    quadrature points component-first, x [dim, E, nq] (so x[0] is the
    first coordinate), and returns a scalar or a tensor broadcastable to
    [E, nq].  Returns [E, nb]."""
    if degree is None:
        degree = {"P1": 2, "P2": 4}[fe_type]
    dev = vert_coords.device
    qp, qw, phi_v, _ = _tables(dim, fe_type, degree, dev)
    _, adet = element_transforms(vert_coords, dim)
    p0 = vert_coords[:, 0, :]
    B = (vert_coords[:, 1:, :] - vert_coords[:, :1, :]).transpose(1, 2)
    xq = p0[:, None, :] + torch.einsum("edk,qk->eqd", B, qp)  # [E,nq,dim]
    fq = torch.as_tensor(f(xq.permute(2, 0, 1)), dtype=f64, device=dev)
    fq = torch.broadcast_to(fq, xq.shape[:2])
    return torch.einsum("q,eq,qa->ea", qw, fq, phi_v) * adet[:, None]


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


def assemble_vector(dof_ids: np.ndarray, elem_vecs: torch.Tensor,
                    n_dofs: int) -> torch.Tensor:
    """Scatter-add element vectors [E, nloc] into a global vector."""
    idx = torch.as_tensor(np.asarray(dof_ids).reshape(-1),
                          device=elem_vecs.device)
    return torch.zeros(n_dofs, dtype=elem_vecs.dtype,
                       device=elem_vecs.device).index_add_(
        0, idx, elem_vecs.reshape(-1))
