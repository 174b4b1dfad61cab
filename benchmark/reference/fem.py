"""Plain finite elements on P1 tetrahedra, in PyTorch, in any dtype and on
any device: the reference that decides `correct`.

Written from the equations, not from the program (it imports nothing of
`feddlib_tpu_torch`, `feddlib_tpu` or JAX, and takes no array the program
made):

- Laplace: K_e = |T| G G^T, G the gradients of the four barycentric
  functions; Dirichlet rows are identity rows (the solution's value).
- Vector mass: M_e[a, b] = |T| (1 + delta_ab) / 20 in each component.
- Body force of constant density d: |T| d / 4 on each corner.
- Compressible Neo-Hooke, W = mu/2 (I1 - 3) - mu ln J + lam/2 (ln J)^2,
  total Lagrangian, one deformation gradient F = I + sum_a u_a (x) g_a per
  element:  P = mu F + (lam ln J - mu) F^-T,
  R_e[a, i] = |T| P_iJ g_aJ,  and with h_a = g_a F^-1
  K_e[a, i, b, k] = |T| (mu delta_ik g_a.g_b + (mu - lam ln J) h_b,i h_a,k
                         + lam h_a,i h_b,k).
"""

from __future__ import annotations

import warnings

import torch

_REF_GRADS = ((-1.0, -1.0, -1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
              (0.0, 0.0, 1.0))


class P1Mesh:
    """Element geometry of a tetrahedral mesh: `grads` [E, 4, 3] and `vol`
    [E], on `device` in `dtype`."""

    def __init__(self, points, elements, dtype=torch.float64, device="cpu"):
        self.dtype, self.device = dtype, torch.device(device)
        self.n_nodes = int(points.shape[0])
        self.elements = torch.as_tensor(elements, device=self.device)
        X = torch.as_tensor(points, dtype=torch.float64,
                            device=self.device)[self.elements]
        B = (X[:, 1:] - X[:, :1]).transpose(1, 2)  # columns: the edges
        ref = torch.tensor(_REF_GRADS, dtype=torch.float64,
                           device=self.device)
        self.grads = (ref @ torch.linalg.inv(B)).to(dtype)
        self.vol = (torch.linalg.det(B).abs() / 6.0).to(dtype)

    def scatter(self, elem_vals: torch.Tensor) -> torch.Tensor:
        """Sum element values [E, 4, c] into nodes [n_nodes, c]."""
        c = elem_vals.shape[-1]
        out = torch.zeros(self.n_nodes, c, dtype=elem_vals.dtype,
                          device=self.device)
        out.index_add_(0, self.elements.reshape(-1), elem_vals.reshape(-1, c))
        return out

    def sparse(self, elem_mats: torch.Tensor, d: int) -> torch.Tensor:
        """Global CSR matrix from element matrices [E, 4d, 4d] whose local
        dof a*d + i is node a's component i (global id node*d + i)."""
        E = self.elements.shape[0]
        dof = (self.elements[:, :, None] * d
               + torch.arange(d, device=self.device)).reshape(E, 4 * d)
        rows = dof[:, :, None].expand(E, 4 * d, 4 * d).reshape(-1)
        cols = dof[:, None, :].expand(E, 4 * d, 4 * d).reshape(-1)
        n = self.n_nodes * d
        with warnings.catch_warnings():  # torch's notes on sparse tensors
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_coo_tensor(
                torch.stack([rows, cols]), elem_mats.reshape(-1), (n, n),
                check_invariants=False).coalesce().to_sparse_csr()


def matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x.unsqueeze(1)).squeeze(1)


def with_dirichlet(y: torch.Tensor, x: torch.Tensor, dirichlet) -> torch.Tensor:
    """y with identity rows on the Dirichlet dofs: y[D] = x[D]."""
    return torch.where(dirichlet, x, y)


# -- Laplace -------------------------------------------------------------------

def laplace_matrix(m: P1Mesh) -> torch.Tensor:
    """The P1 stiffness matrix without boundary rows applied."""
    K = m.vol[:, None, None] * (m.grads @ m.grads.transpose(1, 2))
    return m.sparse(K, 1)


def laplace_relres(A, dirichlet, b, x) -> float:
    """||b - A x|| / ||b|| with identity rows on the Dirichlet dofs."""
    r = b - with_dirichlet(matvec(A, x), x, dirichlet)
    return float(torch.linalg.norm(r) / torch.linalg.norm(b))


# -- elasticity ----------------------------------------------------------------

def mass_matrix(m: P1Mesh, d: int = 3) -> torch.Tensor:
    """The consistent P1 mass matrix of a d-vector field."""
    eye4 = torch.eye(4, dtype=m.dtype, device=m.device)
    M = (m.vol[:, None, None] / 20.0) * (1.0 + eye4)
    eyed = torch.eye(d, dtype=m.dtype, device=m.device)
    full = torch.einsum("eab,ij->eaibj", M, eyed).reshape(-1, 4 * d, 4 * d)
    return m.sparse(full, d)


def body_force(m: P1Mesh, density) -> torch.Tensor:
    """Nodal loads [n_nodes * 3] of a constant body force density."""
    d = torch.as_tensor(density, dtype=m.dtype, device=m.device)
    e = (m.vol[:, None, None] / 4.0) * d.expand(m.vol.shape[0], 4, 3)
    return m.scatter(e).reshape(-1)


def _kinematics(m: P1Mesh, u: torch.Tensor):
    ue = u.reshape(m.n_nodes, 3)[m.elements]  # [E, 4, 3]
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    F = eye + torch.einsum("eai,eaj->eij", ue, m.grads)
    Finv = torch.linalg.inv(F)
    lnJ = torch.log(torch.linalg.det(F))
    h = torch.einsum("eaj,ejk->eak", m.grads, Finv)  # h_a = g_a F^-1
    return F, lnJ, h


def neo_hooke_force(m: P1Mesh, u: torch.Tensor, mu: float, lam: float
                    ) -> torch.Tensor:
    """Internal forces [n_nodes * 3] at displacement u [n_nodes * 3]."""
    F, lnJ, h = _kinematics(m, u)
    Fg = torch.einsum("eij,eaj->eai", F, m.grads)
    R = m.vol[:, None, None] * (mu * Fg + (lam * lnJ - mu)[:, None, None] * h)
    return m.scatter(R).reshape(-1)


def neo_hooke_tangent(m: P1Mesh, u: torch.Tensor, mu: float, lam: float
                      ) -> torch.Tensor:
    """The consistent tangent (CSR) at displacement u."""
    _, lnJ, h = _kinematics(m, u)
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    G = torch.einsum("eaj,ebj->eab", m.grads, m.grads)
    K = (mu * torch.einsum("eab,ik->eaibk", G, eye)
         + (mu - lam * lnJ)[:, None, None, None, None]
         * torch.einsum("ebi,eak->eaibk", h, h)
         + lam * torch.einsum("eai,ebk->eaibk", h, h))
    K = m.vol[:, None, None, None, None] * K
    return m.sparse(K.reshape(-1, 12, 12), 3)


def lame(E: float, nu: float):
    return E / (2.0 * (1.0 + nu)), nu * E / ((1.0 + nu) * (1.0 - 2.0 * nu))
