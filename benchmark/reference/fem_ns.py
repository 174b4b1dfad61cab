"""Plain Taylor–Hood (P2 velocity, P1 pressure) tetrahedra for steady
incompressible Navier–Stokes, in PyTorch, in any dtype and on any device:
the reference that decides `correct` for the cavity cell.

Written from the equations, not from the program (it imports nothing of
`feddlib_tpu_torch`, `feddlib_tpu` or JAX, and takes no array the program
made):

- Nodes: `fem_p2.P2Mesh`'s P2 numbering for the velocity (the P1 vertices
  first, then one midpoint per edge); the pressure lives on the vertices,
  in the P1 mesh's order.  Dofs: velocity node * 3 + component, then the
  pressures.  Another numbering reaches this one by the nodes' keys on the
  half-step lattice (`fem_p2.lattice_keys`).
- With viscosity nu and density rho, the residual at (u, p) is
      F_u = nu K u + rho N(u) u + B^T p,   F_p = B u,
  K the vector Laplacian (int grad u : grad v), N(u) the convection
  int ((u . grad) w) . v, B = -(div u, q); the Newton Jacobian adds
  rho W(u), int ((w . grad) u) . v, to the velocity block.
- Dirichlet rows are identity rows: every boundary velocity dof is fixed,
  the residual there is u - g, and the pressure is free.
- Integrals by a conical (Stroud) product rule of 27 points, exact to
  degree 5, the highest of these integrands (u . grad w . v: 2 + 1 + 2).

Departures from the source (FEDDLib `problems/tests/steadyNavierStokes`):

- the geometry: the lid-driven unit cube, u = (1, 0, 0) on z = 1 (the
  lid's edges included) and u = 0 on the other walls, in place of the DFG
  cylinder channel, whose mesh this repository does not have;
- Re 100 (nu = 0.01, rho = 1, lid speed 1, unit cube);
- no pressure mean or pin: the Jacobian keeps the constant pressure in its
  null space, which no check here needs to remove (each judges a
  residual).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from benchmark import inputs
from benchmark.reference import fem_p2


def conical_rule(n: int = 3):
    """(barycentric points [n^3, 4], weights [n^3] summing to 1) of the
    Stroud conical product rule on a tetrahedron, exact to degree 2n - 1:
    Gauss–Jacobi points of weights (1 - a)^2 and (1 - b) and Gauss–Legendre
    points, mapped by x = a, y = b (1 - a), z = c (1 - a)(1 - b)."""
    from scipy.special import roots_jacobi

    axes = []
    for alpha in (2.0, 1.0, 0.0):
        t, w = roots_jacobi(n, alpha, 0.0)
        axes.append(((t + 1.0) / 2.0, w / 2.0 ** (alpha + 1.0)))
    (a, wa), (b, wb), (c, wc) = axes
    A, B, C = np.meshgrid(a, b, c, indexing="ij")
    W = np.einsum("i,j,k->ijk", wa, wb, wc).ravel()
    x, y = A.ravel(), (B * (1.0 - A)).ravel()
    z = (C * (1.0 - A) * (1.0 - B)).ravel()
    lam = np.stack([1.0 - x - y - z, x, y, z], axis=1)
    return lam, W / W.sum()


class Cavity:
    """The Re-`1 / nu` lid-driven cavity on the unit cube's `cells`^3 mesh of
    `inputs.cube_mesh`: its P2 nodes `m`, the dof counts `n_u` and `n_p`,
    the Dirichlet dofs `D` and values `g` (over all dofs), and the element
    tables of the quadrature."""

    def __init__(self, cells: int, viscosity: float, density: float = 1.0,
                 lid_velocity=(1.0, 0.0, 0.0), dtype=torch.float64,
                 device="cpu"):
        if torch.device(device).type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        points, elements = inputs.cube_mesh(cells)
        self.cells = int(cells)
        self.nu, self.rho = float(viscosity), float(density)
        self.m = m = fem_p2.P2Mesh(points, elements, cells, dtype=dtype,
                                   device=device)
        self.dtype, self.device = dtype, m.device
        self.n_p = int(points.shape[0])
        self.n_u = 3 * m.n_nodes
        self.n = self.n_u + self.n_p
        k = 2 * self.cells
        ijk = np.rint(m.points * k).astype(np.int64)
        wall = ((ijk == 0) | (ijk == k)).any(axis=1)
        lid = ijk[:, 2] == k
        g = np.zeros((m.n_nodes, 3))
        g[lid] = np.asarray(lid_velocity, dtype=np.float64)
        self.D = torch.as_tensor(np.concatenate(
            [np.repeat(wall, 3), np.zeros(self.n_p, bool)]), device=m.device)
        self.g = torch.as_tensor(np.concatenate(
            [g.reshape(-1), np.zeros(self.n_p)]), dtype=dtype,
            device=m.device)
        # element tables at the quadrature points
        lam_np, w_np = conical_rule(3)
        g1 = fem_p2.fem.P1Mesh(points, elements, dtype=torch.float64,
                               device=m.device).grads  # [E, 4, 3]
        lam = torch.as_tensor(lam_np, device=m.device)
        phi, dphi = [], []
        for q in range(lam.shape[0]):
            l = lam[q]
            corner = l * (2.0 * l - 1.0)
            edge = torch.stack([4.0 * l[i] * l[j] for i, j in fem_p2.EDGES])
            phi.append(torch.cat([corner, edge]))
            dc = (4.0 * l - 1.0)[None, :, None] * g1
            de = torch.stack([4.0 * (l[i] * g1[:, j] + l[j] * g1[:, i])
                              for i, j in fem_p2.EDGES], dim=1)
            dphi.append(torch.cat([dc, de], dim=1))
        self.phi = torch.stack(phi).to(dtype)    # [Q, 10]
        self.psi = lam.to(dtype)                 # [Q, 4]
        self.dphi = torch.stack(dphi).to(dtype)  # [Q, E, 10, 3]
        # quadrature weight times element volume, [Q, E]
        self.wv = (torch.as_tensor(w_np, device=m.device)[:, None]
                   * m.vol.to(torch.float64)[None, :]).to(dtype)
        E = m.elements.shape[0]
        self.udof = (m.elements[:, :, None] * 3
                     + torch.arange(3, device=m.device)).reshape(E, 30)
        self.pdof = self.n_u + m.elements[:, :4]

    # -- element integrals -----------------------------------------------------
    def _velocity_block(self, u: torch.Tensor, newton: bool) -> torch.Tensor:
        """[E, 30, 30]: nu K + rho N(u) (+ rho W(u)) of each element."""
        ue = u.reshape(-1, 3)[self.m.elements]  # [E, 10, 3]
        E = ue.shape[0]
        S = torch.zeros(E, 10, 10, dtype=self.dtype, device=self.device)
        Wm = torch.zeros(E, 10, 3, 10, 3, dtype=self.dtype,
                         device=self.device)
        for q in range(self.phi.shape[0]):
            wv, ph, dp = self.wv[q], self.phi[q], self.dphi[q]
            uq = torch.einsum("b,ebi->ei", ph, ue)
            conv = torch.einsum("ei,ebi->eb", uq, dp)  # u . grad phi_b
            S += wv[:, None, None] * (
                self.nu * torch.einsum("eai,ebi->eab", dp, dp)
                + self.rho * ph[None, :, None] * conv[:, None, :])
            if newton:
                gu = torch.einsum("ebi,ebj->eij", ue, dp)  # du_i / dx_j
                Wm += (self.rho * wv)[:, None, None, None, None] * torch.einsum(
                    "a,b,eij->eaibj", ph, ph, gu)
        eye = torch.eye(3, dtype=self.dtype, device=self.device)
        out = torch.einsum("eab,ij->eaibj", S, eye)
        if newton:
            out = out + Wm
        return out.reshape(E, 30, 30)

    def _divergence(self) -> torch.Tensor:
        """[E, 4, 30]: B = -int q div u of each element."""
        E = self.m.elements.shape[0]
        B = torch.zeros(E, 4, 10, 3, dtype=self.dtype, device=self.device)
        for q in range(self.phi.shape[0]):
            B -= self.wv[q][:, None, None, None] * torch.einsum(
                "k,ebj->ekbj", self.psi[q], self.dphi[q])
        return B.reshape(E, 4, 30)

    # -- global forms ----------------------------------------------------------
    def _sparse(self, rows, cols, vals) -> torch.Tensor:
        with warnings.catch_warnings():  # torch's notes on sparse tensors
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_coo_tensor(
                torch.stack([rows, cols]), vals, (self.n, self.n),
                check_invariants=False).coalesce().to_sparse_csr()

    def _entries(self, u: torch.Tensor, newton: bool):
        """(rows, cols, values) of the system without Dirichlet rows."""
        E = self.m.elements.shape[0]
        Auu = self._velocity_block(u, newton)
        B = self._divergence()
        ud, pd = self.udof, self.pdof
        rows = [ud[:, :, None].expand(E, 30, 30).reshape(-1),
                ud[:, :, None].expand(E, 30, 4).reshape(-1),
                pd[:, :, None].expand(E, 4, 30).reshape(-1)]
        cols = [ud[:, None, :].expand(E, 30, 30).reshape(-1),
                pd[:, None, :].expand(E, 30, 4).reshape(-1),
                ud[:, None, :].expand(E, 4, 30).reshape(-1)]
        vals = [Auu.reshape(-1), B.transpose(1, 2).reshape(-1),
                B.reshape(-1)]
        return torch.cat(rows), torch.cat(cols), torch.cat(vals)

    def jacobian(self, u: torch.Tensor) -> torch.Tensor:
        """The Newton Jacobian (CSR) at velocity u [n_u] (or a whole state
        [n]), with identity Dirichlet rows."""
        rows, cols, vals = self._entries(u[:self.n_u], newton=True)
        keep = ~self.D[rows]
        d = torch.nonzero(self.D).reshape(-1)
        return self._sparse(
            torch.cat([rows[keep], d]), torch.cat([cols[keep], d]),
            torch.cat([vals[keep], torch.ones(len(d), dtype=self.dtype,
                                              device=self.device)]))

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        """F(x) [n] at the state x = [u, p], u - g on the Dirichlet dofs."""
        rows, cols, vals = self._entries(x[:self.n_u], newton=False)
        y = torch.zeros(self.n, dtype=self.dtype, device=self.device)
        y.index_add_(0, rows, vals * x[cols])
        return torch.where(self.D, x - self.g, y)

    def start(self) -> torch.Tensor:
        """The state Newton starts from: g on the Dirichlet dofs, 0 else."""
        return torch.where(self.D, self.g, torch.zeros_like(self.g))

    def newton_criterion(self, x: torch.Tensor) -> float:
        """||F(x)|| / ||F(start)||, the relative Newton residual."""
        return float(torch.linalg.norm(self.residual(x))
                     / torch.linalg.norm(self.residual(self.start())))

    def relres(self, J: torch.Tensor, b: torch.Tensor,
               x: torch.Tensor) -> float:
        """||b - J x|| / ||b||."""
        r = b - (J @ x.unsqueeze(1)).squeeze(1)
        return float(torch.linalg.norm(r) / torch.linalg.norm(b))

    def dense_newton(self, tol: float = 1e-10, max_its: int = 20):
        """Newton from `start` with dense least-squares steps (small meshes
        only: the Jacobian's pressure null space makes each step the
        minimum-norm one).  Returns (state, iterations)."""
        x = self.start()
        f0 = float(torch.linalg.norm(self.residual(x)))
        for its in range(1, max_its + 1):
            J = self.jacobian(x).to_dense()
            dx = torch.linalg.lstsq(J, -self.residual(x)[:, None],
                                    driver="gelsd").solution[:, 0]
            x = x + dx
            if float(torch.linalg.norm(self.residual(x))) <= tol * f0:
                return x, its
        raise RuntimeError("dense Newton did not converge")

    # -- other numberings -----------------------------------------------------
    def order_of(self, u_points: np.ndarray, p_points: np.ndarray):
        """(velocity node ids, pressure node ids) here of nodes given in
        another order, matched by their lattice keys."""
        ids_u = self.m.order_of(u_points)
        mine = fem_p2.lattice_keys(self.m.points[:self.n_p], self.cells)
        theirs = fem_p2.lattice_keys(p_points, self.cells)
        o = np.argsort(mine)
        pos = np.clip(np.searchsorted(mine[o], theirs), 0, len(mine) - 1)
        ids_p = o[pos]
        if (len(theirs) != len(mine) or not (mine[ids_p] == theirs).all()
                or len(np.unique(ids_p)) != len(ids_p)):
            raise ValueError("the pressure nodes are not this mesh's")
        return ids_u, ids_p

    def to_mine(self, order, v) -> torch.Tensor:
        """A state [u (node-major 3-vectors), p] given in another node order
        (`order_of`) in this one, as a tensor here."""
        ids_u, ids_p = order
        v = np.asarray(v, dtype=np.float64)
        out = np.empty(self.n)
        out[:self.n_u].reshape(-1, 3)[ids_u] = v[:self.n_u].reshape(-1, 3)
        out[self.n_u + ids_p] = v[self.n_u:]
        return torch.as_tensor(out, dtype=self.dtype, device=self.device)
