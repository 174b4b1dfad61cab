"""Plain quadratic (P2, ten-node) tetrahedra for linear elasticity, in
PyTorch, in any dtype and on any device: the reference that decides
`correct` for a P2 elasticity cell.

Written from the equations, not from the program (it imports nothing of
`feddlib_tpu_torch`, `feddlib_tpu` or JAX, and takes no array the program
made):

- Nodes: the P1 mesh's vertices, then one midpoint per edge, numbered in
  the order of the sorted (lower id, higher id) vertex pairs.  An
  element's nodes are [v0, v1, v2, v3, m01, m02, m03, m12, m13, m23].
- Basis: lambda_i (2 lambda_i - 1) on the corners, 4 lambda_i lambda_j on
  the edges, lambda the barycentric coordinates of the affine element.
- K_e = int 2 mu eps(u) : eps(v) + lam div u div v, with the degree-2
  four-point rule (exact here: on an affine P2 element the integrand is
  quadratic).  Global dof node * 3 + component.
- Dirichlet rows are identity rows (the solution's value).
- Another numbering of the same nodes is matched to this one by each
  node's integer key on the half-step lattice of the n^3 cube,
  round(2 n x) per coordinate (`lattice_keys`), never by float equality.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from benchmark.reference import fem

EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
# the degree-2 four-point rule on the tetrahedron (barycentric points,
# equal weights 1/4 of the volume)
_QA, _QB = 0.5854101966249685, 0.1381966011250105
QUAD = tuple(tuple(_QA if i == q else _QB for i in range(4))
             for q in range(4))


def lattice_keys(points: np.ndarray, cells: int) -> np.ndarray:
    """One integer per node of the n^3 cube's P2 lattice (nodes at
    multiples of 1 / (2n)): (i (2n+1) + j) (2n+1) + k, i = round(2n x)."""
    m = 2 * int(cells)
    ijk = np.rint(np.asarray(points, dtype=np.float64) * m).astype(np.int64)
    return (ijk[:, 0] * (m + 1) + ijk[:, 1]) * (m + 1) + ijk[:, 2]


class P2Mesh:
    """The P2 nodes and element geometry of a P1 tetrahedral mesh of the
    unit cube with `cells`^3 cells: `points` [N, 3] (numpy f64),
    `elements` [E, 10], `grads` [Q, E, 10, 3] (the basis gradients at the
    four quadrature points) and `vol` [E], in `dtype` on `device`."""

    def __init__(self, points, elements, cells: int, dtype=torch.float64,
                 device="cpu"):
        self.dtype, self.device = dtype, torch.device(device)
        self.cells = int(cells)
        points = np.asarray(points, dtype=np.float64)
        elements = np.asarray(elements, dtype=np.int64)
        E, n1 = elements.shape[0], points.shape[0]
        pairs = np.sort(elements[:, list(EDGES)], axis=2).reshape(-1, 2)
        edges, inv = np.unique(pairs, axis=0, return_inverse=True)
        self.points = np.concatenate(
            [points, 0.5 * (points[edges[:, 0]] + points[edges[:, 1]])])
        self.n_nodes = self.points.shape[0]
        self.elements = torch.as_tensor(np.concatenate(
            [elements, n1 + inv.reshape(E, 6)], axis=1), device=self.device)
        g1 = fem.P1Mesh(points, elements, dtype=torch.float64,
                        device=self.device)
        g = g1.grads  # [E, 4, 3], the gradients of the lambda_i
        lam = torch.tensor(QUAD, dtype=torch.float64, device=self.device)
        out = []
        for q in range(4):
            l = lam[q]
            corner = (4.0 * l - 1.0)[None, :, None] * g
            edge = torch.stack([4.0 * (l[i] * g[:, j] + l[j] * g[:, i])
                                for i, j in EDGES], dim=1)
            out.append(torch.cat([corner, edge], dim=1))
        self.grads = torch.stack(out).to(dtype)  # [Q, E, 10, 3]
        self.vol = g1.vol.to(dtype)

    def keys(self) -> np.ndarray:
        return lattice_keys(self.points, self.cells)

    def order_of(self, other_points: np.ndarray) -> np.ndarray:
        """For nodes given in another order, each one's id here; raises
        unless the map is a bijection of the lattice nodes."""
        mine = self.keys()
        theirs = lattice_keys(other_points, self.cells)
        o = np.argsort(mine)
        pos = np.searchsorted(mine[o], theirs)
        pos = np.clip(pos, 0, len(mine) - 1)
        ids = o[pos]
        if (len(theirs) != len(mine) or not (mine[ids] == theirs).all()
                or len(np.unique(ids)) != len(ids)):
            raise ValueError("the nodes are not this mesh's P2 nodes")
        return ids

    def clamped(self, axis: int, side: int) -> np.ndarray:
        """[N] bool: the nodes on the face x_axis = side (0 or 1), by
        their lattice index."""
        m = 2 * self.cells
        i = np.rint(self.points[:, axis] * m).astype(np.int64)
        return i == side * m

    def sparse(self, elem_mats: torch.Tensor, d: int) -> torch.Tensor:
        """Global CSR matrix from element matrices [E, 10 d, 10 d] whose
        local dof a * d + i is node a's component i."""
        E = self.elements.shape[0]
        dof = (self.elements[:, :, None] * d
               + torch.arange(d, device=self.device)).reshape(E, 10 * d)
        k = 10 * d
        rows = dof[:, :, None].expand(E, k, k).reshape(-1)
        cols = dof[:, None, :].expand(E, k, k).reshape(-1)
        n = self.n_nodes * d
        with warnings.catch_warnings():  # torch's notes on sparse tensors
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_coo_tensor(
                torch.stack([rows, cols]), elem_mats.reshape(-1), (n, n),
                check_invariants=False).coalesce().to_sparse_csr()


def linelas_matrix(m: P2Mesh, mu: float, lam: float) -> torch.Tensor:
    """The P2 elasticity stiffness (CSR) without boundary rows applied."""
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    K = 0.0
    for D in m.grads:  # [E, 10, 3] at one quadrature point
        G = torch.einsum("eaj,ebj->eab", D, D)
        K = K + (mu * torch.einsum("eab,ik->eaibk", G, eye)
                 + mu * torch.einsum("eak,ebi->eaibk", D, D)
                 + lam * torch.einsum("eai,ebk->eaibk", D, D))
    K = (0.25 * m.vol)[:, None, None, None, None] * K
    return m.sparse(K.reshape(-1, 30, 30), 3)


class LinElasP2:
    """The clamped P2 elasticity system of the `cells`^3 cube (clamped on
    the face x_axis = side, every P2 node there): its matrix `A` and
    Dirichlet dofs `D`, in this mesh's node order, in `dtype`."""

    def __init__(self, cells: int, mu: float, lam: float, axis: int = 0,
                 side: int = 0, dtype=torch.float64, device="cpu"):
        from benchmark import inputs

        if torch.device(device).type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        points, elements = inputs.cube_mesh(cells)
        self.m = P2Mesh(points, elements, cells, dtype=dtype, device=device)
        self.A = linelas_matrix(self.m, mu, lam)
        self.clamped_nodes = self.m.clamped(axis, side)
        self.D = torch.as_tensor(np.repeat(self.clamped_nodes, 3),
                                 device=self.m.device)

    def to_mine(self, order: np.ndarray, v) -> np.ndarray:
        """A nodal 3-vector field [N * 3] given in another node order (node
        i of it is node order[i] here) in this mesh's order."""
        out = np.empty((self.m.n_nodes, 3))
        out[order] = np.asarray(v, dtype=np.float64).reshape(-1, 3)
        return out.reshape(-1)

    def relres(self, b, x) -> float:
        """||b - A x|| / ||b|| with identity rows on the Dirichlet dofs."""
        bt = torch.as_tensor(b, dtype=self.A.dtype, device=self.m.device)
        xt = torch.as_tensor(x, dtype=self.A.dtype, device=self.m.device)
        return fem.laplace_relres(self.A, self.D, bt, xt)
