"""Quadrilateral/hexahedral elements: Q1, Q2 (tensor), Q2-20 (serendipity),
and the discontinuous P1-disc pressure space.

Counterpart of feddlib_tpu/fe/hex.py.  Hex mappings are non-affine, so the
batched kernels compute J(xi_q) per element per point — one einsum
pipeline over [elements, points, basis, dims], in float64 on the device of
the corner coordinates.

Geometry is subparametric Q1 (corner vertices only); Q2/Q2-20 field bases
ride on the Q1 map.  Reference coordinates live in [0,1]^dim; quadrature
is tensor Gauss-Legendre.

Node ordering (corners first — mesh generation and kernels share it):
  2D quad corners: (0,0),(1,0),(1,1),(0,1)
  3D hex corners:  (0,0,0),(1,0,0),(1,1,0),(0,1,0),
                   (0,0,1),(1,0,1),(1,1,1),(0,1,1)
  Q2/Q2-20 append edge midpoints (bottom ring, top ring, verticals),
  Q2 additionally face centers (z-,z+,y-,x+,y+,x-) and the cell center.

The basis tables (values and reference gradients at the quadrature
points) are host numpy arrays built once per (fe_type, dim, rule): the
gradients by `torch.func.jacfwd` of the closed-form basis on the CPU in
float64, as the JAX package takes them by `jax.jacfwd`.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

import numpy as np
import torch

from feddlib_tpu_torch.fe.assembly import _eval_source, small_det, small_inv

f64 = torch.float64

_QUAD_CORNERS = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=float)
_HEX_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
], dtype=float)

# edges as corner-index pairs (midpoints become Q2 nodes)
_QUAD_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0)]
_HEX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),      # bottom ring
              (4, 5), (5, 6), (6, 7), (7, 4),      # top ring
              (0, 4), (1, 5), (2, 6), (3, 7)]      # verticals
# hex face centers: z=0, z=1, y=0, x=1, y=1, x=0 (corner quadruples)
_HEX_FACES = [(0, 1, 2, 3), (4, 5, 6, 7), (0, 1, 5, 4),
              (1, 2, 6, 5), (2, 3, 7, 6), (3, 0, 4, 7)]


def _corners(dim: int) -> np.ndarray:
    return _QUAD_CORNERS if dim == 2 else _HEX_CORNERS


@lru_cache(maxsize=None)
def ref_nodes(fe_type: str, dim: int) -> np.ndarray:
    """Reference-node coordinates [nb, dim] in [0,1]^dim, corners first."""
    c = _corners(dim)
    if fe_type == "Q1":
        return c
    edges = _QUAD_EDGES if dim == 2 else _HEX_EDGES
    mids = np.array([(c[a] + c[b]) / 2 for a, b in edges])
    if fe_type == "Q2-20":
        if dim != 3:
            raise ValueError("Q2-20 is a 3D (20-node hex) element")
        return np.vstack([c, mids])
    if fe_type == "Q2":
        if dim == 2:
            return np.vstack([c, mids, [[0.5, 0.5]]])
        faces = np.array([c[list(f)].mean(axis=0) for f in _HEX_FACES])
        return np.vstack([c, mids, faces, [[0.5, 0.5, 0.5]]])
    raise ValueError(f"unknown hex fe_type {fe_type!r}")


def hex_n_basis(fe_type: str, dim: int) -> int:
    return len(ref_nodes(fe_type, dim))


def _lagrange_1d(fe_type: str, x, c: float):
    """1D Lagrange factor for node coordinate c ∈ {0, 0.5, 1} on [0,1]."""
    if fe_type == "Q1":
        return x if c > 0.5 else 1.0 - x
    if c == 0.0:
        return (1.0 - x) * (1.0 - 2.0 * x)
    if c == 1.0:
        return x * (2.0 * x - 1.0)
    return 4.0 * x * (1.0 - x)


def _basis_fn(fe_type: str, dim: int) -> Callable:
    """Closed-form basis: x [dim] tensor → [nb] (differentiable)."""
    nodes = ref_nodes(fe_type, dim)

    if fe_type in ("Q1", "Q2"):
        def phi(x):
            vals = []
            for nd in nodes:
                v = 1.0
                for d in range(dim):
                    v = v * _lagrange_1d(fe_type, x[d], nd[d])
                vals.append(v)
            return torch.stack(vals)
        return phi

    # Q2-20 serendipity (20-node hex); standard basis on t ∈ [-1,1]^3:
    #   corner:   1/8 Π(1+t_d t_i,d) (Σ t_d t_i,d − 2)
    #   mid-edge: 1/4 (1−t_a²) Π_{d≠a}(1+t_d t_i,d)   (t_i,a = 0)
    def phi(x):
        t = 2.0 * x - 1.0
        vals = []
        for nd in nodes:
            ti = 2.0 * nd - 1.0  # entries in {-1, 0, +1}
            zero_axes = [d for d in range(3) if abs(ti[d]) < 0.5]
            if not zero_axes:  # corner
                prod = 1.0
                s = 0.0
                for d in range(3):
                    prod = prod * (1.0 + t[d] * ti[d])
                    s = s + t[d] * ti[d]
                vals.append(0.125 * prod * (s - 2.0))
            else:  # edge midpoint
                a = zero_axes[0]
                v = 0.25 * (1.0 - t[a] * t[a])
                for d in range(3):
                    if d != a:
                        v = v * (1.0 + t[d] * ti[d])
                vals.append(v)
        return torch.stack(vals)
    return phi


def hex_phi(fe_type: str, dim: int, pts: np.ndarray) -> np.ndarray:
    """Basis values at reference points [nq, dim] → [nq, nb] (numpy)."""
    pts = torch.as_tensor(np.atleast_2d(np.asarray(pts, dtype=np.float64)))
    fn = _basis_fn(fe_type, dim)
    return torch.func.vmap(fn)(pts).numpy()


def hex_grad_phi(fe_type: str, dim: int, pts: np.ndarray) -> np.ndarray:
    """Reference gradients [nq, nb, dim] via jacfwd of the basis (numpy)."""
    pts = torch.as_tensor(np.atleast_2d(np.asarray(pts, dtype=np.float64)))
    fn = _basis_fn(fe_type, dim)
    return torch.func.vmap(torch.func.jacfwd(fn))(pts).numpy()


# Q1-only signatures of the JAX package's earlier API
def q1_phi(dim: int, pts: np.ndarray) -> np.ndarray:
    return hex_phi("Q1", dim, pts)


def q1_grad_phi(dim: int, pts: np.ndarray) -> np.ndarray:
    return hex_grad_phi("Q1", dim, pts)


@lru_cache(maxsize=None)
def hex_quadrature(dim: int, n: int = 2):
    """Tensor Gauss-Legendre rule on [0,1]^dim (n points per axis)."""
    x, w = np.polynomial.legendre.leggauss(n)
    x = 0.5 * (x + 1)
    w = 0.5 * w
    grids = np.meshgrid(*([x] * dim), indexing="ij")
    wgrids = np.meshgrid(*([w] * dim), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=1)
    wts = np.prod(np.stack([g.ravel() for g in wgrids], axis=1), axis=1)
    return pts, wts


def _default_nq(fe_type: str) -> int:
    return 2 if fe_type == "Q1" else 3


@lru_cache(maxsize=None)
def _tables(fe_type: str, dim: int, nq_axis: int):
    """(qp, qw, phi, dphi, dphi_geo) host tables; dphi_geo is the Q1
    geometry basis gradient on the same rule."""
    qp, qw = hex_quadrature(dim, nq_axis)
    phi = hex_phi(fe_type, dim, qp)
    dphi = hex_grad_phi(fe_type, dim, qp)
    dphi_geo = hex_grad_phi("Q1", dim, qp)
    return qp, qw, phi, dphi, dphi_geo


def _dev(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=f64, device=like.device)


def _geometry(corner_coords, dphi_geo):
    """Per-point Jacobians from the Q1 corner map.
    corner_coords [E, 2^dim, dim]; dphi_geo [nq, 2^dim, dim] →
    (J [E,nq,dim,dim], detJ [E,nq], Jinv [E,nq,dim,dim])."""
    J = torch.einsum("ebi,qbk->eqik", corner_coords, dphi_geo)
    detJ = small_det(J)
    Jinv = small_inv(J, detJ)
    return J, detJ, Jinv


def hex_elem_laplace(corner_coords, dim, fe_type="Q1", nq_axis=None):
    """Stiffness ∫∇φa·∇φb: corner_coords [E, 2^dim, dim] → [E, nb, nb]."""
    nq_axis = nq_axis or _default_nq(fe_type)
    _, qw, _, dphi, dphi_geo = _tables(fe_type, dim, nq_axis)
    dphi, qw = _dev(dphi, corner_coords), _dev(qw, corner_coords)
    _, detJ, Jinv = _geometry(corner_coords, _dev(dphi_geo, corner_coords))
    g = torch.einsum("eqki,qbk->eqbi", Jinv, dphi)
    return torch.einsum("q,eq,eqai,eqbi->eab", qw, detJ.abs(), g, g)


def hex_elem_mass(corner_coords, dim, fe_type="Q1", nq_axis=None):
    """Mass ∫φa φb → [E, nb, nb] (3-pt rule is exact for Q2·Q2 on affine
    cells: degree 4 per axis ≤ 5)."""
    nq_axis = nq_axis or _default_nq(fe_type)
    _, qw, phi, _, dphi_geo = _tables(fe_type, dim, nq_axis)
    phi, qw = _dev(phi, corner_coords), _dev(qw, corner_coords)
    _, detJ, _ = _geometry(corner_coords, _dev(dphi_geo, corner_coords))
    return torch.einsum("q,eq,qa,qb->eab", qw, detJ.abs(), phi, phi)


def hex_elem_rhs(corner_coords, dim, fe_type, f: Callable, nq_axis=None,
                 n_comp=1):
    """Volume source ∫ f φa → [E, nb] (scalar) or [E, nb, n_comp] (vector
    field).  f gets the quadrature points component-first [dim, E, nq], as
    the simplex loads do (assembly._eval_source)."""
    nq_axis = nq_axis or (_default_nq(fe_type) + 1)
    qp, qw, phi, _, dphi_geo = _tables(fe_type, dim, nq_axis)
    cc = corner_coords
    phi_d, qw_d = _dev(phi, cc), _dev(qw, cc)
    geo_phi = _dev(hex_phi("Q1", dim, qp), cc)  # [nq, 2^dim]
    _, detJ, _ = _geometry(cc, _dev(dphi_geo, cc))
    xq = torch.einsum("qb,ebi->eqi", geo_phi, cc)  # [E, nq, dim]
    fq = _eval_source(f, xq, n_comp)  # [E, nq] or [E, nq, n_comp]
    if n_comp == 1:
        return torch.einsum("q,eq,eq,qa->ea", qw_d, detJ.abs(), fq, phi_d)
    return torch.einsum("q,eq,eqc,qa->eac", qw_d, detJ.abs(), fq, phi_d)


# ---------------------------------------------------------------------------
# P1-disc: discontinuous per-element linear pressure (the Q2/P1-disc pair)
# ---------------------------------------------------------------------------


def p1disc_phi(dim: int, pts: np.ndarray) -> np.ndarray:
    """Modal P1-disc basis on [0,1]^dim: {1, ξ−½, η−½(, ζ−½)} →
    [nq, dim+1].  Dofs are ELEMENT-LOCAL (no inter-element continuity):
    pressure dof (e, a) has global id e·(dim+1)+a."""
    pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
    cols = [np.ones(len(pts))] + [pts[:, d] - 0.5 for d in range(dim)]
    return np.stack(cols, axis=1)


def p1disc_n_dofs(n_elements: int, dim: int) -> int:
    return n_elements * (dim + 1)


def hex_elem_divergence_p1disc(corner_coords, dim, fe_u="Q2", nq_axis=None):
    """Mixed divergence B[a,(b,j)] = −∫ ψa ∂j φb with ψ the P1-disc
    pressure basis and φ the Qk velocity basis.  Returns
    [E, dim+1, nb_u, dim]."""
    nq_axis = nq_axis or (_default_nq(fe_u) + 1)
    qp, qw, _, dphi, dphi_geo = _tables(fe_u, dim, nq_axis)
    cc = corner_coords
    psi = _dev(p1disc_phi(dim, qp), cc)  # [nq, dim+1]
    qw, dphi = _dev(qw, cc), _dev(dphi, cc)
    _, detJ, Jinv = _geometry(cc, _dev(dphi_geo, cc))
    g = torch.einsum("eqki,qbk->eqbi", Jinv, dphi)  # phys grads of φ
    return -torch.einsum("q,eq,qa,eqbj->eabj", qw, detJ.abs(), psi, g)


def hex_elem_mass_p1disc(corner_coords, dim, nq_axis=2):
    """P1-disc pressure mass ∫ ψa ψb → [E, dim+1, dim+1] (block-diagonal
    globally — P1-disc dofs are element-local)."""
    qp, qw = hex_quadrature(dim, nq_axis)
    cc = corner_coords
    psi = _dev(p1disc_phi(dim, qp), cc)
    dphi_geo = _dev(hex_grad_phi("Q1", dim, qp), cc)
    _, detJ, _ = _geometry(cc, dphi_geo)
    return torch.einsum("q,eq,qa,qb->eab", _dev(qw, cc), detJ.abs(), psi,
                        psi)


def build_hex_mesh(dim: int, n_cells, lower=None, upper=None,
                   fe_type: str = "Q1"):
    """Structured quadrilateral/hexahedral mesh (fe_type Q1 | Q2 | Q2-20):
    nodes live on the half-index grid (2n+1 per axis); Q2 keeps all of
    it, Q2-20 drops face/cell centers (grid points with ≥2 odd indices)."""
    from feddlib_tpu_torch.mesh.mesh import Mesh

    if isinstance(n_cells, int):
        n_cells = (n_cells,) * dim
    lower = np.array(lower if lower is not None else [0.0] * dim)
    upper = np.array(upper if upper is not None else [1.0] * dim)
    rnodes = ref_nodes(fe_type, dim)
    # node grid resolution: 1 (Q1) or 2 (Q2 family) per cell
    s = 1 if fe_type == "Q1" else 2
    grid_n = [s * n + 1 for n in n_cells]
    axes = [np.linspace(lower[d], upper[d], grid_n[d]) for d in range(dim)]
    grids = np.meshgrid(*axes, indexing="ij")
    all_points = np.stack([g.ravel() for g in grids], axis=1)

    idx_grids = np.meshgrid(*[np.arange(g) for g in grid_n], indexing="ij")
    flat_idx = np.stack([g.ravel() for g in idx_grids], axis=1)  # [N, dim]
    if fe_type == "Q2-20":
        keep = (flat_idx % 2 == 1).sum(axis=1) <= 1
    else:
        keep = np.ones(len(all_points), dtype=bool)
    points = all_points[keep]
    # grid linear index → compact node id
    lin = np.zeros(len(all_points), dtype=np.int64)
    lin[keep] = np.arange(keep.sum())

    def grid_lin(idx):  # idx [E, dim] integer grid coords → linear index
        out = idx[:, 0].astype(np.int64)
        for d in range(1, dim):
            out = out * grid_n[d] + idx[:, d]
        return out

    cells = np.meshgrid(*[np.arange(n) for n in n_cells], indexing="ij")
    cells = np.stack([c.ravel() for c in cells], axis=1)  # [E, dim]
    offs = np.rint(rnodes * s).astype(np.int64)  # [nb, dim]
    conn = np.stack([lin[grid_lin(cells * s + off)] for off in offs], axis=1)

    flags = np.zeros(len(points), dtype=np.int32)
    on_b = np.zeros(len(points), dtype=bool)
    for d in range(dim):
        on_b |= np.isclose(points[:, d], lower[d]) | np.isclose(
            points[:, d], upper[d])
    flags[on_b] = 1
    return Mesh(dim=dim, fe_type=fe_type, points=points, point_flags=flags,
                elements=conn.astype(np.int64),
                element_flags=np.zeros(len(conn), dtype=np.int32))
