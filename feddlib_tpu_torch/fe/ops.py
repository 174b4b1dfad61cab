"""Global assembly operations: Domain → CsrMatrix / vectors.

Counterpart of feddlib_tpu/fe/ops.py: simplex Laplace (scalar and vector),
mass, stress, linear elasticity, the Navier–Stokes convection and Newton
blocks, the FSI ALE divergence, the mixed divergence pair, the
Bochev–Dohrmann stabilization and the volume and surface loads; the
quad/hex Laplace, mass and load and the Q2/P1-disc operators (fe/hex.py).
Each runs the chunked element path (ops.py:48-91 of the JAX package) —
except where the JAX package switches to its element-last fast assembly
(fe/fast_assembly.py) on an accelerator: scalar P1/P2 Laplace and mass and
the two advection operators, which take it for a CUDA domain
(`fast_assembly.use_fast`).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from feddlib_tpu_torch.fe import assembly as asm
from feddlib_tpu_torch.fe.domain import Domain
from feddlib_tpu_torch.la.csr import CsrMatrix

# elements per chunk of the element kernels: bounds the [E, nq, nb, dim]
# temporaries on the device
_CHUNK = 32768


def _assemble_chunked(domain: Domain, pattern, kernel, *extra,
                      post=None) -> CsrMatrix:
    """kernel(vert_coords chunk, *extra chunks) → element matrices, `extra`
    per-element arrays chunked alike; `post` (e.g. vectorize_elem_mat) runs
    on each chunk before it is flattened."""
    vc = domain.vert_coords()
    vals = []
    for s in range(0, vc.shape[0], _CHUNK):
        out = kernel(vc[s:s + _CHUNK], *(a[s:s + _CHUNK] for a in extra))
        vals.append((post(out) if post is not None else out).reshape(-1))
    m = CsrMatrix(pattern, device=domain.device)
    m.assemble(torch.cat(vals))
    return m


def _square_pattern(domain: Domain, dofs_per_node: int):
    def build():
        dofs = domain.elem_dofs(dofs_per_node)
        n = domain.n_dofs(dofs_per_node)
        return asm.scatter_pattern(dofs, dofs, n, n)

    return domain.pattern(("square", dofs_per_node), build)


def _require_simplex(domain: Domain) -> None:
    """The operators the JAX package assembles with its simplex kernels
    only: on a quad/hex domain it fails inside them; the port says so."""
    if domain.is_hex:
        raise NotImplementedError(
            f"{domain.fe_type} spaces: the JAX package assembles this "
            f"operator on simplices only (quad/hex: assemble_laplace, "
            f"assemble_mass, assemble_rhs, assemble_hex_laplace_vec and the "
            f"P1-disc operators)")


def _fast(domain: Domain) -> bool:
    from feddlib_tpu_torch.fe import fast_assembly as fa

    return (not domain.is_hex and fa.use_fast(domain.device)
            and fa.supported(domain.dim, domain.fe_type))


def assemble_laplace(domain: Domain) -> CsrMatrix:
    """Scalar Laplace stiffness (FE::assemblyLaplace) on P1/P2 simplices
    or Q1/Q2/Q2-20 quads/hexes; the element-last fast path on the card."""
    if _fast(domain):
        from feddlib_tpu_torch.fe import fast_assembly as fa

        return fa.assemble_fast(domain, "laplace")
    if domain.is_hex:
        from feddlib_tpu_torch.fe.hex import hex_elem_laplace

        kernel = lambda vc: hex_elem_laplace(vc, domain.dim, domain.fe_type)
    else:
        kernel = lambda vc: asm.elem_laplace(vc, domain.dim, domain.fe_type)
    return _assemble_chunked(domain, _square_pattern(domain, 1), kernel)


def assemble_laplace_vec(domain: Domain, viscosity: float = 1.0) -> CsrMatrix:
    """Vector Laplace (FE::assemblyLaplaceVecField)."""
    _require_simplex(domain)
    return _assemble_chunked(
        domain, _square_pattern(domain, domain.dim),
        lambda vc: asm.elem_laplace_vec(vc, domain.dim, domain.fe_type,
                                        viscosity),
        post=asm.vectorize_elem_mat)


def assemble_mass(domain: Domain, dofs_per_node: int = 1) -> CsrMatrix:
    """Mass matrix, scalar or vector (FE::assemblyMass), on simplices or
    quads/hexes; a scalar simplex mass takes the fast path on the card."""
    eye = torch.eye(dofs_per_node, dtype=torch.float64, device=domain.device)

    def post(M):
        if dofs_per_node > 1:
            return asm.vectorize_elem_mat(
                torch.einsum("eab,ij->eabij", M, eye))
        return M

    if dofs_per_node == 1 and _fast(domain):
        from feddlib_tpu_torch.fe import fast_assembly as fa

        return fa.assemble_fast(domain, "mass")
    if domain.is_hex:
        from feddlib_tpu_torch.fe.hex import hex_elem_mass

        kernel = lambda vc: hex_elem_mass(vc, domain.dim, domain.fe_type)
    else:
        kernel = lambda vc: asm.elem_mass(vc, domain.dim, domain.fe_type)
    return _assemble_chunked(
        domain, _square_pattern(domain, dofs_per_node), kernel, post=post)


def assemble_stress(domain: Domain, viscosity: float = 1.0) -> CsrMatrix:
    """Symmetric-gradient stress form 2μ ∫ε(u):ε(v) (FE::assemblyStress)."""
    _require_simplex(domain)
    return _assemble_chunked(
        domain, _square_pattern(domain, domain.dim),
        lambda vc: asm.elem_stress_sym(vc, domain.dim, domain.fe_type,
                                       viscosity),
        post=asm.vectorize_elem_mat)


def u_elem_values(domain: Domain, u: torch.Tensor) -> torch.Tensor:
    """Nodal vector field u [n_nodes*dim] (NodeWise) → per-element values
    [E, nb, dim] — the reference's repeated-form u_rep_."""
    un = u.reshape(domain.n_nodes, domain.dim)
    return un[torch.as_tensor(domain.elem_nodes(), device=u.device)]


def _vector_identity(domain: Domain):
    """[E, nb, nb] scalar element matrices → the vector form with the
    identity over components (NodeWise)."""
    eye = torch.eye(domain.dim, dtype=torch.float64, device=domain.device)
    return lambda M: asm.vectorize_elem_mat(
        torch.einsum("eab,ij->eabij", M, eye))


def assemble_advection(domain: Domain, u: torch.Tensor) -> CsrMatrix:
    """N(u): the (u·∇)u convection block, expanded to vector dofs
    (FE::assemblyAdvectionVecField); the fast path on the card."""
    _require_simplex(domain)
    if _fast(domain):
        from feddlib_tpu_torch.fe import fast_assembly as fa

        return fa.assemble_advection_fast(domain, u_elem_values(domain, u))
    return _assemble_chunked(
        domain, _square_pattern(domain, domain.dim),
        lambda vc, uc: asm.elem_advection(vc, uc, domain.dim,
                                          domain.fe_type),
        u_elem_values(domain, u), post=_vector_identity(domain))


def assemble_ale_divergence(domain: Domain, w: torch.Tensor) -> CsrMatrix:
    """ALE additional convection ∫ (∇·w) u·v with w the discrete mesh
    velocity (FE::assemblyAdditionalConvection), on the chunked path as in
    the JAX package (which has no fast kernel for it).  The caller scales
    by −density, as FSI does."""
    _require_simplex(domain)
    return _assemble_chunked(
        domain, _square_pattern(domain, domain.dim),
        lambda vc, wc: asm.elem_ale_divergence(vc, wc, domain.dim,
                                               domain.fe_type),
        u_elem_values(domain, w), post=_vector_identity(domain))


def assemble_advection_in_u(domain: Domain, u: torch.Tensor) -> CsrMatrix:
    """W(u): the Newton linearisation (∇u)·δu
    (FE::assemblyAdvectionInUVecField); the fast path on the card."""
    _require_simplex(domain)
    if _fast(domain):
        from feddlib_tpu_torch.fe import fast_assembly as fa

        return fa.assemble_advection_in_u_fast(domain,
                                               u_elem_values(domain, u))
    return _assemble_chunked(
        domain, _square_pattern(domain, domain.dim),
        lambda vc, uc: asm.elem_advection_in_u(vc, uc, domain.dim,
                                               domain.fe_type),
        u_elem_values(domain, u), post=asm.vectorize_elem_mat)


def assemble_divergence(dom_u: Domain, dom_p: Domain):
    """Mixed divergence blocks B (p-rows × u-cols) and Bᵀ
    (FE::assemblyDivAndDivT).  dom_u and dom_p must share the element
    ordering (a P2 space built from the P1 one keeps it)."""
    _require_simplex(dom_u)
    dim = dom_u.dim
    aligned = (dom_u.mesh is dom_p.mesh
               or (dom_u.parent_p1 is not None
                   and dom_u.parent_p1.mesh is dom_p.mesh)
               or (dom_p.parent_p1 is not None
                   and dom_p.parent_p1.mesh is dom_u.mesh)
               or (dom_u.parent_p1 is not None and dom_p.parent_p1 is not None
                   and dom_u.parent_p1.mesh is dom_p.parent_p1.mesh))
    if not aligned:
        raise ValueError(
            "mixed-space assembly requires domains sharing one mesh "
            "(build the P2 space with dom_p.p2_domain())")

    def build():
        return asm.scatter_pattern(dom_p.elem_dofs(1), dom_u.elem_dofs(dim),
                                   dom_p.n_dofs(1), dom_u.n_dofs(dim))

    B = _assemble_chunked(
        dom_u, dom_p.pattern(("div", id(dom_u)), build),
        lambda vc: asm.elem_divergence(vc, dim, dom_u.fe_type,
                                       dom_p.fe_type))
    return B, B.transpose()


def assemble_hex_laplace_vec(domain: Domain, viscosity: float = 1.0
                             ) -> CsrMatrix:
    """Vector Laplace on Q-family hex meshes (identity expansion of the
    scalar hex stiffness — FE::assemblyLaplaceVecField for Q spaces)."""
    from feddlib_tpu_torch.fe.hex import hex_elem_laplace

    dim = domain.dim
    return _assemble_chunked(
        domain, _square_pattern(domain, dim),
        lambda vc: hex_elem_laplace(vc, dim, domain.fe_type) * viscosity,
        post=_vector_identity(domain))


def _p1disc_rows(dom_u: Domain) -> np.ndarray:
    """[E, dim+1] element-local P1-disc pressure dofs e·(dim+1)+a."""
    dim = dom_u.dim
    return (np.arange(dom_u.n_elements)[:, None] * (dim + 1)
            + np.arange(dim + 1)[None, :])


def assemble_divergence_p1disc(dom_u: Domain):
    """Mixed divergence blocks B (P1-disc pressure rows × Qk velocity
    cols) and Bᵀ — the Q2/P1-disc pairing (FE::assemblyDivAndDivT P1-disc
    branch).  Pressure dofs are element-local: gid = e·(dim+1)+a."""
    from feddlib_tpu_torch.fe.hex import hex_elem_divergence_p1disc

    dim = dom_u.dim
    n_p = dom_u.n_elements * (dim + 1)

    def build():
        return asm.scatter_pattern(_p1disc_rows(dom_u), dom_u.elem_dofs(dim),
                                   n_p, dom_u.n_dofs(dim))

    B = _assemble_chunked(
        dom_u, dom_u.pattern(("div_p1disc", dim), build),
        lambda vc: hex_elem_divergence_p1disc(vc, dim, dom_u.fe_type),
        post=lambda Bm: Bm.reshape(Bm.shape[0], Bm.shape[1], -1))
    return B, B.transpose()


def assemble_mass_p1disc(dom_u: Domain) -> CsrMatrix:
    """P1-disc pressure mass matrix (block-diagonal, element-local dofs) —
    the pressure-mass Schur approximation of Q2/P1-disc block
    preconditioners."""
    from feddlib_tpu_torch.fe.hex import hex_elem_mass_p1disc

    dim = dom_u.dim
    n_p = dom_u.n_elements * (dim + 1)
    rows = _p1disc_rows(dom_u)

    def build():
        return asm.scatter_pattern(rows, rows, n_p, n_p)

    return _assemble_chunked(
        dom_u, dom_u.pattern(("mass_p1disc", dim), build),
        lambda vc: hex_elem_mass_p1disc(vc, dim))


def assemble_bd_stabilization(dom_p: Domain) -> CsrMatrix:
    """Bochev–Dohrmann P1–P1 pressure stabilization block C
    (FE::assemblyBDStabilization)."""
    _require_simplex(dom_p)
    return _assemble_chunked(
        dom_p, _square_pattern(dom_p, 1),
        lambda vc: asm.elem_bd_stabilization(vc, dom_p.dim, dom_p.fe_type))


def assemble_lin_elasticity(domain: Domain, mu: float, lam: float) -> CsrMatrix:
    """2μ ε(u):ε(v) + λ div u div v (FE::assemblyLinElasXDim); λ, μ from
    (E, ν) through lame_parameters."""
    _require_simplex(domain)
    return _assemble_chunked(
        domain, _square_pattern(domain, domain.dim),
        lambda vc: asm.elem_lin_elasticity(vc, domain.dim, domain.fe_type,
                                           mu, lam),
        post=asm.vectorize_elem_mat)


def lame_parameters(E: float, nu: float):
    mu = E / (2.0 * (1.0 + nu))
    lam = nu * E / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return mu, lam


def assemble_rhs(domain: Domain, f: Callable, dofs_per_node: int = 1,
                 degree: Optional[int] = None) -> torch.Tensor:
    """Volume source term (FE::assemblyRHS).  f(x) takes the quadrature
    points component-first (x[0] is the first coordinate) and returns a
    scalar or a tensor broadcastable to the points (dofs_per_node == 1),
    or one such value per component (see assembly._eval_source).  On a
    quad/hex domain the hex rule of fe/hex.py is used (`degree` is then
    ignored, as in the JAX package)."""
    if domain.is_hex:
        from feddlib_tpu_torch.fe.hex import hex_elem_rhs

        vec = hex_elem_rhs(domain.vert_coords(), domain.dim, domain.fe_type,
                           f, n_comp=dofs_per_node)
    else:
        vec = asm.elem_rhs(domain.vert_coords(), domain.dim, domain.fe_type,
                           f, degree=degree, n_comp=dofs_per_node)
    return asm.assemble_vector(domain.elem_nodes(), vec,
                               domain.n_dofs(dofs_per_node))


def assemble_surface_rhs(domain: Domain, g: Callable, flag: int,
                         dofs_per_node: int = 1,
                         degree: int = 3) -> torch.Tensor:
    """Neumann boundary load over the surfaces with the given flag
    (FE::assemblySurfaceIntegral); g as f in assemble_rhs."""
    mesh = domain.mesh
    if mesh.surfaces is None:
        raise ValueError("mesh has no surface entities")
    surf = mesh.surfaces[mesh.surface_flags == flag]
    n = domain.n_dofs(dofs_per_node)
    if len(surf) == 0:
        return torch.zeros(n, dtype=torch.float64, device=domain.device)
    nverts = domain.dim  # vertices of the surface simplex
    coords = torch.as_tensor(mesh.points[surf[:, :nverts]],
                             dtype=torch.float64, device=domain.device)
    vec = asm.elem_surface_rhs(coords, domain.dim, domain.fe_type, g,
                               degree=degree, n_comp=dofs_per_node)
    return asm.assemble_vector(surf, vec, n)
