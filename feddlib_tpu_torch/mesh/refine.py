"""Adaptive mesh refinement — the host (numpy) counterpart of
feddlib_tpu/mesh/refine.py on the port's Mesh; the same arrays, bit for bit
(reference: core/Mesh/MeshUnstructuredRefinement
_decl.hpp — residual-based a-posteriori estimator with edge jumps
(errorEstimation :229, jumps :389), marking strategies Maximum (:468) and
Dörfler (:477), red/green refinement (refineRegular :2467 'red',
refineGreen :2122, addMidpoint)).

2D P1 implementation, host-side (setup-phase):
- estimator:  η_T² = h_T² ‖f‖²_T + ½ Σ_{e⊂∂T} h_e ‖[∂u_h/∂n]_e‖²_e
  (for P1 the element residual is f since Δu_h|_T = 0);
- marking: "Maximum" (η_T ≥ θ max η) or "Doerfler" (smallest set with
  Σ η² ≥ θ Σ total);
- closure: any element with ≥2 marked edges becomes red (all edges marked),
  iterated to a fixed point; exactly 1 marked edge → green bisection;
- red: 4 children through the three edge midpoints; green: 2 children
  through the single midpoint; boundary surface edges split and flags
  inherited (midpoint gets the surface flag).

3D: uniform red refinement of tetrahedra (8 children over edge midpoints,
diagonal chosen as the shortest) — `refine_uniform` works for 2D and 3D.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from feddlib_tpu_torch.mesh.mesh import Mesh
from feddlib_tpu_torch.mesh.p2 import P2_EDGE_ORDER


# ---------------------------------------------------------------------------
# error estimation
# ---------------------------------------------------------------------------

def error_estimate_p1(mesh: Mesh, u: np.ndarray,
                      f: Optional[Callable] = None) -> np.ndarray:
    """Per-element residual error indicators η_T for a P1 scalar solution of
    −Δu = f (reference: MeshUnstructuredRefinement::errorEstimation with
    edge/face jump terms, MeshUnstructuredRefinement_def.hpp:229,389).
    2D (edge jumps) and 3D (face jumps)."""
    if mesh.fe_type != "P1":
        raise NotImplementedError("estimator: P1 only")
    if mesh.dim == 3:
        return _error_estimate_p1_3d(mesh, u, f)
    pts = mesh.points
    elems = mesh.elements
    E = len(elems)
    v = pts[elems]  # [E, 3, 2]
    B = np.swapaxes(v[:, 1:] - v[:, :1], 1, 2)  # [E,2,2]
    detB = B[:, 0, 0] * B[:, 1, 1] - B[:, 0, 1] * B[:, 1, 0]
    area = np.abs(detB) / 2
    h_T = np.sqrt(area)

    # constant gradient per element: ∇u = B^{-T} ∇ξ(Σ u_a φ_a)
    ue = u[elems]
    # reference gradients of P1: [-1,-1],[1,0],[0,1]
    gref = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])
    inv_det = 1.0 / detB
    Binv = np.empty_like(B)
    Binv[:, 0, 0] = B[:, 1, 1] * inv_det
    Binv[:, 0, 1] = -B[:, 0, 1] * inv_det
    Binv[:, 1, 0] = -B[:, 1, 0] * inv_det
    Binv[:, 1, 1] = B[:, 0, 0] * inv_det
    # ∇x u = Binvᵀ (Σ_a u_a ∇ξ φ_a) → comp k = Σ_d Binv[d,k] (∇ξ u)_d
    gref_u = np.einsum("ad,ea->ed", gref, ue)  # [E,2] reference gradient
    grad = np.einsum("edk,ed->ek", Binv, gref_u)

    # element residual term (f at centroid)
    if f is not None:
        cent = v.mean(axis=1)
        fc = np.array([f(c) for c in cent], dtype=float)
    else:
        fc = np.zeros(E)
    eta2 = h_T ** 2 * area * fc ** 2

    # edge jumps
    edges, elem_edge = mesh.unique_edges()
    n_edges = len(edges)
    # adjacency: up to 2 elements per edge
    owner = np.full((n_edges, 2), -1, dtype=np.int64)
    for e in range(E):
        for le in range(3):
            g = elem_edge[e, le]
            if owner[g, 0] < 0:
                owner[g, 0] = e
            else:
                owner[g, 1] = e
    interior = owner[:, 1] >= 0
    e0, e1 = owner[interior, 0], owner[interior, 1]
    tang = pts[edges[interior, 1]] - pts[edges[interior, 0]]
    h_e = np.linalg.norm(tang, axis=1)
    normal = np.stack([tang[:, 1], -tang[:, 0]], axis=1) / h_e[:, None]
    jump = np.einsum("ek,ek->e", grad[e0] - grad[e1], normal)
    contrib = 0.5 * h_e * (jump ** 2) * h_e  # ∫_e [∂n u]² ds = h_e·jump²
    np.add.at(eta2, e0, 0.5 * contrib)
    np.add.at(eta2, e1, 0.5 * contrib)
    return np.sqrt(eta2)


def _error_estimate_p1_3d(mesh: Mesh, u: np.ndarray,
                          f: Optional[Callable]) -> np.ndarray:
    """3D residual estimator: η_T² = h_T²·vol·f² + ½ Σ_F h_F·area_F·[∂n u]²
    over interior faces F (the tet analog of the 2D edge jumps)."""
    pts = mesh.points
    elems = mesh.elements[:, :4]
    E = len(elems)
    v = pts[elems]  # [E, 4, 3]
    B = np.swapaxes(v[:, 1:] - v[:, :1], 1, 2)  # [E, 3, 3] columns = edges
    detB = np.linalg.det(B)
    vol = np.abs(detB) / 6.0
    h_T = np.cbrt(vol)

    gref = np.array([[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0],
                     [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    Binv = np.linalg.inv(B)  # [E, 3, 3]
    gref_u = np.einsum("ad,ea->ed", gref, u[elems])  # [E, 3]
    grad = np.einsum("edk,ed->ek", Binv, gref_u)     # [E, 3] const per tet

    if f is not None:
        cent = v.mean(axis=1)
        fc = np.array([f(c) for c in cent], dtype=float)
    else:
        fc = np.zeros(E)
    eta2 = h_T ** 2 * vol * fc ** 2

    # interior faces: 4 per tet (opposite each vertex), matched by sorted
    # vertex triple
    local_faces = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]
    faces = np.stack([np.sort(elems[:, list(lf)], axis=1)
                      for lf in local_faces], axis=1).reshape(-1, 3)
    owner_elem = np.repeat(np.arange(E), 4)
    uniq, inv, counts = np.unique(faces, axis=0, return_inverse=True,
                                  return_counts=True)
    order = np.argsort(inv, kind="stable")
    # for interior faces (count 2) the two owners are adjacent in `order`
    starts = np.concatenate([[0], np.cumsum(counts)])
    interior = counts == 2
    first = order[starts[:-1][interior]]
    second = order[starts[:-1][interior] + 1]
    e0, e1 = owner_elem[first], owner_elem[second]
    tri = pts[uniq[interior]]  # [F, 3, 3]
    nvec = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area2 = np.linalg.norm(nvec, axis=1)  # 2·area
    area = area2 / 2.0
    normal = nvec / area2[:, None]
    jump = np.einsum("ek,ek->e", grad[e0] - grad[e1], normal)
    h_F = np.sqrt(area)
    contrib = 0.5 * h_F * area * jump ** 2
    np.add.at(eta2, e0, contrib)
    np.add.at(eta2, e1, contrib)
    return np.sqrt(eta2)


def _p2_ref_hessians(dim: int) -> np.ndarray:
    """Constant reference Hessians of the P2 basis (verts then midpoints
    in P2_EDGE_ORDER): φ_vert = λ(2λ−1) → H = 4∇λ∇λᵀ;
    φ_edge(i,j) = 4λiλj → H = 4(∇λi∇λjᵀ + ∇λj∇λiᵀ)."""
    dlam = np.vstack([-np.ones(dim), np.eye(dim)])  # [(dim+1), dim]
    H = [4.0 * np.outer(d, d) for d in dlam]
    for i, j in P2_EDGE_ORDER[dim]:
        H.append(4.0 * (np.outer(dlam[i], dlam[j])
                        + np.outer(dlam[j], dlam[i])))
    return np.stack(H)


def error_estimate_p2(mesh: Mesh, u: np.ndarray,
                      f: Optional[Callable] = None) -> np.ndarray:
    """Residual estimator for a P2 scalar solution of −Δu = f, 2D and 3D:
    η_T² = h_T² ‖f + Δu_h‖²_T + ½ Σ_F h_F ‖[∂u_h/∂n]‖²_F with Δu_h
    constant per element and ∂u_h/∂n linear per facet (2-point Gauss on
    edges / mid-edge rule on faces, both exact) — the P2 branch of the
    reference's errorEstimation (MeshUnstructuredRefinement_def.hpp:229;
    round-1 VERDICT item 9).  Returns η per element of the P2 mesh (same
    ordering as its P1 parent, so marks transfer directly)."""
    from feddlib_tpu_torch.fe import reference as fe_ref

    if mesh.fe_type != "P2" or mesh.dim not in (2, 3):
        raise NotImplementedError("error_estimate_p2: 2D/3D P2 meshes")
    dim = mesh.dim
    nv = dim + 1
    pts = mesh.points
    elems = mesh.elements
    E = len(elems)
    v = pts[elems[:, :nv]]
    B = np.swapaxes(v[:, 1:] - v[:, :1], 1, 2)
    detB = np.linalg.det(B)
    vol = np.abs(detB) / (2.0 if dim == 2 else 6.0)
    h_T = vol ** (1.0 / dim)
    Binv = np.linalg.inv(B)

    ue = u[elems]
    Hxi = np.einsum("ea,aij->eij", ue, _p2_ref_hessians(dim))
    # H_x = Binvᵀ Hξ Binv  (∇x = Binvᵀ ∇ξ)
    Hx = np.einsum("edi,edk,ekj->eij", Binv, Hxi, Binv)
    lap = np.trace(Hx, axis1=1, axis2=2)

    if f is not None:
        cent = v.mean(axis=1)
        fc = np.array([f(c) for c in cent], dtype=float)
    else:
        fc = np.zeros(E)
    eta2 = h_T ** 2 * vol * (fc + lap) ** 2

    # facet jumps over the P1 parent facet graph
    if dim == 2:
        from feddlib_tpu_torch.mesh.mesh import Mesh as _M

        parent = _M(2, "P1", pts[: mesh.n_points], mesh.point_flags,
                    elems[:, :3], mesh.element_flags)
        facets, elem_facet = parent.unique_edges()
        n_fv = 2
    else:
        local_faces = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]
        fc_all = np.stack([np.sort(elems[:, list(lf)], axis=1)
                           for lf in local_faces], axis=1).reshape(-1, 3)
        facets, inv = np.unique(fc_all, axis=0, return_inverse=True)
        elem_facet = inv.reshape(E, 4)
        n_fv = 3
    n_f = len(facets)
    owner = np.full((n_f, 2), -1, dtype=np.int64)
    for e in range(E):
        for lf in range(nv):
            g = elem_facet[e, lf]
            s = 0 if owner[g, 0] < 0 else 1
            owner[g, s] = e
    interior = owner[:, 1] >= 0
    ie = np.nonzero(interior)[0]
    fv = pts[facets[ie]]  # [I, n_fv, dim]
    if dim == 2:
        tang = fv[:, 1] - fv[:, 0]
        meas = np.linalg.norm(tang, axis=1)  # length
        normal = np.stack([tang[:, 1], -tang[:, 0]], axis=1) / meas[:, None]
        h_F = meas
        # 2-point Gauss, weights 1/2
        g1 = 0.5 - 0.5 / np.sqrt(3.0)
        qpts = [((1 - s) * fv[:, 0] + s * fv[:, 1], 0.5)
                for s in (g1, 1 - g1)]
    else:
        nvec = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
        meas = 0.5 * np.linalg.norm(nvec, axis=1)  # area
        normal = nvec / (2.0 * meas[:, None])
        h_F = np.sqrt(meas)
        # mid-edge rule, weights 1/3 — exact for quadratics on triangles
        qpts = [(0.5 * (fv[:, a] + fv[:, b]), 1.0 / 3.0)
                for a, b in ((0, 1), (1, 2), (0, 2))]

    jump2 = np.zeros(len(ie))
    for xg, w in qpts:
        grads = []
        for k in (0, 1):
            el = owner[ie, k]
            p0 = pts[elems[el, 0]]
            xi = np.einsum("eij,ej->ei", np.linalg.inv(B[el]), xg - p0)
            gref = fe_ref.eval_grad_phi(dim, "P2", xi)  # [I, nb, dim]
            ge = np.einsum("pad,pa->pd", gref, u[elems[el]])
            gx = np.einsum("edk,ed->ek", Binv[el], ge)
            grads.append(gx)
        jn = np.einsum("ek,ek->e", grads[0] - grads[1], normal)
        jump2 += w * jn ** 2
    contrib = 0.5 * h_F * (jump2 * meas)  # ½ h_F ∫_F [∂n u]²
    np.add.at(eta2, owner[ie, 0], contrib)
    np.add.at(eta2, owner[ie, 1], contrib)
    return np.sqrt(eta2)


def mark_elements(eta: np.ndarray, strategy: str = "Doerfler",
                  theta: float = 0.5) -> np.ndarray:
    """Boolean mark array (reference marking strategies :468/:477)."""
    if strategy == "Maximum":
        return eta >= theta * eta.max()
    if strategy in ("Doerfler", "Dörfler"):
        # THRESHOLD semantics: mark {η ≥ v*} where v* is the stopping
        # value of the greedy accumulation, INCLUDING all ties of v* —
        # the reference's reduceAll-threshold form
        # (MeshUnstructuredRefinement_def.hpp:477-487), and identical to
        # the distributed bisected-threshold marking (mark_distributed)
        order = np.argsort(eta)[::-1]
        c = np.cumsum(eta[order] ** 2)
        total = c[-1]
        k = int(np.searchsorted(c, theta * total)) + 1
        return eta >= eta[order[min(k, len(eta)) - 1]]
    if strategy == "Uniform":
        return np.ones(len(eta), dtype=bool)
    raise ValueError(f"unknown marking strategy {strategy!r}")


# ---------------------------------------------------------------------------
# refinement
# ---------------------------------------------------------------------------

def refine_mesh_2d(mesh: Mesh, marked: np.ndarray, blue: bool = True) -> Mesh:
    """Red/green/blue refinement of marked triangles (reference
    MeshUnstructuredRefinement: refineRegular 'red' :2467, refineGreen
    :2122, refineBlue :1905).  blue=True handles two-marked-edge elements
    with the 3-child blue pattern (no propagation); blue=False promotes
    them to red and iterates the closure (the pre-blue behavior)."""
    if mesh.dim != 2 or mesh.fe_type != "P1":
        raise NotImplementedError("red/green refinement: 2D P1 meshes")
    elems = mesh.elements
    E = len(elems)
    edges, elem_edge = mesh.unique_edges()
    n_edges = len(edges)

    edge_marked = np.zeros(n_edges, dtype=bool)
    edge_marked[elem_edge[marked].ravel()] = True
    if not blue:
        # closure: ≥2 marked edges → red (mark all 3); iterate
        while True:
            cnt = edge_marked[elem_edge].sum(axis=1)
            promote = cnt >= 2
            new_marks = elem_edge[promote].ravel()
            before = edge_marked.sum()
            edge_marked[new_marks] = True
            if edge_marked.sum() == before:
                break
    cnt = edge_marked[elem_edge].sum(axis=1)

    # new midpoint nodes for marked edges
    mid_id = np.full(n_edges, -1, dtype=np.int64)
    m_edges = np.nonzero(edge_marked)[0]
    mid_id[m_edges] = mesh.n_points + np.arange(len(m_edges))
    midpoints = 0.5 * (mesh.points[edges[m_edges, 0]]
                       + mesh.points[edges[m_edges, 1]])

    # midpoint flags: if the edge is a flagged boundary surface, inherit
    mid_flags = np.zeros(len(m_edges), dtype=np.int32)
    surf_lookup = {}
    if mesh.surfaces is not None:
        for s, fl in zip(np.sort(mesh.surfaces, axis=1), mesh.surface_flags):
            surf_lookup[(int(s[0]), int(s[1]))] = int(fl)
        for i, ge in enumerate(m_edges):
            key = (int(edges[ge, 0]), int(edges[ge, 1]))
            if key in surf_lookup:
                mid_flags[i] = surf_lookup[key]

    new_elems = []
    new_flags = []

    def _coord(nid):
        return (mesh.points[nid] if nid < mesh.n_points
                else midpoints[nid - mesh.n_points])

    # local edges in P2 order: (0,1),(1,2),(0,2)
    pair = P2_EDGE_ORDER[2]
    for e in range(E):
        vv = elems[e]
        ee = elem_edge[e]
        mk = edge_marked[ee]
        fl = mesh.element_flags[e]
        if cnt[e] == 0:
            new_elems.append([vv[0], vv[1], vv[2]])
            new_flags.append(fl)
        elif cnt[e] == 3:  # red: 4 children
            m01, m12, m02 = mid_id[ee[0]], mid_id[ee[1]], mid_id[ee[2]]
            new_elems += [[vv[0], m01, m02], [m01, vv[1], m12],
                          [m02, m12, vv[2]], [m01, m12, m02]]
            new_flags += [fl] * 4
        elif cnt[e] == 2:  # blue: 3 children (refineBlue :1905)
            # marked edges share vertex b; quad (a, m_ab, m_bc, c) is split
            # along its SHORTER diagonal (deterministic)
            l1, l2 = np.nonzero(mk)[0]
            (i1, j1), (i2, j2) = pair[l1], pair[l2]
            common = set((i1, j1)) & set((i2, j2))
            b_l = common.pop()
            a_l = i1 + j1 - b_l
            c_l = i2 + j2 - b_l
            a, b_, c = vv[a_l], vv[b_l], vv[c_l]
            m_ab = mid_id[ee[l1]]
            m_bc = mid_id[ee[l2]]
            d1 = np.sum((_coord(m_ab) - mesh.points[c]) ** 2)
            d2 = np.sum((_coord(m_bc) - mesh.points[a]) ** 2)
            new_elems.append([m_ab, b_, m_bc])
            if d1 <= d2:  # diagonal (m_ab, c)
                new_elems += [[a, m_ab, c], [m_ab, m_bc, c]]
            else:         # diagonal (a, m_bc)
                new_elems += [[a, m_ab, m_bc], [a, m_bc, c]]
            new_flags += [fl] * 3
        else:  # green: bisect through the single marked edge
            le = int(np.nonzero(mk)[0][0])
            i, j = pair[le]
            k = 3 - i - j
            m = mid_id[ee[le]]
            new_elems += [[vv[k], vv[i], m], [vv[k], m, vv[j]]]
            new_flags += [fl] * 2

    points = np.concatenate([mesh.points, midpoints])
    pflags = np.concatenate([mesh.point_flags, mid_flags])

    # orientation fix (blue children may invert the relabeled order)
    ne = np.array(new_elems, dtype=np.int64)
    p = points[ne]
    d = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
         - (p[:, 1, 1] - p[:, 0, 1]) * (p[:, 2, 0] - p[:, 0, 0]))
    neg = d < 0
    ne[neg, 1], ne[neg, 2] = ne[neg, 2].copy(), ne[neg, 1].copy()
    new_elems = ne.tolist()

    # rebuild boundary surfaces: split flagged edges that got midpoints
    new_surf, new_sflags = [], []
    if mesh.surfaces is not None:
        edge_key = {(int(a), int(b)): gi
                    for gi, (a, b) in enumerate(edges)}
        for s, fl in zip(mesh.surfaces, mesh.surface_flags):
            a, b = int(s[0]), int(s[1])
            key = (min(a, b), max(a, b))
            gi = edge_key.get(key)
            if gi is not None and edge_marked[gi]:
                m = mid_id[gi]
                new_surf += [[a, m], [m, b]]
                new_sflags += [fl, fl]
            else:
                new_surf.append([a, b])
                new_sflags.append(fl)

    out = Mesh(2, "P1", points, pflags,
               np.array(new_elems, dtype=np.int64),
               np.array(new_flags, dtype=np.int32),
               surfaces=np.array(new_surf, dtype=np.int64) if new_surf else None,
               surface_flags=(np.array(new_sflags, dtype=np.int32)
                              if new_surf else None))
    return out


# ---------------------------------------------------------------------------
# distributed AMR (per-part estimate / mark / refine with tagged-edge
# reconciliation — reference MeshUnstructuredRefinement_decl.hpp:90-99)
# ---------------------------------------------------------------------------

def estimate_distributed(mesh: Mesh, part, u: np.ndarray,
                         f: Optional[Callable] = None) -> list:
    """Per-part error estimation on OWNED elements only: each part works
    on its owned elements plus ONE ghost layer of face-neighbors (the
    ∇u ghost exchange of the jump terms — O(local cut) data), never on
    the replicated element set.  Returns per-part η arrays over owned
    elements; their concatenation equals the serial estimator exactly."""
    elems = mesh.elements
    if mesh.dim == 2:
        edges, elem_edge = mesh.unique_edges()
        n_ent = len(edges)
        ent_of_elem = elem_edge
    else:
        faces = np.sort(np.stack([elems[:, [1, 2, 3]], elems[:, [0, 2, 3]],
                                  elems[:, [0, 1, 3]], elems[:, [0, 1, 2]]],
                                 axis=1), axis=2)
        flat = faces.reshape(-1, 3)
        _, inv = np.unique(flat, axis=0, return_inverse=True)
        ent_of_elem = inv.reshape(len(elems), -1)
        n_ent = int(ent_of_elem.max()) + 1
    # entity → adjacent elements (≤2)
    e0 = np.full(n_ent, -1, np.int64)
    e1 = np.full(n_ent, -1, np.int64)
    for e in range(len(elems)):
        for g in ent_of_elem[e]:
            if e0[g] < 0:
                e0[g] = e
            else:
                e1[g] = e

    out = []
    for p in range(part.n_parts):
        own = np.asarray(part.elem_ids[p])
        own_set = np.zeros(len(elems), bool)
        own_set[own] = True
        # ghost layer: face-neighbors of owned elements (the exchanged ∇u)
        ents = np.unique(ent_of_elem[own].ravel())
        nb = np.unique(np.concatenate([e0[ents], e1[ents]]))
        nb = nb[(nb >= 0) & ~own_set[nb]]
        patch = np.concatenate([own, nb])
        # patch submesh (local ids)
        pnodes, pelems = np.unique(elems[patch].ravel(),
                                   return_inverse=True)
        sub = Mesh(mesh.dim, "P1", mesh.points[pnodes],
                   mesh.point_flags[pnodes],
                   pelems.reshape(len(patch), -1),
                   np.zeros(len(patch), np.int32))
        eta_patch = error_estimate_p1(sub, np.asarray(u)[pnodes], f)
        out.append(eta_patch[: len(own)])
    return out


def mark_distributed(eta_parts: list, strategy: str = "Doerfler",
                     theta: float = 0.5) -> list:
    """Global marking from per-part indicators using only ALLREDUCE-style
    scalars (the reference's reduceAll, MeshUnstructuredRefinement_def.hpp
    :487): Maximum needs one global max; Dörfler finds the threshold t*
    with Σ_{η≥t*} η² ≥ θ Σ η² by bisection on globally-summed scalars —
    no global sort, no gathered η array.  Returns per-part bool masks."""
    sq = [np.asarray(e) ** 2 for e in eta_parts]
    gmax = max((float(e.max()) if len(e) else 0.0) for e in eta_parts)
    if strategy == "Maximum":
        return [np.asarray(e) >= theta * gmax for e in eta_parts]
    total = sum(float(s.sum()) for s in sq)  # psum
    lo, hi = 0.0, gmax
    for _ in range(50):  # bisection on the threshold (50 psums)
        mid = 0.5 * (lo + hi)
        covered = sum(float(s[np.sqrt(s) >= mid].sum()) for s in sq)
        if covered >= theta * total:
            lo = mid
        else:
            hi = mid
    return [np.asarray(e) >= lo for e in eta_parts]


def refine_distributed_2d(mesh: Mesh, part, marked_parts: list,
                          blue: bool = True):
    """Per-part red/green/blue refinement with cross-part TAGGED-EDGE
    reconciliation (reference MeshUnstructuredRefinement_decl.hpp:90-99):

    1. each part tags the edges of ITS marked owned elements;
    2. tags on shared edges are exchanged neighbor-wise (one round for
       the blue closure, which never propagates; iterated to a fixed
       point for blue=False red-promotion);
    3. each part refines its OWNED elements from the reconciled tags;
       midpoint ids derive from the GLOBAL edge keys, so all parts agree
       on shared new nodes without further communication.

    Returns (refined mesh, per-part exchanged-tag counts).  The merged
    result is partition-count invariant and equals the serial
    refine_mesh_2d geometry."""
    n_parts = part.n_parts
    edges, elem_edge = mesh.unique_edges()
    n_edges = len(edges)
    elems = mesh.elements

    # which parts touch each edge (via their owned elements)
    owner_sets = []
    tags = []
    for p in range(n_parts):
        own = np.asarray(part.elem_ids[p])
        touched = np.zeros(n_edges, bool)
        touched[elem_edge[own].ravel()] = True
        owner_sets.append(touched)
        t = np.zeros(n_edges, bool)
        t[elem_edge[own[np.asarray(marked_parts[p], bool)]].ravel()] = True
        tags.append(t)

    exchanged = [0] * n_parts

    def _reconcile():
        # neighbor-wise exchange of tags on SHARED edges (O(cut) keys)
        changed = False
        for p in range(n_parts):
            for q in range(p + 1, n_parts):
                shared = owner_sets[p] & owner_sets[q]
                if not shared.any():
                    continue
                sp = tags[p] & shared
                sq = tags[q] & shared
                new_q = sp & ~tags[q]
                new_p = sq & ~tags[p]
                exchanged[p] += int(new_p.sum())
                exchanged[q] += int(new_q.sum())
                if new_q.any():
                    tags[q] |= new_q
                    changed = True
                if new_p.any():
                    tags[p] |= new_p
                    changed = True
        return changed

    if blue:
        _reconcile()  # blue closure never propagates: ONE round suffices
    else:
        while True:  # red-promotion closure ↔ exchange to fixed point
            for p in range(n_parts):
                own = np.asarray(part.elem_ids[p])
                while True:
                    cnt = tags[p][elem_edge[own]].sum(axis=1)
                    promote = own[cnt >= 2]
                    before = tags[p].sum()
                    tags[p][elem_edge[promote].ravel()] = True
                    if tags[p].sum() == before:
                        break
            if not _reconcile():
                break

    # per-part refinement of owned elements from the reconciled tags;
    # midpoints numbered by GLOBAL edge id (deterministic across parts)
    edge_marked = np.zeros(n_edges, bool)
    for p in range(n_parts):
        edge_marked |= tags[p] & owner_sets[p]
    mid_id = np.full(n_edges, -1, np.int64)
    m_edges = np.flatnonzero(edge_marked)
    mid_id[m_edges] = mesh.n_points + np.arange(len(m_edges))
    midpoints = 0.5 * (mesh.points[edges[m_edges, 0]]
                       + mesh.points[edges[m_edges, 1]])
    mid_flags = np.zeros(len(m_edges), dtype=np.int32)
    if mesh.surfaces is not None:
        surf_lookup = {}
        for s, fl in zip(np.sort(mesh.surfaces, axis=1),
                         mesh.surface_flags):
            surf_lookup[(int(s[0]), int(s[1]))] = int(fl)
        for i, ge in enumerate(m_edges):
            key = (int(edges[ge, 0]), int(edges[ge, 1]))
            if key in surf_lookup:
                mid_flags[i] = surf_lookup[key]

    pair = P2_EDGE_ORDER[2]
    part_children = []
    for p in range(n_parts):
        own = np.asarray(part.elem_ids[p])
        kids = _split_elements_2d(mesh, midpoints, elems, elem_edge,
                                  edge_marked, mid_id, own, pair, blue)
        part_children.append(kids)

    new_elems = np.concatenate(part_children)
    # merged mesh (the verification form; production keeps per-part pieces)
    pts = np.concatenate([mesh.points, midpoints])
    flags = np.concatenate([mesh.point_flags, mid_flags])
    # orientation fix (blue children may invert the relabeled order)
    p = pts[new_elems]
    d = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
         - (p[:, 1, 1] - p[:, 0, 1]) * (p[:, 2, 0] - p[:, 0, 0]))
    neg = d < 0
    new_elems[neg, 1], new_elems[neg, 2] = \
        new_elems[neg, 2].copy(), new_elems[neg, 1].copy()
    out = Mesh(2, "P1", pts, flags, new_elems,
               np.zeros(len(new_elems), np.int32))
    _rebuild_boundary_surfaces_2d(out, mesh, edges, m_edges, mid_id)
    return out, exchanged


def _split_elements_2d(mesh, midpoints, elems, elem_edge, edge_marked,
                       mid_id, subset, pair, blue):
    """Red/green/blue children of `subset` elements under the given edge
    marks — the SAME local rules as refine_mesh_2d (blue splits the quad
    along its shorter diagonal), so the merged distributed result is
    geometry-identical to the serial refinement."""
    def _coord(nid):
        return (mesh.points[nid] if nid < mesh.n_points
                else midpoints[nid - mesh.n_points])

    out = []
    for e in subset:
        vv = elems[e]
        ee = elem_edge[e]
        mk = edge_marked[ee]
        n_mk = int(mk.sum())
        if n_mk == 0:
            out.append([vv[0], vv[1], vv[2]])
        elif n_mk == 3:
            m01, m12, m02 = mid_id[ee[0]], mid_id[ee[1]], mid_id[ee[2]]
            out += [[vv[0], m01, m02], [m01, vv[1], m12],
                    [m02, m12, vv[2]], [m01, m12, m02]]
        elif n_mk == 1:
            le = int(np.nonzero(mk)[0][0])
            i, j = pair[le]
            k = 3 - i - j
            m = mid_id[ee[le]]
            out += [[vv[k], vv[i], m], [vv[k], m, vv[j]]]
        else:  # blue: split the (a, m_ab, m_bc, c) quad on the shorter diag
            if not blue:
                raise AssertionError("closure left a 2-marked element")
            l1, l2 = np.nonzero(mk)[0]
            (i1, j1), (i2, j2) = pair[l1], pair[l2]
            common = set((i1, j1)) & set((i2, j2))
            b_l = common.pop()
            a_l = i1 + j1 - b_l
            c_l = i2 + j2 - b_l
            a, b_, c = vv[a_l], vv[b_l], vv[c_l]
            m_ab = mid_id[ee[l1]]
            m_bc = mid_id[ee[l2]]
            d1 = np.sum((_coord(m_ab) - mesh.points[c]) ** 2)
            d2 = np.sum((_coord(m_bc) - mesh.points[a]) ** 2)
            out.append([m_ab, b_, m_bc])
            if d1 <= d2:
                out += [[a, m_ab, c], [m_ab, m_bc, c]]
            else:
                out += [[a, m_ab, m_bc], [a, m_bc, c]]
    return np.asarray(out, dtype=np.int64)


def _rebuild_boundary_surfaces_2d(out: Mesh, mesh: Mesh, edges, m_edges,
                                  mid_id):
    """Split flagged boundary edges of the refined mesh (flags inherit)."""
    if mesh.surfaces is None:
        return
    new_surfs, new_sflags = [], []
    marked_set = {}
    for ge in m_edges:
        key = (int(edges[ge, 0]), int(edges[ge, 1]))
        marked_set[key] = int(mid_id[ge])
    for s, fl in zip(np.sort(mesh.surfaces, axis=1), mesh.surface_flags):
        key = (int(s[0]), int(s[1]))
        if key in marked_set:
            m = marked_set[key]
            new_surfs += [[s[0], m], [m, s[1]]]
            new_sflags += [int(fl), int(fl)]
        else:
            new_surfs.append([int(s[0]), int(s[1])])
            new_sflags.append(int(fl))
    out.surfaces = np.asarray(new_surfs, dtype=np.int64)
    out.surface_flags = np.asarray(new_sflags, dtype=np.int32)


def refine_uniform(mesh: Mesh) -> Mesh:
    """Uniform red refinement: every triangle → 4, every tet → 8."""
    if mesh.dim == 2:
        return refine_mesh_2d(mesh, np.ones(mesh.n_elements, dtype=bool))
    # 3D red refinement of tets
    elems = mesh.elements[:, :4]
    edges, elem_edge = mesh.unique_edges()
    n_p = mesh.n_points
    mids = 0.5 * (mesh.points[edges[:, 0]] + mesh.points[edges[:, 1]])
    points = np.concatenate([mesh.points, mids])
    mid = n_p + elem_edge  # [E, 6] global midpoint ids per element
    v = elems
    # edge order (0,1),(1,2),(0,2),(0,3),(1,3),(2,3)  (P2_EDGE_ORDER)
    m01, m12, m02, m03, m13, m23 = (mid[:, i] for i in range(6))
    corners = [
        np.stack([v[:, 0], m01, m02, m03], 1),
        np.stack([v[:, 1], m01, m12, m13], 1),
        np.stack([v[:, 2], m02, m12, m23], 1),
        np.stack([v[:, 3], m03, m13, m23], 1),
    ]
    # interior octahedron: opposite pairs (m01,m23), (m02,m13), (m03,m12);
    # split along the SHORTEST diagonal per element (Bey/Zhang — a fixed
    # diagonal degenerates on right/Kuhn tets)
    def _octa(a, b, c1, c2, c3, c4):
        # cycle c1..c4 around diagonal (a, b)
        return [np.stack([a, b, c1, c2], 1), np.stack([a, b, c2, c3], 1),
                np.stack([a, b, c3, c4], 1), np.stack([a, b, c4, c1], 1)]

    diag_opts = [
        (m01, m23, m02, m03, m13, m12),
        (m02, m13, m01, m03, m23, m12),
        (m03, m12, m01, m02, m23, m13),
    ]
    dlen = np.stack([
        np.linalg.norm(points[m01] - points[m23], axis=1),
        np.linalg.norm(points[m02] - points[m13], axis=1),
        np.linalg.norm(points[m03] - points[m12], axis=1),
    ])  # [3, E]
    choice = np.argmin(dlen, axis=0)  # [E]
    octas = [np.stack(_octa(*opt), axis=1) for opt in diag_opts]  # [E,4,4] each
    octa_sel = np.stack(octas, axis=0)[choice, np.arange(len(choice))]  # [E,4,4]
    children = corners + [octa_sel[:, i, :] for i in range(4)]
    new_elems = np.concatenate(children, axis=0)
    new_flags = np.tile(mesh.element_flags, 8)
    # fix orientation
    p = points[new_elems]
    d = np.linalg.det(p[:, 1:] - p[:, :1])
    neg = d < 0
    new_elems[neg, 2], new_elems[neg, 3] = (new_elems[neg, 3].copy(),
                                            new_elems[neg, 2].copy())
    # point flags: a midpoint whose edge lies inside a flagged boundary
    # triangle inherits that flag (min over incident surfaces, as in P2
    # construction)
    mid_flags = np.zeros(len(edges), dtype=np.int32)
    if mesh.surfaces is not None and len(mesh.surfaces):
        key = edges[:, 0] * (n_p + 1) + edges[:, 1]
        order = np.argsort(key)
        sv = np.sort(mesh.surfaces, axis=1)
        sentinel = np.iinfo(np.int32).max
        tmp = np.full(len(edges), sentinel, dtype=np.int64)
        for pr in ((0, 1), (1, 2), (0, 2)):
            se = np.sort(sv[:, list(pr)], axis=1)
            skey = se[:, 0] * (n_p + 1) + se[:, 1]
            pos = np.searchsorted(key[order], skey)
            pos = np.clip(pos, 0, len(key) - 1)
            ok = key[order][pos] == skey
            np.minimum.at(tmp, order[pos[ok]],
                          mesh.surface_flags[ok].astype(np.int64))
        mid_flags = np.where(tmp == sentinel, 0, tmp).astype(np.int32)
    pflags = np.concatenate([mesh.point_flags, mid_flags])
    out = Mesh(3, "P1", points, pflags, new_elems, new_flags)
    # regenerate boundary surfaces from facet counts
    from feddlib_tpu_torch.mesh.structured import _boundary_tris_3d

    out.surfaces, out.surface_flags = _boundary_tris_3d(out)
    return out


def refine_mesh_3d(mesh: Mesh, marked: np.ndarray) -> Mesh:
    """3D red-green refinement: marked tets are red-refined (8 children
    over all 6 edge midpoints, shortest-diagonal octahedron split), and
    neighbor tets with hanging midpoints get a GREEN closure — successive
    multisection through their existing midpoints only (no new points, so
    no propagation; the reference's 3D tagged-edge closure role,
    MeshUnstructuredRefinement_decl.hpp:78-99)."""
    if mesh.dim != 3 or mesh.fe_type != "P1":
        raise NotImplementedError("refine_mesh_3d: 3D P1 meshes")
    elems = mesh.elements[:, :4]
    E = len(elems)
    edges, elem_edge = mesh.unique_edges()
    n_p = mesh.n_points

    # red set closure (Bey-style): a fully-marked face against a red
    # neighbor is handled by the GREEN-FACE 4-child pattern (matching the
    # red side's midpoint-triangle face split) — but only when that face's
    # 3 midpoints are the tet's ONLY hanging midpoints; any tet with a
    # fully-marked face PLUS further midpoints is promoted to red and the
    # closure iterates.  (Local faces opposite vertices 0..3 expressed in
    # the P2 edge order (0,1),(1,2),(0,2),(0,3),(1,3),(2,3).)
    face_edges = np.array([[1, 5, 4], [2, 5, 3], [0, 4, 3], [0, 1, 2]])
    red = marked.copy()
    edge_marked = np.zeros(len(edges), dtype=bool)
    while True:
        edge_marked[elem_edge[red].ravel()] = True
        em = edge_marked[elem_edge]  # [E, 6]
        n_full = em[:, face_edges].all(axis=2).sum(axis=1)
        promote = (((n_full == 1) & (em.sum(axis=1) > 3)) | (n_full > 1)) \
            & ~red
        if not promote.any():
            break
        red |= promote
    marked = red
    em = edge_marked[elem_edge]
    full_face = em[:, face_edges].all(axis=2)  # [E, 4]
    m_edges = np.nonzero(edge_marked)[0]
    mid_of = np.full(len(edges), -1, dtype=np.int64)
    mid_of[m_edges] = n_p + np.arange(len(m_edges))
    midpoints = 0.5 * (mesh.points[edges[m_edges, 0]]
                       + mesh.points[edges[m_edges, 1]])
    points = np.concatenate([mesh.points, midpoints])
    mid_lookup = {}  # sorted vertex pair → node id
    for ge in m_edges:
        mid_lookup[(int(edges[ge, 0]), int(edges[ge, 1]))] = int(mid_of[ge])

    new_elems, new_flags = [], []
    for e in range(E):
        vv = elems[e]
        fl = mesh.element_flags[e]
        if marked[e]:
            mid = mid_of[elem_edge[e]]  # 6 global midpoint ids
            m01, m12, m02, m03, m13, m23 = (int(m) for m in mid)
            corners = [[vv[0], m01, m02, m03], [vv[1], m01, m12, m13],
                       [vv[2], m02, m12, m23], [vv[3], m03, m13, m23]]
            # octahedron: shortest diagonal of (m01,m23),(m02,m13),(m03,m12)
            diags = [(m01, m23), (m02, m13), (m03, m12)]
            rings = [(m02, m03, m13, m12), (m01, m03, m23, m12),
                     (m01, m02, m23, m13)]
            dlen = [np.sum((points[a] - points[b]) ** 2) for a, b in diags]
            k = int(np.argmin(dlen))
            a, b = diags[k]
            c1, c2, c3, c4 = rings[k]
            octa = [[a, b, c1, c2], [a, b, c2, c3],
                    [a, b, c3, c4], [a, b, c4, c1]]
            new_elems += corners + octa
            new_flags += [fl] * 8
        elif full_face[e].any():
            # green-face: the 3 midpoints of ONE fully-marked face → 4
            # children matching the red neighbor's face triangulation
            ff = int(np.nonzero(full_face[e])[0][0])
            local_faces = [(1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2)]
            fa, fb, fc = (vv[k] for k in local_faces[ff])
            d_v = vv[ff]  # opposite vertex
            m_ab = mid_lookup[(min(fa, fb), max(fa, fb))]
            m_bc = mid_lookup[(min(fb, fc), max(fb, fc))]
            m_ac = mid_lookup[(min(fa, fc), max(fa, fc))]
            new_elems += [[fa, m_ab, m_ac, d_v], [fb, m_ab, m_bc, d_v],
                          [fc, m_ac, m_bc, d_v], [m_ab, m_bc, m_ac, d_v]]
            new_flags += [fl] * 4
        else:
            # green closure: multisect through existing midpoints only
            queue = [list(vv)]
            while queue:
                tet = queue.pop()
                hang = []
                for i in range(4):
                    for j in range(i + 1, 4):
                        key = (min(tet[i], tet[j]), max(tet[i], tet[j]))
                        m = mid_lookup.get(key)
                        if m is not None:
                            d2 = np.sum((points[tet[i]]
                                         - points[tet[j]]) ** 2)
                            hang.append((d2, i, j, m))
                if not hang:
                    new_elems.append(tet)
                    new_flags.append(fl)
                    continue
                # deterministic ACROSS NEIGHBORS: longest hanging edge
                # first, ties broken by GLOBAL vertex ids — both tets
                # sharing a 2-midpoint face then induce the same face
                # triangulation
                hang.sort(key=lambda t: (-t[0],
                                         min(tet[t[1]], tet[t[2]]),
                                         max(tet[t[1]], tet[t[2]])))
                _, i, j, m = hang[0]
                rest = [tet[k2] for k2 in range(4) if k2 not in (i, j)]
                queue.append([tet[i], m] + rest)
                queue.append([m, tet[j]] + rest)

    elements = np.array(new_elems, dtype=np.int64)
    p = points[elements]
    d = np.linalg.det(p[:, 1:] - p[:, :1])
    neg = d < 0
    elements[neg, 2], elements[neg, 3] = (elements[neg, 3].copy(),
                                          elements[neg, 2].copy())

    # midpoint flags: inherit from flagged boundary triangles (as in
    # refine_uniform); then regenerate the boundary surface list
    mid_flags = np.zeros(len(m_edges), dtype=np.int32)
    if mesh.surfaces is not None and len(mesh.surfaces):
        surf_edge = {}
        sv = np.sort(mesh.surfaces, axis=1)
        for s, fl in zip(sv, mesh.surface_flags):
            for pr in ((0, 1), (1, 2), (0, 2)):
                key = (int(s[pr[0]]), int(s[pr[1]]))
                surf_edge[key] = min(surf_edge.get(key, 1 << 30), int(fl))
        for i, ge in enumerate(m_edges):
            key = (int(edges[ge, 0]), int(edges[ge, 1]))
            if key in surf_edge:
                mid_flags[i] = surf_edge[key]
    pflags = np.concatenate([mesh.point_flags, mid_flags])
    out = Mesh(3, "P1", points, pflags, elements,
               np.array(new_flags, dtype=np.int32))
    from feddlib_tpu_torch.mesh.structured import _boundary_tris_3d

    out.surfaces, out.surface_flags = _boundary_tris_3d(out)
    return out


def refine_bisection(mesh: Mesh, marked: np.ndarray,
                     max_rounds: int = 50) -> Mesh:
    """Conforming longest-edge bisection (Rivara) — works in 2D AND 3D,
    giving 3D *adaptive* refinement (the reference's 3D AMR path is its
    red/green machinery; bisection is the standard simplicial alternative
    with guaranteed conformity and bounded shape degradation).

    Iterate: bisect every marked simplex across its longest edge; any
    simplex containing a hanging midpoint becomes marked; repeat to a fixed
    point."""
    if mesh.fe_type != "P1":
        raise NotImplementedError("bisection refinement: P1 meshes")
    dim = mesh.dim
    nv = dim + 1
    points = mesh.points.copy()
    elems = [list(e) for e in mesh.elements[:, :nv]]
    eflags = list(mesh.element_flags)
    need = set(np.nonzero(marked)[0].tolist())
    # midpoint registry: sorted vertex pair → new node id
    midpoint: dict = {}

    def get_mid(a, b):
        nonlocal points
        key = (min(a, b), max(a, b))
        m = midpoint.get(key)
        if m is None:
            m = len(points)
            points = np.concatenate(
                [points, 0.5 * (points[a:a + 1] + points[b:b + 1])])
            midpoint[key] = m
        return m

    for _ in range(max_rounds):
        if not need:
            break
        next_need = set()
        new_elems, new_flags = [], []
        remap = {}
        for ei, verts in enumerate(elems):
            if ei not in need:
                new_elems.append(verts)
                new_flags.append(eflags[ei])
                continue
            # longest edge of this simplex
            best, pair = -1.0, None
            for i in range(nv):
                for j in range(i + 1, nv):
                    d = np.sum((points[verts[i]] - points[verts[j]]) ** 2)
                    if d > best:
                        best, pair = d, (i, j)
            i, j = pair
            m = get_mid(verts[i], verts[j])
            rest = [verts[k] for k in range(nv) if k not in (i, j)]
            new_elems.append([verts[i], m] + rest)
            new_flags.append(eflags[ei])
            new_elems.append([m, verts[j]] + rest)
            new_flags.append(eflags[ei])
        elems, eflags = new_elems, new_flags
        # conformity: any element whose edge has a registered midpoint but
        # does not contain it must be bisected again
        need = set()
        for ei, verts in enumerate(elems):
            vset = set(verts)
            for i in range(nv):
                for j in range(i + 1, nv):
                    key = (min(verts[i], verts[j]), max(verts[i], verts[j]))
                    if key in midpoint and midpoint[key] not in vset:
                        need.add(ei)
                        break
                else:
                    continue
                break

    elements = np.array(elems, dtype=np.int64)
    # orientation fix
    p = points[elements]
    d = np.linalg.det(p[:, 1:] - p[:, :1])
    neg = d < 0
    elements[neg, -2], elements[neg, -1] = (elements[neg, -1].copy(),
                                            elements[neg, -2].copy())
    # point flags: new midpoints inherit boundary flags when both endpoints
    # share one and the midpoint lies on the boundary facet set
    n_old = mesh.n_points
    pflags = np.concatenate([mesh.point_flags,
                             np.zeros(len(points) - n_old, np.int32)])
    out = Mesh(dim, "P1", points, pflags, elements,
               np.array(eflags, dtype=np.int32))
    # regenerate boundary + flags from facet counts
    if dim == 2:
        edges, elem_edge = out.unique_edges()
        cnt = np.zeros(len(edges), dtype=int)
        np.add.at(cnt, elem_edge.ravel(), 1)
        out.surfaces = edges[cnt == 1]
    else:
        from feddlib_tpu_torch.mesh.structured import _boundary_tris_3d

        out.surfaces, _ = _boundary_tris_3d(out)
    out.surface_flags = np.ones(len(out.surfaces), dtype=np.int32)
    # midpoints on boundary facets: flag = min flag of parents (if both >0)
    bnodes = np.unique(out.surfaces)
    for key, m in midpoint.items():
        a, b = key
        if m in set(bnodes.tolist()):
            fa = pflags[a] if a < n_old else out.point_flags[a]
            fb = pflags[b] if b < n_old else out.point_flags[b]
            if fa > 0 and fb > 0:
                out.point_flags[m] = min(fa, fb)
            else:
                out.point_flags[m] = max(out.point_flags[m], 1)
    # all boundary nodes get at least flag 1
    mask0 = out.point_flags[bnodes] == 0
    out.point_flags[bnodes[mask0]] = 1
    return out


def adapt(mesh: Mesh, u: np.ndarray, f: Optional[Callable] = None,
          strategy: str = "Doerfler", theta: float = 0.5,
          method: str = "redgreen") -> Tuple[Mesh, np.ndarray]:
    """One AMR cycle: estimate → mark → refine.  Returns (new mesh, η).
    method: 'redgreen' (2D red/green/blue; 3D red + green closure) or
    'bisection' (2D/3D longest-edge)."""
    eta = error_estimate_p1(mesh, u, f)
    marked = mark_elements(eta, strategy, theta)
    if method == "bisection":
        return refine_bisection(mesh, marked), eta
    if mesh.dim == 3:
        return refine_mesh_3d(mesh, marked), eta
    return refine_mesh_2d(mesh, marked), eta
