"""GDSW coarse space — the FROSch GDSWCoarseOperator equivalent.

Counterpart of the coarse-space half of feddlib_tpu/precond/gdsw.py
(`GDSWCoarseOperator` and the helpers it calls).  The construction is host
numpy/scipy work:

1. *Interface classification*: interface dofs (node held by ≥2 subdomains
   of the repeated maps) grouped into components by their set of touching
   subdomains (vertices/edges/faces arise naturally).
2. *Null space*: constants for scalar problems; translations (+ rotations)
   for elasticity.
3. *Coarse functions* Φ: each null-space vector restricted to each interface
   component, extended harmonically into the subdomain interiors
   (Φ_I = −A_II⁻¹ A_IΓ Φ_Γ, sparse LU per subdomain).
4. *Galerkin coarse operator* A₀ = Φᵀ A Φ (host SpGEMM, or `rap_device`).

`TwoLevelSchwarz` puts the coarse level on top of the one-level
`SchwarzPreconditioner` (precond/schwarz.py), additively or
multiplicatively; `distributed_two_level` puts it on top of
`distributed_schwarz` for the shard-axis solve (parallel/solve.py), its
setup reading only the shards' rows.  The padded two-level preconditioner
of the mixed-precision solve is precond/cluster_coarse.py.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from feddlib_tpu_torch.la.csr import CsrMatrix, ell_apply
from feddlib_tpu_torch.la.dense_blocks import _parallel_map
from feddlib_tpu_torch.la.map import IndexMap
from feddlib_tpu_torch.utils.device import resolve_device


def interface_components(node_part_sets: List[np.ndarray], n_nodes: int,
                         return_sets: bool = False):
    """Group interface nodes by their touching-subdomain set.

    node_part_sets: per-part arrays of (repeated) node ids.
    Returns (components: list of node-id arrays, interface_mask [n_nodes])
    — and the touching sets themselves with return_sets=True.

    Fully vectorized (was a Python loop over parts x nodes — the dominant
    cost of GDSW setup at bench sizes): nodes are grouped by their sorted
    touching-part signature via np.unique over a (-1)-padded signature
    matrix, which sorts identically to the tuple ordering (shorter
    signatures pad with -1 and sort first, as tuple prefix order does)."""
    arr_nodes = np.concatenate(
        [np.asarray(nodes, dtype=np.int64) for nodes in node_part_sets]
        or [np.zeros(0, np.int64)])
    arr_parts = np.concatenate(
        [np.full(len(nodes), p, np.int64)
         for p, nodes in enumerate(node_part_sets)]
        or [np.zeros(0, np.int64)])
    o = np.lexsort((arr_parts, arr_nodes))
    an, ap = arr_nodes[o], arr_parts[o]
    cnt = np.bincount(an, minlength=n_nodes)
    mask = cnt >= 2
    iface_nodes = np.flatnonzero(mask)
    if len(iface_nodes) == 0:
        return ([], mask, []) if return_sets else ([], mask)
    starts = np.concatenate([[0], np.cumsum(cnt)])
    m_star = int(cnt[iface_nodes].max())
    sig = np.full((len(iface_nodes), m_star), -1, np.int64)
    for j in range(m_star):
        has = cnt[iface_nodes] > j
        sig[has, j] = ap[starts[iface_nodes[has]] + j]
    uniq, inv = np.unique(sig, axis=0, return_inverse=True)
    order = np.argsort(inv, kind="stable")
    bounds = np.searchsorted(inv[order], np.arange(len(uniq) + 1))
    comps = [iface_nodes[order[bounds[i]:bounds[i + 1]]]
             for i in range(len(uniq))]
    if return_sets:
        sets = [frozenset(int(v) for v in row if v >= 0) for row in uniq]
        return comps, mask, sets
    return comps, mask


def rgdsw_vertex_weights(comps: List[np.ndarray],
                         sets: List[frozenset]) -> List[List[tuple]]:
    """RGDSW Option 1 coarse-node selection + partition-of-unity weights
    (FROSch RGDSWCoarseOperator / the IPOUHarmonic GDSW* family).

    Coarse nodes = interface components whose touching-subdomain set is
    MAXIMAL under inclusion (the subdomain 'vertices' — faces touch 2
    parts, edges more, vertices the most).  Every other component
    distributes its nullspace values equally among its coarse ancestors
    {v : S_comp ⊆ S_v}; components with no ancestor become coarse nodes
    themselves.  Returns, per coarse node, a list of (comp_index, weight)
    — a partition of unity over the interface."""
    n = len(comps)
    is_coarse = [True] * n
    for i in range(n):
        for j in range(n):
            if i != j and sets[i] < sets[j]:  # proper subset → not maximal
                is_coarse[i] = False
                break
    # promote orphan components (no maximal superset) first, THEN resolve
    # every component's ancestors against the final coarse set
    for i in range(n):
        if not is_coarse[i] and not any(
                is_coarse[j] and sets[i] <= sets[j] for j in range(n)):
            is_coarse[i] = True
    coarse_ids = [i for i in range(n) if is_coarse[i]]
    members: dict = {v: [] for v in coarse_ids}
    for i in range(n):
        if is_coarse[i]:
            members[i].append((i, 1.0))
            continue
        anc = [j for j in coarse_ids if sets[i] <= sets[j]]
        w = 1.0 / len(anc)
        for v in anc:
            members[v].append((i, w))
    return [members[v] for v in coarse_ids]


def classify_entities(comps: List[np.ndarray], sets: List[frozenset],
                      dim: int) -> List[str]:
    """FROSch entity classes per interface component: 'vertex' (single
    node), 'face' (shared by exactly 2 subdomains, 3D), 'edge' (the rest;
    in 2D two-subdomain components are edges) — the classification behind
    IPOUHarmonic's Custom sublist (parametersPrec.xml:84-92:
    Vertices/ShortEdges/StraightEdges/Edges/Faces)."""
    cls = []
    for c, s in zip(comps, sets):
        if len(c) == 1:
            cls.append("vertex")
        elif len(s) == 2:
            cls.append("face" if dim == 3 else "edge")
        else:
            cls.append("edge" if dim == 3 else "vertex")
    return cls


def ipou_groups(comps: List[np.ndarray], sets: List[frozenset], dim: int,
                opts: Optional[dict] = None) -> List[List[tuple]]:
    """Interface-partition-of-unity coarse groups — the FROSch
    IPOUHarmonicCoarseOperator (parametersPrec.xml:63-120): entity classes
    are individually toggleable, and the POU 'Type' selects between
      'GDSW'      one characteristic function per (included) entity;
      'GDSWStar' / 'RGDSW'  root-based partition of unity: roots are the
        included vertex entities, every other included entity distributes
        its interface values equally among its root ancestors
        {v : S_comp ⊆ S_v} (orphans promoted to roots).
    Returns per-group lists of (component index, weight)."""
    opts = opts or {}
    pou = str(opts.get("pou_type", "GDSWStar"))
    include = {"vertex": bool(opts.get("vertices", True)),
               "edge": bool(opts.get("edges", True)),
               "face": bool(opts.get("faces", True))}
    cls = classify_entities(comps, sets, dim)
    keep = [i for i in range(len(comps)) if include[cls[i]]]
    if pou == "GDSW":
        return [[(i, 1.0)] for i in keep]
    roots = [i for i in keep if cls[i] == "vertex"]
    if not roots:  # no vertex entities (e.g. strip decompositions)
        roots = [i for i in keep
                 if not any(sets[i] < sets[j] for j in keep if j != i)]
    members = {v: [(v, 1.0)] for v in roots}
    for i in keep:
        if i in members:
            continue
        anc = [v for v in roots if sets[i] <= sets[v]]
        if not anc:
            members[i] = [(i, 1.0)]  # orphan → own coarse function
            continue
        w = 1.0 / len(anc)
        for v in anc:
            members[v].append((i, w))
    return [members[v] for v in sorted(members)]


def build_null_space(kind: str, points: np.ndarray, dofs_per_node: int):
    """Null-space basis evaluated at nodes → [n_nodes, dofs_per_node, k].

    kind='laplace': constants per component (k = dofs_per_node).
    kind='elasticity': translations + rotations (k = 3 in 2D, 6 in 3D) —
    FROSch null spaces (SURVEY.md §2.8)."""
    n, d = points.shape[0], dofs_per_node
    if kind == "laplace":
        ns = np.zeros((n, d, d))
        for c in range(d):
            ns[:, c, c] = 1.0
        return ns
    if kind == "elasticity":
        dim = d
        k = 3 if dim == 2 else 6
        ns = np.zeros((n, d, k))
        for c in range(dim):
            ns[:, c, c] = 1.0
        if dim == 2:
            ns[:, 0, 2] = -points[:, 1]
            ns[:, 1, 2] = points[:, 0]
        else:
            # rotations about z, x, y
            ns[:, 0, 3] = -points[:, 1]
            ns[:, 1, 3] = points[:, 0]
            ns[:, 1, 4] = -points[:, 2]
            ns[:, 2, 4] = points[:, 1]
            ns[:, 0, 5] = points[:, 2]
            ns[:, 2, 5] = -points[:, 0]
        return ns
    raise ValueError(f"unknown null space {kind!r}")


def _robust_splu(A_csc):
    """splu with a diagonal-shift fallback for (near-)singular interior
    blocks — the KLU pivot-perturbation role (parametersPrec.xml Solver)."""
    try:
        return spla.splu(A_csc)
    except RuntimeError:
        scale = max(np.abs(A_csc.data).max(), 1.0) if A_csc.nnz else 1.0
        eye = sps.identity(A_csc.shape[0], format="csc")
        for eps in (1e-12, 1e-10, 1e-8):
            try:
                return spla.splu(A_csc + eps * scale * eye)
            except RuntimeError:
                continue
        raise


def rap_device(A: CsrMatrix, phi: sps.csr_matrix,
               chunk: int = 128) -> np.ndarray:
    """Galerkin product A₀ = Φᵀ A Φ computed on A's device: chunks of Φ's
    columns are densified [n, c] and pushed through the sparse × dense
    product (Y = AΦ_c), then Φᵀ Y is one segment sum over Φ's nonzeros.
    f64 throughout."""
    n, nc = phi.shape
    dev = A.device
    coo = phi.tocoo()
    prows = torch.as_tensor(coo.row.astype(np.int64), device=dev)
    pcols = torch.as_tensor(coo.col.astype(np.int64), device=dev)
    pvals = torch.as_tensor(coo.data, dtype=torch.float64, device=dev)
    A0 = np.zeros((nc, nc))
    for s in range(0, nc, chunk):
        c = min(chunk, nc - s)
        sel = (coo.col >= s) & (coo.col < s + c)
        X = torch.zeros((n, c), dtype=torch.float64, device=dev)
        X[torch.as_tensor(coo.row[sel], device=dev),
          torch.as_tensor(coo.col[sel] - s, device=dev)] = torch.as_tensor(
              coo.data[sel], dtype=torch.float64, device=dev)
        Y = A.matmat(X)  # [n, c]
        A0[:, s: s + c] = torch.zeros((nc, c), dtype=torch.float64,
                                      device=dev).index_add_(
            0, pcols, pvals[:, None] * Y[prows]).cpu().numpy()
    return A0


class GDSWCoarseOperator:
    """Φ and A₀ for a GDSW coarse level.

    Single-space systems: pass (node_part_sets, points, dofs_per_node,
    null_space).  Block/monolithic systems (Stokes, NS, FSI — the FROSch
    MONOLITHIC path, fed per-block repeated maps + DofsPerNode,
    Preconditioner_def.hpp:295-383): pass `blocks`, a list of dicts with
    keys {offset, node_part_sets, points, dofs_per_node, null_space};
    Φ is then block-diagonal (per-block interface classification and null
    spaces) while the energy-minimal extension and A₀ use the MERGED
    matrix."""

    def __init__(self, A: Optional[CsrMatrix], unique_map: IndexMap,
                 node_part_sets: Optional[List[np.ndarray]] = None,
                 points: Optional[np.ndarray] = None,
                 dofs_per_node: int = 1, null_space: str = "laplace",
                 dirichlet_mask: Optional[np.ndarray] = None,
                 dtype=torch.float64, rap: str = "host",
                 blocks: Optional[List[dict]] = None,
                 variant: str = "GDSW", row_source=None,
                 ipou: Optional[dict] = None, device=None):
        """A may be None when `row_source` gives the rows (the
        distributed setup); Φ then lives on `device`."""
        self.device = (A.device if A is not None
                       else resolve_device(device or "cuda"))
        if variant not in ("GDSW", "RGDSW", "IPOUHarmonic"):
            raise ValueError(f"unknown coarse variant {variant!r}")
        self.variant = variant
        self.ipou = ipou
        n = unique_map.n_global if A is None else A.shape[0]
        if blocks is None:
            if points is None or node_part_sets is None:
                raise ValueError("need node_part_sets+points or blocks")
            if n != points.shape[0] * dofs_per_node:
                raise ValueError("matrix size != n_nodes * dofs_per_node")
            blocks = [dict(offset=0, node_part_sets=node_part_sets,
                           points=points, dofs_per_node=dofs_per_node,
                           null_space=null_space)]
        # All matrix access below is ROW-decomposed: row_source(p) yields
        # (owned_gids, csr [n_own, n]) for part p — serial: rows of the
        # global CSR; distributed: DistributedCsr.local_rows.
        if row_source is None:
            if A is None:
                raise ValueError("need A or row_source")
            sp_all = A.to_scipy().tocsr()

            def row_source(p):
                owned = unique_map.partition_indices[p]
                return owned, sp_all[owned]

        # per-block interface classification + null-space restrictions;
        # dof-level interface mask over the MERGED index space.  Dirichlet
        # dofs are excluded from the coarse space (their rows are identity —
        # extending through them would pollute Φ)
        iface_dof = np.zeros(n, dtype=bool)
        cols = []
        for blk in blocks:
            off = int(blk["offset"])
            dpn = int(blk["dofs_per_node"])
            pts = blk["points"]
            n_nodes = pts.shape[0]
            comps, iface_node, csets = interface_components(
                blk["node_part_sets"], n_nodes, return_sets=True)
            ns = build_null_space(blk.get("null_space", "laplace"), pts, dpn)
            k = ns.shape[2]
            blk_iface = np.repeat(iface_node, dpn)
            if dirichlet_mask is not None:
                blk_iface = blk_iface & ~dirichlet_mask[off:off + n_nodes * dpn]
            iface_dof[off:off + n_nodes * dpn] = blk_iface

            # coarse groups: GDSW = one group per interface component with
            # unit weights; RGDSW = one group per subdomain VERTEX with
            # partition-of-unity weights over its descendant components;
            # IPOUHarmonic = entity-class-filtered POU (ipou_groups)
            if variant == "RGDSW":
                groups = rgdsw_vertex_weights(comps, csets)
            elif variant == "IPOUHarmonic":
                groups = ipou_groups(comps, csets, pts.shape[1], ipou)
            else:
                groups = [[(i, 1.0)] for i in range(len(comps))]

            # Φ_Γ: per group, the (weighted) null-space restrictions
            # ORTHONORMALIZED by QR with rank filtering — on small groups
            # rotations become linearly dependent on translations, which
            # would make A₀ nearly singular and the coarse correction an
            # amplifier (FROSch's partition-of-unity basis serves the same
            # role)
            for grp in groups:
                dof_l, V_l = [], []
                for ci, w in grp:
                    c = comps[ci]
                    cdofs = (c[:, None] * dpn
                             + np.arange(dpn)[None, :]).ravel()
                    keep = blk_iface[cdofs]
                    if not keep.any():
                        continue
                    dof_l.append(cdofs[keep] + off)
                    V_l.append(w * ns[c].reshape(-1, k)[keep])
                if not dof_l:
                    continue
                kept = np.concatenate(dof_l)
                V = np.concatenate(V_l, axis=0)  # [n_kept_dofs, k]
                if not np.abs(V).max() > 0:
                    continue
                Q, Rm = np.linalg.qr(V)
                diag = np.abs(np.diag(Rm))
                good = diag > 1e-10 * max(diag.max(), 1e-300)
                for j in np.nonzero(good)[0]:
                    cols.append((kept, Q[:, j]))
        nc = len(cols)
        if nc == 0:
            raise ValueError("empty coarse space (no interface components)")

        rows_t, cols_t, vals_t = [], [], []
        for j, (dofs, vals) in enumerate(cols):
            rows_t.append(dofs)
            cols_t.append(np.full(len(dofs), j, dtype=np.int64))
            vals_t.append(vals)
        phi_gamma = sps.csr_matrix(
            (np.concatenate(vals_t),
             (np.concatenate(rows_t), np.concatenate(cols_t))),
            shape=(n, nc))

        # harmonic extension per subdomain: interior = owned, non-interface,
        # non-Dirichlet dofs (energy-minimal extension, reuses the subdomain
        # solves FROSch would — here sparse LU at setup).  Multi-block
        # systems extend BLOCK-DIAGONALLY (each field through its own
        # diagonal block — the FROSch monolithic construction): the merged
        # interior matrix of a saddle-point system is singular, the field
        # diagonal blocks are not.  A structurally empty diagonal block
        # (P2/P1 pressure) gets the zero extension.
        interior_all = ~iface_dof
        if dirichlet_mask is not None:
            interior_all = interior_all & ~dirichlet_mask
        block_ranges = [(int(blk["offset"]),
                         int(blk["offset"]) + blk["points"].shape[0]
                         * int(blk["dofs_per_node"])) for blk in blocks]
        local_rows = [row_source(p) for p in range(unique_map.n_parts)]

        def _extend(job):
            owned, R, lo, hi = job
            in_blk = (owned >= lo) & (owned < hi)
            I = owned[in_blk & interior_all[owned]]
            if len(I) == 0:
                return None
            subI = R[np.searchsorted(owned, I)]
            A_II = subI[:, I].tocsc()
            if A_II.nnz == 0:
                return None  # structurally empty diagonal block
            # boundary of the extension = same-block interface dofs
            # adjacent to I
            Gcols = np.unique(subI.indices)
            Gcols = Gcols[(Gcols >= lo) & (Gcols < hi)]
            G = Gcols[iface_dof[Gcols]]
            if len(G) == 0:
                return None
            rhs = -(subI[:, G] @ phi_gamma[G]).toarray()
            X = _robust_splu(A_II).solve(rhs)
            rr, cc = np.nonzero(np.abs(X) > 1e-14)
            return I[rr], cc.astype(np.int64), X[rr, cc]

        # subdomain extensions factorize on a thread pool (SuperLU releases
        # the GIL; round-1 weak item 8: sequential setup loops)
        
        jobs = [(owned, R, lo, hi) for owned, R in local_rows
                for lo, hi in block_ranges]
        for out in _parallel_map(_extend, jobs):
            if out is not None:
                rows_t.append(out[0])
                cols_t.append(out[1])
                vals_t.append(out[2])
        phi = sps.csr_matrix(
            (np.concatenate(vals_t),
             (np.concatenate(rows_t), np.concatenate(cols_t))),
            shape=(n, nc))

        if rap == "device":
            A0s = sps.csr_matrix(rap_device(A, phi))
        else:
            # row-decomposed Galerkin product ΦᵀAΦ = Σ_p Φ[rows_p]ᵀ A_p Φ,
            # accumulated SPARSE end-to-end — O(nnz(A₀)) setup memory (the
            # round-4 dense [nc, nc] accumulator was the O(nc²) host wall
            # the reference's gathered coarse matrix never pays)
            phi_csc = phi.tocsc()
            A0s = sps.csr_matrix((nc, nc))
            for p in range(unique_map.n_parts):
                owned, R = local_rows[p]
                if len(owned):
                    A0s = A0s + (phi_csc[owned].T @ (R @ phi_csc)).tocsr()
        # regularize exact zero diagonal (fully-Dirichlet components)
        d0 = np.abs(A0s.diagonal())
        bad = d0 < 1e-14 * max(d0.max() if nc else 1.0, 1.0)
        if bad.any():
            A0s = (A0s + sps.diags(bad.astype(np.float64))).tocsr()
        self.n_coarse = nc
        self.phi = CsrMatrix.from_scipy(phi, dtype=dtype, device=self.device)
        self._phiT = None
        # A0 kept SPARSE; the dense form and its inverse are LAZY — the
        # scalable coarse-solver paths (sparse LU wavefront / iterative
        # GMRES, the reference's CoarseSolver sublist) never form them
        # (O(nc³) setup + O(nc²) replicated memory are the pod-scale wall)
        self._A0_sp = A0s.tocsr()
        self._A0_np = None
        self._A0_inv = None
        self._dtype = dtype

    @property
    def A0_np(self) -> np.ndarray:
        if self._A0_np is None:
            self._A0_np = self._A0_sp.toarray()
        return self._A0_np

    @property
    def A0_inv(self):
        # the numpy inverse is cached; the tensor is made per access
        if self._A0_inv is None:
            self._A0_inv = np.linalg.inv(self.A0_np)
        return torch.as_tensor(self._A0_inv, dtype=self._dtype,
                               device=self.device)

    def A0_sparse(self) -> sps.csr_matrix:
        """A₀ as scipy CSR (the native storage)."""
        return self._A0_sp

    @property
    def phiT(self) -> CsrMatrix:
        """Φᵀ as its own CSR (the restriction of the serial coarse apply;
        built on first use — the padded coarse level never needs it)."""
        if self._phiT is None:
            self._phiT = CsrMatrix.from_scipy(
                self.phi.to_scipy().T.tocsr(), dtype=self._dtype,
                device=self.device)
        return self._phiT

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        rc = self.phiT.matvec(r)
        return self.phi.matvec(self.A0_inv @ rc)


def _two_level_apply(ops, r):
    """Additive two-level apply: ops = (l1_fn, l1_ops, coarse_ops) with
    coarse_ops = (phi_ops, phiT_ops, A0_inv) or None."""
    l1_fn, l1_ops, coarse_ops = ops
    z = l1_fn(l1_ops, r)
    if coarse_ops is not None:
        phi_ops, phiT_ops, A0_inv = coarse_ops
        z = z + ell_apply(phi_ops, A0_inv @ ell_apply(phiT_ops, r))
    return z


def _two_level_mult_apply(ops, r):
    """Multiplicative: the coarse level acts on the residual updated by the
    first level; ops = (l1_fn, l1_ops, coarse_ops, A_ops)."""
    l1_fn, l1_ops, coarse_ops, A_ops = ops
    z = l1_fn(l1_ops, r)
    if coarse_ops is not None:
        phi_ops, phiT_ops, A0_inv = coarse_ops
        r2 = r - ell_apply(A_ops, z)
        z = z + ell_apply(phi_ops, A0_inv @ ell_apply(phiT_ops, r2))
    return z


class TwoLevelSchwarz:
    """Two-level Schwarz: one-level overlapping Schwarz + the GDSW/RGDSW/
    IPOU coarse level.  'Level Combination' Additive (default) applies both
    levels to the same residual; Multiplicative applies the coarse
    correction to the residual updated by the first level (one more SpMV
    per apply, typically fewer Krylov iterations)."""

    def __init__(self, A: CsrMatrix, unique_map: IndexMap,
                 node_part_sets: Optional[List[np.ndarray]] = None,
                 points: Optional[np.ndarray] = None,
                 dofs_per_node: int = 1, overlap: int = 1,
                 combine: str = "Restricted", null_space: str = "laplace",
                 dirichlet_mask: Optional[np.ndarray] = None,
                 rap: str = "host", blocks: Optional[List[dict]] = None,
                 variant: str = "GDSW",
                 level_combination: str = "Additive",
                 subdomain_solver: str = "auto",
                 ipou: Optional[dict] = None):
        from feddlib_tpu_torch.precond.schwarz import SchwarzPreconditioner

        if level_combination not in ("Additive", "Multiplicative"):
            raise ValueError(f"unknown level combination "
                             f"{level_combination!r}")
        self.level_combination = level_combination
        self.A = A
        t0 = time.perf_counter()
        self.level1 = SchwarzPreconditioner(A, unique_map, overlap=overlap,
                                            combine=combine,
                                            solver=subdomain_solver)
        t1 = time.perf_counter()
        try:
            self.coarse = GDSWCoarseOperator(
                A, unique_map, node_part_sets, points, dofs_per_node,
                null_space, dirichlet_mask, rap=rap, blocks=blocks,
                variant=variant, ipou=ipou)
        except ValueError as e:
            # tiny problems can have a fully-Dirichlet interface → no coarse
            # functions; degrade gracefully to one level
            import warnings

            warnings.warn(f"GDSW coarse space unavailable ({e}); "
                          "falling back to one-level Schwarz")
            self.coarse = None
        self.timings = {"level1_s": t1 - t0,
                        "gdsw_s": time.perf_counter() - t1}
        self._op = None

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        fn, ops = self.operator()
        return fn(ops, r)

    def operator(self):
        """(fn, operands) for the solver's operator protocol."""
        if self._op is None:
            l1 = self.level1.operator()
            co = self.coarse
            coarse_ops = None if co is None else (
                co.phi.operator()[1], co.phiT.operator()[1], co.A0_inv)
            if self.level_combination == "Multiplicative":
                self._op = (_two_level_mult_apply,
                            (*l1, coarse_ops, self.A.operator()[1]))
            else:
                self._op = (_two_level_apply, (*l1, coarse_ops))
        return self._op


def distributed_two_level(dmat, part=None, points: Optional[np.ndarray] = None,
                          dofs_per_node: int = 1,
                          combine: str = "Restricted",
                          null_space: str = "laplace",
                          dirichlet_mask: Optional[np.ndarray] = None,
                          coarse_ranks: int = 0, variant: str = "GDSW",
                          overlap: int = 1,
                          blocks: Optional[List[dict]] = None,
                          factor: str = "host",
                          ipou: Optional[dict] = None,
                          coarse_procs: int = 0,
                          level_combination: str = "Additive",
                          coarse_solver: str = "dense",
                          coarse_tol: float = 1e-6,
                          coarse_maxiter: int = 200):
    """Two-level GDSW for the shard-axis solver (parallel/solve.py), built
    from the DistributedCsr alone: the setup reads only the shards' rows
    (DistributedCsr.local_rows).

    Level 1 is `distributed_schwarz`.  Each shard holds the compact
    restriction of Φ to its owned rows, [N_o, C_loc] over the C_loc coarse
    functions supported there (`cids`); the coarse residual is the psum
    over the shards of Φ_ownᵀ r, solved against A₀ and prolonged locally.
    Single-variable problems pass (part, points, dofs_per_node); block
    systems pass `blocks`, the per-block specs of GDSWCoarseOperator.

    Coarse solver: 'dense' (A₀⁻¹), 'sparse' (the sparse LU of A₀) or
    'iterative' (GMRES to `coarse_tol` on the ELL of A₀).  The shards of a
    process hold one copy of what the JAX package replicates (A₀⁻¹, the
    factors, the ELL of A₀): the coarse residual (a psum over the axis) is
    the same on every shard, so each process solves it once per apply —
    the JAX package's result, without its n_dev copies.  The placement
    options of the reference's Distribution sublist (coarse_procs = k > 0
    shards over the first k, coarse_ranks = k > 0 over the last k, which
    must own no matrix rows: IndexMap.with_free_parts) choose, with several
    processes, the ranks that own those shards: the first of them solves
    and broadcasts the coarse solution to every rank.  In one process the
    placement gives the same single coarse solve.

    The host setup (Φ, A₀) is replicated on every rank from the gathered
    rows; each rank keeps its shards' level-1 factors and compact Φ.

    Returns (build_fn, arrays); `build_fn.timings` adds "gdsw_s" (Φ and
    A₀), "phi_s" (the compact Φ) and "coarse_s" (the coarse solver's setup)
    to the level-1 seconds, and `build_fn.shape` adds nc and C_loc."""
    from feddlib_tpu_torch.parallel.spmd import DistributedCsr
    from feddlib_tpu_torch.precond.schwarz import distributed_schwarz

    build1, arrays1 = distributed_schwarz(dmat, overlap=overlap,
                                          combine=combine, factor=factor)
    n1 = len(arrays1)
    umap = dmat.unique_map
    n_dev, dev = dmat.n_dev, dmat.device
    axis = dmat.axis
    lo, hi = axis.lo, axis.hi
    if coarse_ranks < 0 or coarse_ranks >= n_dev:
        raise ValueError("coarse_ranks must be in [0, n_dev)")
    if coarse_ranks:
        for p in range(n_dev - coarse_ranks, n_dev):
            if len(umap.partition_indices[p]):
                raise ValueError(
                    "dedicated coarse devices must own no matrix rows "
                    "(build the unique map with with_free_parts)")
    if level_combination not in ("Additive", "Multiplicative"):
        raise ValueError(f"unknown level combination {level_combination!r}")
    if coarse_ranks and coarse_procs:
        raise ValueError("choose coarse_ranks OR coarse_procs")
    if coarse_solver not in ("dense", "sparse", "iterative"):
        raise ValueError(f"unknown coarse solver {coarse_solver!r}")
    t0 = time.perf_counter()
    coarse = GDSWCoarseOperator(
        None, umap,
        part.repeated_map.partition_indices if part is not None else None,
        points, dofs_per_node, null_space, dirichlet_mask, variant=variant,
        blocks=blocks, row_source=dmat.local_rows, ipou=ipou, device=dev)
    mult = level_combination == "Multiplicative"
    t1 = time.perf_counter()
    phi = coarse.phi.to_scipy()
    nc = coarse.n_coarse
    N_o = dmat.plan.N_o
    # the compact per-shard Φ: only the coarse functions supported on the
    # shard's owned rows
    sup = []
    for p in range(n_dev):
        owned = umap.partition_indices[p]
        sup.append(np.unique(phi[owned].indices) if len(owned)
                   else np.zeros(0, np.int64))
    C_loc = max(max((len(s) for s in sup), default=1), 1)
    # this rank's shards [lo, hi)
    phi_comp = np.zeros((hi - lo, N_o, C_loc))
    cids = np.full((hi - lo, C_loc), nc, np.int64)  # pad → zero slot nc
    for p in range(lo, hi):
        owned = umap.partition_indices[p]
        s = sup[p]
        cids[p - lo, : len(s)] = s
        if len(owned):
            sub = phi[owned].tocoo()
            phi_comp[p - lo, sub.row, np.searchsorted(s, sub.col)] = sub.data
    arrays = list(arrays1) + [torch.as_tensor(phi_comp, device=dev),
                              torch.as_tensor(cids, device=dev)]
    # the coarse solve's placement across ranks: None = every rank solves
    root = None
    if axis.group is not None and (coarse_procs or coarse_ranks):
        named = (range(coarse_procs) if coarse_procs
                 else range(n_dev - coarse_ranks, n_dev))
        root = min(axis.rank_of(p) for p in named)
    t2 = time.perf_counter()

    if coarse_solver == "sparse":
        from feddlib_tpu_torch.la.sparse_lu import BatchedSparseLU

        lu = BatchedSparseLU([coarse.A0_sparse().tocsc()], device=dev)
        arrays += list(lu.arrays())
        S_lu = lu.S
    elif coarse_solver == "iterative":
        A0s = coarse.A0_sparse()
        kmax = max(int(np.diff(A0s.indptr).max()), 1)
        ecols = np.zeros((nc, kmax), np.int64)
        evals = np.zeros((nc, kmax))
        for i in range(nc):
            lo, hi = A0s.indptr[i], A0s.indptr[i + 1]
            ecols[i, : hi - lo] = A0s.indices[lo:hi]
            evals[i, : hi - lo] = A0s.data[lo:hi]
        arrays += [torch.as_tensor(evals, device=dev),
                   torch.as_tensor(ecols, device=dev)]
    else:
        # one [nc, nc] copy, seen by every shard of the rank
        arrays.append(coarse.A0_inv.expand(hi - lo, nc, nc))
    t3 = time.perf_counter()

    def build(prec_arrays, ctx):
        from feddlib_tpu_torch.solvers.krylov import gmres_loop

        M1 = build1(prec_arrays[:n1], ctx)
        phi_p, cid = prec_arrays[n1], prec_arrays[n1 + 1]
        solver_arrs = prec_arrays[n1 + 2:]
        ed, ec, mk, imp_f, exp_f = ctx

        def A_loc(x):
            return DistributedCsr.local_matvec(ed, ec, imp_f(x))

        def solve_A0(rc):
            if coarse_solver == "sparse":
                from feddlib_tpu_torch.la.sparse_lu import solve_batched

                r_pad = rc.new_zeros(1, S_lu)
                r_pad[0, :nc] = rc
                return solve_batched(r_pad, tuple(solver_arrs))[0, :nc]
            if coarse_solver == "iterative":
                evs, ecs = solver_arrs

                def A0mv(v):
                    return (evs * v[ecs]).sum(1)

                z, _, _, _ = gmres_loop(A0mv, lambda r: r, rc,
                                        torch.zeros_like(rc), coarse_tol,
                                        min(coarse_maxiter, nc),
                                        coarse_maxiter)
                return z
            return solver_arrs[0][0] @ rc

        def coarse_corr(r):
            q = torch.einsum("pnc,pn->pc", phi_p, r)        # [n_local, C_loc]
            rc = axis.psum(q.new_zeros(q.shape[0], nc + 1).scatter_(
                1, cid, q))[:nc]
            if root is None:
                zc = solve_A0(rc)
            else:  # solved on the first rank of the named shards
                zc = axis.broadcast(solve_A0(rc) if axis.rank == root
                                    else rc.new_empty(nc), root)
            zg = torch.cat([zc, zc.new_zeros(1)])[cid]        # [n_local, C_loc]
            return torch.einsum("pnc,pc->pn", phi_p, zg)

        def M(r):
            z1 = M1(r)
            if mult:
                # the coarse level acts on the level-1-updated residual
                return z1 + coarse_corr(r - A_loc(z1))
            return z1 + coarse_corr(r)

        return M

    build.timings = dict(build1.timings, gdsw_s=t1 - t0, phi_s=t2 - t1,
                         coarse_s=t3 - t2)
    build.shape = dict(build1.shape, nc=nc, C_loc=C_loc)
    return build, arrays
