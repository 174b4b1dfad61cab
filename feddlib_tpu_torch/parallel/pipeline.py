"""Device-resident distributed assembly→solve pipeline, no global matrix —
counterpart of feddlib_tpu/parallel/pipeline.py.

- the HOST builds integer-only symbolic plans once per (mesh partition,
  block structure): each shard's owned-row pattern (the union of every
  shard's contributions into those rows), the segment-target plan of its
  element contributions (a local slot or a slot of its send buffer), the
  edge-coloured exchange rounds of the send buffers, the ELL layout with
  column-map-local columns, and the SpMV halo plan;
- the DEVICE runs one plain function over the stacked [n_local, ...]
  tensors of a process's shards (where the JAX package runs one shard_map
  program; n_local = n_dev in one process, a rank's range with several —
  parallel/multihost.py): batched element kernels for every block over
  the [n_local · E_max] elements, a
  deterministic stacked segment sum into (local slots ++ send buffer), the
  neighbour-wise `ppermute` rounds of the send buffers, a second segment
  sum of what they deliver, and a gather into each shard's ELL values — a
  `DistributedCsr` made with `from_parts`, its values on the device from
  birth.

Both sums go through the fixed-order segment sum of `parallel/assembly.py`
(the card's `index_add_` uses atomics, so its last bits move from run to
run); their order is sorted once at `finalize`, as the seg plans are
static.
Solution-dependent blocks (N(u), W(u), the hyperelastic tangent, the GI
shape derivatives) gather their fields through a repeated-node halo plan
of their own, so a Newton reassembly re-runs the same function on the new
solution shards.  Pad elements carry element 0's coordinates (finite
Jacobians), `valid = 0`, and scatter into the dump slot L + S.

Multi-variable block systems (the monolithic Stokes / Navier–Stokes
layout), several meshes on disjoint shard ranges (`aux_parts`, FSI fluid
and solid), mesh-less variables (the interface multiplier λ) and element-
less coarse shards (`n_free`) are supported.  The plan arrays hold the
JAX package's values entry for entry (stored int64 where it stores int32).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from feddlib_tpu_torch.fe import assembly as asm
from feddlib_tpu_torch.la.map import IndexMap
from feddlib_tpu_torch.mesh.partition import MeshPartition
from feddlib_tpu_torch.parallel.assembly import (_stacked_segment_sum,
                                                 stacked_segment_plan)
from feddlib_tpu_torch.parallel.spmd import (DeviceAxis, DistributedCsr,
                                             HaloPlan, _col_local_ids,
                                             _pad_stack, lane_index,
                                             local_lanes)
from feddlib_tpu_torch.utils import timers

f64 = torch.float64

# elements per chunk of the batched element kernels over [n_local · E_max]:
# the plain kinds, and the kinds differentiated per element (torch.func),
# whose jacfwd / hessian temporaries are larger (as fe/shape_derivatives.py
# and problems/nonlin_elasticity.py chunk them)
_CHUNK = 131072
_AD_CHUNK = 16384
_AD_KINDS = ("hyperelastic", "shape_u", "shape_p")
_FIELD_KINDS = ("advection", "advection_in_u", "ale_divergence",
                "hyperelastic")


# ---------------------------------------------------------------------------
# merged dof map over one mesh partition (multi-block)
# ---------------------------------------------------------------------------


def p2_unique_map(part: MeshPartition, p2_mesh) -> IndexMap:
    """Unique node map of the P2 child mesh from the P1 partition: midpoint
    nodes are owned by the owner of their lower-numbered edge endpoint."""
    n_p1 = part.mesh.n_points
    owner_p1 = part.unique_map.owner_of()
    mid_owner = owner_p1[p2_mesh.p2_edges.min(axis=1)]
    order = np.argsort(mid_owner, kind="stable")
    cuts = np.searchsorted(mid_owner[order], np.arange(part.n_parts + 1))
    parts = []
    for p in range(part.n_parts):
        own_p1 = part.unique_map.partition_indices[p]
        own_mid = n_p1 + order[cuts[p]:cuts[p + 1]]
        parts.append(np.sort(np.concatenate([own_p1, own_mid])))
    return IndexMap(p2_mesh.n_points, parts)


def _var_node_map(part: MeshPartition, dom) -> IndexMap:
    """Node map of `dom` relative to a partition: the partition's own
    unique map, or its P2 child's."""
    if dom.mesh is part.mesh:
        return part.unique_map
    if dom.parent_p1 is not None and dom.parent_p1.mesh is part.mesh:
        return p2_unique_map(part, dom.mesh)
    raise ValueError("variable does not live on this partitioned mesh "
                     "or its P2 child")


def merged_dof_map(part: MeshPartition, variables) -> Tuple[IndexMap,
                                                             np.ndarray]:
    """Unique dof map of the merged block system: per block, the node map
    (P1 partition or its P2 child) × dofs_per_node (NodeWise), shifted by
    the block offset.  Returns (map, offsets[n_blocks+1])."""
    sizes = [dom.n_dofs(dofs) for dom, dofs in variables]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    parts = [[] for _ in range(part.n_parts)]
    for b, (dom, dofs) in enumerate(variables):
        dmap = _var_node_map(part, dom).build_vec_field_map(dofs)
        for p in range(part.n_parts):
            parts[p].append(dmap.partition_indices[p] + offsets[b])
    merged = [np.sort(np.concatenate(lst)) for lst in parts]
    return IndexMap(int(offsets[-1]), merged), offsets


# ---------------------------------------------------------------------------
# block kernel registry
# ---------------------------------------------------------------------------


@dataclass
class _BlockDef:
    i: int
    j: int
    kind: str
    params: dict
    row_dofs: np.ndarray  # [E, nr] merged-global row dof ids
    col_dofs: np.ndarray  # [E, nc] merged-global col dof ids
    #: element fields the kernel consumes, in argument order: (variable
    #: index, source) with source "x" (solution slice) or "ext:<name>"
    #: (assemble(ext_fields=...))
    fields: List[Tuple[int, str]] = field(default_factory=list)
    mesh: int = 0         # element-mesh index (0 = main partition)
    geom: str = "current"  # "current" | "ref" (reference-configuration vc)

    @property
    def needs_field(self):  # back-compat single-field view
        return self.fields[0][0] if self.fields else None

    @property
    def field_src(self):
        return self.fields[0][1] if self.fields else "x"


@dataclass
class _CooBlockDef:
    """Constant COO entries (the FSI interface identities C1/C1ᵀ/C2/C3ᵀ:
    nodal identities between matched interface dofs, no element integral),
    contributed once by the row owner and folded into the owner-local
    patterns and a constant value vector."""

    keys: np.ndarray   # [n_entries] merged-global row*n_total + col
    vals: np.ndarray   # [n_entries]


def _exchange_rounds(send_keys, key_owner, dst_of, n_dev, pad_dst):
    """Edge-colour the contribution-exchange neighbour graph into ppermute
    rounds (the SpMV-halo scheme applied to assembly sends).

    send_keys[q]: sorted unique keys shard q must ship; key_owner(keys) →
    owning shard per key; dst_of(p, keys) → destination local slots on p.
    Returns (meta [(perm, W)], sidx [rounds][n_dev, W], rdst [...]) with
    host int64 arrays."""
    pair_pos = {}
    for q in range(n_dev):
        sk = send_keys[q]
        if not len(sk):
            continue
        ko = key_owner(sk)
        for p in np.unique(ko):
            if p == q:
                continue
            sel = np.flatnonzero(ko == p)
            pair_pos[(int(q), int(p))] = (sel, dst_of(int(p), sk[sel]))
    edges = sorted({tuple(sorted(e)) for e in pair_pos})
    color_of = {}
    used = [set() for _ in range(n_dev)]
    for e in edges:
        c = 0
        while c in used[e[0]] or c in used[e[1]]:
            c += 1
        color_of[e] = c
        used[e[0]].add(c)
        used[e[1]].add(c)
    n_rounds = 1 + max(color_of.values()) if color_of else 0
    by_round = [[] for _ in range(n_rounds)]
    for e, c in color_of.items():
        by_round[c].append(e)
    meta, sidx_l, rdst_l = [], [], []
    for r in range(n_rounds):
        perm = []
        members = {}
        W = 1
        for a, b in by_round[r]:
            perm += [(a, b), (b, a)]
            members[a] = b
            members[b] = a
            W = max(W,
                    len(pair_pos.get((a, b), ((), ()))[0]),
                    len(pair_pos.get((b, a), ((), ()))[0]))
        sidx = np.zeros((n_dev, W), np.int64)
        rdst = np.full((n_dev, W), pad_dst, np.int64)
        for q, p in members.items():
            snd = pair_pos.get((q, p))
            if snd is not None:
                sidx[q, : len(snd[0])] = snd[0]
            rcv = pair_pos.get((p, q))
            if rcv is not None:
                rdst[q, : len(rcv[1])] = rcv[1]
        meta.append((perm, W))
        sidx_l.append(sidx)
        rdst_l.append(rdst)
    return meta, sidx_l, rdst_l


def _expand(M, dim):
    """[E, nb, nb] scalar element matrices → the identity over `dim`
    components, NodeWise [E, nb·dim, nb·dim]."""
    eye = torch.eye(dim, dtype=f64, device=M.device)
    return asm.vectorize_elem_mat(torch.einsum("eab,ij->eabij", M, eye))


def _block_eval(kind: str, dim: int, fe_r: str, fe_c: str, params: dict):
    """fn(vc[, fields...][, elem_data]) → [E, nr, nc] element matrices,
    flattened COO order (element, test, trial) row-major — the serial
    fe/ops.py constructions."""
    if kind == "laplace":
        coeff = float(params.get("coeff", 1.0))
        if coeff == 1.0:
            return lambda vc: asm.elem_laplace(vc, dim, fe_r)
        return lambda vc: asm.elem_laplace(vc, dim, fe_r) * coeff
    if kind == "laplace_vec":
        visc = float(params.get("viscosity", 1.0))
        return lambda vc: asm.vectorize_elem_mat(
            asm.elem_laplace_vec(vc, dim, fe_r, visc))
    if kind == "laplace_vec_scaled":
        # per-element scalar weights (Geometry 'Distance Scaled Laplace')
        return lambda vc, wd: _expand(
            asm.elem_laplace(vc, dim, fe_r) * wd[:, None, None], dim)
    if kind == "ale_divergence":
        # ∫ (∇·w) φa φb over components, scaled (the FSI ALE term); w is
        # an external field
        coeff = float(params.get("coeff", 1.0))
        return lambda vc, we: _expand(
            asm.elem_ale_divergence(vc, we, dim, fe_r) * coeff, dim)
    if kind == "hyperelastic":
        # consistent tangent of the hyperelastic internal forces
        # (torch.func hessian of the strain energy)
        from feddlib_tpu_torch.fe.hyperelastic import \
            elem_hyper_residual_tangent

        material = params.get("material", "Neo-Hooke")
        mat_params = tuple(params.get("mat_params", (1.0, 1.0)))
        return lambda vc, de: elem_hyper_residual_tangent(
            vc, de, dim, fe_r, material, mat_params)[1]
    if kind == "stress":
        visc = float(params.get("viscosity", 1.0))
        return lambda vc: asm.vectorize_elem_mat(
            asm.elem_stress_sym(vc, dim, fe_r, visc))
    if kind == "lin_elasticity":
        mu = float(params.get("mu", 1.0))
        lam = float(params.get("lam", 1.0))
        return lambda vc: asm.vectorize_elem_mat(
            asm.elem_lin_elasticity(vc, dim, fe_r, mu, lam))
    if kind == "mass":
        rho = float(params.get("coeff", 1.0))
        dpn = int(params.get("dofs_per_node", 1))

        def mass(vc):
            M = asm.elem_mass(vc, dim, fe_r) * rho
            return _expand(M, dpn) if dpn > 1 else M

        return mass
    if kind == "divergence":  # rows = pressure (fe_r), cols = velocity
        coeff = float(params.get("coeff", 1.0))

        def div(vc):
            B = asm.elem_divergence(vc, dim, fe_c, fe_r)  # [E, nbp, nbu, d]
            return B.reshape(B.shape[0], B.shape[1], -1) * coeff

        return div
    if kind == "divergence_T":  # rows = velocity, cols = pressure (fe_c)
        coeff = float(params.get("coeff", 1.0))

        def div_t(vc):
            B = asm.elem_divergence(vc, dim, fe_r, fe_c)
            return B.permute(0, 2, 3, 1).reshape(
                B.shape[0], B.shape[2] * B.shape[3], B.shape[1]) * coeff

        return div_t
    if kind == "bd_stab":
        return lambda vc: asm.elem_bd_stabilization(vc, dim, fe_r)
    if kind == "advection":  # N(u) expanded to vector dofs
        coeff = float(params.get("coeff", 1.0))  # density scaling of u
        return lambda vc, ue: _expand(
            asm.elem_advection(vc, ue, dim, fe_r) * coeff, dim)
    if kind == "advection_in_u":  # W(u) Newton linearisation
        coeff = float(params.get("coeff", 1.0))
        return lambda vc, ue: asm.vectorize_elem_mat(
            asm.elem_advection_in_u(vc, ue, dim, fe_r)) * coeff
    if kind in ("shape_u", "shape_p"):
        # GI shape-derivative blocks ∂(fluid residual)/∂(mesh displacement)
        # differentiated inside the assembly (torch.func.jacfwd inside
        # vmap of the element residual of fe/shape_derivatives.py)
        from feddlib_tpu_torch.fe.shape_derivatives import \
            elem_shape_derivative

        fe_u, fe_p = params["_fe_u"], params["_fe_p"]
        mu = float(params.get("viscosity", 1.0))
        rho = float(params.get("density", 1.0))
        dt = float(params["dt"])
        mass_coef = float(params.get("mass_coef", 0.0))
        want_u = kind == "shape_u"

        def shape(vc_ref, u_e, p_e, g_e, gp_e, uo_e):
            Du, Dp = elem_shape_derivative(
                u_e, p_e[..., 0], g_e, gp_e, vc_ref, uo_e, dim, fe_u, fe_p,
                mu, rho, dt, mass_coef)
            return Du if want_u else Dp

        return shape
    raise ValueError(f"unknown block kind {kind!r}")


def _eval_chunked(ev, args, chunk):
    """ev over the leading (element) axis of every argument in chunks."""
    n = args[0].shape[0]
    if n <= chunk:
        return ev(*args)
    return torch.cat([ev(*(a[s:s + chunk] for a in args))
                      for s in range(0, n, chunk)])


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


class DistributedPipeline:
    """Distributed block-system assembly over a MeshPartition.

    Usage:
        pipe = DistributedPipeline(part, [(dom_u, dim), (dom_p, 1)])
        pipe.add_block(0, 0, "stress", viscosity=1.0)
        pipe.add_block(0, 1, "divergence_T")
        pipe.add_block(1, 0, "divergence")
        pipe.finalize(axis)
        dmat = pipe.assemble()            # DistributedCsr on the device
        b    = pipe.assemble_rhs({0: f})  # [n_local, N_o]
        dmat, b = pipe.apply_dirichlet(dmat, b, mask, g)

    The plans are built for every shard on the host (replicated on every
    rank); the device tensors are the axis' rank's rows [n_local, ...].
    """

    #: host→device uploads through this pipeline (a device-resident
    #: Newton / time loop stops incrementing after its first step; tests
    #: assert on it)
    n_distributes = 0

    def __init__(self, part: MeshPartition, variables, n_free: int = 0,
                 aux_parts=None, device="cuda"):
        """n_free > 0 appends that many element-less shards (dedicated
        coarse-solver ranks: no matrix rows).

        Multi-mesh systems (FSI fluid + solid): `aux_parts` is a list of
        dicts {"part": MeshPartition, "range": (lo, hi)} placing that
        partition's parts onto shards [lo, hi).  Variable entries are then
        (Domain, dofs[, mesh_idx]) with mesh_idx 0 = the main partition,
        k >= 1 = aux_parts[k-1]; mesh-less variables (interface Lagrange
        multipliers λ) are {"extra": n_dofs, "owner": shard}.  The shards
        live on `device` unless `finalize` is given an axis."""
        self.part = part
        self._device_arg = device
        self.aux_parts = list(aux_parts or [])
        for a in self.aux_parts:
            lo, hi = a["range"]
            if hi - lo != a["part"].n_parts:
                raise ValueError("aux rank range size != its part count")
        self.n_free = n_free
        base = max([part.n_parts] + [a["range"][1] for a in self.aux_parts])
        self.n_dev = base + n_free
        self.variables = []
        self.var_mesh: List[Optional[int]] = []
        self.var_owner: List[int] = []
        for v in variables:
            if isinstance(v, dict):
                owner = int(v.get("owner", 0))
                if not (0 <= owner < base):
                    raise ValueError(
                        f"extra-variable owner {owner} outside the "
                        f"matrix-owning shards [0, {base}) (free coarse "
                        f"shards own no rows)")
                self.variables.append((None, int(v["extra"])))
                self.var_mesh.append(None)
                self.var_owner.append(owner)
            else:
                dom, dofs = v[0], int(v[1])
                self.variables.append((dom, dofs))
                self.var_mesh.append(int(v[2]) if len(v) > 2 else 0)
                self.var_owner.append(-1)
        self.dof_map, self.offsets = self._build_dof_map()
        if n_free:
            self.dof_map = self.dof_map.with_free_parts(n_free)
        self.blocks: List[_BlockDef] = []
        self.coo_blocks: List[_CooBlockDef] = []
        self.row_weight_defs: Dict[int, np.ndarray] = {}
        self._rhs_defs = []
        self._rhs_meta = None
        self._final = False
        self._prog = None
        self.dim = part.mesh.dim

    # -- mesh bookkeeping ----------------------------------------------------
    def _mesh_part(self, m: int) -> Tuple[MeshPartition, int, int]:
        """(partition, lo, hi) of mesh index m on the shard axis."""
        if m == 0:
            return self.part, 0, self.part.n_parts
        a = self.aux_parts[m - 1]
        return a["part"], a["range"][0], a["range"][1]

    def _n_meshes(self) -> int:
        return 1 + len(self.aux_parts)

    def _build_dof_map(self) -> Tuple[IndexMap, np.ndarray]:
        sizes = [dom.n_dofs(dofs) if dom is not None else dofs
                 for dom, dofs in self.variables]
        offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        parts: List[list] = [[] for _ in range(self.n_dev - self.n_free)]
        for b, (dom, dofs) in enumerate(self.variables):
            off = offsets[b]
            if dom is None:
                parts[self.var_owner[b]].append(off + np.arange(dofs))
                continue
            mp, lo, hi = self._mesh_part(self.var_mesh[b])
            dmap = _var_node_map(mp, dom).build_vec_field_map(dofs)
            for q in range(lo, hi):
                parts[q].append(dmap.partition_indices[q - lo] + off)
        merged = [np.sort(np.concatenate(lst)) if lst
                  else np.zeros(0, np.int64) for lst in parts]
        return IndexMap(int(offsets[-1]), merged), offsets

    def _var_gmap(self, b: int) -> IndexMap:
        """Variable b's unique node-dof map over the whole shard axis
        (0-based within the block)."""
        dom, dofs = self.variables[b]
        if dom is None:
            parts = [np.arange(dofs) if q == self.var_owner[b]
                     else np.zeros(0, np.int64) for q in range(self.n_dev)]
            return IndexMap(dofs, parts)
        mp, lo, hi = self._mesh_part(self.var_mesh[b])
        dmap = _var_node_map(mp, dom).build_vec_field_map(dofs)
        parts = [dmap.partition_indices[q - lo] if lo <= q < hi
                 else np.zeros(0, np.int64) for q in range(self.n_dev)]
        return IndexMap(dmap.n_global, parts)

    def _eids(self, q: int, m: int = 0) -> np.ndarray:
        mp, lo, hi = self._mesh_part(m)
        if not (lo <= q < hi):
            return np.zeros(0, np.int64)
        return mp.elem_ids[q - lo]

    # -- registration --------------------------------------------------------
    def add_block(self, i: int, j: int, kind: str, **params) -> None:
        if self._final:
            raise RuntimeError("pipeline already finalized")
        dom_i, dofs_i = self.variables[i]
        dom_j, dofs_j = self.variables[j]
        if dom_i is None or dom_j is None:
            raise ValueError("element blocks need mesh variables; use "
                             "add_coo_block for coupling entries")
        if self.var_mesh[i] != self.var_mesh[j]:
            raise ValueError("element block variables must share a mesh")
        rows = dom_i.elem_dofs(dofs_i) + self.offsets[i]
        cols = dom_j.elem_dofs(dofs_j) + self.offsets[j]
        fields: List[Tuple[int, str]] = []
        if kind in _FIELD_KINDS:
            # the field rides in the COLUMN variable's space; an external
            # source name ("ext:w") reads it from assemble(ext_fields=...)
            fields = [(int(params.pop("field_var", j)),
                       params.pop("field_src", "x"))]
        elif kind in ("shape_u", "shape_p"):
            # GI shape derivatives consume (u, p, g, g_prev, u_old);
            # g = the column variable, u / p from u_var / p_var
            uvar = int(params.pop("u_var", 0))
            pvar = int(params.pop("p_var", 1))
            gvar = int(params.pop("g_var", j))
            fields = [(uvar, "x"), (pvar, "x"), (gvar, "x"),
                      (gvar, params.pop("gp_src", "ext:gp")),
                      (uvar, params.pop("uold_src", "ext:uold"))]
            params["_fe_u"] = self.variables[uvar][0].fe_type
            params["_fe_p"] = self.variables[pvar][0].fe_type
        geom = params.pop("geom", "ref" if kind in ("shape_u", "shape_p")
                          else "current")
        rw = params.pop("row_weights", None)
        if rw is not None:
            # per-row 0/1 weights in the ROW variable's block-local dof
            # space (the GI geometry block's built-in Dirichlet rows)
            self.row_weight_defs[len(self.blocks)] = np.asarray(
                rw, dtype=np.float64)
        self.blocks.append(_BlockDef(i, j, kind, params, rows, cols, fields,
                                     self.var_mesh[i], geom))

    def add_coo_block(self, i: int, j: int, rows: np.ndarray,
                      cols: np.ndarray, vals: np.ndarray) -> None:
        """Constant coupling entries at (block-local rows of var i,
        block-local cols of var j) — the FSI interface identities.  Values
        are constants of the plan (rebuilt only with the pipeline)."""
        if self._final:
            raise RuntimeError("pipeline already finalized")
        n_total = int(self.offsets[-1])
        gk = ((np.asarray(rows, np.int64) + self.offsets[i]) * n_total
              + np.asarray(cols, np.int64) + self.offsets[j])
        self.coo_blocks.append(_CooBlockDef(gk, np.asarray(vals, np.float64)))

    # -- symbolic phase --------------------------------------------------------
    def finalize(self, axis: Optional[DeviceAxis] = None) -> None:
        """Build every plan on the host and upload the axis' rank's rows
        (every shard without ranks; the default axis is
        `multihost.global_device_axis`), in the synchronised span
        `pipe.finalize` (utils/timers.py) with a child span a part:
        `pipe.keys`, `pipe.patterns`, `pipe.send`, `pipe.rounds`,
        `pipe.ell`, `pipe.halo`, `pipe.geometry`, `pipe.fields`."""
        if self._final:
            return
        with timers.timer("pipe.finalize", sync=True):
            self._finalize(axis)
        self._final = True

    def _finalize(self, axis: Optional[DeviceAxis]) -> None:
        with timers.timer("pipe.keys", sync=True):
            n_dev = self.n_dev
            owner = self.dof_map.owner_of()
            n_total = self.dof_map.n_global
            if axis is None:
                from feddlib_tpu_torch.parallel import multihost

                axis = multihost.global_device_axis(n_dev, self._device_arg)
            self.axis = axis
            if self.axis.n_dev != n_dev:
                raise ValueError("device axis size != the pipeline's shards")
            dev = self.device = self.axis.device
            ix = self.axis.ix  # this rank's rows of a stacked host plan
            n_mesh = self._n_meshes()

            # ------- global symbolic COO (integers only) --------------------
            keys_per_block = []
            for blk in self.blocks:
                E, nr = blk.row_dofs.shape
                nc = blk.col_dofs.shape[1]
                keys_per_block.append(
                    (blk.row_dofs.astype(np.int64)[:, :, None] * n_total
                     + blk.col_dofs[:, None, :]).reshape(E, nr * nc))
            coo_keys = (np.concatenate([cb.keys for cb in self.coo_blocks])
                        if self.coo_blocks else np.zeros(0, np.int64))
            coo_vals = (np.concatenate([cb.vals for cb in self.coo_blocks])
                        if self.coo_blocks else np.zeros(0))

        with timers.timer("pipe.patterns", sync=True):
            # ------- per-shard owned-row patterns ----------------------------
            # pattern of shard p = the sorted unique (row, col) keys over ALL
            # shards' contributions whose row p owns (+ the coupling keys): one
            # global unique, then a stable split by owner — the JAX package's
            # per-shard np.unique(all_keys[key_owner == p]), entry for entry
            uk = np.unique(np.concatenate([k.reshape(-1)
                                           for k in keys_per_block]
                                          + [coo_keys]))
            uo = owner[uk // n_total]
            order = np.argsort(uo, kind="stable")
            cuts = np.searchsorted(uo[order], np.arange(n_dev + 1))
            uk = uk[order]
            loc_patterns = [uk[cuts[p]:cuts[p + 1]] for p in range(n_dev)]
            del uk, uo, order
            self.L = max(max((len(k) for k in loc_patterns), default=0), 1)

            # constant coupling values per shard (owner-contributed; no
            # exchange): const_vals [n_dev, L]
            cdense = np.zeros((n_dev, self.L))
            if len(coo_keys):
                co = owner[coo_keys // n_total]
                for p in np.unique(co):
                    sel = co == p
                    slots = np.searchsorted(loc_patterns[p], coo_keys[sel])
                    np.add.at(cdense[p], slots, coo_vals[sel])
            self.const_vals = self.axis.put(cdense)

        with timers.timer("pipe.send", sync=True):
            # ------- send plans: shard q's contributions to remote rows -----
            E_max_m = []
            for m in range(n_mesh):
                mp, _, _ = self._mesh_part(m)
                E_max_m.append(int(mp.element_map.local_sizes.max()))
            self.E_max_m = E_max_m
            self.E_max = E_max_m[0]
            send_keys: List[np.ndarray] = []
            seg_l: List[np.ndarray] = []
            for q in range(n_dev):
                mine_l = []
                for blk, k in zip(self.blocks, keys_per_block):
                    eids = self._eids(q, blk.mesh)
                    if len(eids):
                        mine_l.append(k[eids].reshape(-1))
                mine = (np.concatenate(mine_l) if mine_l
                        else np.zeros(0, np.int64))
                remote = owner[mine // n_total] != q
                sk = np.unique(mine[remote])
                send_keys.append(sk)
                # segment target per raw contribution: local slot or L + slot
                seg = np.searchsorted(loc_patterns[q], mine)
                seg[remote] = self.L + np.searchsorted(sk, mine[remote])
                seg_l.append(seg)
            self.S = max(max((len(s) for s in send_keys), default=0), 1)
            dump = self.L + self.S

            # stacked seg plans [n_dev, Σ_b E_max(mesh_b)·w_b], blocks in
            # element-major order per block; pad elements (beyond E_q) scatter
            # into the dump slot L + S
            plan_len = sum(E_max_m[blk.mesh] * k.shape[1]
                           for blk, k in zip(self.blocks, keys_per_block))
            seg_stacked = np.full((n_dev, max(plan_len, 1)), dump, np.int64)
            for q in range(n_dev):
                pos = spos = 0
                for blk, keys in zip(self.blocks, keys_per_block):
                    w = keys.shape[1]
                    Eq = len(self._eids(q, blk.mesh))
                    seg_stacked[q, pos: pos + Eq * w] = \
                        seg_l[q][spos: spos + Eq * w]
                    pos += E_max_m[blk.mesh] * w
                    spos += Eq * w
            del seg_l, keys_per_block
            self.seg_ids = ix(seg_stacked)
            del seg_stacked
            self._seg_plan = stacked_segment_plan(self.seg_ids, dump + 1, dev)

        with timers.timer("pipe.rounds", sync=True):
            # ------- contribution exchange: neighbour-wise ppermute rounds --
            meta, sidx, rdst = _exchange_rounds(
                send_keys, lambda sk: owner[sk // n_total],
                lambda p, sk: np.searchsorted(loc_patterns[p], sk),
                n_dev, self.L)
            self._xc_meta = meta
            self._xc_sidx = [ix(a) for a in sidx]
            self._xc_rdst = [ix(a) for a in rdst]
            self._xc_src = [self.axis.perm_source(perm) for perm, _ in meta]
            self._xc_plan = (stacked_segment_plan(torch.cat(self._xc_rdst, 1),
                                                  self.L + 1, dev)
                             if meta else None)
            del send_keys

        with timers.timer("pipe.ell", sync=True):
            # ------- ELL layout + halo plan ----------------------------------
            N_o = self.dof_map.max_local_size
            self.N_o = N_o
            col_gids: List[np.ndarray] = []
            csr_meta = []
            K = 1
            for p in range(n_dev):
                owned = self.dof_map.partition_indices[p]
                keys = loc_patterns[p]
                rows = keys // n_total
                cols = keys % n_total
                ghosts = np.setdiff1d(cols, owned)
                col_gids.append(np.concatenate([owned, ghosts]))
                # owned-local row index per slot (keys sorted ⇒ rows
                # ascending; owned rows may have no slots)
                r_loc = np.searchsorted(owned, rows)
                lens = np.bincount(r_loc, minlength=len(owned))
                K = max(K, int(lens.max()) if len(lens) else 1)
                csr_meta.append((r_loc,
                                 _col_local_ids(owned, ghosts, cols, N_o),
                                 lens))
            self.K = K
            self.row_lens = np.zeros((n_dev, N_o), dtype=np.int64)
            ell_cols = np.zeros((n_dev, K, N_o), dtype=np.int64)
            # → zero
            ell_src = np.full((n_dev, K, N_o), self.L, dtype=np.int64)
            for p in range(n_dev):
                r_loc, c_loc, lens = csr_meta[p]
                self.row_lens[p, : len(lens)] = lens
                starts = np.concatenate([[0], np.cumsum(lens)])
                kk = np.arange(len(r_loc)) - starts[r_loc]
                ell_cols[p, kk, r_loc] = c_loc
                ell_src[p, kk, r_loc] = np.arange(len(r_loc))
            del csr_meta, loc_patterns
            self.ell_cols_host = ell_cols
            self.ell_src_host = ell_src
            self.ell_cols = ix(ell_cols)
            self.ell_src = ix(ell_src)
            # plan-static Dirichlet diagonal: the owned diagonal entry of each
            # row where the row holds one
            self._diag = self.axis.put(
                (ell_cols == np.arange(N_o)[None, None, :])
                & (ell_src != self.L))
            self.col_gids = col_gids
        with timers.timer("pipe.halo", sync=True):
            self.plan = HaloPlan(self.dof_map, col_gids, axis=self.axis)

        with timers.timer("pipe.geometry", sync=True):
            # ------- geometry (per mesh) + per-element data + field plans ---
            self.mesh_vc = []
            self.mesh_valid = []
            for m in range(n_mesh):
                mp, _, _ = self._mesh_part(m)
                self.mesh_vc.append(self.mesh_vert_coords(m, mp.mesh.points))
                valid = np.zeros((n_dev, E_max_m[m]))
                for q in range(n_dev):
                    valid[q, : len(self._eids(q, m))] = 1.0
                self.mesh_valid.append(self.axis.put(valid))
            self.vert_coords = self.mesh_vc[0]
            self.valid = self.mesh_valid[0]

            # reference-configuration coordinates for geom="ref" blocks (the GI
            # shape derivatives differentiate around the REFERENCE mesh)
            self._ref_meshes = sorted({blk.mesh for blk in self.blocks
                                       if blk.geom == "ref"})
            self.mesh_vc_ref = {}
            for m in self._ref_meshes:
                msh = self._mesh_part(m)[0].mesh
                pts = (msh.ref_points
                       if getattr(msh, "ref_points", None) is not None
                       else msh.points)
                self.mesh_vc_ref[m] = self.mesh_vert_coords(m, pts)

            # per-block row weights [n_dev, E_max, nr]
            self.row_wts = {}
            for bi, rw in self.row_weight_defs.items():
                blk = self.blocks[bi]
                wt_e = rw[blk.row_dofs - self.offsets[blk.i]]  # [E, nr]
                out = np.zeros((n_dev, E_max_m[blk.mesh], wt_e.shape[1]))
                for q in range(n_dev):
                    eids = self._eids(q, blk.mesh)
                    out[q, : len(eids)] = wt_e[eids]
                self.row_wts[bi] = self.axis.put(out)

            # per-element static data ("elem_data" param) per block
            self.elem_data = {}
            for bi, blk in enumerate(self.blocks):
                wd = blk.params.get("elem_data")
                if wd is None:
                    continue
                wd = np.asarray(wd, dtype=np.float64)
                out = np.zeros((n_dev, E_max_m[blk.mesh]))
                for q in range(n_dev):
                    eids = self._eids(q, blk.mesh)
                    out[q, : len(eids)] = wd[eids]
                self.elem_data[bi] = self.axis.put(out)

        with timers.timer("pipe.fields", sync=True):
            # field plans (one per distinct field variable among the blocks)
            self.field_plans: Dict[int, dict] = {}
            for blk in self.blocks:
                for b, _src in blk.fields:
                    self._build_field_plan(b)

    def _build_field_plan(self, b: int) -> None:
        """Halo plan delivering variable b's repeated-node values to each
        shard (the reference's u_rep_)."""
        if b in self.field_plans:
            return
        n_dev = self.n_dev
        dom, dofs = self.variables[b]
        off = int(self.offsets[b])
        mesh_b = self.var_mesh[b]
        bmap = self._var_gmap(b)
        E_max = self.E_max_m[mesh_b]
        nb = dom.n_basis()
        rep_dofs = []
        for q in range(n_dev):
            eids = self._eids(q, mesh_b)
            nodes = (np.unique(dom.mesh.elements[eids]) if len(eids)
                     else np.zeros(0, np.int64))
            rd = (nodes[:, None] * dofs + np.arange(dofs)[None, :]).reshape(-1)
            owned = bmap.partition_indices[q]
            rep_dofs.append(np.concatenate([owned, np.setdiff1d(rd, owned)]))
        fplan = HaloPlan(bmap, rep_dofs, axis=self.axis)
        N_ob = fplan.N_o
        # per shard: positions of owned block-b dofs inside the merged owned
        # list, and element-node gather indices into the field column
        # vector [N_ob + G_b]
        pos = np.zeros((n_dev, N_ob), dtype=np.int64)
        eidx = np.zeros((n_dev, E_max, nb, dofs), dtype=np.int64)
        for q in range(n_dev):
            owned_b = bmap.partition_indices[q]
            pos[q, : len(owned_b)] = np.searchsorted(
                self.dof_map.partition_indices[q], owned_b + off)
            eids = self._eids(q, mesh_b)
            if len(eids):
                cg = rep_dofs[q]
                ed = (dom.mesh.elements[eids][:, :, None] * dofs
                      + np.arange(dofs)[None, None, :])  # [Eq, nb, dofs]
                eidx[q, : len(eids)] = _col_local_ids(
                    cg[: len(owned_b)], cg[len(owned_b):], ed.reshape(-1),
                    N_ob).reshape(ed.shape)
        mask = (np.arange(N_ob)[None, :]
                < bmap.local_sizes[:, None]).astype(np.float64)
        put = self.axis.put
        self.field_plans[b] = dict(
            plan=fplan, pos=put(pos), mask=put(mask), elem_idx=put(eidx),
            dofs=dofs)

    # -- numeric phase ---------------------------------------------------------
    def _program(self):
        """Build (once) the assembly function over the rank's stacked
        tensors: f(x, vcs, exts) → ell_data [n_local, K, N_o]."""
        if self._prog is not None:
            return self._prog
        L, S, K, N_o = self.L, self.S, self.K, self.N_o
        n = self.axis.n_local
        evals = []
        for blk in self.blocks:
            dom_i, _ = self.variables[blk.i]
            dom_j, _ = self.variables[blk.j]
            evals.append((_block_eval(blk.kind, dom_i.dim, dom_i.fe_type,
                                      dom_j.fe_type, blk.params),
                          _AD_CHUNK if blk.kind in _AD_KINDS else _CHUNK))
        blocks = self.blocks
        field_ids = sorted(self.field_plans)
        importers = {b: self.field_plans[b]["plan"].importer()
                     for b in field_ids}
        srcs_of = {b: sorted({src for blk in blocks for bb, src in blk.fields
                              if bb == b}) for b in field_ids}
        rounds = list(zip(self._xc_sidx, self._xc_src))
        rdst = (torch.cat(self._xc_rdst, 1) if rounds else None)
        axis = self.axis

        def prog(x, vcs, exts):
            # gather fields (repeated element values) through their halos,
            # once per (variable, source)
            u_elems = {}
            for b in field_ids:
                fp = self.field_plans[b]
                mask_b = fp["mask"]
                N_ob = mask_b.shape[1]
                u_own = torch.gather(x, 1, fp["pos"]) * mask_b
                eidx = fp["elem_idx"]
                for src in srcs_of[b]:
                    own = (u_own if src == "x"
                           else exts[src[4:]][:, :N_ob] * mask_b)
                    u_col = importers[b](own, fp["plan"].import_arrays)
                    u_elems[(b, src)] = torch.gather(
                        u_col, 1, eidx.reshape(n, -1)).reshape(
                        n * eidx.shape[1], *eidx.shape[2:])
            vals = []
            for bi, (blk, (ev, chunk)) in enumerate(zip(blocks, evals)):
                vc = (self.mesh_vc_ref[blk.mesh] if blk.geom == "ref"
                      else vcs[blk.mesh])
                E = vc.shape[1]
                args = [vc.reshape(n * E, *vc.shape[2:])]
                args += [u_elems[f] for f in blk.fields]
                if bi in self.elem_data:
                    args.append(self.elem_data[bi].reshape(-1))
                v = _eval_chunked(ev, args, chunk)
                v = v.reshape(n, E, v.shape[1], v.shape[2])
                if bi in self.row_wts:
                    v = v * self.row_wts[bi][:, :, :, None]
                v = v * self.mesh_valid[blk.mesh][:, :, None, None]
                vals.append(v.reshape(n, -1))
            flat = torch.cat(vals, 1) if vals else x.new_zeros(n, 1)
            acc = _stacked_segment_sum(flat, self.seg_ids, L + S + 1,
                                       self._seg_plan)
            local, send = acc[:, :L], acc[:, L:L + S]
            # neighbour-wise exchange: one ppermute per edge colour, each
            # moving only that pair's contributions (O(local cut)); what
            # the rounds deliver is summed in round order
            if rounds:
                got = torch.cat([axis.ppermute(torch.gather(send, 1, si),
                                               src)
                                 for si, src in rounds], 1)
                local = local + _stacked_segment_sum(
                    got, rdst, L + 1, self._xc_plan)[:, :L]
            data = torch.cat([local + self.const_vals,
                              local.new_zeros(n, 1)], 1)
            return torch.gather(data, 1, self.ell_src.reshape(n, -1)
                                ).reshape(n, K, N_o)

        self._prog = prog
        self._ext_names = sorted({src[4:] for blk in blocks
                                  for _b, src in blk.fields
                                  if src.startswith("ext:")})
        return prog

    def assemble(self, x: Optional[torch.Tensor] = None,
                 ext_fields: Optional[Dict[str, torch.Tensor]] = None,
                 vert_coords: Optional[Dict[int, torch.Tensor]] = None
                 ) -> DistributedCsr:
        """Run the assembly on the device → DistributedCsr.  `x` is the
        merged distributed solution [n_local, N_o] (for the field blocks),
        zeros if omitted.  `ext_fields` maps external field names (blocks
        registered with field_src='ext:<name>') to OWNED per-variable
        arrays [n_local, N_ob] (`distribute_field`); `vert_coords`
        optionally overrides a mesh's vertex coordinates [n_local,
        E_max_m, nv, dim] (moved / ALE meshes, `mesh_vert_coords`)."""
        if not self._final:
            self.finalize()
        f = self._program()
        if x is None:
            x = torch.zeros(self.axis.n_local, self.N_o, dtype=f64,
                            device=self.device)
        for nm in self._ext_names:
            if ext_fields is None or nm not in ext_fields:
                raise ValueError(f"missing external field {nm!r}")
        vcs = [(vert_coords or {}).get(m, self.mesh_vc[m])
               for m in range(self._n_meshes())]
        ell_data = f(x, vcs, ext_fields or {})
        return DistributedCsr.from_parts(
            self.dof_map, self.col_gids, self.ell_cols, ell_data, self.K,
            plan=self.plan, row_lens=self.row_lens,
            ell_cols_host=self.ell_cols_host)

    def mesh_vert_coords(self, m: int, points) -> torch.Tensor:
        """[n_local, E_max_m, nv, dim] vertex coordinates of mesh m from an
        overriding point set (moved / ALE meshes) — feed to
        assemble(vert_coords={m: ...}).  The symbolic plans are
        coordinate-independent, so nothing is rebuilt.  Pad elements take
        element 0's vertices."""
        mp, _, _ = self._mesh_part(m)
        msh = mp.mesh
        nv = msh.vertices_per_element
        pts = np.asarray(points)
        lo, hi = self.axis.lo, self.axis.hi
        vc = np.zeros((hi - lo, self.E_max_m[m], nv, msh.dim))
        for q in range(lo, hi):
            eids = self._eids(q, m)
            Eq = len(eids)
            if Eq:
                vc[q - lo, :Eq] = pts[msh.elements[eids][:, :nv]]
            vc[q - lo, Eq:] = pts[msh.elements[0][:nv]]
        return torch.as_tensor(vc, device=self.device)

    # -- RHS -------------------------------------------------------------------
    def assemble_rhs(self, sources: Dict[int, Callable]) -> torch.Tensor:
        """Volume sources per block → merged distributed RHS [n_local, N_o]
        (host-side one-shot setup).  f(x) → scalar (dofs=1) or [dofs], x
        component-first as fe/assembly.py passes it."""
        if not self._final:
            self.finalize()
        owner = self.dof_map.owner_of()
        out = np.zeros((self.n_dev, self.N_o))
        for b, fsrc in sources.items():
            dom, dofs = self.variables[b]
            off = int(self.offsets[b])
            mb = self.var_mesh[b]
            msh = self._mesh_part(mb)[0].mesh
            nv = msh.vertices_per_element
            for q in range(self.n_dev):
                eids = self._eids(q, mb)
                if not len(eids):
                    continue
                vcq = torch.as_tensor(msh.points[msh.elements[eids][:, :nv]],
                                      device=self.device)
                vec = asm.elem_rhs(vcq, dom.dim, dom.fe_type, fsrc,
                                   n_comp=dofs)
                en = dom.mesh.elements[eids]
                ids = ((en[:, :, None] * dofs
                        + np.arange(dofs)[None, None, :]).reshape(-1)
                       if dofs > 1 else en.reshape(-1))
                contrib = np.zeros(self.dof_map.n_global)
                np.add.at(contrib, ids + off, vec.cpu().numpy().reshape(-1))
                nzg = np.nonzero(contrib)[0]
                for g in np.unique(owner[nzg]):
                    sel = nzg[owner[nzg] == g]
                    loc = np.searchsorted(self.dof_map.partition_indices[g],
                                          sel)
                    out[g, loc] += contrib[sel]
        return self.axis.put(out)

    # -- device-side RHS (volume + Neumann surface loads) ---------------------
    def add_rhs(self, b: int, fn: Callable) -> None:
        """Register a volume source for variable b: fn(x, t) → scalar
        (dofs=1) or [dofs], x component-first.  Assembled on the device by
        `assemble_rhs_device(t)`: time-dependent loads reassemble with no
        host work."""
        self._rhs_defs.append((b, fn, None))
        self._rhs_meta = None

    def add_surface_rhs(self, b: int, fn: Callable, flag: int) -> None:
        """Register a Neumann surface load on variable b's mesh boundary
        entities with `flag`: fn(x, t) → scalar."""
        self._rhs_defs.append((b, fn, int(flag)))
        self._rhs_meta = None

    def _rhs_plans(self):
        """Symbolic phase of the device RHS: per-def geometry and a
        contribution seg / exchange plan (rows only)."""
        if self._rhs_meta is not None:
            return self._rhs_meta
        if not self._final:
            self.finalize()
        n_dev, dev = self.n_dev, self.device
        owner = self.dof_map.owner_of()
        geo = []  # per def: (vc [n_local, Emax, nv, dim], valid, dofs)
        dof_lists = [[] for _ in range(n_dev)]  # per shard: per-def dofs
        for b, fn, flag in self._rhs_defs:
            dom, dofs = self.variables[b]
            off = int(self.offsets[b])
            m = self.var_mesh[b]
            mp, lo, hi = self._mesh_part(m)
            msh = mp.mesh
            if flag is None:
                E_max = self.E_max_m[m]
                vc = self.mesh_vc[m]
                valid = self.mesh_valid[m]
                rows = np.zeros((n_dev, E_max, dom.n_basis() * dofs),
                                np.int64)
                ed_all = dom.elem_dofs(dofs) + off
                for q in range(n_dev):
                    eids = self._eids(q, m)
                    rows[q, : len(eids)] = ed_all[eids]
            else:
                if msh.surfaces is None:
                    raise ValueError("mesh has no surface entities")
                surfs = msh.surfaces[np.flatnonzero(msh.surface_flags
                                                    == flag)]
                nsv = msh.dim  # vertices of the surface simplex
                nbs = surfs.shape[1] if len(surfs) else nsv
                # each surface goes to the shard owning its min node
                nmap = _var_node_map(mp, dom)
                nowner = np.full(dom.mesh.n_points, -1, np.int64)
                for pq in range(mp.n_parts):
                    nowner[nmap.partition_indices[pq]] = lo + pq
                sdev = (nowner[surfs.min(axis=1)] if len(surfs)
                        else np.zeros(0, np.int64))
                S_max = max(int(np.bincount(
                    sdev, minlength=n_dev).max()) if len(surfs) else 0, 1)
                vcn = np.zeros((n_dev, S_max, nsv, msh.dim))
                validn = np.zeros((n_dev, S_max))
                rows = np.zeros((n_dev, S_max, nbs * dofs), np.int64)
                pad_pts = msh.points[(msh.surfaces[0] if len(msh.surfaces)
                                      else msh.elements[0][:nsv])[:nsv]]
                for q in range(n_dev):
                    mine = surfs[sdev == q]
                    Sq = len(mine)
                    if Sq:
                        vcn[q, :Sq] = msh.points[mine[:, :nsv]]
                        validn[q, :Sq] = 1.0
                        sd = (mine[:, :, None] * dofs
                              + np.arange(dofs)[None, None, :])
                        rows[q, :Sq] = sd.reshape(Sq, -1) + off
                    vcn[q, Sq:] = pad_pts
                vc = self.axis.put(vcn)
                valid = self.axis.put(validn)
            geo.append((vc, valid, dofs))
            for q in range(n_dev):
                dof_lists[q].append(rows[q].reshape(-1))

        # seg plans: local owned position or N_o + send slot
        N_o = self.N_o
        send_keys, segs = [], []
        for q in range(n_dev):
            allk = (np.concatenate(dof_lists[q]) if dof_lists[q]
                    else np.zeros(0, np.int64))
            owned = self.dof_map.partition_indices[q]
            pos = np.searchsorted(owned, allk)
            pos_c = np.minimum(pos, max(len(owned) - 1, 0))
            is_own = ((owned[pos_c] == allk) if len(owned)
                      else np.zeros(len(allk), bool))
            sk = np.unique(allk[~is_own])
            send_keys.append(sk)
            segs.append(np.where(is_own, pos_c,
                                 N_o + np.searchsorted(sk, allk)))
        S_r = max(max((len(s) for s in send_keys), default=0), 1)
        seg_stacked = _pad_stack(
            [np.where(s >= N_o, np.minimum(s, N_o + S_r), s) for s in segs],
            N_o + S_r, dtype=np.int64)
        # neighbour-wise ppermute rounds (the matrix exchange's scheme —
        # the RHS reassembles every time step)
        owned_lists = self.dof_map.partition_indices
        r_meta, r_sidx, r_rdst = _exchange_rounds(
            send_keys, lambda sk: owner[sk],
            lambda p, sk: np.searchsorted(owned_lists[p], sk), n_dev, N_o)
        ix = self.axis.ix
        seg = ix(seg_stacked)
        xc_rdst = [ix(a) for a in r_rdst]
        self._rhs_meta = dict(
            geo=geo, seg=seg,
            seg_plan=stacked_segment_plan(seg, N_o + S_r + 1, dev),
            xc_meta=r_meta, xc_sidx=[ix(a) for a in r_sidx],
            xc_rdst=xc_rdst,
            xc_src=[self.axis.perm_source(p) for p, _ in r_meta],
            xc_plan=(stacked_segment_plan(torch.cat(xc_rdst, 1), N_o + 1,
                                          dev) if r_meta else None),
            S_r=S_r)
        return self._rhs_meta

    def assemble_rhs_device(self, t: float = 0.0) -> torch.Tensor:
        """The device RHS at time t → [n_local, N_o]: the plans are built
        once, each step re-runs the element loads and the exchange."""
        meta = self._rhs_plans()
        n, N_o, S_r = self.axis.n_local, self.N_o, meta["S_r"]
        t = float(t)
        flats = []
        for (b, fn, flag), (vc, valid, dofs) in zip(self._rhs_defs,
                                                   meta["geo"]):
            dom = self.variables[b][0]
            E = vc.shape[1]
            vcf = vc.reshape(n * E, *vc.shape[2:])
            src = (lambda f: (lambda x: f(x, t)))(fn)
            if flag is None:
                vec = asm.elem_rhs(vcf, dom.dim, dom.fe_type, src,
                                   n_comp=dofs)
            else:
                vec = asm.elem_surface_rhs(vcf, dom.dim, dom.fe_type, src)
            vec = vec.reshape(n, E, -1) * valid[:, :, None]
            flats.append(vec.reshape(n, -1))
        flat = torch.cat(flats, 1)
        acc = _stacked_segment_sum(flat, meta["seg"], N_o + S_r + 1,
                                   meta["seg_plan"])
        local, send = acc[:, :N_o], acc[:, N_o:N_o + S_r]
        if meta["xc_meta"]:
            got = torch.cat([self.axis.ppermute(torch.gather(send, 1, si),
                                                src)
                             for si, src in zip(meta["xc_sidx"],
                                                meta["xc_src"])], 1)
            local = local + _stacked_segment_sum(
                got, torch.cat(meta["xc_rdst"], 1), N_o + 1,
                meta["xc_plan"])[:, :N_o]
        return local

    # -- boundary conditions -----------------------------------------------------
    def _lanes(self):
        """(gids, lanes) of the merged dof map on the axis' rank as device
        index tensors."""
        cached = getattr(self, "_lane_t", None)
        if cached is None:
            gids, lanes = local_lanes(self.dof_map, self.N_o, self.axis)
            cached = (torch.as_tensor(gids, device=self.device),
                      torch.as_tensor(lanes, device=self.device))
            self._lane_t = cached
        return cached

    def dirichlet_arrays(self, mask_global, g_global=None):
        """Distribute a merged Dirichlet mask (and values) to the owner
        shards: (mask [n_local, N_o] f64 0/1, g [n_local, N_o])."""
        gids, lanes = self._lanes()
        n_loc = self.axis.n_local
        n = n_loc * self.N_o

        def spread(v):
            v = torch.as_tensor(np.asarray(v, dtype=np.float64)
                                if not torch.is_tensor(v) else v,
                                dtype=f64, device=self.device)
            out = torch.zeros(n, dtype=f64, device=self.device)
            out[lanes] = v[gids]
            return out.view(n_loc, self.N_o)

        m = spread(mask_global)
        g = (spread(g_global) if g_global is not None
             else torch.zeros_like(m))
        return m, g

    def apply_dirichlet(self, dmat: DistributedCsr, rhs, mask_global,
                        g_global=None):
        """Row elimination on the distributed matrix: Dirichlet rows become
        unit-diagonal; with g_global given the RHS entries become g, with
        g_global=None the RHS is returned unchanged (the caller's RHS
        already carries the BC values).  Returns a NEW DistributedCsr
        sharing the plans, and the RHS."""
        m, g = self.dirichlet_arrays(mask_global, g_global)
        data = torch.where(m[:, None, :] > 0, self._diag.to(f64),
                           dmat.ell_data)
        new = DistributedCsr.from_parts(
            self.dof_map, self.col_gids, dmat.ell_cols, data, self.K,
            plan=dmat.plan, row_lens=self.row_lens,
            ell_cols_host=dmat._ell_cols_host)
        if g_global is not None:
            rhs = torch.where(m > 0, g, rhs)
        return new, rhs

    # -- preconditioner feed ----------------------------------------------------
    def block_specs(self, null_space: str = "laplace") -> List[dict]:
        """Per-block GDSW coarse specs (offset, repeated node sets, points,
        dofs per node, null space) — the monolithic coarse space's feed."""
        specs = []
        n_base = self.n_dev - self.n_free
        for b, (dom, dofs) in enumerate(self.variables):
            if dom is None:
                continue  # mesh-less (λ) blocks carry no coarse functions
            mp, lo, hi = self._mesh_part(self.var_mesh[b])
            if dom.mesh is mp.mesh:
                loc_sets = mp.repeated_map.partition_indices
            else:  # P2 child: repeated nodes = nodes touched by my elements
                loc_sets = [np.unique(dom.mesh.elements[mp.elem_ids[p]])
                            for p in range(mp.n_parts)]
            rep_sets = [loc_sets[q - lo] if lo <= q < hi
                        else np.zeros(0, np.int64) for q in range(n_base)]
            nsp = null_space if (dofs > 1 and null_space == "elasticity") \
                else "laplace"
            specs.append(dict(offset=int(self.offsets[b]),
                              node_part_sets=rep_sets,
                              points=dom.mesh.points,
                              dofs_per_node=dofs, null_space=nsp))
        return specs

    def distribute_field(self, b: int, xb) -> torch.Tensor:
        """Block-b global vector → per-shard OWNED field array [n_local,
        N_ob] (the layout assemble(ext_fields=...) expects)."""
        if b not in self.field_plans:
            raise ValueError(f"variable {b} has no field plan")
        self.n_distributes += 1
        fp = self.field_plans[b]
        lanes = fp.get("lanes")
        if lanes is None:
            gids, ln = local_lanes(self._var_gmap(b), fp["plan"].N_o,
                                   self.axis)
            lanes = fp["lanes"] = (torch.as_tensor(gids, device=self.device),
                                   torch.as_tensor(ln, device=self.device))
        return self._scatter(xb, lanes, fp["plan"].N_o)

    def _scatter(self, xg, lanes, width):
        gids, ln = lanes
        xg = torch.as_tensor(xg if torch.is_tensor(xg) else np.asarray(xg),
                             dtype=f64, device=self.device)
        n_loc = self.axis.n_local
        out = torch.zeros(n_loc * width, dtype=f64, device=self.device)
        out[ln] = xg[gids]
        return out.view(n_loc, width)

    # -- vector helpers ----------------------------------------------------------
    def distribute(self, x_global) -> torch.Tensor:
        """Global merged vector (host or device) → owned shards [n_local,
        N_o] on the device; counts one upload."""
        self.n_distributes += 1
        return self._scatter(x_global, self._lanes(), self.N_o)

    def gather(self, x_dist: torch.Tensor) -> torch.Tensor:
        """Owned shards [n_local, N_o] → the global merged vector, on the
        shards' device; with ranks every rank gets all of it (every rank
        must call it)."""
        gids, lanes = self._lanes()
        if self.axis.group is not None:
            x_dist = self.axis.all_gather(x_dist)
            g, ln = lane_index(self.dof_map, self.N_o)
            gids, lanes = (torch.as_tensor(a, device=self.device)
                           for a in (g, ln))
        out = x_dist.new_zeros(self.dof_map.n_global)
        out[gids] = x_dist.reshape(-1)[lanes]
        return out

    def collect(self, x_dist) -> np.ndarray:
        """Owned shards [n_local, N_o] → global vector (host numpy)."""
        return self.gather(torch.as_tensor(x_dist, device=self.device)
                           ).cpu().numpy()
