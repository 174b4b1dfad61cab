"""FaCSI preconditioner for the monolithic FSI system — counterpart of the
serial half of feddlib_tpu/precond/facsi.py (Deparis et al.: structure
solve → interface condensation with the C1/C1ᵀ/C2 coupling → fluid solve
with strongly imposed interface motion), on the port's f64 one-level
Schwarz for each field.

Acting on the merged residual r = (r_u, r_p, r_d, r_λ) of the four-field
GE system (problems/fsi.py):

1. solid:   z_d = S̃_d⁻¹ r_d                     (Schwarz on A_dd)
2. condense: the constraint row gives Dirichlet data for the fluid
   interface velocity:  u|_Γ = r_λ|rows − C2 z_d  (C2 = −1/dt I)
3. fluid:   solve the fluid saddle block with interface velocity rows
   replaced by identity and that data in the rhs:  z_u, z_p = F̃⁻¹ r̂_f
4. recover: z_λ = (r_u − [A Bᵀ] z)|_Γ            (interface traction)

The apply is plain torch (the Schwarz applies, gathers and two CSR
products), as the JAX package runs it as XLA.  A five-field GI system is
refused with a ValueError: the JAX package's operator returns the four GE
blocks for it and fails inside GMRES.  `distributed_facsi` is the same
operator on the shard axis (parallel/solve.py), for the four GE fields
and for the five GI fields with a geometry stage first.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from feddlib_tpu_torch.la.block import BlockMatrix
from feddlib_tpu_torch.la.csr import CsrMatrix
from feddlib_tpu_torch.la.map import IndexMap
from feddlib_tpu_torch.mesh.partition import MeshPartition
from feddlib_tpu_torch.precond.schwarz import SchwarzPreconditioner


class FaCSIPreconditioner:
    def __init__(self, fsi, sys_bc: BlockMatrix, n_subdomains: int = 4,
                 overlap: int = 1):
        from feddlib_tpu_torch.solvers.linear import _p2_unique_map

        sizes = fsi.block_sizes()
        if len(sizes) != 4:
            raise ValueError(
                f"FaCSI acts on the four GE fields (u, p, d, λ); this system "
                f"has {len(sizes)} blocks {list(sizes)} (the GI geometry "
                f"block g has no FaCSI step; use 'SchwarzOneLevel' or 'Use "
                f"Mixed Precision' for advance_gi)")
        self.fsi = fsi
        self.sizes = sizes
        self.off = np.concatenate([[0], np.cumsum(sizes)])
        self.timings = {}

        # --- solid sub-preconditioner (field 2)
        t0 = time.perf_counter()
        dom_d = fsi.variables[2][0]
        part_d = MeshPartition((dom_d.parent_p1 or dom_d).mesh, n_subdomains)
        nmap_d = (_p2_unique_map(part_d, dom_d)
                  if dom_d.fe_type == "P2" else part_d.unique_map)
        self.solid_prec = SchwarzPreconditioner(
            sys_bc.get_block(2, 2), nmap_d.build_vec_field_map(fsi.dim),
            overlap=overlap)
        self.timings["solid"] = time.perf_counter() - t0

        # --- fluid block with interface velocity rows → identity
        t0 = time.perf_counter()
        uf = fsi._uf_cols  # interface u-dofs (fluid numbering)
        fl = BlockMatrix(sizes[:2])
        fl.add_block(0, 0, _rows_to_identity(sys_bc.get_block(0, 0), uf))
        fl.add_block(0, 1, _rows_to_zero(sys_bc.get_block(0, 1), uf))
        fl.add_block(1, 0, sys_bc.get_block(1, 0))
        if sys_bc.get_block(1, 1) is not None:
            fl.add_block(1, 1, sys_bc.get_block(1, 1))
        Ff = fl.merge()
        dom_u = fsi.variables[0][0]
        part_u = MeshPartition((dom_u.parent_p1 or dom_u).mesh, n_subdomains)
        nmap_u = (_p2_unique_map(part_u, dom_u)
                  if dom_u.fe_type == "P2" else part_u.unique_map)
        dof_u = nmap_u.build_vec_field_map(fsi.dim)
        # merged fluid dof map: u dofs ++ p dofs (block offset sizes[0]);
        # the pressure lives on the P1 parent's nodes
        nmap_p = part_u.unique_map
        fmap = IndexMap(sizes[0] + sizes[1], [
            np.sort(np.concatenate([dof_u.partition_indices[p],
                                    nmap_p.partition_indices[p] + sizes[0]]))
            for p in range(n_subdomains)])
        self.fluid_prec = SchwarzPreconditioner(Ff, fmap, overlap=overlap)
        self.timings["fluid"] = time.perf_counter() - t0

        # coupling pieces
        dev = sys_bc.get_block(0, 0).device
        self.Auu_full = sys_bc.get_block(0, 0)
        self.BT_full = sys_bc.get_block(0, 1)
        self.uf = torch.as_tensor(uf, device=dev)
        self.iface_rows = torch.as_tensor(fsi._iface_rows, device=dev)
        self.ds = torch.as_tensor(fsi._ds_cols, device=dev)
        self.dt = fsi.dt

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        o = self.off
        ru, rp = r[o[0]:o[1]], r[o[1]:o[2]]
        rd, rl = r[o[2]:o[3]], r[o[3]:o[4]]
        # 1) solid
        zd = self.solid_prec.apply(rd)
        # 2) interface fluid velocity data: u|Γ = r_λ + (1/dt) d|Γ
        ru_hat = ru.clone()
        ru_hat[self.uf] = rl[self.iface_rows] + zd[self.ds] / self.dt
        # 3) fluid solve
        zf = self.fluid_prec.apply(torch.cat([ru_hat, rp]))
        zu, zp = zf[: o[1]], zf[o[1]:]
        # 4) traction recovery
        res_u = ru - self.Auu_full.matvec(zu) - self.BT_full.matvec(zp)
        zl = torch.zeros_like(rl)
        zl[self.iface_rows] = res_u[self.uf]
        return torch.cat([zu, zp, zd, zl])

    __call__ = apply

    def operator(self):
        """(fn, operands) form for the solver's operator protocol."""
        return facsi_op_apply, (self,)


def facsi_op_apply(ops, r):
    return ops[0].apply(r)


def _rows_to_identity(m: CsrMatrix, rows) -> CsrMatrix:
    """m with the given rows (ids or a boolean mask) made identity rows:
    off-diagonal entries 0, diagonal 1."""
    pat = m.pattern
    rmask = np.zeros(pat.n_rows, dtype=bool)
    rmask[rows] = True
    r = pat.rows_of_slots()
    in_r = rmask[r]
    is_diag = pat.indices == r
    data = m.data.clone()
    data[torch.as_tensor(np.nonzero(in_r & ~is_diag)[0],
                         device=m.device)] = 0.0
    data[torch.as_tensor(np.nonzero(in_r & is_diag)[0],
                         device=m.device)] = 1.0
    return CsrMatrix(pat, data, m.dtype, device=m.device)


def _rows_to_zero(m: CsrMatrix, rows) -> CsrMatrix:
    """m with the given rows (ids or a boolean mask) zeroed."""
    pat = m.pattern
    rmask = np.zeros(pat.n_rows, dtype=bool)
    rmask[rows] = True
    data = m.data.clone()
    data[torch.as_tensor(np.nonzero(rmask[pat.rows_of_slots()])[0],
                         device=m.device)] = 0.0
    return CsrMatrix(pat, data, m.dtype, device=m.device)


# ---------------------------------------------------------------------------
# distributed FaCSI (the shard-axis form)
# ---------------------------------------------------------------------------


def _field_subdomains(dmat, lo: int, hi: int, overlap: int,
                      vals_flat: np.ndarray, ident_rows=None):
    """Per-shard overlapping subdomain factors of the merged distributed
    matrix RESTRICTED to the field dof range [lo, hi) — the sub-
    preconditioner each FaCSI field gets.  Each shard's subdomain is its
    owned field dofs grown `overlap` layers through the FIELD subgraph;
    `ident_rows` (global ids) become identity rows inside every subdomain
    block (the fluid's interface-velocity condensation).  Returns (inv
    [n_local, S, S], ov_col [n_local, S] plan-local restriction ids,
    own_pos [n_local, N_o] scatter of the subdomain solutions to owned dofs (pad →
    S), HaloPlan, factorize(vals_flat) → a new inv)."""
    from feddlib_tpu_torch.la.dense_blocks import (_parallel_map,
                                                   _robust_inverse)
    from feddlib_tpu_torch.parallel.spmd import HaloPlan
    from feddlib_tpu_torch.precond.schwarz import grow_overlap

    unique_map = dmat.unique_map
    dev = dmat.device
    n_dev, N_o = dmat.n_dev, dmat.plan.N_o
    field = dmat.locator()[lo:hi, lo:hi].tocsr()
    ident_mask = None
    if ident_rows is not None and len(ident_rows):
        ident_mask = np.zeros(hi - lo, dtype=bool)
        ident_mask[np.asarray(ident_rows) - lo] = True

    ov_sets = []
    for p in range(n_dev):
        owned = unique_map.partition_indices[p]
        seeds = owned[(owned >= lo) & (owned < hi)] - lo
        ov_sets.append(grow_overlap(field, seeds, overlap) + lo if len(seeds)
                       else np.zeros(0, np.int64))
    S = max(max((len(o) for o in ov_sets), default=0), 1)

    col_gids = [np.concatenate([unique_map.partition_indices[p],
                                np.setdiff1d(ov_sets[p],
                                             unique_map.partition_indices[p])])
                for p in range(n_dev)]
    axis = dmat.axis
    plan = HaloPlan(unique_map, col_gids, axis=axis)
    a_lo, a_hi = axis.lo, axis.hi  # this rank's shards

    subs = []  # per shard: COO (row, col, slot) of its subdomain block
    for p in range(n_dev):
        ov = ov_sets[p]
        if len(ov):
            sub = field[ov - lo][:, ov - lo].tocoo()
            ident_on = (ident_mask[ov[sub.row] - lo]
                        if ident_mask is not None else None)
            subs.append((sub.row, sub.col, sub.data.astype(np.int64) - 1,
                         ident_on))
        else:
            subs.append(None)

    def factorize(vals_flat):
        inv = np.zeros((a_hi - a_lo, S, S))

        def one(p):
            k = len(ov_sets[p])
            block = np.zeros((S, S))
            block[np.arange(k, S), np.arange(k, S)] = 1.0
            if subs[p] is not None:
                row, col, slot, ident_on = subs[p]
                vals = vals_flat[slot]
                if ident_on is not None:
                    vals = np.where(ident_on,
                                    (row == col).astype(np.float64), vals)
                block[row, col] = vals
            inv[p - a_lo] = _robust_inverse(block)

        # each block is independent: LAPACK releases the GIL
        _parallel_map(one, range(a_lo, a_hi))
        return torch.as_tensor(inv, device=dev)

    ov_col = np.zeros((n_dev, S), dtype=np.int64)
    own_pos = np.full((n_dev, N_o), S, dtype=np.int64)
    for p in range(n_dev):
        owned = unique_map.partition_indices[p]
        ov = ov_sets[p]
        # restriction: overlap gids → overlap-plan column-local ids
        extra = col_gids[p][len(owned):]
        ov_col[p, : len(ov)] = np.where(
            np.isin(ov, owned), np.searchsorted(owned, ov),
            N_o + np.searchsorted(extra, ov))
        # restricted prolongation: owned field dofs ← their subdomain slot
        mine = (owned >= lo) & (owned < hi)
        own_pos[p, np.flatnonzero(mine)] = np.searchsorted(ov, owned[mine])
    return (factorize(vals_flat), axis.put(ov_col), axis.put(own_pos),
            plan, factorize)


def _scatter_plan(unique_map, gids: np.ndarray, slots: np.ndarray,
                  N_o: int, n_slots: int, axis):
    """Per-shard (src [n_local, W], dst [n_local, W]) plans of the axis'
    rank: shard p pulls its
    OWNED entries of `gids` from local position src (pad → N_o, a zero
    slot of the extended vector) and puts them at `slots` of an
    interface-sized accumulator (pad → the n_slots dump)."""
    n_dev = unique_map.n_parts
    src_l, dst_l = [], []
    for p in range(n_dev):
        owned = unique_map.partition_indices[p]
        pos = np.searchsorted(owned, gids)
        pos_c = np.minimum(pos, max(len(owned) - 1, 0))
        is_own = ((owned[pos_c] == gids) if len(owned)
                  else np.zeros(len(gids), bool))
        src_l.append(pos_c[is_own])
        dst_l.append(np.asarray(slots)[is_own])
    W = max(max((len(s) for s in src_l), default=0), 1)
    src = np.full((n_dev, W), N_o, dtype=np.int64)
    dst = np.full((n_dev, W), n_slots, dtype=np.int64)
    for p in range(n_dev):
        src[p, : len(src_l[p])] = src_l[p]
        dst[p, : len(dst_l[p])] = dst_l[p]
    return axis.put(src), axis.put(dst)


def distributed_facsi(dmat, offsets, uf_cols, ds_cols, iface_rows,
                      dt: float, overlap: int = 1):
    """FaCSI preconditioner for the DISTRIBUTED FSI system — (build,
    arrays) for `DistributedSolver.solve(precond=...)`.

    Each shard holds ONE overlapping subdomain per field (its owned field
    rows grown through the field subgraph — shards of the other mesh's
    range hold empty identity blocks), and the interface condensation
    rides two psums over the matrix's axis of interface-sized vectors
    (O(n_Γ), not a global gather):

      0. z_g  = G̃⁻¹ r_g                       (five-field GI only)
      1. z_d  = S̃_d⁻¹ r_d                    (solid restricted Schwarz)
      2. uΓ   = r_λ + z_d|Γ / dt              (psum #1)
      3. z_f  = F̃⁻¹ r̂_f  with interface velocity rows ≡ I and r̂|Γ = uΓ
      4. z_λ  = (r_u − [A Bᵀ] z_f)|Γ          (psum #2, via one merged SpMV)

    `offsets` = the merged block offsets (u, p, d, λ[, g] ends); uf_cols /
    ds_cols / iface_rows are the FSI problem's matched-interface index
    triple (block-local).  `build.refresh(dmat_new)` gives new arrays for
    new values on the same pattern (only the factors are recomputed);
    `build.timings` holds the setup seconds."""
    from feddlib_tpu_torch.parallel.spmd import DistributedCsr

    t0 = time.perf_counter()
    o = [int(v) for v in offsets[:6]]
    has_geom = len(o) == 6  # five-field GI system (…, λ, g)
    n_lam = o[4] - o[3]
    unique_map = dmat.unique_map
    N_o = dmat.plan.N_o
    vals_flat = dmat.values_host()

    uf_glob = np.asarray(uf_cols, np.int64) + o[0]
    ds_glob = np.asarray(ds_cols, np.int64) + o[2]
    lam_glob = np.asarray(iface_rows, np.int64) + o[3]
    slot = np.arange(n_lam)  # interface slot k ↔ (uf[k], ds[k], λ row[k])

    inv_s, ovcol_s, spos, plan_s, fact_s = _field_subdomains(
        dmat, o[2], o[3], overlap, vals_flat)
    t1 = time.perf_counter()
    inv_f, ovcol_f, fpos, plan_f, fact_f = _field_subdomains(
        dmat, o[0], o[2], overlap, vals_flat, ident_rows=uf_glob)
    t2 = time.perf_counter()
    if has_geom:  # the GI geometry sub-solve
        inv_g, ovcol_g, gpos, plan_g, fact_g = _field_subdomains(
            dmat, o[4], o[5], overlap, vals_flat)

    axis = dmat.axis

    def sp(gids):
        return _scatter_plan(unique_map, gids, slot, N_o, n_lam, axis)

    src_lam, dst_lam = sp(lam_glob)
    src_ds, dst_ds = sp(ds_glob)
    src_uf, dst_uf = sp(uf_glob)
    # writers: owned uf positions ← uΓ slot; owned λ positions ← zλ slot
    # (the same plans as the readers)
    plans = [plan_s, plan_f] + ([plan_g] if has_geom else [])
    imps = [pl.importer() for pl in plans]
    head = [src_lam, dst_lam, src_ds, dst_ds, src_uf, dst_uf]
    fields = [[inv_s, ovcol_s, spos], [inv_f, ovcol_f, fpos]]
    if has_geom:
        fields.append([inv_g, ovcol_g, gpos])
    arrays = ([a for f in fields for a in f] + head
              + [pl.import_arrays for pl in plans])
    n_f = len(fields)
    inv_dt = 1.0 / dt

    def build(prec_arrays, ctx):
        ed, ec, mask, imp_A, _exp = ctx
        fl = [prec_arrays[3 * i: 3 * i + 3] for i in range(n_f)]
        (src_lam, dst_lam, src_ds, dst_ds, src_uf,
         dst_uf) = prec_arrays[3 * n_f: 3 * n_f + 6]
        ias = prec_arrays[3 * n_f + 6:]

        def sub_solve(i, r):
            inv, ovcol, pos = fl[i]
            z_ov = torch.einsum("pij,pj->pi", inv,
                                torch.gather(imps[i](r, ias[i]), 1, ovcol))
            return torch.gather(_ext(z_ov), 1, pos)

        def M(r):
            n = r.shape[0]
            # 1) solid restricted Schwarz
            zd = sub_solve(0, r)
            # 2) interface velocity data uΓ = r_λ + z_d|Γ / dt  (psum)
            rex, zdx = _ext(r), _ext(zd)
            acc = r.new_zeros(n, n_lam + 1)
            acc.scatter_add_(1, dst_lam, torch.gather(rex, 1, src_lam))
            acc.scatter_add_(1, dst_ds,
                             torch.gather(zdx, 1, src_ds) * inv_dt)
            uG = _ext1(axis.psum(acc[:, :n_lam]))
            # 3) fluid solve with interface rows ≡ I, r̂|Γ = uΓ
            rhat = rex.scatter(1, src_uf, uG[dst_uf])[:, :N_o]
            zf = sub_solve(1, rhat)
            if has_geom:
                zf = zf + sub_solve(2, r)  # disjoint owned ranges
            # 4) traction recovery zλ = (r_u − A z_f)|Γ (merged SpMV: rows
            # uf are [Auu Bᵀ 0 C1ᵀ (D_ug)]; z is zero on d and λ, so C1ᵀ
            # adds nothing; the GI shape column rides z_g)
            y = DistributedCsr.local_matvec(ed, ec, imp_A(zf))
            resu = rex - _ext(y)
            acc2 = r.new_zeros(n, n_lam + 1).scatter_add_(
                1, dst_uf, torch.gather(resu, 1, src_uf))
            zl = _ext1(axis.psum(acc2[:, :n_lam]))
            zl = r.new_zeros(n, N_o + 1).scatter(
                1, src_lam, zl[dst_lam])[:, :N_o]
            return (zd + zf + zl) * mask

        return M

    facts = [fact_s, fact_f] + ([fact_g] if has_geom else [])

    def refresh(dmat_new):
        """New arrays for new matrix VALUES on the SAME pattern (a Newton
        or time reassembly): only the subdomain factors are recomputed,
        every plan — and `build` — is reused."""
        vf = dmat_new.values_host()
        out = list(arrays)
        for i, fac in enumerate(facts):
            out[3 * i] = fac(vf)
        return out

    build.refresh = refresh
    build.timings = {"solid_s": t1 - t0, "fluid_s": t2 - t1,
                     "rest_s": time.perf_counter() - t2}
    build.shape = {"S": [int(f[0].shape[1]) for f in fields],
                   "n_lam": n_lam}
    return build, arrays


def _ext(x: torch.Tensor) -> torch.Tensor:
    """[n_dev, m] → [n_dev, m + 1] with a zero slot at m."""
    return torch.cat([x, x.new_zeros(x.shape[0], 1)], 1)


def _ext1(v: torch.Tensor) -> torch.Tensor:
    """[m] → [m + 1] with a zero slot at m."""
    return torch.cat([v, v.new_zeros(1)])
