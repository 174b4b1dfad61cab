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
blocks for it and fails inside GMRES.  `distributed_facsi` is not ported
yet (ROADMAP.md A10b).
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
