"""Boundary-condition registry and applier — the BCBuilder equivalent.

Counterpart of feddlib_tpu/bc.py (the parts Problem uses).  Application
semantics:
- Dirichlet: zero the matrix row, unit diagonal, write g(x, t) into the rhs;
- Dirichlet_X/_Y/_Z/_X_Y/...: per-component variants;
- Neumann: registered only; its load is assembled by
  fe/ops.assemble_surface_rhs.

The host precomputes, per (block, matrix pattern), the Dirichlet dof mask
and the nnz slots to zero and to set to one; application is then a device
index write.

BC function contract: func(x, t) gets the flagged nodes' coordinates
component-first, x [dim, n_nodes] (so x[0] is the first coordinate), and
returns a scalar, a tensor of shape [n_nodes], [dofs, n_nodes], or — for a
vector field with the same value at every node — a sequence or tensor of
[dofs] values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from feddlib_tpu_torch.fe.domain import Domain
from feddlib_tpu_torch.la.block import BlockMatrix, BlockVector
from feddlib_tpu_torch.la.csr import CsrMatrix, SparsityPattern

_COMPONENTS = {"X": 0, "Y": 1, "Z": 2}


def _parse_type(bc_type: str, dim: int) -> Optional[List[int]]:
    """Dirichlet component list, or None for non-Dirichlet types."""
    if bc_type == "Dirichlet":
        return list(range(dim))
    if bc_type.startswith("Dirichlet_"):
        return [_COMPONENTS[c] for c in bc_type.split("_")[1:]]
    return None


@dataclass
class _BC:
    func: Callable
    flag: int
    block: int
    domain: Domain
    bc_type: str
    dofs_per_node: int
    components: Optional[List[int]]


def _eval_bc(func, coords: torch.Tensor, t: float,
             dofs: int = 1) -> torch.Tensor:
    """func at nodes coords [n, dim] → [n, k] f64 (k = 1 or dofs).  A 1-D
    result of length n is one value per node; otherwise a 1-D result of
    length dofs is one constant per component."""
    n = coords.shape[0]
    g = func(coords.T, t)
    if isinstance(g, (list, tuple)):
        g = torch.stack([torch.as_tensor(v, dtype=torch.float64,
                                         device=coords.device) for v in g])
    g = torch.as_tensor(g, dtype=torch.float64, device=coords.device)
    if g.dim() == 0:
        return g.expand(n, 1)
    if g.dim() == 1 and g.shape[0] == n:
        return g[:, None]
    if g.dim() == 1 and g.shape[0] == dofs:
        return g[None, :].expand(n, dofs)
    if g.dim() == 2 and g.shape[1] == n:
        return g.T
    raise ValueError(f"BC function returned shape {tuple(g.shape)} for "
                     f"{n} nodes and {dofs} dofs per node (expected (), "
                     f"({n},), ({dofs},) or (dofs, {n}))")


class BCBuilder:
    def __init__(self):
        self.bcs: List[_BC] = []
        self._cache: Dict = {}

    def add_bc(self, func: Callable, flag: int, block: int, domain: Domain,
               bc_type: str, dofs_per_node: int) -> None:
        comps = _parse_type(bc_type, dofs_per_node)
        if comps is None and bc_type != "Neumann":
            raise ValueError(f"unknown BC type {bc_type!r}")
        self.bcs.append(_BC(func, flag, block, domain, bc_type,
                            dofs_per_node, comps))
        self._cache.clear()

    # -- masks --------------------------------------------------------------
    def dirichlet_mask(self, block: int, n_dofs: int) -> np.ndarray:
        """Boolean [n_dofs] mask of constrained dofs in a block."""
        key = ("mask", block, n_dofs)
        if key not in self._cache:
            mask = np.zeros(n_dofs, dtype=bool)
            for bc in self.bcs:
                if bc.block != block or bc.components is None:
                    continue
                nodes = np.nonzero(bc.domain.mesh.point_flags == bc.flag)[0]
                for c in bc.components:
                    mask[nodes * bc.dofs_per_node + c] = True
            self._cache[key] = mask
        return self._cache[key]

    def dirichlet_values(self, block: int, n_dofs: int, t: float = 0.0,
                         device="cuda") -> torch.Tensor:
        """[n_dofs] vector with g(x, t) at constrained dofs, 0 elsewhere.
        Later-registered BCs win on overlapping flags (corner nodes)."""
        vals = None
        for bc in self.bcs:
            if bc.block != block or bc.components is None:
                continue
            dev = bc.domain.device
            if vals is None:
                vals = torch.zeros(n_dofs, dtype=torch.float64, device=dev)
            nodes = np.nonzero(bc.domain.mesh.point_flags == bc.flag)[0]
            if len(nodes) == 0:
                continue
            coords = torch.as_tensor(bc.domain.mesh.points[nodes],
                                     dtype=torch.float64, device=dev)
            g = _eval_bc(bc.func, coords, t, bc.dofs_per_node)
            for c in bc.components:
                gc = g[:, c] if g.shape[1] > 1 else g[:, 0]
                idx = torch.as_tensor(nodes * bc.dofs_per_node + c,
                                      device=dev)
                vals[idx] = gc
        if vals is None:
            vals = torch.zeros(n_dofs, dtype=torch.float64, device=device)
        return vals

    # -- matrix application -------------------------------------------------
    def _slots(self, key, m: CsrMatrix, select):
        if key not in self._cache:
            self._cache[key] = tuple(
                torch.as_tensor(s, device=m.device) for s in select())
        return self._cache[key]

    def apply_to_matrix(self, m: CsrMatrix, block: int,
                        diag_value: float = 1.0) -> CsrMatrix:
        """Zero Dirichlet rows, unit diagonal (setLocalRowOne/Zero)."""
        pat = m.pattern

        def select():
            mask = self.dirichlet_mask(block, pat.n_rows)
            rows = pat.rows_of_slots()
            in_d = mask[rows]
            is_diag = pat.indices == rows
            return np.nonzero(in_d & ~is_diag)[0], np.nonzero(in_d & is_diag)[0]

        zero_slots, diag_slots = self._slots(("slots", block, id(pat)), m,
                                             select)
        data = m.data.clone()
        data[zero_slots] = 0.0
        data[diag_slots] = diag_value
        return CsrMatrix(pat, data, m.dtype, device=m.device)

    def apply_to_offdiag_matrix(self, m: CsrMatrix,
                                row_block: int) -> CsrMatrix:
        """Zero Dirichlet rows of an off-diagonal block (no diagonal)."""
        pat = m.pattern

        def select():
            mask = self.dirichlet_mask(row_block, pat.n_rows)
            return (np.nonzero(mask[pat.rows_of_slots()])[0],)

        (slots,) = self._slots(("offslots", row_block, id(pat)), m, select)
        data = m.data.clone()
        data[slots] = 0.0
        return CsrMatrix(pat, data, m.dtype, device=m.device)

    def apply_symmetric(self, m: CsrMatrix, rhs: torch.Tensor, block: int,
                        t: float = 0.0):
        """Symmetric Dirichlet elimination: zero rows AND columns, unit
        diagonal, lift boundary data into the rhs.  Returns (matrix, rhs)."""
        pat = m.pattern
        mask_np = self.dirichlet_mask(block, pat.n_rows)
        mask = torch.as_tensor(mask_np, device=m.device)
        vals = self.dirichlet_values(block, pat.n_rows, t, device=m.device)
        g_masked = torch.where(mask, vals, torch.zeros_like(vals))
        new_rhs = torch.where(mask, vals, rhs - m.matvec(g_masked))

        def select():
            rows = pat.rows_of_slots()
            in_r = mask_np[rows]
            in_c = mask_np[pat.indices]
            is_diag = pat.indices == rows
            return (np.nonzero((in_r | in_c) & ~(is_diag & in_r))[0],
                    np.nonzero(in_r & is_diag)[0])

        zero_slots, diag_slots = self._slots(("symslots", block, id(pat)), m,
                                             select)
        data = m.data.clone()
        data[zero_slots] = 0.0
        data[diag_slots] = 1.0
        return CsrMatrix(pat, data, m.dtype, device=m.device), new_rhs

    def apply_to_system(self, system: BlockMatrix) -> BlockMatrix:
        """Dirichlet row masking of a whole block system
        (Problem::setBoundariesSystem).  A block row with Dirichlet dofs but
        no diagonal block (a pinned pressure dof of a Taylor–Hood system)
        gets a sparse identity-at-Dirichlet diagonal block, so the system
        stays nonsingular."""
        out = BlockMatrix(system.row_sizes, system.col_sizes)
        for (i, j), m in system.blocks.items():
            if i == j:
                out.add_block(i, j, self.apply_to_matrix(m, i))
            else:
                out.add_block(i, j, self.apply_to_offdiag_matrix(m, i))
        for i in range(system.n_block_rows):
            if (i, i) in out.blocks:
                continue
            mask = self.dirichlet_mask(i, system.row_sizes[i])
            if not mask.any():
                continue
            d = np.nonzero(mask)[0]
            dev = next(iter(system.blocks.values())).device
            diag = CsrMatrix(SparsityPattern.from_coo(
                d, d, system.row_sizes[i], system.col_sizes[i]), device=dev)
            diag.assemble(torch.ones(len(d), dtype=torch.float64, device=dev))
            out.add_block(i, i, diag)
        return out

    # -- rhs application ----------------------------------------------------
    def apply_to_rhs(self, rhs: BlockVector, t: float = 0.0) -> BlockVector:
        """rhs[d] = g(x, t) on Dirichlet dofs (BCBuilder::setRHS)."""
        out = rhs.copy()
        for b in range(len(rhs)):
            n = rhs[b].shape[0]
            mask = self.dirichlet_mask(b, n)
            if not mask.any():
                continue
            vals = self.dirichlet_values(b, n, t, device=rhs[b].device)
            out[b] = torch.where(torch.as_tensor(mask, device=rhs[b].device),
                                 vals, rhs[b])
        return out

    def _dirichlet_where(self, vec: BlockVector, value,
                         t: float = 0.0) -> BlockVector:
        """vec with block b's Dirichlet dofs replaced by value(b, g_b), g_b
        the Dirichlet data of block b at time t."""
        out = vec.copy()
        for b in range(len(vec)):
            n = vec[b].shape[0]
            mask = self.dirichlet_mask(b, n)
            if not mask.any():
                continue
            dev = vec[b].device
            g = self.dirichlet_values(b, n, t, device=dev)
            out[b] = torch.where(torch.as_tensor(mask, device=dev),
                                 value(b, g), vec[b])
        return out

    def set_vector_minus_bc(self, residual: BlockVector, sol: BlockVector,
                            t: float = 0.0) -> BlockVector:
        """residual := u − g on Dirichlet dofs (setVectorMinusBC) — the
        Newton residual correction."""
        return self._dirichlet_where(residual, lambda b, g: sol[b] - g, t)

    def set_bc_minus_vector(self, residual: BlockVector, sol: BlockVector,
                            t: float = 0.0) -> BlockVector:
        """residual := g − u on Dirichlet dofs."""
        return self._dirichlet_where(residual, lambda b, g: g - sol[b], t)

    def zero_dirichlet(self, vec: BlockVector) -> BlockVector:
        """Zero the constrained entries (homogeneous form, for Newton
        updates)."""
        return self._dirichlet_where(vec, lambda b, g: torch.zeros_like(g))
