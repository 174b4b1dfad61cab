"""Carry the JAX package's assembled state into the port.

The system has no weights; what crosses between the two packages is the
assembled state — a CSR matrix, a mesh, a partition, a built SpMV format,
a block vector, a built one-level Schwarz preconditioner, a Newton iterate
— given as numpy arrays, so both packages can build every operator from the
same matrix and the same clusters, apply the very same format planes or
subdomain inverses, or take a Newton step from the same iterate.  Copy a jax array with `np.array(a, copy=True)` first:
`np.asarray` of a jax array is read-only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from feddlib_tpu_torch.la.block import BlockVector
from feddlib_tpu_torch.la.csr import CsrMatrix, SparsityPattern
from feddlib_tpu_torch.la.dia import (BlockDiaMatrix, DiaMatrix,
                                      SplitDiaMatrix, split_gathers)
from feddlib_tpu_torch.la.sell import BlockSellMatrix, SellMatrix
from feddlib_tpu_torch.mesh.mesh import Mesh
from feddlib_tpu_torch.mesh.partition import MeshPartition


def csr_from_numpy(indptr, indices, data, shape, device="cuda",
                   dtype=torch.float64) -> CsrMatrix:
    """CsrMatrix from CSR arrays (indices sorted within each row)."""
    pat = SparsityPattern.from_csr(np.asarray(indptr), np.asarray(indices),
                                   int(shape[1]))
    if pat.n_rows != int(shape[0]):
        raise ValueError(f"indptr gives {pat.n_rows} rows, shape {shape}")
    return CsrMatrix(pat, torch.as_tensor(np.array(data, copy=True)),
                     dtype=dtype, device=device)


def mesh_from_numpy(points, elements, point_flags, element_flags=None,
                    fe_type: str = "P1", surfaces=None, surface_flags=None,
                    lines=None, line_flags=None,
                    p2_edges: Optional[np.ndarray] = None) -> Mesh:
    """Mesh from its arrays (dim from the points' width)."""
    points = np.array(points, dtype=np.float64, copy=True)
    elements = np.array(elements, dtype=np.int64, copy=True)
    if element_flags is None:
        element_flags = np.zeros(len(elements), np.int32)
    return Mesh(points.shape[1], fe_type, points,
                np.array(point_flags, dtype=np.int32, copy=True), elements,
                np.array(element_flags, dtype=np.int32, copy=True),
                surfaces=None if surfaces is None else np.array(surfaces),
                surface_flags=(None if surface_flags is None
                               else np.array(surface_flags)),
                lines=None if lines is None else np.array(lines),
                line_flags=None if line_flags is None else np.array(line_flags),
                p2_edges=None if p2_edges is None else np.array(p2_edges))
    return mesh


def partition_from_numpy(mesh: Mesh, elem_part,
                         n_parts: Optional[int] = None) -> MeshPartition:
    """MeshPartition (element lists, repeated and unique node maps) from a
    given element → part assignment."""
    elem_part = np.array(elem_part, dtype=np.int32, copy=True)
    n = int(n_parts if n_parts is not None else elem_part.max() + 1)
    return MeshPartition(mesh, n, elem_part=elem_part)


# -- SpMV formats: the JAX object's arrays (as numpy) → the port's object ----

def _dev(a, device, dtype=None):
    """numpy (or None) → tensor on `device`; index arrays become int64."""
    if a is None:
        return None
    a = np.array(a, copy=True)
    if dtype is None and a.dtype.kind in "iu" and a.dtype != np.int16:
        a = a.astype(np.int64)
    return torch.as_tensor(a, dtype=dtype, device=device)


def sell_from_numpy(shape, vals, pidx, bids, E, K, nnz, data_slots,
                    data_spill, spill_rows=None, spill_cols=None,
                    spill_vals=None, perm=None, iperm=None, csr_order=None,
                    dtype=torch.float32, device="cuda") -> SellMatrix:
    """SellMatrix from the planes and plans of a JAX `SellMatrix`."""
    return SellMatrix(
        int(shape[0]), int(shape[1]), _dev(vals, device, dtype),
        _dev(pidx, device), _dev(bids, device, torch.int32),
        _dev(spill_rows, device), _dev(spill_cols, device),
        _dev(spill_vals, device, dtype), int(nnz),
        np.array(data_slots, dtype=np.int64, copy=True),
        np.array(data_spill, dtype=np.int64, copy=True), dtype, int(E),
        int(K), _dev(perm, device), _dev(iperm, device),
        None if csr_order is None else np.array(csr_order, copy=True))


def block_sell_from_numpy(n, d, layout: SellMatrix, vals, dof_slots, nnz,
                          spill_rows=None, spill_cols=None, spill_vals=None,
                          spill_sel=None,
                          dtype=torch.float32) -> BlockSellMatrix:
    """BlockSellMatrix from a JAX `BlockSellMatrix`: `layout` is its
    node-pattern layout carried over with sell_from_numpy, vals the
    [nchunks, d*d, 8, 128] planes."""
    dev = layout.device
    return BlockSellMatrix(
        int(n), int(d), layout, _dev(vals, dev, dtype),
        _dev(spill_rows, dev), _dev(spill_cols, dev),
        _dev(spill_vals, dev, dtype), int(nnz), _dev(dof_slots, dev),
        _dev(spill_sel, dev), dtype)


def dia_from_numpy(shape, offsets, vals, data_slots, nnz, spill_rows=None,
                   spill_cols=None, spill_vals=None, spill_sel=None,
                   dtype=torch.float32, device="cuda") -> DiaMatrix:
    """DiaMatrix from a JAX `DiaMatrix` (vals [n_offsets, n_rows])."""
    return DiaMatrix(
        int(shape[0]), int(shape[1]), tuple(int(o) for o in offsets),
        _dev(vals, device, dtype), _dev(spill_rows, device),
        _dev(spill_cols, device), _dev(spill_vals, device, dtype), int(nnz),
        _dev(data_slots, device), _dev(spill_sel, device), dtype)


def block_dia_from_numpy(n, d, offsets, vals, data_slots, nnz,
                         spill_rows=None, spill_cols=None, spill_vals=None,
                         spill_sel=None, dtype=torch.float32,
                         device="cuda") -> BlockDiaMatrix:
    """BlockDiaMatrix from a JAX `BlockDiaMatrix` (vals [d, n_off*d, nn],
    spill ids planar)."""
    return BlockDiaMatrix(
        int(n), int(d), tuple(int(o) for o in offsets),
        _dev(vals, device, dtype), _dev(spill_rows, device),
        _dev(spill_cols, device), _dev(spill_vals, device, dtype), int(nnz),
        _dev(data_slots, device), _dev(spill_sel, device), dtype)


def split_dia_from_numpy(dia_part, sell_part, d, node_perm, sel_dia, sel_res,
                         nnz, dtype=torch.float32) -> SplitDiaMatrix:
    """SplitDiaMatrix from a JAX `SplitDiaMatrix`: its two parts carried
    over with the functions above, its RCM node permutation and its
    with_data selections.  The entry and exit gathers are rebuilt from
    `node_perm` (the JAX object keeps only their TPU window plans)."""
    node_perm = np.array(node_perm, dtype=np.int64, copy=True)
    gin, gout = split_gathers(node_perm, int(d), dia_part.device)
    return SplitDiaMatrix(
        dia_part, sell_part, int(d), len(node_perm), node_perm,
        np.array(sel_dia, dtype=np.int64, copy=True),
        np.array(sel_res, dtype=np.int64, copy=True), int(nnz), dtype, gin,
        gout)


# -- vectors, preconditioners and nonlinear state ------------------------------

def block_vector_from_numpy(blocks, device="cuda",
                            dtype=torch.float64) -> BlockVector:
    """BlockVector from a sequence of numpy blocks (a JAX BlockVector's
    `blocks`, each copied with np.array)."""
    return BlockVector([_dev(b, device, dtype) for b in blocks])


def schwarz_from_numpy(n, ov_idx, keep, inv, avg_scale=None,
                       combine: str = "Restricted", dtype=torch.float64,
                       device="cuda"):
    """SchwarzPreconditioner from the arrays of a JAX
    `SchwarzPreconditioner` with dense subdomain inverses: ov_idx [P, S]
    (pad → n), keep [P, S], inv [P, S, S], and avg_scale [n] for the
    Averaging combine."""
    from feddlib_tpu_torch.precond.schwarz import SchwarzPreconditioner
    from feddlib_tpu_torch.utils.device import resolve_device

    pre = SchwarzPreconditioner.__new__(SchwarzPreconditioner)
    pre.device = resolve_device(device)
    pre.combine = combine
    pre.n = int(n)
    pre.ov_idx = _dev(ov_idx, pre.device)
    pre.n_parts, pre.S = pre.ov_idx.shape
    pre.ov_sets = [row[row < pre.n] for row in np.asarray(ov_idx)]
    pre.solver, pre.slu = "dense", None
    pre.keep = _dev(keep, pre.device, dtype)
    pre.inv = _dev(inv, pre.device, dtype)
    pre.avg_scale = _dev(avg_scale, pre.device, dtype)
    pre._op = None
    return pre


def newton_state_from_numpy(problem, u, p) -> None:
    """Set a velocity–pressure problem's iterate (u, p) — a JAX problem's
    solution blocks — so a Newton step starts from it."""
    problem.solution = block_vector_from_numpy([u, p], problem.device)


def fsi_state_from_numpy(problem, blocks, solid_v, solid_a, g_prev, points,
                         ref_points) -> None:
    """Carry an FSI state — a JAX FSI problem's solution blocks (four for
    GE, five for GI), Newmark velocity and acceleration, previous mesh
    displacement [n_nodes, dim] and the fluid mesh's current and reference
    points — into the port's (assembled) FSI problem, so that its next
    time step starts from it."""
    dev = problem.device
    if len(blocks) == 5:
        problem._gi = True
    problem.solution = block_vector_from_numpy(blocks, dev)
    problem.rhs = BlockVector([torch.zeros_like(b)
                               for b in problem.solution.blocks])
    problem.solid_v = _dev(solid_v, dev, torch.float64)
    problem.solid_a = _dev(solid_a, dev, torch.float64)
    problem.u_prev = problem.solution[0]
    problem.g_prev = np.array(g_prev, dtype=np.float64, copy=True)
    dom_u = problem.variables[0][0]
    dom_u.mesh.ref_points = np.array(ref_points, dtype=np.float64, copy=True)
    dom_u.mesh.points = np.array(points, dtype=np.float64, copy=True)
    dom_u.invalidate_geometry()
    if getattr(problem, "Af", None) is not None:
        problem._assemble_fluid_constant()
