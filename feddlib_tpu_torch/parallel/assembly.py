"""Distributed FE assembly: each shard assembles its own elements and the
ghost-row contributions are exported to the owning shard — counterpart of
feddlib_tpu/parallel/assembly.py (the scalar-Laplace reference of the
exchange plan; the general device pipeline is parallel/pipeline.py).

All plans are static host-built index maps; the device work is

    values_q = element_kernel(vert_coords_q)               (batched, local)
    acc      = segment_sum(values_q, seg_ids_q)            (local + send)
    buf      = all_gather(acc[send part])
    data_q   = acc[local] + segment_sum(buf[recv_src], recv_dst)

producing each shard's owned-row CSR values without a global matrix.  The
segment sums add real duplicates, so on the card they go through the
fixed-order `la.csr.scatter_sum`.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from feddlib_tpu_torch.fe import assembly as asm
from feddlib_tpu_torch.la.csr import (SparsityPattern, scatter_sum,
                                     segment_sum_sorted)
from feddlib_tpu_torch.mesh.partition import MeshPartition
from feddlib_tpu_torch.parallel.spmd import DeviceAxis, _pad_stack


def stacked_segment_plan(seg, n_seg: int, device):
    """The fixed summation order of `_stacked_segment_sum` for a static
    seg [n_dev, m] (host or device), sorted once on `device`: (order,
    lengths) of the stacked targets.  None on the CPU, whose sum is
    `index_add_`."""
    device = torch.device(device)
    if device.type == "cpu":
        return None
    seg = torch.as_tensor(seg, dtype=torch.int64, device=device)
    n = seg.shape[0]
    idx = (seg + n_seg * torch.arange(n, device=device)[:, None]).reshape(-1)
    return (torch.argsort(idx, stable=True),
            torch.bincount(idx, minlength=n * n_seg))


def _stacked_segment_sum(vals: torch.Tensor, seg: torch.Tensor,
                         n_seg: int, plan=None) -> torch.Tensor:
    """Per-shard segment sums: vals, seg [n_dev, m] → [n_dev, n_seg], in a
    fixed order on the card (`la.csr.scatter_sum`, or the `plan` of
    `stacked_segment_plan` for the same seg)."""
    n = vals.shape[0]
    if plan is not None and vals.device.type != "cpu":
        return segment_sum_sorted(vals.reshape(-1), *plan).view(n, n_seg)
    off = n_seg * torch.arange(n, device=vals.device)[:, None]
    return scatter_sum(vals.reshape(-1), (seg + off).reshape(-1),
                       n * n_seg).view(n, n_seg)


class DistributedAssembly:
    """Distributed scalar Laplace-type assembly over a MeshPartition.

    Builds, per shard: padded element vertex coordinates, the segment-target
    plan (local CSR slot or send-buffer slot of each element-matrix entry),
    and the send/recv exchange plan.  `assemble_laplace(axis)` returns the
    stacked owned-row CSR data [n_dev, L] whose slots follow each shard's
    local CSR (rows = owned dofs ascending, columns sorted within rows)."""

    def __init__(self, part: MeshPartition, dofs_per_node: int = 1):
        mesh = part.mesh
        self.part = part
        self.dofs = dofs_per_node
        n_dev = part.n_parts
        self.n_dev = n_dev
        nv = mesh.vertices_per_element
        nb = mesh.nodes_per_element
        nloc = nb * dofs_per_node
        n_dofs = mesh.n_points * dofs_per_node

        # global dof pattern (host symbolic, shared bookkeeping only)
        elem_dofs = asm.vector_dof_ids(mesh.elements, dofs_per_node) \
            if dofs_per_node > 1 else mesh.elements
        pat = asm.scatter_pattern(elem_dofs, elem_dofs, n_dofs, n_dofs)
        dof_map = part.unique_map.build_vec_field_map(dofs_per_node) \
            if dofs_per_node > 1 else part.unique_map
        owner = dof_map.owner_of()

        # per-shard local CSR slot table: owned rows ascending, cols sorted
        rows_of = pat.rows_of_slots()
        slot_owner = owner[rows_of]
        self.local_slot_of_global = np.full(pat.nnz, -1, dtype=np.int64)
        self.n_local = np.zeros(n_dev, dtype=np.int64)
        for p in range(n_dev):
            sel = np.nonzero(slot_owner == p)[0]  # ascending = local order
            self.local_slot_of_global[sel] = np.arange(len(sel))
            self.n_local[p] = len(sel)
        self.L = int(self.n_local.max())
        self.pattern = pat
        self.dof_map = dof_map

        # per-shard element lists and their COO slot targets
        E_max = int(part.element_map.local_sizes.max())
        self.E_max = E_max
        keys = _pattern_keys(pat, n_dofs)
        vc_l, seg_l, valid_l = [], [], []
        send_pairs: List[np.ndarray] = []
        for q in range(n_dev):
            eids = part.elem_ids[q]
            Eq = len(eids)
            vc = np.zeros((E_max, nv, mesh.dim))
            vc[:Eq] = mesh.points[mesh.elements[eids][:, :nv]]
            vc[Eq:] = mesh.points[mesh.elements[0][:nv]]  # benign pad geometry
            valid = np.zeros(E_max)
            valid[:Eq] = 1.0
            ed = elem_dofs[eids]
            rows = np.broadcast_to(ed[:, :, None], (Eq, nloc, nloc)).ravel()
            cols = np.broadcast_to(ed[:, None, :], (Eq, nloc, nloc)).ravel()
            gslot = np.searchsorted(keys, rows * n_dofs + cols)
            remote = owner[rows] != q
            # send list: the unique global slots owned elsewhere
            send_slots = np.unique(gslot[remote])
            send_pairs.append(send_slots)
            slot_in_send = np.full(pat.nnz, -1, dtype=np.int64)
            slot_in_send[send_slots] = np.arange(len(send_slots))
            seg = np.where(remote,
                           self.L + slot_in_send[gslot],
                           self.local_slot_of_global[gslot])
            # pad elements (zeroed by `valid`) scatter into local slot 0
            seg_full = np.zeros(E_max * nloc * nloc, dtype=np.int64)
            seg_full[: len(seg)] = seg
            vc_l.append(vc)
            seg_l.append(seg_full)
            valid_l.append(valid)
        self.S = max(max((len(s) for s in send_pairs), default=0), 1)

        # recv plans: owner p gathers, from each q's send buffer, the
        # entries whose global slot it owns
        recv_src, recv_dst = [], []
        for p in range(n_dev):
            src_l, dst_l = [], []
            for q in range(n_dev):
                if q == p:
                    continue
                ss = send_pairs[q]
                sel = np.nonzero(owner[rows_of[ss]] == p)[0]
                src_l.append(q * self.S + sel)
                dst_l.append(self.local_slot_of_global[ss[sel]])
            recv_src.append(np.concatenate(src_l) if src_l
                            else np.array([], np.int64))
            recv_dst.append(np.concatenate(dst_l) if dst_l
                            else np.array([], np.int64))
        self.Rx = max(max((len(s) for s in recv_src), default=0), 1)

        self.vert_coords = np.stack(vc_l)
        self.seg_ids = _pad_stack(seg_l, 0, E_max * nloc * nloc, np.int64)
        self.valid = np.stack(valid_l)
        self.recv_src = _pad_stack(recv_src, 0, self.Rx, np.int64)
        self.recv_dst = _pad_stack(recv_dst, self.L, self.Rx, np.int64)
        self.nloc = nloc
        self.dim = mesh.dim
        self.fe_type = mesh.fe_type

    def assemble_laplace(self, axis: DeviceAxis) -> torch.Tensor:
        """Distributed scalar Laplace assembly → [n_local, L] owned CSR
        data of the axis' rank on its device (every shard without ranks)."""
        if self.dofs != 1:
            raise ValueError("assemble_laplace: dofs_per_node=1 only")
        if axis.n_dev != self.n_dev:
            raise ValueError("device axis size != partition count")
        L, S = self.L, self.S
        _, E, nv, dim = self.vert_coords.shape
        n = axis.n_local
        vc = axis.put(self.vert_coords)
        valid = axis.put(self.valid)
        Ke = asm.elem_laplace(vc.view(n * E, nv, dim), self.dim, self.fe_type)
        Ke = Ke.reshape(n, E, -1) * valid[:, :, None]
        acc = _stacked_segment_sum(Ke.reshape(n, -1), axis.ix(self.seg_ids),
                                   L + S)
        local, send = acc[:, :L], acc[:, L:]
        buf = axis.all_gather(send)  # [n_dev, S]
        vals = buf.reshape(-1)[axis.ix(self.recv_src)]
        add = _stacked_segment_sum(vals, axis.ix(self.recv_dst),
                                   L + 1)[:, :L]
        return local + add

    def reference_local_data(self, global_data: np.ndarray) -> np.ndarray:
        """Slice serial CSR data into the per-shard local layout (for
        verification)."""
        out = np.zeros((self.n_dev, self.L))
        owner = self.dof_map.owner_of()
        slot_owner = owner[self.pattern.rows_of_slots()]
        for p in range(self.n_dev):
            sel = np.nonzero(slot_owner == p)[0]
            out[p, : len(sel)] = global_data[sel]
        return out


def _pattern_keys(pat: SparsityPattern, n_cols: int) -> np.ndarray:
    return pat.rows_of_slots() * n_cols + pat.indices
