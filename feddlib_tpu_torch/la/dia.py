"""DIA (diagonal) SpMV formats and the automatic format choice.

Counterpart of feddlib_tpu/la/dia.py.  For matrices whose nonzeros sit on a
small set of diagonals — structured-grid FEM stencils above all (a 3D P1
tet stencil is exactly 15 diagonals) — the apply needs no gather at all:

    y = Σ_d  vals[d] ⊙ shift(x, off_d)

a stream of multiply-adds over shifted, unit-stride reads of x.  These are
plain tensor ops in the JAX package and plain torch ops here; no kernel of
its own computes them.

`DiaMatrix.from_csr` detects the diagonal structure and REFUSES (returns
None) when the matrix is not truly banded-sparse — unstructured meshes
spread their nonzeros over too many partial diagonals.  `SplitDiaMatrix`
reorders those with reverse Cuthill-McKee, keeps the well-filled node
diagonals in (block-)DIA form and sends the residue through the windowed
sliced-ELL kernels (la/sell.py: B2 for scalar fields, B5 for d x d node
blocks), with one permutation gather (la/permute.py, B1) on the way in and
one on the way out.  `auto_spmv` picks among them.  A small remainder is
always carried exactly in a COO spill applied with `index_add`.

Vector-field formats work on PLANAR component-major vectors [d, nn]
(dof (node, c) at c*nn + node); `operator()` / `matvec` take the NodeWise
interleaved vector [nn*d] and transpose on the way in and out.
"""

from __future__ import annotations

import numpy as np
import torch

from feddlib_tpu_torch.la.permute import PermutationGather, permute_op
from feddlib_tpu_torch.la.sell import BlockSellMatrix, SellMatrix, sell_op
from feddlib_tpu_torch.utils import timers
from feddlib_tpu_torch.utils.device import resolve_device


def _host_csr(A, device):
    """(scipy CSR with sorted indices, device, device values or None)."""
    if hasattr(A, "to_scipy"):
        sp = A.to_scipy().tocsr()
        sp.sort_indices()
        return sp, A.device, A.data
    sp = A.tocsr()
    sp.sort_indices()
    return sp, resolve_device(device), None


def _device_values(sp, data, dtype, dev):
    if data is not None:
        return data.to(dtype)
    return torch.as_tensor(np.asarray(sp.data), dtype=dtype, device=dev)


def _itemsize(dtype) -> int:
    return torch.finfo(dtype).bits // 8


def _fill_dia(data, slots, size):
    """vals[slots[i]] = data[i] for slots[i] >= 0 (setup-only scatter)."""
    valid = slots >= 0
    out = torch.zeros(size, dtype=data.dtype, device=data.device)
    out[slots[valid]] = data[valid]
    return out


def _kept_diagonals(off, nnz, max_offsets, coverage):
    """The `max_offsets` best-filled of the offsets `off` (one per nonzero),
    or None if they cover less than `coverage` of the nonzeros.  Returns
    (kept offsets sorted, rank of each nonzero's offset or -1)."""
    uoff, inv, counts = np.unique(off, return_inverse=True,
                                  return_counts=True)
    inv = inv.ravel()
    order = np.argsort(-counts, kind="stable")[:max_offsets]
    if int(counts[order].sum()) < coverage * nnz:
        return None
    keep = np.zeros(len(uoff), np.bool_)
    keep[order] = True
    kept_off = np.sort(uoff[keep])
    rank_of_uoff = np.full(len(uoff), -1, np.int64)
    rank_of_uoff[keep] = np.searchsorted(kept_off, uoff[keep])
    return kept_off, rank_of_uoff[inv]


class DiaMatrix:
    """Diagonal-storage operator for y = A @ x (+ exact COO spill)."""

    def __init__(self, n_rows, n_cols, offsets, vals, spill_rows, spill_cols,
                 spill_vals, nnz, data_slots, spill_sel, dtype):
        self.shape = (n_rows, n_cols)
        self.offsets = offsets          # host tuple of python ints
        self.vals = vals                # [n_offsets, n_rows] dtype
        self.spill_rows = spill_rows    # [S] int64 (or None)
        self.spill_cols = spill_cols
        self.spill_vals = spill_vals
        self.nnz = nnz
        self.data_slots = data_slots    # device: csr nnz -> k*n_rows+row (-1)
        self.spill_sel = spill_sel      # device: csr positions of spill nnz
        self.dtype = dtype
        self.device = vals.device

    # -- construction --------------------------------------------------------
    @classmethod
    def from_csr(cls, A, dtype=torch.float32, max_offsets=40, coverage=0.97,
                 max_bytes_per_nnz=8.0, device="cuda"):
        """Build from CsrMatrix/scipy CSR, or return None if the matrix is
        not diagonal-concentrated enough for the format to win:
        - the top `max_offsets` diagonals must cover >= `coverage` of nnz
        - padded storage must stay under `max_bytes_per_nnz` streamed bytes
        """
        sp, dev, data = _host_csr(A, device)
        n_rows, n_cols = sp.shape
        if n_rows != n_cols or n_rows == 0:
            return None
        row = np.repeat(np.arange(n_rows, dtype=np.int64),
                        np.diff(sp.indptr))
        kept = _kept_diagonals(sp.indices.astype(np.int64) - row, sp.nnz,
                               max_offsets, coverage)
        if kept is None:
            return None
        kept_off, nz_rank = kept
        n_off = len(kept_off)
        if n_off * n_rows * _itemsize(dtype) > max_bytes_per_nnz * sp.nnz:
            return None
        in_dia = nz_rank >= 0
        data_slots = np.where(in_dia, nz_rank * n_rows + row, -1)
        spill_idx = np.flatnonzero(~in_dia)

        data_dev = _device_values(sp, data, dtype, dev)
        slots_dev = torch.as_tensor(data_slots, device=dev)
        vals = _fill_dia(data_dev, slots_dev, n_off * n_rows).reshape(
            n_off, n_rows)
        if len(spill_idx):
            spill_sel = torch.as_tensor(spill_idx, device=dev)
            s_rows = torch.as_tensor(row[spill_idx], device=dev)
            s_cols = torch.as_tensor(sp.indices[spill_idx].astype(np.int64),
                                     device=dev)
            s_vals = data_dev[spill_sel]
        else:
            spill_sel = s_rows = s_cols = s_vals = None
        return cls(n_rows, n_cols, tuple(int(o) for o in kept_off), vals,
                   s_rows, s_cols, s_vals, sp.nnz, slots_dev, spill_sel,
                   dtype)

    def with_data(self, data: torch.Tensor) -> "DiaMatrix":
        """Same pattern, new CSR value array (reassembly)."""
        d = data.to(device=self.device, dtype=self.dtype)
        vals = _fill_dia(d, self.data_slots,
                         self.vals.numel()).reshape(self.vals.shape)
        s_vals = d[self.spill_sel] if self.spill_sel is not None else None
        return DiaMatrix(self.shape[0], self.shape[1], self.offsets, vals,
                         self.spill_rows, self.spill_cols, s_vals, self.nnz,
                         self.data_slots, self.spill_sel, self.dtype)

    # -- apply ---------------------------------------------------------------
    def operands(self):
        return (self.vals, self.spill_rows, self.spill_cols,
                self.spill_vals, self.shape[0], self.shape[1], self.offsets)

    def operator(self):
        """(fn, operands) for the solver's operator protocol."""
        return dia_op, self.operands()

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return dia_op(self.operands(), x)

    def hbm_bytes_per_apply(self) -> int:
        isz = self.vals.element_size()
        b = self.vals.numel() * isz + (self.shape[1] + self.shape[0]) * isz
        if self.spill_rows is not None:
            b += int(self.spill_rows.numel()) * (8 + 2 * isz)
        return b


def dia_op(ops, x):
    vals, s_rows, s_cols, s_vals, n_rows, n_cols, offsets = ops
    out_dtype = x.dtype
    xc = x.to(vals.dtype)
    lo = min(min(offsets), 0)
    hi = max(max(offsets) + n_rows - n_cols, 0)
    xp = torch.nn.functional.pad(xc, (-lo, hi))
    y = torch.zeros(n_rows, dtype=vals.dtype, device=vals.device)
    for k, o in enumerate(offsets):
        y.addcmul_(vals[k], xp[o - lo: o - lo + n_rows])
    if s_rows is not None:
        y.index_add_(0, s_rows, s_vals * xc[s_cols])
    return y.to(out_dtype)


class BlockDiaMatrix:
    """Block-DIA SpMV for vector-field operators (dofs-per-node d > 1).

    Vector operators (elasticity 2με:ε+λdiv·div, vector Laplace) produce
    d×d dense node blocks on the scalar node pattern under NodeWise dof
    ordering (dof = node·d + c).  On a banded NODE pattern every
    (node-offset, ci, cj) triple is its own perfect dof-diagonal, so the
    apply is d² gather-free scalar-DIA passes over component PLANES:

        y[ci] += vals[o, ci, cj] ⊙ shift(x[cj], node_off)

    with unit-stride reads.  Non-banded node patterns return None
    (auto_spmv goes on to the split and SELL formats).

    LAYOUT: the apply works on PLANAR component-major vectors xc [d, nn].
    Keep whole Krylov loops planar via `planar_operator()` +
    `to_planar`/`from_planar`; `operator()`/`matvec` accept interleaved
    vectors and pay the two transposes."""

    def __init__(self, n, d, offsets, vals, spill_rows, spill_cols,
                 spill_vals, nnz, data_slots, spill_sel, dtype):
        self.shape = (n, n)
        self.d = d
        self.offsets = offsets          # node offsets, python ints
        self.vals = vals                # [d, n_off*d, nn] ci-major planes
        self.spill_rows = spill_rows    # PLANAR flat dof ids (c*nn + node)
        self.spill_cols = spill_cols
        self.spill_vals = spill_vals
        self.nnz = nnz
        self.data_slots = data_slots    # device: csr nnz -> flat slot (-1)
        self.spill_sel = spill_sel
        self.dtype = dtype
        self.device = vals.device

    @classmethod
    def from_csr(cls, A, d, dtype=torch.float32, max_offsets=40,
                 coverage=0.97, max_bytes_per_nnz=8.0, device="cuda"):
        sp, dev, data = _host_csr(A, device)
        n = sp.shape[0]
        if sp.shape[0] != sp.shape[1] or n == 0 or d <= 1 or n % d:
            return None
        nn = n // d
        row = np.repeat(np.arange(n, dtype=np.int64), np.diff(sp.indptr))
        col = sp.indices.astype(np.int64)
        nrow, ci = row // d, row % d
        ncol, cj = col // d, col % d
        kept = _kept_diagonals(ncol - nrow, sp.nnz, max_offsets, coverage)
        if kept is None:
            return None
        kept_off, nz_rank = kept
        n_off = len(kept_off)
        if n_off * d * d * nn * _itemsize(dtype) > max_bytes_per_nnz * sp.nnz:
            return None
        in_dia = nz_rank >= 0

        # ci-major plane index: plane = ci*(n_off*d) + k*d + cj — one
        # contiguous [n_off*d, nn] slab per output component
        plane = (ci * n_off + nz_rank) * d + cj
        data_slots = np.where(in_dia, plane * nn + nrow, -1)
        spill_idx = np.flatnonzero(~in_dia)

        data_dev = _device_values(sp, data, dtype, dev)
        slots_dev = torch.as_tensor(data_slots, device=dev)
        vals = _fill_dia(data_dev, slots_dev, n_off * d * d * nn).reshape(
            d, n_off * d, nn)
        if len(spill_idx):
            spill_sel = torch.as_tensor(spill_idx, device=dev)
            # planar flat ids: dof (node, c) lives at c*nn + node
            sr, sc = row[spill_idx], col[spill_idx]
            s_rows = torch.as_tensor((sr % d) * nn + sr // d, device=dev)
            s_cols = torch.as_tensor((sc % d) * nn + sc // d, device=dev)
            s_vals = data_dev[spill_sel]
        else:
            spill_sel = s_rows = s_cols = s_vals = None
        return cls(n, d, tuple(int(o) for o in kept_off), vals,
                   s_rows, s_cols, s_vals, sp.nnz, slots_dev, spill_sel,
                   dtype)

    def with_data(self, data: torch.Tensor) -> "BlockDiaMatrix":
        d = data.to(device=self.device, dtype=self.dtype)
        vals = _fill_dia(d, self.data_slots,
                         self.vals.numel()).reshape(self.vals.shape)
        s_vals = d[self.spill_sel] if self.spill_sel is not None else None
        return BlockDiaMatrix(self.shape[0], self.d, self.offsets, vals,
                              self.spill_rows, self.spill_cols, s_vals,
                              self.nnz, self.data_slots, self.spill_sel,
                              self.dtype)

    # -- vector layout -------------------------------------------------------
    def to_planar(self, x: torch.Tensor) -> torch.Tensor:
        """NodeWise interleaved [nn*d] → planar [d, nn] (do this once per
        solve, not per apply)."""
        return x.reshape(self.shape[0] // self.d, self.d).T

    def from_planar(self, xc: torch.Tensor) -> torch.Tensor:
        return xc.T.reshape(-1)

    # -- applies -------------------------------------------------------------
    def operands(self):
        return (self.vals, self.spill_rows, self.spill_cols,
                self.spill_vals, self.d, self.offsets)

    def planar_operator(self):
        """(fn, operands) on planar [d, nn] vectors."""
        return block_dia_planar_op, self.operands()

    def operator(self):
        """(fn, operands) on NodeWise interleaved vectors (two transposes
        per apply — use planar_operator for Krylov loops)."""
        return block_dia_op, self.operands()

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return block_dia_op(self.operands(), x)

    def hbm_bytes_per_apply(self) -> int:
        isz = self.vals.element_size()
        b = self.vals.numel() * isz + 2 * self.shape[0] * isz
        if self.spill_rows is not None:
            b += int(self.spill_rows.numel()) * (8 + 2 * isz)
        return b


def block_dia_planar_op(ops, xc):
    """xc [d, nn] planar → y [d, nn]: one stacked shift of x and ONE
    multiply-reduce against the ci-major value slabs."""
    vals, s_rows, s_cols, s_vals, d, offsets = ops
    out_dtype = xc.dtype
    nn = xc.shape[1]
    xd = xc.to(vals.dtype)
    lo = min(min(offsets), 0)
    hi = max(max(offsets), 0)
    xp = torch.nn.functional.pad(xd, (-lo, hi))
    xs = torch.stack([xp[:, o - lo: o - lo + nn]
                      for o in offsets]).reshape(len(offsets) * d, nn)
    y = (vals * xs[None]).sum(dim=1)          # [d, nn]
    if s_rows is not None:
        contrib = s_vals * xd.reshape(-1)[s_cols]
        y = y.reshape(-1).index_add(0, s_rows, contrib).reshape(d, nn)
    return y.to(out_dtype)


def block_dia_op(ops, x):
    """Interleaved NodeWise x [nn*d] → y [nn*d]."""
    d = ops[4]
    y = block_dia_planar_op(ops, x.reshape(-1, d).T)
    return y.T.reshape(-1).to(x.dtype)


class SplitDiaMatrix:
    """RCM-banded (block-)DIA + windowed-SELL residue for UNSTRUCTURED
    operators.

    RCM reordering concentrates most nonzeros of an unstructured FE
    operator onto O(1) near diagonals; those stream through the
    gather-free (Block)DiaMatrix path and only the residue pays the SELL
    gather — and with the dense diagonals removed, the residue's slots per
    row shrink too.  A node diagonal is kept when its occupancy clears
    `min_occupancy`.

    The operator lives in RCM-PERMUTED (and, for d > 1, PLANAR [d, nn])
    space; `operator()` wraps it with one PermutationGather each way
    (interleaved NodeWise in/out — drop-in for the Krylov paths),
    `permuted_operator()` exposes the raw form for whole-loop use.
    `from_csr` opens the synchronised spans (utils/timers.py) `split.rcm`,
    `split.permute`, `split.dia_layout`, `split.sell_layout` and
    `split.gathers`, one a part of the host set-up."""

    def __init__(self, dia_part, sell_part, d, nn, node_perm, sel_dia,
                 sel_res, nnz, dtype, gin, gout):
        self.dia = dia_part          # DiaMatrix (d=1) | BlockDiaMatrix
        self.sell = sell_part        # SellMatrix | BlockSellMatrix | None
        self.d = d
        self.nn = nn
        self.shape = (nn * d, nn * d)
        self.node_perm = node_perm
        self.sel_dia = sel_dia       # original CSR positions per part
        self.sel_res = sel_res
        self._sel_dia_dev = None
        self._sel_res_dev = None
        self.nnz = nnz
        self.dtype = dtype
        self.gin = gin               # PermutationGather in/out plans
        self.gout = gout
        self.device = dia_part.device

    @classmethod
    def from_csr(cls, A, dtype=torch.float32, dofs_per_node: int = 1,
                 min_occupancy: float = 0.15, max_offsets: int = 96,
                 min_dia_share: float = 0.25, device="cuda"):
        import scipy.sparse as sps
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        with timers.timer("split.rcm", sync=True):
            sp, dev, _ = _host_csr(A, device)
            n = sp.shape[0]
            d = int(dofs_per_node)
            if sp.shape[0] != sp.shape[1] or n == 0 or n % max(d, 1):
                return None
            nn = n // d
            data_np = np.asarray(sp.data)

            # node-graph RCM (symmetric pattern)
            if d > 1:
                row = np.repeat(np.arange(n, dtype=np.int64),
                                np.diff(sp.indptr))
                ng = sps.csr_matrix(
                    (np.ones(sp.nnz, np.int8), (row // d, sp.indices // d)),
                    shape=(nn, nn))
            else:
                ng = sp
            node_perm = np.asarray(
                reverse_cuthill_mckee(ng.tocsr(), symmetric_mode=True),
                dtype=np.int64)
            dof_perm = ((node_perm[:, None] * d
                         + np.arange(d)[None, :]).reshape(-1) if d > 1
                        else node_perm)

        with timers.timer("split.permute", sync=True):
            # permute WITH original-position tracking (with_data plans)
            pos = sp.copy()
            pos.data = np.arange(sp.nnz, dtype=np.int64) + 1
            pos_p = pos[dof_perm][:, dof_perm].tocsr()
            pos_p.sort_indices()
            opos = pos_p.data - 1
            rowp = np.repeat(np.arange(n, dtype=np.int64),
                             np.diff(pos_p.indptr))
            colp = pos_p.indices.astype(np.int64)

            # node-offset occupancy → kept diagonals
            noff = colp // d - rowp // d
            uoff, inv, counts = np.unique(noff, return_inverse=True,
                                          return_counts=True)
            inv = inv.ravel()
            slots = np.maximum(nn - np.abs(uoff), 1) * d * d
            occ = counts / slots
            cand = np.flatnonzero(occ >= min_occupancy)
            if len(cand) > max_offsets:
                cand = cand[np.argsort(-occ[cand],
                                       kind="stable")[:max_offsets]]
            keep = np.zeros(len(uoff), np.bool_)
            keep[cand] = True
            in_dia = keep[inv]
            covered = int(in_dia.sum())
        if covered < min_dia_share * sp.nnz:
            return None  # not diagonal-concentrated even under RCM

        def _sub(mask):
            """Sub-CSR of the permuted matrix + the ORIGINAL CSR position
            per entry, in the sub's canonical (row-major) data order —
            the with_data plan."""
            r, c, o = rowp[mask], colp[mask], opos[mask]
            srt = np.lexsort((c, r))
            return (sps.csr_matrix((data_np[o[srt]], (r[srt], c[srt])),
                                   shape=(n, n)), o[srt])

        with timers.timer("split.dia_layout", sync=True):
            sub_dia, sel_dia = _sub(in_dia)
            if d > 1:
                dia_part = BlockDiaMatrix.from_csr(
                    sub_dia, d, dtype=dtype, max_offsets=len(cand) + 1,
                    coverage=0.0, max_bytes_per_nnz=1e12, device=dev)
            else:
                dia_part = DiaMatrix.from_csr(
                    sub_dia, dtype=dtype, max_offsets=len(cand) + 1,
                    coverage=0.0, max_bytes_per_nnz=1e12, device=dev)
            if dia_part is None:
                return None
            if dia_part.spill_rows is not None:
                return None  # by construction the sub is pure-diagonal

        with timers.timer("split.sell_layout", sync=True):
            if int((~in_dia).sum()):
                sub_res, sel_res = _sub(~in_dia)
                sell_part = (BlockSellMatrix.from_csr(sub_res, d,
                                                      dtype=dtype,
                                                      device=dev)
                             if d > 1 else
                             SellMatrix.from_csr(sub_res, dtype=dtype,
                                                 device=dev))
                if sell_part is None and d > 1:
                    # partial blocks in the residue: planar-indexed scalar
                    # SELL
                    m = ~in_dia
                    r_pl = (rowp[m] % d) * nn + rowp[m] // d
                    c_pl = (colp[m] % d) * nn + colp[m] // d
                    order = np.lexsort((c_pl, r_pl))
                    sub_pl = sps.csr_matrix(
                        (data_np[opos[m]][order],
                         (r_pl[order], c_pl[order])), shape=(n, n))
                    sell_part = SellMatrix.from_csr(sub_pl, dtype=dtype,
                                                    device=dev)
                    sel_res = opos[m][order]
            else:
                sell_part = None
                sel_res = np.zeros(0, np.int64)

        with timers.timer("split.gathers", sync=True):
            gin, gout = split_gathers(node_perm, d, dev)
        return cls(dia_part, sell_part, d, nn, node_perm, sel_dia,
                   sel_res, sp.nnz, dtype, gin, gout)

    @property
    def dia_share(self) -> float:
        return len(self.sel_dia) / max(self.nnz, 1)

    def with_data(self, data: torch.Tensor) -> "SplitDiaMatrix":
        """Same pattern, new values in the ORIGINAL CSR order, routed to
        the two parts through sel_dia / sel_res."""
        d_arr = data.to(self.device)
        if self._sel_dia_dev is None:
            self._sel_dia_dev = torch.as_tensor(self.sel_dia,
                                                device=self.device)
            self._sel_res_dev = (torch.as_tensor(self.sel_res,
                                                 device=self.device)
                                 if len(self.sel_res) else None)
        new_dia = self.dia.with_data(d_arr[self._sel_dia_dev])
        new_sell = (self.sell.with_data(d_arr[self._sel_res_dev])
                    if self.sell is not None else None)
        out = SplitDiaMatrix(new_dia, new_sell, self.d, self.nn,
                             self.node_perm, self.sel_dia, self.sel_res,
                             self.nnz, self.dtype, self.gin, self.gout)
        out._sel_dia_dev = self._sel_dia_dev
        out._sel_res_dev = self._sel_res_dev
        return out

    def _part_ops(self):
        """((dia_fn, dia_ops), (sell_fn, sell_ops) or None) in the permuted
        (planar for d > 1) space."""
        if self.d > 1:
            dia = self.dia.planar_operator()
            if self.sell is None:
                return dia, None
            if hasattr(self.sell, "planar_operator"):
                return dia, self.sell.planar_operator()
            # planar-indexed scalar SELL: flat [d*nn] in/out
            return dia, (_flat_sell_planar_op, self.sell.operands())
        return (self.dia.operator(),
                None if self.sell is None else self.sell.operator())

    def permuted_operator(self):
        """(fn, ops) in the RCM-permuted (planar for d>1) space: x is
        [d, nn] planar (d>1) or [n] (d=1)."""
        return split_permuted_op, self._part_ops()

    def operator(self):
        """(fn, ops) on interleaved NodeWise vectors in the ORIGINAL
        numbering — one permutation gather each way."""
        return split_op, (self._part_ops(), self.gin.operands(),
                          self.gout.operands(), self.d, self.nn)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return split_op(self.operator()[1], x)

    def to_permuted(self, x: torch.Tensor) -> torch.Tensor:
        y = self.gin(x)
        return y.reshape(self.d, self.nn) if self.d > 1 else y

    def from_permuted(self, y: torch.Tensor) -> torch.Tensor:
        return self.gout(y.reshape(-1))

    def hbm_bytes_per_apply(self) -> int:
        b = self.dia.hbm_bytes_per_apply()
        if self.sell is not None:
            b += self.sell.hbm_bytes_per_apply()
        b += 2 * self.shape[0] * 6  # entry/exit permutation gathers
        return b


def split_gathers(node_perm: np.ndarray, d: int, device):
    """Entry/exit PermutationGathers of a SplitDiaMatrix: interleaved
    NodeWise original order ↔ permuted (planar for d > 1) operator space."""
    nn = len(node_perm)
    inode = np.empty(nn, np.int64)
    inode[node_perm] = np.arange(nn)
    if d > 1:
        cc, ii = np.meshgrid(np.arange(d), np.arange(nn), indexing="ij")
        idx_in = (node_perm[ii] * d + cc).reshape(-1)  # [d*nn] planar
        no, co = np.meshgrid(np.arange(nn), np.arange(d), indexing="ij")
        idx_out = (co * nn + inode[no]).reshape(-1)    # [nn*d]
    else:
        idx_in, idx_out = node_perm, inode
    return (PermutationGather(idx_in, nn * d, device=device),
            PermutationGather(idx_out, nn * d, device=device))


def _flat_sell_planar_op(ops, xc):
    return sell_op(ops, xc.reshape(-1)).reshape(xc.shape)


def split_permuted_op(ops, x):
    (dia_fn, dia_ops), sell = ops
    y = dia_fn(dia_ops, x)
    if sell is not None:
        y = y + sell[0](sell[1], x)
    return y


def split_op(ops, x):
    p_ops, gi, go, d, nn = ops
    xp = permute_op(gi, x)
    if d > 1:
        xp = xp.reshape(d, nn)
    y = split_permuted_op(p_ops, xp)
    return permute_op(go, y.reshape(-1))


def auto_spmv(A, dtype=torch.float32, order=None, dofs_per_node=1,
              device="cuda"):
    """Pick the SpMV operator for this matrix: (block-)DIA for banded node
    patterns (structured grids), the RCM-banded DIA+SELL split for
    unstructured patterns that concentrate under reordering, windowed
    sliced-ELL otherwise.  All expose the same (operator()/matvec/
    with_data/hbm_bytes_per_apply) surface.  A CsrMatrix keeps its own
    device; `device` places a scipy matrix."""
    if hasattr(A, "to_scipy"):
        device = A.device
    if dofs_per_node > 1:
        bdia = BlockDiaMatrix.from_csr(A, dofs_per_node, dtype=dtype,
                                       device=device)
        if bdia is not None:
            return bdia
        split = SplitDiaMatrix.from_csr(A, dtype=dtype,
                                        dofs_per_node=dofs_per_node,
                                        device=device)
        if split is not None:
            return split
        bsell = BlockSellMatrix.from_csr(A, dofs_per_node, dtype=dtype,
                                         device=device)
        if bsell is not None:
            return bsell
    dia = DiaMatrix.from_csr(A, dtype=dtype, device=device)
    if dia is not None:
        return dia
    if dofs_per_node == 1:
        split = SplitDiaMatrix.from_csr(A, dtype=dtype, device=device)
        if split is not None:
            return split
    return SellMatrix.from_csr(A, dtype=dtype, order=order, device=device)
