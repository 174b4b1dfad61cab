"""Windowed sliced-ELL SpMV — kernels B2 (scalar) and B5 (d x d blocks).

Counterpart of feddlib_tpu/la/sell.py (`SellMatrix`, `sell_padded_from`,
`PaddedSplitSpMV`, `BlockSellMatrix`).  The host builds the same layout as
the JAX package:

  - rows are grouped in chunks of `rows_per_chunk = 8 * (128 // E)`
    (E = padded ELL slots per row, a power of two <= 128); row r owns the
    E consecutive slots r*E .. r*E+E-1 of the [nchunks, 8, 128] planes;
  - each chunk lists <= K window block ids `bids[chunk, k]`, the distinct
    128-column blocks its nonzeros touch; each slot stores its value and
    an int16 `k*128 + lane` window-local column;
  - entries of chunks that touch more than K blocks (or rows longer than E)
    spill to a COO tail, applied with `index_add_`.

`BlockSellMatrix` builds that slot layout once on the NODE pattern of a
vector-field operator (NodeWise dofs, dof = node*d + c); each slot then
carries the d x d block of values as d*d planes, and vectors are PLANAR
[d, nn] (component-major).  Those planes pad every node row to E slots; the
card applies a second layout built from them (`SlicePlan`): node rows
sorted by occupied length within windows of SORT_WINDOW rows, cut into
slices of SLICE_ROWS rows, each slice as wide as its longest row.

`sell_spmv` / `block_sell_slices` launch the CUDA kernels (csrc/sell.cu,
csrc/block_sell.cu) for a CUDA tensor and run the plain versions for a CPU
tensor.  The JAX package splits (B2) or abandons (B5) its kernel launch
above 2048 chunks for the TPU's scalar memory; the card needs neither.
"""

from __future__ import annotations

import numpy as np
import torch

from feddlib_tpu_torch.la import _cuda
from feddlib_tpu_torch.utils import timers
from feddlib_tpu_torch.la.permute import permute_op
from feddlib_tpu_torch.utils.device import resolve_device

_LANES = 128
SLICE_ROWS = 32        # node rows of a slice: one warp, a thread a row
SORT_WINDOW = 1024     # rows are sorted by occupied length in such windows


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def sell_spmv_plain(vals, pidx, bids, x2d, E):
    """Plain PyTorch version: per row, the sum of its E slots
    vals * x[bids[c, pidx >> 7] * 128 + (pidx & 127)] → [nchunks*8*128/E]."""
    nchunks = vals.shape[0]
    rpl = _LANES // E
    p = pidx.reshape(nchunks, -1).long()
    cols = (torch.gather(bids.long(), 1, p >> 7) * _LANES
            + (p & (_LANES - 1)))
    g = x2d.reshape(-1)[cols]
    contrib = vals.reshape(nchunks, -1) * g
    return contrib.reshape(nchunks, 8, rpl, E).sum(-1).reshape(-1)


def sell_spmv(vals, pidx, bids, x2d, E):
    """SELL SpMV of f32 planes: vals [nchunks, 8, 128] f32, pidx int16,
    bids [nchunks, K] int32, x2d [nx2, 128] f32 → y [nchunks*8*128/E]."""
    if vals.device.type == "cpu":
        return sell_spmv_plain(vals, pidx, bids, x2d, E)
    _cuda.require_hopper(vals, pidx, bids, x2d)
    _cuda.require(vals, "vals", torch.float32, 3)
    _cuda.require(pidx, "pidx", torch.int16, 3)
    _cuda.require(bids, "bids", torch.int32, 2)
    _cuda.require(x2d, "x2d", torch.float32, 2)
    if E not in (1, 2, 4, 8, 16, 32, 64, 128):
        raise ValueError(f"E must be a power of two <= 128, got {E}")
    nchunks = vals.shape[0]
    if (tuple(vals.shape[1:]) != (8, _LANES) or pidx.shape != vals.shape
            or bids.shape[0] != nchunks or x2d.shape[1] != _LANES):
        raise ValueError("inconsistent SELL plane shapes")
    y = torch.empty(nchunks * 8 * (_LANES // E), dtype=torch.float32,
                    device=vals.device)
    rc = _cuda.lib().fedd_sell_spmv_f32(
        vals.data_ptr(), pidx.data_ptr(), bids.data_ptr(), x2d.data_ptr(),
        y.data_ptr(), nchunks, bids.shape[1], E, _cuda.stream_of(vals))
    _cuda.check(rc, "sell_spmv")
    timers.count("kernel.sell_spmv")
    return y


def block_sell_spmv_plain(vals, pidx, bids, x2d, E, d):
    """Plain PyTorch version of the block-SELL SpMV on planar vectors:
    y[ci, r] = sum over the E slots of node row r and over cj of
    vals[c, ci*d + cj, slot] * x[cj, col(slot)], with col(slot) =
    bids[c, pidx >> 7] * 128 + (pidx & 127) and component cj of x at rows
    cj*nx2 .. of x2d → [d, nchunks*8*128/E]."""
    nchunks = vals.shape[0]
    rpl = _LANES // E
    p = pidx.reshape(nchunks, -1).long()
    cols = (torch.gather(bids.long(), 1, p >> 7) * _LANES
            + (p & (_LANES - 1)))                       # [nchunks, 1024]
    xg = x2d.reshape(d, -1)[:, cols]                    # [d, nchunks, 1024]
    v = vals.reshape(nchunks, d * d, -1)
    ys = []
    for ci in range(d):
        contrib = v[:, ci * d] * xg[0]
        for cj in range(1, d):
            contrib = contrib + v[:, ci * d + cj] * xg[cj]
        ys.append(contrib.reshape(nchunks, 8, rpl, E).sum(-1).reshape(-1))
    return torch.stack(ys)


def block_sell_slices_plain(hvals, hcols, slice_ptr, row_of, x, n_rows):
    """Plain PyTorch version of the sliced block SpMV (`SlicePlan` layout):
    one gather of x by hcols, a multiply by hvals and an index_add into the
    original rows.  hvals [n_cols, d*d, SLICE_ROWS], hcols [n_cols,
    SLICE_ROWS], x [d, nx] planar → y [d, n_rows]."""
    d = x.shape[0]
    n_cols = hcols.shape[0]
    widths = slice_ptr[1:] - slice_ptr[:-1]
    nslices = widths.numel()
    slice_of = torch.repeat_interleave(
        torch.arange(nslices, device=x.device), widths)        # [n_cols]
    pad = nslices * SLICE_ROWS - n_rows
    rows = torch.cat([row_of.long(), row_of.new_full((pad,), n_rows).long()])
    dest = rows[slice_of[:, None] * SLICE_ROWS
                + torch.arange(SLICE_ROWS, device=x.device)]    # [n_cols, C]
    xg = x[:, hcols.long()]                                 # [d, n_cols, C]
    v = hvals.reshape(n_cols, d, d, SLICE_ROWS)
    contrib = torch.einsum("tijc,jtc->itc", v, xg).reshape(d, -1)
    y = torch.zeros((d, n_rows + 1), dtype=x.dtype, device=x.device)
    return y.index_add_(1, dest.reshape(-1), contrib)[:, :n_rows]


def block_sell_slices(hvals, hcols, slice_ptr, row_of, x, n_rows):
    """Sliced block SpMV in f32 (kernel B5): hvals [n_cols, d*d, 32] f32,
    hcols [n_cols, 32] int32, slice_ptr [nslices + 1] int64, row_of
    [n_rows] int32, x [d, nx] f32 planar (node columns < nx) →
    y [d, n_rows]."""
    if hvals.device.type == "cpu":
        return block_sell_slices_plain(hvals, hcols, slice_ptr, row_of, x,
                                       n_rows)
    _cuda.require_hopper(hvals, hcols, slice_ptr, row_of, x)
    _cuda.require(hvals, "hvals", torch.float32, 3)
    _cuda.require(hcols, "hcols", torch.int32, 2)
    _cuda.require(slice_ptr, "slice_ptr", torch.int64, 1)
    _cuda.require(row_of, "row_of", torch.int32, 1)
    _cuda.require(x, "x", torch.float32, 2)
    d = x.shape[0]
    nslices = slice_ptr.numel() - 1
    if (d < 1 or tuple(hvals.shape[1:]) != (d * d, SLICE_ROWS)
            or tuple(hcols.shape) != (hvals.shape[0], SLICE_ROWS)
            or row_of.numel() != n_rows
            or nslices != -(-n_rows // SLICE_ROWS) or x.shape[1] == 0):
        raise ValueError("inconsistent sliced block-SELL shapes")
    y = torch.empty((d, n_rows), dtype=torch.float32, device=x.device)
    rc = _cuda.lib().fedd_block_sell_slices_f32(
        hvals.data_ptr(), hcols.data_ptr(), slice_ptr.data_ptr(),
        row_of.data_ptr(), x.data_ptr(), y.data_ptr(), n_rows, nslices, d,
        x.shape[1], _cuda.stream_of(x))
    _cuda.check(rc, "block_sell_slices")
    timers.count("kernel.block_sell_spmv")
    return y


class SellMatrix:
    """Windowed sliced-ELL operator for y = A @ x."""

    def __init__(self, n_rows, n_cols, vals, pidx, bids, spill_rows,
                 spill_cols, spill_vals, nnz, data_slots, data_spill,
                 dtype, E, K, perm=None, iperm=None, csr_order=None):
        self.shape = (n_rows, n_cols)
        self.vals = vals          # [nchunks, 8, 128] dtype
        self.pidx = pidx          # [nchunks, 8, 128] int16 (k*128+lane)
        self.bids = bids          # [nchunks, K] int32 rows of x2d
        self.spill_rows = spill_rows  # [S] int64 (or None)
        self.spill_cols = spill_cols  # [S] int64
        self.spill_vals = spill_vals  # [S] dtype
        self.nnz = nnz
        self.data_slots = data_slots  # host plan: csr nnz -> flat slot (-1)
        self.data_spill = data_spill  # host plan: csr nnz -> spill pos (-1)
        self.dtype = dtype
        self.E = E
        self.K = K
        self.perm = perm    # row/col permutation applied (None = identity)
        self.iperm = iperm
        # caller-CSR nnz position of each nnz of the CSR laid out here
        # (set under order='rcm' and by sell_padded_from; None = same order)
        self.csr_order = csr_order
        self.device = vals.device
        self._slice_plan = None  # built by slice_plan() for B5

    # -- construction --------------------------------------------------------
    @classmethod
    def from_csr(cls, A, dtype=torch.float32, E=None, K=None, order=None,
                 device="cuda"):
        """Build from a CsrMatrix (feddlib_tpu_torch.la.csr) or scipy CSR
        (a CsrMatrix keeps its own device); the matrix may be rectangular.

        order: None (keep row order) or 'rcm' (bandwidth-reducing reverse
        Cuthill-McKee on the symmetric pattern — for unstructured meshes
        whose natural order scatters column support; square only).
        """
        is_fedd = hasattr(A, "to_scipy")
        if is_fedd:
            device = A.device
        dev = resolve_device(device)
        sp = A.to_scipy().tocsr() if is_fedd else A.tocsr()
        n_rows, n_cols = sp.shape
        perm = iperm = csr_order = None
        if order == "rcm":
            import scipy.sparse as sps
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            if n_rows != n_cols:
                raise ValueError("rcm ordering needs a square matrix")
            perm = np.asarray(reverse_cuthill_mckee(sp, symmetric_mode=True))
            iperm = np.empty_like(perm)
            iperm[perm] = np.arange(n_rows)
            # track where each original nnz lands under the permutation
            # (+1 so scipy never drops a "zero" entry structurally)
            pos = sps.csr_matrix(
                (np.arange(sp.nnz, dtype=np.int64) + 1,
                 sp.indices.copy(), sp.indptr.copy()), shape=sp.shape)
            pos = pos[perm][:, perm].tocsr()
            pos.sort_indices()
            if pos.nnz != sp.nnz:
                raise ValueError(
                    f"rcm permutation changed the nnz count "
                    f"({pos.nnz} != {sp.nnz}): duplicate entries in the "
                    f"input CSR would be silently summed")
            csr_order = np.asarray(pos.data) - 1
            sp = sp[perm][:, perm].tocsr()
        elif order is not None:
            raise ValueError(f"unknown order {order!r} (None or 'rcm')")
        sp.sort_indices()

        row_nnz = np.diff(sp.indptr)
        max_nnz = max(int(row_nnz.max()) if n_rows else 1, 1)
        if E is None:
            E = 8
            while E < min(max_nnz, _LANES):
                E *= 2
        rpl = _LANES // E          # rows per sublane
        rpc = 8 * rpl              # rows per chunk
        nchunks = max(_round_up(n_rows, rpc) // rpc, 1)

        indices = sp.indices
        nz_row = np.repeat(np.arange(n_rows), row_nnz)
        nz_chunk = nz_row // rpc
        nz_block = (indices // _LANES).astype(np.int64)

        # distinct blocks per chunk, ranked by frequency (top-K kept)
        keys = nz_chunk.astype(np.int64) * (1 << 32) + nz_block
        uk, inv, counts = np.unique(keys, return_inverse=True,
                                    return_counts=True)
        inv = inv.ravel()
        uc = (uk >> 32).astype(np.int64)
        ub = (uk & 0xFFFFFFFF).astype(np.int64)
        if K is None:
            per = np.bincount(uc, minlength=nchunks)
            K = int(min(max(per.max() if len(per) else 1, 1), 16))
        order_idx = np.lexsort((-counts, uc))
        rank_of = np.empty(len(uk), np.int64)
        starts = np.searchsorted(uc[order_idx], np.arange(nchunks))
        rank_of[order_idx] = np.arange(len(uk)) - starts[uc[order_idx]]
        bids = np.zeros((nchunks, K), np.int32)
        keep_blk = rank_of < K
        bids[uc[keep_blk], rank_of[keep_blk]] = ub[keep_blk].astype(np.int32)
        nz_k = np.where(rank_of[inv] < K, rank_of[inv], -1).astype(np.int32)

        # slot position within each row over kept entries; >= E spills too
        kept = nz_k >= 0
        kept_idx = np.flatnonzero(kept)
        kr = nz_row[kept_idx]
        row_start = np.zeros(n_rows + 1, np.int64)
        np.add.at(row_start[1:], kr, 1)
        np.cumsum(row_start, out=row_start)
        pos = np.arange(len(kr)) - row_start[kr]
        over = pos >= E
        kept[kept_idx[over]] = False
        kept_idx = kept_idx[~over]
        pos = pos[~over]

        r = nz_row[kept_idx]
        c = r // rpc
        rloc = r - c * rpc
        sublane = rloc // rpl
        lane = (rloc % rpl) * E + pos
        flat = c * (8 * _LANES) + sublane * _LANES + lane

        pidx_flat = np.zeros(nchunks * 8 * _LANES, np.int16)
        pidx_flat[flat] = (nz_k[kept_idx] * _LANES
                           + (indices[kept_idx] % _LANES)).astype(np.int16)
        data_slots = np.full(sp.nnz, -1, np.int64)
        data_slots[kept_idx] = flat

        spill = ~kept
        n_spill = int(spill.sum())
        data_spill = np.full(sp.nnz, -1, np.int64)
        data_spill[np.flatnonzero(spill)] = np.arange(n_spill)
        s_rows = (torch.as_tensor(nz_row[spill].astype(np.int64), device=dev)
                  if n_spill else None)
        s_cols = (torch.as_tensor(indices[spill].astype(np.int64),
                                  device=dev) if n_spill else None)

        # device-side value fill: ship index plans, reuse device CSR values
        if is_fedd and perm is None:
            data_dev = A.data.to(dtype)
        else:
            data_dev = torch.as_tensor(np.asarray(sp.data), dtype=dtype,
                                       device=dev)
        slots_dev = torch.as_tensor(data_slots, device=dev)
        vals = _fill_slots(data_dev, slots_dev,
                           nchunks * 8 * _LANES).reshape(nchunks, 8, _LANES)
        s_vals = (data_dev[torch.as_tensor(np.flatnonzero(spill),
                                           device=dev)]
                  if n_spill else None)

        return cls(n_rows, n_cols, vals,
                   torch.as_tensor(pidx_flat, device=dev).reshape(
                       nchunks, 8, _LANES),
                   torch.as_tensor(bids, device=dev), s_rows, s_cols, s_vals,
                   sp.nnz, data_slots, data_spill, dtype, E, K,
                   None if perm is None else torch.as_tensor(
                       perm.astype(np.int64), device=dev),
                   None if iperm is None else torch.as_tensor(
                       iperm.astype(np.int64), device=dev),
                   csr_order)

    def with_data(self, data: torch.Tensor) -> "SellMatrix":
        """Same pattern, new CSR value array (reassembly).  `data` is in
        the CALLER's CSR order, reordered through csr_order if set."""
        d = data.to(device=self.device, dtype=self.dtype)
        if self.csr_order is not None:
            d = d[torch.as_tensor(self.csr_order, device=self.device)]
        vals = _fill_slots(d, torch.as_tensor(self.data_slots,
                                              device=self.device),
                           self.vals.numel()).reshape(self.vals.shape)
        s_vals = None
        if self.spill_rows is not None:
            s_vals = d[torch.as_tensor(np.flatnonzero(self.data_spill >= 0),
                                       device=self.device)]
        return SellMatrix(self.shape[0], self.shape[1], vals, self.pidx,
                          self.bids, self.spill_rows, self.spill_cols,
                          s_vals, self.nnz, self.data_slots, self.data_spill,
                          self.dtype, self.E, self.K, self.perm, self.iperm,
                          self.csr_order)

    # -- apply ---------------------------------------------------------------
    def operands(self):
        return (self.vals, self.pidx, self.bids, self.spill_rows,
                self.spill_cols, self.spill_vals, self.shape[0],
                self.shape[1], self.E, self.perm, self.iperm)

    def operator(self):
        """(fn, operands) for the solver's operator protocol."""
        return sell_op, self.operands()

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return sell_op(self.operands(), x)

    def hbm_bytes_per_apply(self) -> int:
        """Device-memory bytes one apply must move (planes and x read once,
        y written once, 16 B per spill entry)."""
        b = (self.vals.numel() * self.vals.element_size()
             + self.pidx.numel() * 2 + self.bids.numel() * 4
             + _round_up(self.shape[1], _LANES) * 4 + self.shape[0] * 4)
        if self.spill_rows is not None:
            b += int(self.spill_rows.numel()) * 16
        return b


def sell_op(ops, x):
    (vals, pidx, bids, s_rows, s_cols, s_vals, n_rows, n_cols, E, perm,
     iperm) = ops
    out_dtype = x.dtype
    if perm is not None:
        x = x[perm]
    nx2 = max(_round_up(n_cols, _LANES) // _LANES, 1)
    x2d = torch.zeros(nx2 * _LANES, dtype=vals.dtype, device=vals.device)
    x2d[:n_cols] = x.to(vals.dtype)
    x2d = x2d.reshape(nx2, _LANES)
    if vals.dtype == torch.float32:
        y = sell_spmv(vals, pidx, bids, x2d, E)[:n_rows]
    else:  # the JAX package sends only f32 through its kernel
        y = sell_spmv_plain(vals, pidx, bids, x2d, E)[:n_rows]
    if s_rows is not None:
        y = y.index_add(0, s_rows, s_vals * x2d.reshape(-1)[s_cols])
    if iperm is not None:
        y = y[iperm]
    return y.to(out_dtype)


def _fill_slots(data, slots, size):
    """vals[slots[i]] = data[i] for slots[i] >= 0 (setup-only scatter)."""
    valid = slots >= 0
    out = torch.zeros(size, dtype=data.dtype, device=data.device)
    out[slots[valid]] = data[valid]
    return out


def sell_padded_from(A, db, dtype=torch.float32, K=12):
    """SELL operator on the PADDED-CLUSTERED row/column space of a
    DenseBlockSpMV (la/dense_blocks.py): rows/cols are permuted by
    `db.pad_of_old`, pad lanes are empty rows."""
    import scipy.sparse as sps

    sp = A.to_scipy().tocoo()
    pad_of_old = db.pad_of_old.cpu().numpy()
    M = db.P * db.R
    perm_sp = sps.csr_matrix(
        (np.asarray(sp.data), (pad_of_old[sp.row], pad_of_old[sp.col])),
        shape=(M, M))
    sm = SellMatrix.from_csr(perm_sp, dtype=dtype, K=K, device=A.device)
    pos = sps.csr_matrix(
        (np.arange(sp.nnz, dtype=np.int64) + 1,
         (pad_of_old[sp.row], pad_of_old[sp.col])), shape=(M, M)).tocsr()
    pos.sort_indices()
    if pos.nnz == sp.nnz:
        sm.csr_order = np.asarray(pos.data) - 1
    return sm


class PaddedSplitSpMV:
    """Padded-space SpMV as ONE windowed-SELL over [xp ++ g(xp)].

      y = [A_loc | B] · concat(xp, g(xp)),   g = the permutation gather of
      the cluster ghost values (la/permute.py, kernel B1).

    The column space is [padded ids 0..M) ++ [compact ghost ids
    M..M+P·G): the cluster-local part and the ghost part in one kernel
    pass.  with_data() supports reassembly."""

    def __init__(self, A, db, dtype=torch.float32):
        import scipy.sparse as sps

        sp = A.to_scipy().tocoo()
        pad_of_old = db.pad_of_old.cpu().numpy()
        P, R, G = db.P, db.R, db.G
        M = P * R
        self.shape = (M, M)
        self.dtype = dtype
        pr = pad_of_old[sp.row]
        pc = pad_of_old[sp.col]
        own = (pc // R) == (pr // R)

        # ghost columns -> compact ghost-space ids M + p*G + j via the
        # cluster's ghost list (sorted padded ids per cluster)
        gi = db.ghost_idx.cpu().numpy()          # [P, G] padded ids (pad M)
        rows_g = pr[~own]
        cols_g = pc[~own]
        pcl = rows_g // R
        j = np.empty(len(cols_g), np.int64)
        for p in np.unique(pcl):
            sel = pcl == p
            j[sel] = np.searchsorted(gi[p], cols_g[sel])
        rows = np.concatenate([pr[own], rows_g])
        cols = np.concatenate([pc[own], M + pcl * G + j])
        opos = np.concatenate([np.flatnonzero(own), np.flatnonzero(~own)])
        srt = np.lexsort((cols, rows))
        comb = sps.csr_matrix(
            (np.asarray(sp.data)[opos[srt]], (rows[srt], cols[srt])),
            shape=(M, M + P * G))
        self.Ac = SellMatrix.from_csr(comb, dtype=dtype, device=A.device)
        self._sel = torch.as_tensor(opos[srt], device=A.device)
        self.ghost_plan = db.ghost_plan
        self.P, self.G = P, G
        self.nnz = sp.nnz

    def with_data(self, data: torch.Tensor) -> "PaddedSplitSpMV":
        new = object.__new__(PaddedSplitSpMV)
        new.__dict__.update(self.__dict__)
        new.Ac = self.Ac.with_data(data.to(self._sel.device)[self._sel])
        return new

    def operands(self):
        return (self.Ac.operands(), self.ghost_plan)

    def operator(self):
        return padded_split_op, self.operands()

    def matvec(self, xp: torch.Tensor) -> torch.Tensor:
        return padded_split_op(self.operands(), xp)

    def hbm_bytes_per_apply(self) -> int:
        """The SELL apply's bytes (`SellMatrix.hbm_bytes_per_apply`, the
        JAX layout) plus the ghost gather's: one int32 index read and one
        f32 value written a ghost slot (the JAX count takes 6 B a
        slot)."""
        return self.Ac.hbm_bytes_per_apply() + self.P * self.G * 8


def padded_split_op(ops, xp):
    c_ops, gplan = ops
    g = permute_op(gplan, xp)
    return sell_op(c_ops, torch.cat([xp, g.to(xp.dtype)]))


# -- Block-SELL: windowed sliced-ELL over d x d node blocks ------------------

class BlockSellMatrix:
    """Windowed sliced-ELL SpMV for VECTOR-FIELD operators on unstructured
    meshes (dofs-per-node d > 1, NodeWise ordering) — kernel B5.

    The slot layout (window blocks, lane indices) is built once on the
    NODE pattern; each slot then carries the d x d block of values, so the
    int16 index stream is read once for d*d values and node rows pad to a
    smaller E than dof rows would.

    Vectors are PLANAR [d, nn] (see la/dia.BlockDiaMatrix).  Non-square or
    non-NodeWise matrices give None; use auto_spmv, which goes on to the
    scalar formats.

    The [nchunks, d*d, 8, 128] planes are the JAX package's layout (the
    parity tests compare them); the apply reads `hvals`, the same values
    in the sliced layout of `slice_plan(layout)`, gathered out of the
    planes here, so every constructor and with_data gets it.
    """

    def __init__(self, n, d, layout, vals, spill_rows, spill_cols,
                 spill_vals, nnz, dof_slots, spill_sel, dtype):
        self.shape = (n, n)
        self.d = d
        self.layout = layout            # node-pattern SellMatrix (slots)
        self.vals = vals                # [nchunks, d*d, 8, 128]
        self.spill_rows = spill_rows    # planar flat ids (c*nn + node)
        self.spill_cols = spill_cols
        self.spill_vals = spill_vals
        self.nnz = nnz
        self.dof_slots = dof_slots      # device: csr nnz -> flat val slot
        self.spill_sel = spill_sel
        self.dtype = dtype
        self.device = vals.device
        self.plan = slice_plan(layout)
        self.hvals = self.plan.gather(vals)   # [n_cols, d*d, SLICE_ROWS]

    @classmethod
    def from_csr(cls, A, d, dtype=torch.float32, E=None, K=None,
                 device="cuda"):
        import scipy.sparse as sps

        is_fedd = hasattr(A, "to_scipy")
        if is_fedd:
            device = A.device
        dev = resolve_device(device)
        sp = (A.to_scipy() if is_fedd else A).tocsr()
        sp.sort_indices()
        n = sp.shape[0]
        if sp.shape[0] != sp.shape[1] or n == 0 or d <= 1 or n % d:
            return None
        nn = n // d
        row = np.repeat(np.arange(n, dtype=np.int64), np.diff(sp.indptr))
        col = sp.indices.astype(np.int64)
        nr, ci = row // d, row % d
        nc, cj = col // d, col % d
        keys = nr * nn + nc
        ukeys = np.unique(keys)
        if d * d * len(ukeys) > 1.34 * sp.nnz:
            # pattern is not d x d node-blocked (e.g. a merged saddle-point
            # system): padding the missing block entries would blow storage
            return None
        sp_node = sps.csr_matrix(
            (np.ones(len(ukeys), np.float32),
             (ukeys // nn, ukeys % nn)), shape=(nn, nn))
        layout = SellMatrix.from_csr(sp_node, dtype=torch.float32, E=E, K=K,
                                     device=dev)
        nslot = layout.vals.numel()                    # nchunks*8*128

        pair_idx = np.searchsorted(ukeys, keys)        # dof nnz -> node pair
        s = layout.data_slots[pair_idx]                # flat node slot or -1
        plane = ci * d + cj
        dof_slots = np.where(s >= 0, plane * nslot + s, -1)

        data_dev = (A.data.to(dtype) if is_fedd else
                    torch.as_tensor(np.asarray(sp.data), dtype=dtype,
                                    device=dev))
        slots_dev = torch.as_tensor(dof_slots, device=dev)
        vals = _block_fill(data_dev, slots_dev, d, layout.vals.shape[0])

        spill_idx = np.flatnonzero(s < 0)
        if len(spill_idx):
            spill_sel = torch.as_tensor(spill_idx, device=dev)
            # planar flat ids: dof (node, c) lives at c*nn + node
            sr, sc = row[spill_idx], col[spill_idx]
            s_rows = torch.as_tensor((sr % d) * nn + sr // d, device=dev)
            s_cols = torch.as_tensor((sc % d) * nn + sc // d, device=dev)
            s_vals = data_dev[spill_sel]
        else:
            spill_sel = s_rows = s_cols = s_vals = None
        return cls(n, d, layout, vals, s_rows, s_cols, s_vals, sp.nnz,
                   slots_dev, spill_sel, dtype)

    def with_data(self, data: torch.Tensor) -> "BlockSellMatrix":
        dd = data.to(device=self.device, dtype=self.dtype)
        vals = _block_fill(dd, self.dof_slots, self.d,
                           self.layout.vals.shape[0])
        s_vals = dd[self.spill_sel] if self.spill_sel is not None else None
        return BlockSellMatrix(self.shape[0], self.d, self.layout, vals,
                               self.spill_rows, self.spill_cols, s_vals,
                               self.nnz, self.dof_slots, self.spill_sel,
                               self.dtype)

    # -- vector layout -------------------------------------------------------
    def to_planar(self, x: torch.Tensor) -> torch.Tensor:
        """NodeWise interleaved [nn*d] → planar [d, nn]."""
        return x.reshape(self.shape[0] // self.d, self.d).T

    def from_planar(self, xc: torch.Tensor) -> torch.Tensor:
        return xc.T.reshape(-1)

    # -- applies -------------------------------------------------------------
    def operands(self):
        pl = self.plan
        return (self.hvals, pl.hcols, pl.slice_ptr, pl.row_of,
                self.spill_rows, self.spill_cols, self.spill_vals,
                self.shape[0] // self.d, self.d)

    def planar_operator(self):
        """(fn, operands) on planar [d, nn] vectors."""
        return block_sell_planar_op, self.operands()

    def operator(self):
        """(fn, operands) on NodeWise interleaved vectors (two transposes
        per apply)."""
        return block_sell_op, self.operands()

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return block_sell_op(self.operands(), x)

    def hbm_bytes_per_apply(self) -> int:
        """Device-memory bytes one apply moves: the sliced layout read once,
        x read and y written once, the spill (the planes are not read)."""
        isz = self.hvals.element_size()
        b = (self.hvals.numel() * isz + self.plan.nbytes()
             + 2 * self.shape[0] * isz)
        if self.spill_rows is not None:
            b += int(self.spill_rows.numel()) * (8 + 2 * isz)
        return b


def _block_fill(data, dof_slots, d, nchunks):
    """CSR values → the [nchunks, d*d, 8, 128] planes.  dof_slots index the
    plane-major order [d*d, nchunks*1024] (as the JAX package scatters);
    the kernel reads the chunk-major transpose."""
    vals = _fill_slots(data, dof_slots, d * d * nchunks * 8 * _LANES)
    return vals.reshape(d * d, nchunks, 8, _LANES).permute(
        1, 0, 2, 3).contiguous()


class SlicePlan:
    """The sliced layout of a node-pattern SellMatrix, which kernel B5 reads.

    It comes from the layout's `data_slots` alone: node row r owns the flat
    slots r*E .. r*E+E-1 of the planes, and its occupied slots are a prefix
    of them (a slot's position is its entry's rank in the row).  Within
    each window of SORT_WINDOW consecutive rows (the planes' row order), rows
    are sorted stably by occupied length, longest first, and cut into
    slices of C = SLICE_ROWS rows, each as wide as its longest row.  The
    whole slices are then ordered widest first (stably; a last, partial
    slice stays last): the kernel runs a one-warp CTA a slice, in order,
    so the card's block scheduler starts the longest work first.  Sorted
    row i, in slice i // C, is row `row_of[i]`; slice s owns the columns
    slice_ptr[s] .. slice_ptr[s+1]-1, one entry a row in each.  For column
    t and lane l, `hcols[t, l]` is the node column and `src[t, l]` the flat
    slot of the planes the values come from; a padding entry has src -1,
    column 0 and value 0."""

    def __init__(self, layout):
        C, E, n = SLICE_ROWS, layout.E, layout.shape[0]
        ds = layout.data_slots
        occ = ds[ds >= 0]
        lens = np.bincount(occ // E, minlength=n)
        if len(occ) and (occ % E >= lens[occ // E]).any():
            raise ValueError("node layout rows are not prefix-occupied")
        order = np.lexsort((np.arange(n), -lens,
                            np.arange(n) // SORT_WINDOW))
        nslices = -(-n // C)
        slen = np.zeros(nslices * C, np.int64)
        slen[:n] = lens[order]
        widths = slen.reshape(nslices, C).max(1)
        perm = np.arange(nslices)
        perm[:n // C] = np.argsort(-widths[:n // C], kind="stable")
        moved = (perm[:, None] * C + np.arange(C)).reshape(-1)
        order = np.concatenate([order, np.zeros(nslices * C - n,
                                                order.dtype)])[moved][:n]
        slen, widths = slen[moved], widths[perm]
        slice_ptr = np.zeros(nslices + 1, np.int64)
        np.cumsum(widths, out=slice_ptr[1:])
        slice_of = np.repeat(np.arange(nslices), widths)
        j = (np.arange(slice_ptr[-1]) - slice_ptr[slice_of])[:, None]
        i = slice_of[:, None] * C + np.arange(C)        # sorted rows [t, C]
        rows = np.zeros(nslices * C, np.int64)
        rows[:n] = order
        src = np.where(j < slen[i], rows[i] * E + j, -1)

        dev = layout.device
        self.src = torch.as_tensor(src, device=dev)
        f = self.src.clamp_min(0)
        p = layout.pidx.reshape(-1)[f].long()
        col = (layout.bids.long()[f // (8 * _LANES), p >> 7] * _LANES
               + (p & (_LANES - 1)))
        self.hcols = torch.where(self.src >= 0, col, 0).to(torch.int32)
        self.slice_ptr = torch.as_tensor(slice_ptr, device=dev)
        self.row_of = torch.as_tensor(order.astype(np.int32), device=dev)
        self.n_rows = n
        self.n_occupied = len(occ)

    @property
    def slots_per_occupied(self) -> float:
        return self.src.numel() / max(self.n_occupied, 1)

    def nbytes(self) -> int:
        """Bytes of the index arrays an apply reads."""
        return (self.hcols.numel() * 4 + self.slice_ptr.numel() * 8
                + self.row_of.numel() * 4)

    def gather(self, vals):
        """The [nchunks, d*d, 8, 128] planes → hvals [n_cols, d*d, C]."""
        nch, dd = vals.shape[:2]
        f = self.src.clamp_min(0)
        hv = vals.reshape(nch, dd, 8 * _LANES)[f // (8 * _LANES), :,
                                                f % (8 * _LANES)]
        hv = hv.masked_fill((self.src < 0)[..., None], 0)   # [t, C, d*d]
        return hv.permute(0, 2, 1).contiguous()


def slice_plan(layout) -> SlicePlan:
    """The SlicePlan of a node layout, built once and kept on it."""
    if layout._slice_plan is None:
        layout._slice_plan = SlicePlan(layout)
    return layout._slice_plan


def block_sell_planar_op(ops, xc):
    """xc [d, nn] planar → y [d, nn]."""
    hvals, hcols, slice_ptr, row_of, s_rows, s_cols, s_vals, nn, d = ops
    out_dtype = xc.dtype
    x = xc.to(hvals.dtype).contiguous()
    if hvals.dtype == torch.float32:
        y = block_sell_slices(hvals, hcols, slice_ptr, row_of, x, nn)
    else:  # the JAX package sends only f32 through its kernel
        y = block_sell_slices_plain(hvals, hcols, slice_ptr, row_of, x, nn)
    if s_rows is not None:
        contrib = s_vals * x.reshape(-1)[s_cols]
        y = y.reshape(-1).index_add(0, s_rows, contrib).reshape(d, nn)
    return y.to(out_dtype)


def block_sell_op(ops, x):
    """Interleaved NodeWise x [nn*d] → y [nn*d]."""
    nn, d = ops[-2:]
    y = block_sell_planar_op(ops, x.reshape(nn, d).T)
    return y.T.reshape(-1).to(x.dtype)
