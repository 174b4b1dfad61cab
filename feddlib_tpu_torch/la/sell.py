"""Windowed sliced-ELL SpMV — kernel B2.

Counterpart of feddlib_tpu/la/sell.py (`SellMatrix`, `sell_padded_from`,
`PaddedSplitSpMV`).  The host builds the same layout as the JAX package:

  - rows are grouped in chunks of `rows_per_chunk = 8 * (128 // E)`
    (E = padded ELL slots per row, a power of two <= 128); row r owns the
    E consecutive slots r*E .. r*E+E-1 of the [nchunks, 8, 128] planes;
  - each chunk lists <= K window block ids `bids[chunk, k]`, the distinct
    128-column blocks its nonzeros touch; each slot stores its value and
    an int16 `k*128 + lane` window-local column;
  - entries of chunks that touch more than K blocks (or rows longer than E)
    spill to a COO tail, applied with `index_add_`.

`sell_spmv` launches the CUDA kernel (csrc/sell.cu) for a CUDA tensor and
runs the plain version for a CPU tensor.  The JAX package splits launches
above 2048 chunks for the TPU's scalar memory; the card needs no split.
"""

from __future__ import annotations

import numpy as np
import torch

from feddlib_tpu_torch.la import _cuda
from feddlib_tpu_torch.la.permute import permute_op
from feddlib_tpu_torch.utils.device import resolve_device

_LANES = 128


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
    _cuda.launch_counts["sell_spmv"] += 1
    return y


class SellMatrix:
    """Windowed sliced-ELL operator for y = A @ x."""

    def __init__(self, n_rows, n_cols, vals, pidx, bids, spill_rows,
                 spill_cols, spill_vals, nnz, data_slots, data_spill,
                 dtype, E, K, csr_order=None):
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
        # caller-CSR nnz position of each nnz of the CSR laid out here
        # (set by sell_padded_from; None = the same order)
        self.csr_order = csr_order
        self.device = vals.device

    # -- construction --------------------------------------------------------
    @classmethod
    def from_csr(cls, A, dtype=torch.float32, E=None, K=None,
                 device="cuda"):
        """Build from a CsrMatrix (feddlib_tpu_torch.la.csr) or scipy CSR
        (a CsrMatrix keeps its own device)."""
        is_fedd = hasattr(A, "to_scipy")
        if is_fedd:
            device = A.device
        dev = resolve_device(device)
        sp = A.to_scipy().tocsr() if is_fedd else A.tocsr()
        n_rows, n_cols = sp.shape
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
        if is_fedd:
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
                   sp.nnz, data_slots, data_spill, dtype, E, K)

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
                          self.dtype, self.E, self.K, self.csr_order)

    # -- apply ---------------------------------------------------------------
    def operands(self):
        return (self.vals, self.pidx, self.bids, self.spill_rows,
                self.spill_cols, self.spill_vals, self.shape[0],
                self.shape[1], self.E)

    def operator(self):
        """(fn, operands) for the solver's operator protocol."""
        return sell_op, self.operands()

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        return sell_op(self.operands(), x)


def sell_op(ops, x):
    vals, pidx, bids, s_rows, s_cols, s_vals, n_rows, n_cols, E = ops
    out_dtype = x.dtype
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


def padded_split_op(ops, xp):
    c_ops, gplan = ops
    g = permute_op(gplan, xp)
    return sell_op(c_ops, torch.cat([xp, g.to(xp.dtype)]))
