"""Sparse matrix with host-symbolic structure and device-resident values.

Counterpart of feddlib_tpu/la/csr.py.  The insert → fillComplete flow is:

1. *Symbolic phase* (host, once): dedupe COO (row, col) pairs → CSR pattern
   + an assembly plan mapping every raw COO contribution to its slot
   (`SparsityPattern.from_coo`, numpy).
2. *Numeric phase* (device, per assembly): a segment sum of the raw values
   into their slots (`index_add_`).

The apply is a plain-torch padded-ELL gather (the f64 refinement residual
of the mixed-precision solve; no kernel computes it in the JAX package
either):  y[i] = sum_k data[slot_of[k, i]] * x[ell_cols[k, i]].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from feddlib_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class SparsityPattern:
    """Host-side symbolic CSR structure + COO→slot assembly plan."""

    n_rows: int
    n_cols: int
    indptr: np.ndarray  # [n_rows+1] int64
    indices: np.ndarray  # [nnz] int64, sorted within each row
    coo_slots: Optional[np.ndarray] = None  # [n_raw_coo] slot of each raw entry

    @property
    def nnz(self) -> int:
        return len(self.indices)

    @classmethod
    def from_coo(cls, rows: np.ndarray, cols: np.ndarray,
                 n_rows: int, n_cols: int) -> "SparsityPattern":
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        key = rows * n_cols + cols
        uniq, inv = np.unique(key, return_inverse=True)
        urows = uniq // n_cols
        ucols = uniq % n_cols
        indptr = np.zeros(n_rows + 1, dtype=np.int64)
        np.add.at(indptr, urows + 1, 1)
        np.cumsum(indptr, out=indptr)
        return cls(n_rows, n_cols, indptr, ucols,
                   coo_slots=inv.astype(np.int64).ravel())

    @classmethod
    def from_csr(cls, indptr, indices, n_cols) -> "SparsityPattern":
        return cls(len(indptr) - 1, int(n_cols),
                   np.asarray(indptr, np.int64), np.asarray(indices, np.int64))

    def row_lengths(self) -> np.ndarray:
        return np.diff(self.indptr)

    def rows_of_slots(self) -> np.ndarray:
        return np.repeat(np.arange(self.n_rows, dtype=np.int64),
                         self.row_lengths())


class CsrMatrix:
    """Sparse matrix = static SparsityPattern + device value buffer.

    Values are stored in CSR slot order (`data[k]` ↔ `pattern.indices[k]`);
    the ELL gather plan for the apply is built lazily and cached."""

    def __init__(self, pattern: SparsityPattern, data=None,
                 dtype=torch.float64, device="cuda"):
        self.pattern = pattern
        self.dtype = dtype
        self.device = resolve_device(device)
        if data is None:
            data = torch.zeros(pattern.nnz, dtype=dtype, device=self.device)
        self.data = torch.as_tensor(data, dtype=dtype, device=self.device)
        self._ell = None  # (ell_cols [K, n_rows], slot_of [K, n_rows])

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_coo(cls, rows, cols, vals, n_rows, n_cols, dtype=torch.float64,
                 device="cuda"):
        pat = SparsityPattern.from_coo(rows, cols, n_rows, n_cols)
        m = cls(pat, dtype=dtype, device=device)
        m.assemble(torch.as_tensor(vals, dtype=dtype, device=m.device))
        return m

    @classmethod
    def from_scipy(cls, sp, dtype=torch.float64, device="cuda"):
        sp = sp.tocsr()
        sp.sort_indices()
        pat = SparsityPattern.from_csr(sp.indptr, sp.indices, sp.shape[1])
        return cls(pat, data=torch.as_tensor(np.asarray(sp.data)),
                   dtype=dtype, device=device)

    def to_scipy(self):
        import scipy.sparse as sps

        return sps.csr_matrix(
            (self.data.detach().cpu().numpy(), self.pattern.indices,
             self.pattern.indptr),
            shape=(self.pattern.n_rows, self.pattern.n_cols),
        )

    # -- assembly (numeric fillComplete) ------------------------------------
    def assemble(self, coo_vals: torch.Tensor) -> None:
        """Sum raw COO contributions (in the order given to from_coo) into
        the CSR value buffer."""
        slots = self.pattern.coo_slots
        if slots is None:
            raise ValueError("pattern has no COO assembly plan")
        vals = coo_vals.to(device=self.device, dtype=self.dtype).reshape(-1)
        idx = torch.as_tensor(slots, device=self.device)
        self.data = torch.zeros(self.pattern.nnz, dtype=self.dtype,
                                device=self.device).index_add_(0, idx, vals)

    # -- shape / properties -------------------------------------------------
    @property
    def shape(self):
        return (self.pattern.n_rows, self.pattern.n_cols)

    @property
    def nnz(self):
        return self.pattern.nnz

    # -- ELL plan -----------------------------------------------------------
    def _ell_plan(self):
        if self._ell is None:
            pat = self.pattern
            lens = pat.row_lengths()
            K = max(int(lens.max()) if len(lens) else 1, 1)
            ell_cols = np.zeros((K, pat.n_rows), dtype=np.int64)
            slot_of = np.full((K, pat.n_rows), pat.nnz, dtype=np.int64)
            pos = np.arange(pat.nnz) - np.repeat(pat.indptr[:-1], lens)
            r = pat.rows_of_slots()
            ell_cols[pos, r] = pat.indices
            slot_of[pos, r] = np.arange(pat.nnz)
            self._ell = (torch.as_tensor(ell_cols, device=self.device),
                         torch.as_tensor(slot_of, device=self.device))
        return self._ell

    # -- operations ---------------------------------------------------------
    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        ell_cols, slot_of = self._ell_plan()
        return ell_apply((self.data, ell_cols, slot_of), x)

    def matmat(self, X: torch.Tensor) -> torch.Tensor:
        """Sparse × dense-block product: X [n_cols, m] → [n_rows, m]."""
        ell_cols, slot_of = self._ell_plan()
        padded = torch.cat([self.data, self.data.new_zeros(1)])
        return (padded[slot_of][:, :, None] * X[ell_cols]).sum(0)

    def operator(self):
        """(fn, operands) form for the solver's operator protocol
        (feddlib_tpu_torch.solvers.krylov.solve)."""
        ell_cols, slot_of = self._ell_plan()
        return ell_apply, (self.data, ell_cols, slot_of)

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self) -> torch.Tensor:
        pat = self.pattern
        r = pat.rows_of_slots()
        mask = pat.indices == r
        slot = np.full(pat.n_rows, pat.nnz, dtype=np.int64)
        slot[r[mask]] = np.nonzero(mask)[0]
        padded = torch.cat([self.data, self.data.new_zeros(1)])
        return padded[torch.as_tensor(slot, device=self.device)]

    def __repr__(self):
        return f"CsrMatrix({self.shape[0]}x{self.shape[1]}, nnz={self.nnz})"


def ell_apply(ops, x):
    """Pure operator form: ops = (data, ell_cols [K,n], slot_of [K,n])."""
    data, ell_cols, slot_of = ops
    padded = torch.cat([data, data.new_zeros(1)])
    return (padded[slot_of] * x[ell_cols]).sum(0)
