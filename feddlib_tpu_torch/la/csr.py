"""Sparse matrix with host-symbolic structure and device-resident values.

Counterpart of feddlib_tpu/la/csr.py.  The insert → fillComplete flow is:

1. *Symbolic phase* (host, once): dedupe COO (row, col) pairs → CSR pattern
   + an assembly plan mapping every raw COO contribution to its slot
   (`SparsityPattern.from_coo`, through the native host library).
2. *Numeric phase* (device, per assembly): a segment sum of the raw values
   into their slots.  On the CPU that is `index_add_`; on the card, where
   `index_add_` sums with atomics in a run-dependent order, each value is
   scatter-SET to a unique position slot*Dp + dup of a [nnz, Dp] buffer
   (`SparsityPattern.duplication_plan`) and the rows are summed, so two
   assemblies of one pattern are bitwise equal.

The apply is a plain-torch padded-ELL gather (the f64 refinement residual
of the mixed-precision solve; no kernel computes it in the JAX package
either):  y[i] = sum_k data[slot_of[k, i]] * x[ell_cols[k, i]].  Its
gather plan (ell_cols, slot_of) depends on the pattern alone, so it lives
on the `SparsityPattern` (`ell_plan`), built on the host and uploaded once
per device, and every `CsrMatrix` on that pattern shares it: the
BC-applied, scaled and summed copies a solve or a Newton step makes of one
operator build nothing.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from feddlib_tpu_torch import native
from feddlib_tpu_torch.utils import timers
from feddlib_tpu_torch.utils.device import resolve_device

# symbolic-union cache of CsrMatrix.add across reassemblies:
# (id(patA), id(patB)) → (patA, patB, union pattern)
_union_pattern_cache: dict = {}


def _device_key(device) -> torch.device:
    """`device` with its index made explicit, so that "cuda" and "cuda:0"
    key one plan."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


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
        """The symbolic phase through the native library (row-bucketed,
        equal to from_coo_plain array for array); RuntimeError if the
        library cannot be built."""
        indptr, indices, slots = native.coo_to_csr(rows, cols, n_rows, n_cols)
        return cls(n_rows, n_cols, indptr, indices, coo_slots=slots)

    @classmethod
    def from_coo_plain(cls, rows: np.ndarray, cols: np.ndarray,
                       n_rows: int, n_cols: int) -> "SparsityPattern":
        """The numpy version of from_coo (np.unique over row * n_cols + col
        keys), the reference the native library is held against."""
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

    def duplication_plan(self):
        """(pos [n_raw] int64, Dp): the unique scatter target slot*Dp + dup
        of each raw COO contribution (dup = its index among the entries of
        its slot, Dp = the most duplicates, padded to 8), as in the JAX
        package; (None, 0) if Dp > 64 or nnz*Dp overflows int32.  None
        without a COO plan.  Cached on the pattern (host numpy)."""
        cached = getattr(self, "_dup_plan", None)
        if cached is None:
            slots = self.coo_slots
            if slots is None:
                return None
            order = np.argsort(slots, kind="stable")
            ss = slots[order]
            starts = np.searchsorted(ss, np.arange(self.nnz))
            dup = np.empty(len(slots), np.int64)
            dup[order] = np.arange(len(slots)) - starts[ss]
            D = int(dup.max()) + 1 if len(dup) else 1
            Dp = 8 * ((D + 7) // 8)
            if Dp > 64 or self.nnz * Dp >= 2 ** 31:
                cached = (None, 0)
            else:
                cached = (slots * Dp + dup, Dp)
            object.__setattr__(self, "_dup_plan", cached)
        return cached

    def _device_plan(self, device):
        """The assembly plan of `assemble` on a CUDA device (any device for
        `assemble_planned`), uploaded once per device:
        ("set", pos, Dp) from duplication_plan, else ("sorted", order,
        lengths) for a segmented sum over the contributions sorted by slot."""
        plans = getattr(self, "_dev_plans", None)
        if plans is None:
            plans = {}
            object.__setattr__(self, "_dev_plans", plans)
        plan = plans.get(device)
        if plan is None:
            pos, Dp = self.duplication_plan()
            if pos is not None:
                plan = ("set", torch.as_tensor(pos, device=device), Dp)
            else:
                order = np.argsort(self.coo_slots, kind="stable")
                lengths = np.bincount(self.coo_slots, minlength=self.nnz)
                plan = ("sorted", torch.as_tensor(order, device=device),
                        torch.as_tensor(lengths, device=device))
            plans[device] = plan
        return plan

    def ell_plan(self, device):
        """(ell_cols [K, n_rows], slot_of [K, n_rows]) int64: the padded-ELL
        gather plan of the apply (K the longest row; padding column 0, slot
        nnz), built on the host and uploaded once per device, then shared
        by every CsrMatrix on this pattern.  Each build adds one to the
        counter `csr.ell_plan_builds`, each reuse one to
        `csr.ell_plan_hits` (utils/timers.py)."""
        plans = getattr(self, "_ell_plans", None)
        if plans is None:
            plans = {}
            object.__setattr__(self, "_ell_plans", plans)
        device = _device_key(device)
        plan = plans.get(device)
        if plan is not None:
            timers.count("csr.ell_plan_hits")
            return plan
        lens = self.row_lengths()
        K = max(int(lens.max()) if len(lens) else 1, 1)
        ell_cols = np.zeros((K, self.n_rows), dtype=np.int64)
        slot_of = np.full((K, self.n_rows), self.nnz, dtype=np.int64)
        pos = np.arange(self.nnz) - np.repeat(self.indptr[:-1], lens)
        r = self.rows_of_slots()
        ell_cols[pos, r] = self.indices
        slot_of[pos, r] = np.arange(self.nnz)
        plan = plans[device] = (torch.as_tensor(ell_cols, device=device),
                                torch.as_tensor(slot_of, device=device))
        timers.count("csr.ell_plan_builds")
        return plan


def segment_sum_sorted(vals: torch.Tensor, order: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """Deterministic segment sum: the values taken in `order` (sorted by
    target) fall into consecutive segments of `lengths`."""
    return torch.segment_reduce(vals[order], "sum", lengths=lengths)


def assemble_planned(vals: torch.Tensor, plan, nnz: int) -> torch.Tensor:
    """CSR data from raw values through a plan of
    `SparsityPattern._device_plan`, in a fixed summation order: scatter-set
    to the unique positions of a [nnz, Dp] buffer and sum its rows, or the
    segmented sum over the slot-sorted values."""
    kind, a, b = plan
    if kind == "set":
        buf = torch.zeros(nnz * b, dtype=vals.dtype, device=vals.device)
        buf[a] = vals
        return buf.reshape(nnz, b).sum(1)
    return segment_sum_sorted(vals, a, b)


def scatter_sum(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """out[i] = sum of vals[idx == i], out of length n.  `index_add_` on
    the CPU; on the card the device-sorted segmented sum, whose order is
    fixed, so that repeated calls are bitwise equal."""
    if vals.device.type == "cpu":
        return torch.zeros(n, dtype=vals.dtype).index_add_(0, idx, vals)
    order = torch.argsort(idx, stable=True)
    lengths = torch.bincount(idx, minlength=n)
    return segment_sum_sorted(vals, order, lengths)


class CsrMatrix:
    """Sparse matrix = static SparsityPattern + device value buffer.

    Values are stored in CSR slot order (`data[k]` ↔ `pattern.indices[k]`);
    the ELL gather plan of the apply is the pattern's (`ell_plan`), shared
    with every matrix on it."""

    def __init__(self, pattern: SparsityPattern, data=None,
                 dtype=torch.float64, device="cuda"):
        self.pattern = pattern
        self.dtype = dtype
        self.device = resolve_device(device)
        if data is None:
            data = torch.zeros(pattern.nnz, dtype=dtype, device=self.device)
        self.data = torch.as_tensor(data, dtype=dtype, device=self.device)

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
        the CSR value buffer.  Deterministic on every device: the card
        takes the duplication plan's scatter-set and row sums (or, where
        the plan is None, a segmented sum over the slot-sorted values),
        never `index_add_`'s atomics."""
        slots = self.pattern.coo_slots
        if slots is None:
            raise ValueError("pattern has no COO assembly plan")
        vals = coo_vals.to(device=self.device, dtype=self.dtype).reshape(-1)
        nnz = self.pattern.nnz
        if self.device.type == "cpu":
            idx = torch.as_tensor(slots)
            self.data = torch.zeros(nnz, dtype=self.dtype).index_add_(
                0, idx, vals)
            return
        self.data = assemble_planned(
            vals, self.pattern._device_plan(self.device), nnz)

    # -- shape / properties -------------------------------------------------
    @property
    def shape(self):
        return (self.pattern.n_rows, self.pattern.n_cols)

    @property
    def nnz(self):
        return self.pattern.nnz

    # -- ELL plan -----------------------------------------------------------
    def _ell_plan(self):
        return self.pattern.ell_plan(self.device)

    def ell_arrays(self):
        """(ell_cols [K, n_rows], ell_data [K, n_rows]): transposed ELL
        planes for external kernels (padding: column 0, value 0)."""
        ell_cols, slot_of = self._ell_plan()
        return ell_cols, torch.cat([self.data, self.data.new_zeros(1)])[slot_of]

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

    def scale(self, alpha) -> "CsrMatrix":
        return CsrMatrix(self.pattern, self.data * alpha, self.dtype,
                         device=self.device)

    def add(self, other: "CsrMatrix", alpha=1.0, beta=1.0) -> "CsrMatrix":
        """alpha*self + beta*other.  Same pattern → one device add;
        otherwise the symbolic union is built on the host once per pattern
        pair and cached (Newton and time loops add the same two patterns
        every reassembly), and the values are summed into it on the
        device."""
        if other.pattern is self.pattern or (
            len(other.pattern.indices) == len(self.pattern.indices)
            and np.array_equal(other.pattern.indptr, self.pattern.indptr)
            and np.array_equal(other.pattern.indices, self.pattern.indices)
        ):
            return CsrMatrix(self.pattern,
                             alpha * self.data + beta * other.data,
                             self.dtype, device=self.device)
        key = (id(self.pattern), id(other.pattern))
        ent = _union_pattern_cache.get(key)
        if (ent is None or ent[0] is not self.pattern
                or ent[1] is not other.pattern):
            rows = np.concatenate([self.pattern.rows_of_slots(),
                                   other.pattern.rows_of_slots()])
            cols = np.concatenate([self.pattern.indices,
                                   other.pattern.indices])
            pat = SparsityPattern.from_coo(rows, cols, *self.shape)
            # hold the operand patterns so the id() key stays valid
            ent = (self.pattern, other.pattern, pat)
            _union_pattern_cache[key] = ent
        m = CsrMatrix(ent[2], dtype=self.dtype, device=self.device)
        m.assemble(torch.cat([alpha * self.data, beta * other.data]))
        return m

    def transpose(self) -> "CsrMatrix":
        pat = self.pattern
        tpat = SparsityPattern.from_coo(pat.indices, pat.rows_of_slots(),
                                        pat.n_cols, pat.n_rows)
        m = CsrMatrix(tpat, dtype=self.dtype, device=self.device)
        m.assemble(self.data)
        return m

    def write_matrix_market(self, path: str) -> None:
        """MatrixMarket dump (reference: Matrix::writeMM,
        Matrix_decl.hpp:124)."""
        import scipy.io as sio

        sio.mmwrite(path, self.to_scipy())

    def __repr__(self):
        return f"CsrMatrix({self.shape[0]}x{self.shape[1]}, nnz={self.nnz})"


def assemble_csr_data(coo_vals: torch.Tensor, slots, nnz: int,
                      plan=None) -> torch.Tensor:
    """CSR values from raw COO contributions: out[s] = sum of coo_vals
    where slots == s (the pattern's `coo_slots`).  `plan` is the pattern's
    `_device_plan(device)` (the duplication plan's scatter-set); without
    it the CPU sums with `index_add_` and the card with the segmented sum
    over the slot-sorted values (`scatter_sum`) — a fixed order either
    way on the card, never atomics."""
    vals = coo_vals.reshape(-1)
    if plan is not None:
        return assemble_planned(vals, plan, nnz)
    idx = torch.as_tensor(slots, device=vals.device)
    return scatter_sum(vals, idx, nnz)


def ell_apply(ops, x):
    """Pure operator form: ops = (data, ell_cols [K,n], slot_of [K,n])."""
    data, ell_cols, slot_of = ops
    padded = torch.cat([data, data.new_zeros(1)])
    return (padded[slot_of] * x[ell_cols]).sum(0)
