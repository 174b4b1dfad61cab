"""Batched sparse LU subdomain solves — the Amesos2/KLU role.

Counterpart of feddlib_tpu/la/sparse_lu.py.  Replaces the [P, S, S] dense
explicit inverses of the Schwarz subdomain solves where they would cost
O(S³) setup and O(P·S²) memory:

- host setup: scipy `splu` per subdomain (COLAMD ordering); the sparse
  triangular factors L (unit lower) and U are level-scheduled: row i's
  level is 1 + the highest level of its in-factor dependencies, so all rows
  of one level solve at once;
- device apply: a Python loop over the levels; each step gathers one
  level's dependency values, does one row dot and scatters the solved rows
  — a wavefront triangular solve, batched over the P subdomains.  The JAX
  package pads every level to the widest level's rows R and the longest
  row's dependencies K and slices the level out of [P, S, K] plans under
  `fori_loop`; here the host packs each level once into its own
  contiguous planes [P, R_t, K_t] (R_t, K_t the largest over the
  subdomains), which drops only padding (zero values against the zero
  dump slot) and leaves the result unchanged.

The solve is exact (the dense inverse's result up to roundoff), so Krylov
iteration counts are unchanged.  It is plain torch on every device: the
JAX package runs it as XLA, not as a Pallas kernel.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

from feddlib_tpu_torch.la.dense_blocks import _parallel_map
from feddlib_tpu_torch.utils.device import resolve_device


def _tri_plan(F: sps.csr_matrix, lower: bool, S: int):
    """Level-schedule one sparse triangular factor (size n ≤ S, padded).

    Returns a dict of numpy arrays in level-sequential row order:
      seq [S+1]       row ids, level-major (pad → S = dump slot)
      dep_cols [S, K] in-factor dependency columns, ascending (pad → S)
      dep_vals [S, K]
      diag_inv [S]    1/diag in seq order (1 for unit-diagonal L)
      offs/lens [T]   per-level start/width in seq
    The JAX package's plan, with everything but the level recursion
    vectorized."""
    n = F.shape[0]
    F = F.tocsr()
    F.sort_indices()
    indptr, indices, data = F.indptr, F.indices, F.data
    rows = np.repeat(np.arange(n), np.diff(indptr))
    diag = np.ones(n)
    on = np.flatnonzero(indices == rows)[::-1]  # the first entry wins
    diag[rows[on]] = data[on]
    dep = indices < rows if lower else indices > rows
    dcols, dvals = indices[dep].astype(np.int64), data[dep]
    nd = np.bincount(rows[dep], minlength=n)
    dptr = np.concatenate([[0], np.cumsum(nd)])
    # level[i] = 1 + the highest level of i's dependencies (sequential)
    level = np.zeros(n, dtype=np.int64)
    for i in (range(n) if lower else range(n - 1, -1, -1)):
        if nd[i]:
            level[i] = 1 + level[dcols[dptr[i]:dptr[i + 1]]].max()
    K = max(int(nd.max()) if n else 0, 1)
    T = int(level.max()) + 1 if n else 1
    seq_order = np.lexsort((np.arange(n), level))
    seq = np.full(S + 1, S, dtype=np.int64)
    seq[:n] = seq_order
    lens = np.bincount(level, minlength=T)
    offs = np.concatenate([[0], np.cumsum(lens)])[:-1]
    # row k of the plan holds the dependencies of row seq_order[k]
    cnt = nd[seq_order]
    k_of = np.repeat(np.arange(n), cnt)
    j_of = np.arange(len(k_of)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    src = dptr[seq_order][k_of] + j_of
    dep_cols = np.full((S, K), S, dtype=np.int64)
    dep_vals = np.zeros((S, K))
    dep_cols[k_of, j_of] = dcols[src]
    dep_vals[k_of, j_of] = dvals[src]
    diag_inv = np.ones(S)
    diag_inv[:n] = 1.0 / diag[seq_order]
    return dict(seq=seq, dep_cols=dep_cols, dep_vals=dep_vals,
                diag_inv=diag_inv, offs=offs.astype(np.int64),
                lens=lens.astype(np.int64), T=T, K=K,
                R=int(lens.max()) if len(lens) else 1)


def _pad_plans(plans: List[dict], S: int):
    """Stack per-subdomain factor plans to a common (T, R, K) (host numpy,
    the JAX package's layout)."""
    P = len(plans)
    T = max(p["T"] for p in plans)
    R = max(p["R"] for p in plans)
    K = max(p["K"] for p in plans)
    seq = np.stack([p["seq"] for p in plans])
    dep_cols = np.full((P, S, K), S, dtype=np.int64)
    dep_vals = np.zeros((P, S, K))
    diag_inv = np.ones((P, S))
    offs = np.zeros((P, T), dtype=np.int64)
    lens = np.zeros((P, T), dtype=np.int64)
    for b, p in enumerate(plans):
        dep_cols[b, :, : p["K"]] = p["dep_cols"]
        dep_vals[b, :, : p["K"]] = p["dep_vals"]
        diag_inv[b] = p["diag_inv"]
        offs[b, : len(p["offs"])] = p["offs"]
        lens[b, : len(p["lens"])] = p["lens"]
    return dict(seq=seq, dep_cols=dep_cols, dep_vals=dep_vals,
                diag_inv=diag_inv, offs=offs, lens=lens), T, R, K


def _level_planes(pl: dict, S: int, dtype, device):
    """One tuple per level: (rows [P, R_t], dependency columns
    [P, R_t*K_t], values [P, R_t, K_t], 1/diag [P, R_t]) on `device`.  Pad
    rows point at the dump slot S with zero values and zero 1/diag, so they
    write 0 there; pad dependencies point at S (zero) with value 0."""
    seq, dep_cols, offs, lens = (pl["seq"], pl["dep_cols"], pl["offs"],
                                 pl["lens"])
    P = seq.shape[0]
    nnz_dep = (dep_cols != S).sum(2)  # [P, S]
    pb = np.arange(P)[:, None]
    out = []
    for t in range(offs.shape[1]):
        R = int(lens[:, t].max())
        ar = np.arange(R)
        valid = ar[None, :] < lens[:, t:t + 1]
        pos = np.where(valid, offs[:, t:t + 1] + ar, 0)
        K = int(np.where(valid, nnz_dep[pb, pos], 0).max())
        rows = np.where(valid, seq[pb, pos], S)
        dc = np.where(valid[..., None], dep_cols[pb, pos, :K], S)
        dv = np.where(valid[..., None], pl["dep_vals"][pb, pos, :K], 0.0)
        dinv = np.where(valid, pl["diag_inv"][pb, pos], 0.0)
        out.append((torch.as_tensor(rows, device=device),
                    torch.as_tensor(dc.reshape(P, R * K), device=device),
                    torch.as_tensor(dv, dtype=dtype, device=device),
                    torch.as_tensor(dinv, dtype=dtype, device=device)))
    return tuple(out)


def tri_solve_seq(b_pad, levels):
    """Wavefront solve of one factor for P subdomains at once: b_pad
    [P, S+1] (last = dump slot) and the factor's level planes
    (`_level_planes`).  Returns x [P, S+1] with the dump slot zero."""
    x = torch.zeros_like(b_pad)
    for rows, dc, dv, dinv in levels:
        rhs = torch.gather(b_pad, 1, rows)
        if dv.shape[2]:
            xg = torch.gather(x, 1, dc).view(dv.shape)
            rhs = rhs - (dv * xg).sum(-1)
        x.scatter_(1, rows, rhs * dinv)
    return x


class BatchedSparseLU:
    """Batched exact sparse subdomain solves: setup O(Σ nnz·fill) on the
    host, apply = two wavefront triangular sweeps per subdomain on the
    device."""

    def __init__(self, blocks: List[sps.spmatrix], S: Optional[int] = None,
                 dtype=torch.float64, device="cuda"):
        self.device = resolve_device(device)
        P = len(blocks)
        sizes = [b.shape[0] for b in blocks]
        S = S if S is not None else max(sizes)
        self.P, self.S = P, S
        perm_r = np.full((P, S), S, dtype=np.int64)
        perm_c_inv = np.full((P, S), S, dtype=np.int64)
        fill = 0
        # SuperLU releases the GIL: the subdomains factor on a thread pool
        lus = _parallel_map(lambda A: _robust_splu_local(A.tocsc()), blocks)
        plans_L = _parallel_map(
            lambda lu: _tri_plan(lu.L.tocsr(), True, S), lus)
        plans_U = _parallel_map(
            lambda lu: _tri_plan(lu.U.tocsr(), False, S), lus)
        for b, (A, lu) in enumerate(zip(blocks, lus)):
            n = A.shape[0]
            fill += lu.L.nnz + lu.U.nnz
            # scipy convention: A[argsort(perm_r)][:, argsort(perm_c)] = LU
            # ⇒ w = U⁻¹ L⁻¹ b[argsort(perm_r)], x[argsort(perm_c)[j]] = w[j]
            perm_r[b, :n] = np.argsort(lu.perm_r)
            perm_c_inv[b, :n] = np.argsort(lu.perm_c)
        self.nnz_factors = fill
        L, self.T_L, self.R_L, self.K_L = _pad_plans(plans_L, S)
        U, self.T_U, self.R_U, self.K_U = _pad_plans(plans_U, S)
        self.L = _level_planes(L, S, dtype, self.device)
        self.U = _level_planes(U, S, dtype, self.device)
        # b_perm[i] = b[perm_r[i]]; out[perm_c[j]] = z[j]  (scatter form)
        self.perm_r = torch.as_tensor(perm_r, device=self.device)
        self.perm_c = torch.as_tensor(perm_c_inv, device=self.device)

    def arrays(self):
        """Operand tuple for operator composition."""
        return (self.perm_r, self.perm_c, self.L, self.U)

    def nbytes(self) -> int:
        """Device bytes of the permutations and the level planes."""
        ts = [self.perm_r, self.perm_c] + [t for lv in self.L + self.U
                                           for t in lv]
        return sum(t.numel() * t.element_size() for t in ts)

    @property
    def dims(self):
        """Wavefront dimensions (T_L, R_L, T_U, R_U): the level counts and
        the widest level of each factor."""
        return (self.T_L, self.R_L, self.T_U, self.R_U)

    @staticmethod
    def apply_ops(ops, r_pad):
        """Batched solve from the flat operand tuple: r_pad [P, S] →
        x [P, S]."""
        return solve_batched(r_pad, ops)

    def solve(self, r_pad: torch.Tensor) -> torch.Tensor:
        """r_pad [P, S] stacked (padded) residuals → solutions [P, S]."""
        return self.apply_ops(self.arrays(), r_pad)


def solve_batched(r, ops):
    """Every subdomain's exact solve: r [P, S] and the operands of
    `BatchedSparseLU.arrays` (the JAX package's vmapped `solve_one`)."""
    pr1, pc1, L, U = ops
    P, S = r.shape
    zero = r.new_zeros(P, 1)
    b = torch.cat([torch.gather(torch.cat([r, zero], 1), 1, pr1), zero], 1)
    z = tri_solve_seq(tri_solve_seq(b, L), U)
    return r.new_zeros(P, S + 1).scatter_(1, pc1, z[:, :S])[:, :S]


def _robust_splu_local(A_csc):
    try:
        return spla.splu(A_csc)
    except RuntimeError:
        scale = max(np.abs(A_csc.data).max(), 1.0) if A_csc.nnz else 1.0
        # structured first fallback: pin one zero-diagonal (pressure) dof —
        # the exact deflation of a saddle-point subdomain's local
        # constant-pressure null space (see dense_blocks._robust_inverse)
        d = A_csc.diagonal()
        zd = np.flatnonzero(np.abs(d) <= 1e-14 * scale)
        if len(zd):
            j = int(zd[0])
            P = A_csc.tolil()
            P[j, :] = 0.0
            P[:, j] = 0.0
            P[j, j] = scale
            try:
                return spla.splu(P.tocsc())
            except RuntimeError:
                pass
        eye = sps.identity(A_csc.shape[0], format="csc")
        for eps in (1e-12, 1e-10, 1e-8):
            try:
                return spla.splu(A_csc + eps * scale * eye)
            except RuntimeError:
                continue
        raise
