"""One-level overlapping Schwarz preconditioner — the FROSch
AlgebraicOverlappingOperator equivalent.

Counterpart of the serial half of feddlib_tpu/precond/schwarz.py
(`grow_overlap`, `SchwarzPreconditioner`, `schwarz_op_apply`):
- subdomains are the parts of a unique dof map, grown `overlap` layers
  through the matrix graph;
- each subdomain matrix is factored once and solved per apply;
- combine modes on the overlap: Restricted (each dof updated only by its
  owner), Full (sum), Averaging (sum / multiplicity).

The subdomain solves are batched: either dense explicit inverses, one
[P, S, S] tensor applied as z_ov[p] = A_p⁻¹ r_ov[p] (f64: host LAPACK with
the structured fallbacks of `_robust_inverse`; f32 on the card: a batched
inverse of the blocks scattered on the card), or the batched sparse LU of
la/sparse_lu.py.  The apply is plain torch (a batched matmul, gathers and
an index_add): the JAX package runs it as XLA, not as a Pallas kernel.
`distributed_schwarz` builds the same preconditioner from a DistributedCsr
alone, for the shard-axis solve of parallel/solve.py.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import scipy.sparse as sps
import torch

from feddlib_tpu_torch.la.csr import CsrMatrix
from feddlib_tpu_torch.la.dense_blocks import _parallel_map, _robust_inverse
from feddlib_tpu_torch.la.map import IndexMap


def grow_overlap(csr: sps.csr_matrix, seed_rows: np.ndarray,
                 layers: int) -> np.ndarray:
    """Grow `layers` of overlap through the matrix graph from the seed rows.
    Returns the sorted dof set."""
    current = np.unique(seed_rows)
    reach = current
    for _ in range(layers):
        sub = csr[reach]
        reach = np.unique(sub.indices)
        current = np.union1d(current, reach)
    return current


class SchwarzPreconditioner:
    """One-level additive/restricted Schwarz built from a global matrix and
    a unique (owned) dof map; lives on the matrix's device."""

    def __init__(self, A: CsrMatrix, unique_map: IndexMap, overlap: int = 1,
                 combine: str = "Restricted", dtype=torch.float64,
                 device_factor: Optional[bool] = None,
                 solver: str = "auto"):
        """solver: 'dense' ([P,S,S] explicit inverses, O(S³) setup),
        'sparse' (batched sparse LU with wavefront applies, setup
        O(nnz·fill)), or 'auto' (sparse once subdomains reach 4,096 dofs).
        device_factor (default: f32 on a CUDA device) factors the dense
        blocks on the card instead of the host."""
        if combine not in ("Restricted", "Full", "Averaging"):
            raise ValueError(f"unknown combine mode {combine!r}")
        if solver not in ("auto", "dense", "sparse"):
            raise ValueError(f"unknown subdomain solver {solver!r}")
        t0 = time.perf_counter()
        self.combine = combine
        self.device = dev = A.device
        self.n = A.shape[0]
        self.n_parts = unique_map.n_parts
        sp = A.to_scipy()
        if device_factor is None:
            device_factor = dtype == torch.float32 and dev.type == "cuda"

        ov_sets: List[np.ndarray] = []
        for p in range(self.n_parts):
            owned = unique_map.partition_indices[p]
            ov = grow_overlap(sp, owned, overlap) if overlap > 0 else owned
            ov_sets.append(ov)
        self.ov_sets = ov_sets
        S = max(len(o) for o in ov_sets)
        self.S = S
        P_ = self.n_parts
        if solver == "auto":
            # dense inverses win the apply up to a few thousand dofs (one
            # batched matmul against T_L + T_U wavefront steps); sparse LU
            # wins setup time and memory as S grows
            solver = "sparse" if S >= 4096 else "dense"
        self.solver = solver

        owner = unique_map.owner_of()
        ov_idx = np.full((P_, S), self.n, dtype=np.int64)  # pad → extra slot
        keep = np.zeros((P_, S), dtype=np.float64)
        mult = np.zeros(self.n, dtype=np.float64)
        for p in range(P_):
            ov = ov_sets[p]
            k = len(ov)
            ov_idx[p, :k] = ov
            if combine == "Restricted":
                keep[p, :k] = (owner[ov] == p).astype(np.float64)
            else:
                keep[p, :k] = 1.0
                mult[ov] += 1.0

        t1 = time.perf_counter()
        self.slu = None
        if self.solver == "sparse":
            from feddlib_tpu_torch.la.sparse_lu import BatchedSparseLU

            self.slu = BatchedSparseLU([sp[ov][:, ov].tocsc()
                                        for ov in ov_sets], S, dtype=dtype,
                                       device=dev)
            self.inv = None
        elif device_factor:
            # slot-carrying trick: a CSR copy whose values are the slot ids
            # survives scipy's submatrix extraction
            spi = sp.copy()
            spi.data = np.arange(sp.nnz, dtype=np.float64)
            flat_l, slot_l, eye_l = [], [], []
            for p in range(P_):
                ov = ov_sets[p]
                k = len(ov)
                sub = spi[ov][:, ov].tocoo()
                flat_l.append(p * S * S + sub.row.astype(np.int64) * S
                              + sub.col)
                slot_l.append(sub.data.astype(np.int64))
                eye_l.append(p * S * S + np.arange(k, S) * (S + 1))
            flat = torch.as_tensor(np.concatenate(flat_l), device=dev)
            slots = torch.as_tensor(np.concatenate(slot_l), device=dev)
            eye_idx = torch.as_tensor(np.concatenate(eye_l), device=dev)
            blocks = torch.zeros(P_ * S * S, dtype=dtype, device=dev)
            blocks[flat] = A.data.to(dtype)[slots]
            blocks[eye_idx] = 1.0
            blocks = blocks.reshape(P_, S, S)
            # tiny diagonal shift guards exactly-singular saddle blocks
            shift = 1e-6 if dtype == torch.float32 else 1e-12
            diag = torch.arange(S, device=dev)
            blocks[:, diag, diag] += shift * blocks.abs().max()
            self.inv = torch.linalg.inv(blocks)
        else:
            inv = np.zeros((P_, S, S), dtype=np.float64)

            def _factor(p):
                ov = ov_sets[p]
                k = len(ov)
                block = np.eye(S)
                block[:k, :k] = sp[ov][:, ov].toarray()
                inv[p] = _robust_inverse(block)

            # each block is independent: LAPACK releases the GIL
            _parallel_map(_factor, range(P_))
            self.inv = torch.as_tensor(inv, dtype=dtype, device=dev)

        # setup seconds: overlap sets and plans, then the subdomain factors
        # (host inverses and their upload, the card's batched inverse, or
        # the sparse LU with its level schedules)
        self.timings = {"overlap_s": t1 - t0,
                        "factor_s": time.perf_counter() - t1}
        self.ov_idx = torch.as_tensor(ov_idx, device=dev)
        self.keep = torch.as_tensor(keep, dtype=dtype, device=dev)
        if combine == "Averaging":
            scale = np.where(mult > 0, 1.0 / np.where(mult == 0, 1, mult), 0.0)
            self.avg_scale = torch.as_tensor(scale, dtype=dtype, device=dev)
        else:
            self.avg_scale = None
        self._op = None

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        """z = Σ_p R_pᵀ D_p A_p⁻¹ R_p r, batched over the subdomains."""
        fn, ops = self.operator()
        return fn(ops, r)

    def __call__(self, r):
        return self.apply(r)

    def operator(self):
        """(fn, operands) form for the solver's operator protocol."""
        if self._op is None:
            scale = (self.avg_scale if self.avg_scale is not None
                     else torch.ones(self.n, dtype=self.keep.dtype,
                                     device=self.device))
            if self.slu is not None:
                self._op = (schwarz_sparse_op_apply,
                            (self.ov_idx, self.keep, scale,
                             *self.slu.arrays()))
            else:
                self._op = (schwarz_op_apply,
                            (self.ov_idx, self.keep, self.inv, scale))
        return self._op


def _restrict(ov_idx, r):
    return torch.cat([r, r.new_zeros(1)])[ov_idx]  # [P, S], pad → 0


def _prolong(ov_idx, z_ov, n):
    return z_ov.new_zeros(n + 1).index_add_(
        0, ov_idx.reshape(-1), z_ov.reshape(-1))[:n]


def schwarz_op_apply(ops, r):
    """Dense-inverse apply: ops = (ov_idx, keep, inv [P,S,S], scale)."""
    ov_idx, keep, inv, scale = ops
    z_ov = torch.einsum("pij,pj->pi", inv, _restrict(ov_idx, r)) * keep
    return _prolong(ov_idx, z_ov, r.shape[0]) * scale


def schwarz_sparse_op_apply(ops, r):
    """Sparse-LU apply: ops = (ov_idx, keep, scale, *slu arrays)."""
    from feddlib_tpu_torch.la.sparse_lu import solve_batched

    ov_idx, keep, scale = ops[:3]
    z_ov = solve_batched(_restrict(ov_idx, r), ops[3:]) * keep
    return _prolong(ov_idx, z_ov, r.shape[0]) * scale


def distributed_schwarz(dmat, overlap: int = 1, combine: str = "Restricted",
                        factor: str = "host"):
    """One-level overlapping Schwarz for the shard-axis solver
    (parallel/solve.py), built from the DistributedCsr alone — no global
    matrix: the overlap grown `overlap` layers through the matrix graph of
    the symbolic locator, each shard's overlap set with its own halo plan
    (ppermute rounds) for the residual restriction and, for the Full /
    Averaging combines, the reverse export of the overlap corrections.

    factor: "host" (f64 dense inverses with the fallbacks of
    `_robust_inverse`), "sparse" (the batched sparse LU of every shard at
    once) or "device" (the blocks scattered on the device, a diagonal
    guard, one batched inverse).  The apply is batched over the shard axis.
    The overlap sets and plans are built for every shard on the host
    (replicated on every rank); a rank factors and keeps only its own
    shards' blocks (the matrix values of the others come from
    `values_host`, gathered once).

    Returns (build_fn, arrays) for DistributedSolver.solve(precond=...);
    `build_fn.timings` holds the setup seconds ("overlap_s": the overlap
    sets, "ovplan_s": their halo plan, "blocks_s": the subdomain blocks
    through the locator, "factor_s": the subdomain factors and the device
    arrays) and `build_fn.shape` the level-1 sizes."""
    from feddlib_tpu_torch.parallel.spmd import (HaloPlan, _col_local_ids,
                                                 _pad_stack)

    if combine not in ("Restricted", "Full", "Averaging"):
        raise ValueError(f"unknown combine mode {combine!r}")
    if overlap < 1:
        raise ValueError("overlap must be >= 1")
    if factor not in ("host", "sparse", "device"):
        raise ValueError(f"unknown factor {factor!r}")
    t0 = time.perf_counter()
    dev = dmat.device
    axis = dmat.axis
    lo, hi = axis.lo, axis.hi
    unique_map = dmat.unique_map
    n_dev, N_o = dmat.n_dev, dmat.plan.N_o
    loc = dmat.locator()
    owner = unique_map.owner_of()

    ov_sets, mult = [], np.zeros(dmat.n_global)
    for p in range(n_dev):
        owned = unique_map.partition_indices[p]
        ov = grow_overlap(loc, owned, overlap) if len(owned) else owned
        ov_sets.append(ov)
        mult[ov] += 1.0
    S = max(max(len(o) for o in ov_sets), 1)

    # the overlap halo plan: column map = owned ++ (ov \ owned)
    t_sets = time.perf_counter()
    extras = [np.setdiff1d(ov_sets[p], unique_map.partition_indices[p])
              for p in range(n_dev)]
    ovplan = HaloPlan(unique_map,
                      [np.concatenate([unique_map.partition_indices[p],
                                       extras[p]]) for p in range(n_dev)],
                      axis=axis)
    G_ov = ovplan.G
    t_plan = time.perf_counter()

    subs = []
    ov_col = np.zeros((n_dev, S), np.int64)
    ov_dst = np.full((n_dev, S), N_o + G_ov, np.int64)  # pad → dump slot
    keep = np.zeros((n_dev, S))
    own_pos = np.zeros((n_dev, N_o), np.int64)
    for p in range(n_dev):
        owned = unique_map.partition_indices[p]
        ov = ov_sets[p]
        k = len(ov)
        if lo <= p < hi:  # this rank's subdomain blocks
            subs.append(loc[ov][:, ov].tocoo())
        # overlap gids → overlap-plan column-local ids
        ov_col[p, :k] = _col_local_ids(owned, extras[p], ov, N_o)
        ov_dst[p, :k] = ov_col[p, :k]
        keep[p, :k] = (owner[ov] == p) if combine == "Restricted" else 1.0
        own_pos[p, : len(owned)] = np.searchsorted(ov, owned)
    t1 = time.perf_counter()

    slu = None
    if factor == "device":
        n_loc = hi - lo
        src = _pad_stack([s.data.astype(np.int64) - 1 for s in subs], 0,
                         None, np.int64)
        dst = _pad_stack([p * S * S + s.row.astype(np.int64) * S + s.col
                          for p, s in enumerate(subs)], n_loc * S * S, None,
                         np.int64)
        # a block reads its neighbours' rows: with ranks, every shard's
        # values (gathered once)
        flat = (dmat.ell_data.reshape(-1) if axis.group is None
                else torch.as_tensor(dmat.values_host(),
                                     dtype=dmat.ell_data.dtype, device=dev))
        blocks = flat.new_zeros(n_loc * S * S + 1)
        blocks[torch.as_tensor(dst, device=dev)] = flat[
            torch.as_tensor(src, device=dev)]
        blocks = blocks[:-1].reshape(n_loc, S, S)
        fill = torch.as_tensor(np.stack(
            [(np.arange(S) >= len(o)).astype(np.float64)
             for o in ov_sets[lo:hi]]), dtype=blocks.dtype, device=dev)
        diag = torch.arange(S, device=dev)
        blocks[:, diag, diag] += fill
        # tiny diagonal shift guards exactly-singular saddle blocks
        shift = 1e-6 if blocks.dtype == torch.float32 else 1e-12
        blocks[:, diag, diag] += shift * blocks.abs().max()
        inv = torch.linalg.inv(blocks)
    else:
        vals_flat = dmat.values_host()
        if factor == "sparse":
            from feddlib_tpu_torch.la.sparse_lu import BatchedSparseLU

            slu = BatchedSparseLU(
                [sps.csr_matrix((vals_flat[s.data.astype(np.int64) - 1],
                                 (s.row, s.col)),
                                shape=(max(s.shape[0], 1),) * 2)
                 for s in subs], S, device=dev)
            inv = None
        else:
            inv_h = np.zeros((len(subs), S, S))

            def _factor(p):
                s = subs[p]
                block = np.zeros((S, S))
                k = s.shape[0]
                block[np.arange(k, S), np.arange(k, S)] = 1.0  # pad identity
                block[s.row, s.col] = vals_flat[s.data.astype(np.int64) - 1]
                inv_h[p] = _robust_inverse(block)

            # each block is independent: LAPACK releases the GIL
            _parallel_map(_factor, range(len(subs)))
            inv = torch.as_tensor(inv_h, device=dev)
            del inv_h

    scale = np.zeros((n_dev, N_o))
    for p in range(n_dev):
        owned = unique_map.partition_indices[p]
        scale[p, : len(owned)] = 1.0 / np.maximum(mult[owned], 1.0)

    ix = axis.put  # this rank's rows
    head = [ix(ov_col), ix(ov_dst), ix(keep), ix(own_pos), ix(scale)]
    head = head + list(slu.arrays()) if slu is not None else [inv] + head
    n_head = len(head)
    arrays = head + [ovplan.import_arrays, ovplan.export_arrays]
    ov_imp, ov_exp = ovplan.importer(), ovplan.exporter()

    def build(prec_arrays, ctx):
        mask = ctx[2]
        if slu is not None:
            from feddlib_tpu_torch.la.sparse_lu import solve_batched

            oc, od, kp, op_, sc = prec_arrays[:5]
            slu_ops = tuple(prec_arrays[5:n_head])

            def solve_sub(r_ov):
                return solve_batched(r_ov, slu_ops)
        else:
            inv_p, oc, od, kp, op_, sc = prec_arrays[:6]

            def solve_sub(r_ov):
                return torch.einsum("pij,pj->pi", inv_p, r_ov)
        ia, ea = prec_arrays[n_head], prec_arrays[n_head + 1]

        def M(r):
            r_ov = torch.gather(ov_imp(r, ia), 1, oc)  # [n_dev, S]
            z_ov = solve_sub(r_ov) * kp
            if combine == "Restricted":
                return torch.gather(z_ov, 1, op_) * mask
            z_col = z_ov.new_zeros(z_ov.shape[0], N_o + G_ov + 1).scatter_(
                1, od, z_ov)[:, :-1]
            z = ov_exp(z_col, ea) * mask
            return z * sc if combine == "Averaging" else z

        return M

    build.timings = {"overlap_s": t_sets - t0, "ovplan_s": t_plan - t_sets,
                     "blocks_s": t1 - t_plan,
                     "factor_s": time.perf_counter() - t1}
    build.shape = {"n_dev": n_dev, "S": S, "G_ov": G_ov,
                   "comm": ovplan.comm_stats()}
    return build, arrays
