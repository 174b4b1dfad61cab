"""Dense row-cluster operator and restricted Schwarz in padded cluster space.

Counterpart of feddlib_tpu/la/dense_blocks.py:

- rows are clustered (point RCB) and renumbered into a PADDED cluster space
  of stride R: row k of cluster p lives at padded id p·R + k (pad lanes hold
  zeros);
- each cluster stores one dense block [R, W = R + G]: its rows restricted to
  [own columns | ghost columns];
- apply:  y.reshape(P, R) = blocks @ [x.reshape(P, R) | ghosts], where the
  ghost fetch is the permutation gather (kernel B1) and the batched GEMV is
  kernel B3 (f32) — or B4 for the bf16-stored Schwarz inverse.

`DenseBlockSchwarz` is overlap-1 restricted additive Schwarz on the same
layout: the cluster's column map [own | ghost] is its overlap-1 subdomain,
and the Restricted combine keeps only the owned rows of each subdomain
inverse ([P, R, W]).  On the card the f32 inverse is factored in place by a
batched Cholesky (symmetric matrices) or a batched LU solve; on the CPU by
host LAPACK in f64.

Vector convention: hot-loop vectors live in the padded space [P*R] (pad
lanes zero).  `to_padded` / `from_padded` convert.
"""

from __future__ import annotations

import contextlib
import ctypes
import logging
import os
from typing import Optional

import numpy as np
import torch

from feddlib_tpu_torch.la.csr import CsrMatrix
from feddlib_tpu_torch.la.dense_kernels import (dense_block_mv,
                                                dense_block_mv_lowp,
                                                dense_block_mv_lowp_plain)
from feddlib_tpu_torch.la.permute import PermutationGather, permute_op


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def rebalance_row_clusters(sp, row_cluster, n_parts=None,
                           max_passes: int = 32) -> np.ndarray:
    """Deterministically even out cluster sizes by moving boundary rows of
    over-full clusters to column-adjacent under-full clusters (a copy of
    the JAX package's layout pass: the padded size R = max cluster count
    sets the [P, R, W] stream and the padded vector length).  Only rows
    with an out-of-cluster column move, so clusters stay compact."""
    indptr, indices = sp.indptr, sp.indices
    rc0 = np.asarray(row_cluster).astype(np.int32)
    rc = rc0.copy()
    P = int(n_parts if n_parts is not None else rc.max() + 1)
    n = len(rc)
    target = -(-n // P)
    row_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    BIG = np.iinfo(np.int64).max

    def _rank_within(groups):
        o = np.argsort(groups, kind="stable")
        rk = np.empty(len(groups), np.int64)
        uniq, start = np.unique(groups[o], return_index=True)
        rk[o] = np.arange(len(groups)) - start[
            np.searchsorted(uniq, groups[o])]
        return rk

    for _ in range(max_passes):
        counts = np.bincount(rc, minlength=P).astype(np.int64)
        if counts.max() <= target:
            break
        # per row: least-loaded FOREIGN neighbor cluster (tie → lowest id)
        col_c = rc[indices]
        key = np.where(col_c != rc[row_of],
                       counts[col_c] * P + col_c, BIG)
        best = np.full(n, BIG)
        np.minimum.at(best, row_of, key)
        dst = (best % P).astype(np.int32)
        # diffusion: any strictly-downhill move, capped per (src, dst) pair,
        # per dst inflow and per src outflow at half the count differences
        cand = np.flatnonzero((best != BIG)
                              & (counts[rc] > best // P + 1))
        if len(cand) == 0:
            break
        src_c, dst_c = rc[cand], dst[cand]
        pair = src_c.astype(np.int64) * P + dst_c
        smax = np.zeros(P, np.int64)
        np.maximum.at(smax, dst_c, counts[src_c])
        dmin = np.full(P, np.iinfo(np.int64).max)
        np.minimum.at(dmin, src_c, counts[dst_c])
        keep = ((_rank_within(pair) < (counts[src_c] - counts[dst_c]) // 2)
                & (_rank_within(dst_c) < (smax[dst_c] - counts[dst_c]) // 2)
                & (_rank_within(src_c) < (counts[src_c] - dmin[src_c]) // 2))
        sel = cand[keep]
        if len(sel) == 0:
            break
        rc[sel] = dst[sel]
    if np.bincount(rc, minlength=P).max() > np.bincount(
            rc0, minlength=P).max():
        return rc0  # diffusion oscillated — keep the input layout
    return rc


class DenseBlockSpMV:
    def __init__(self, blocks, ghost_idx, n: int, pad_of_old, old_of_pad,
                 dtype=torch.float64):
        self.blocks = blocks  # [P, R, R+G]
        self.ghost_idx = ghost_idx  # [P, G] padded ids (pad → P*R slot = 0)
        self.n = n
        self.P, self.R = blocks.shape[0], blocks.shape[1]
        self.G = ghost_idx.shape[1]
        self.pad_of_old = pad_of_old  # [n] old dof → padded id
        self.old_of_pad = old_of_pad  # [P*R] padded id → old dof (pad → n)
        self.dtype = dtype
        self.device = blocks.device
        gi = ghost_idx.cpu().numpy().ravel().astype(np.int64)
        M = self.P * self.R
        self.ghost_plan = PermutationGather(
            np.where(gi < M, gi, -1), M, device=self.device).operands()

    @classmethod
    def from_csr(cls, A: CsrMatrix, row_cluster: np.ndarray,
                 dtype=torch.float64, balance: bool = False
                 ) -> "DenseBlockSpMV":
        n = A.shape[0]
        if A.shape[0] != A.shape[1]:
            raise ValueError("square matrices only")
        dev = A.device
        sp = A.to_scipy().tocsr()
        row_cluster = np.asarray(row_cluster)
        if balance:
            row_cluster = rebalance_row_clusters(sp, row_cluster)
        P = int(row_cluster.max()) + 1
        counts = np.bincount(row_cluster, minlength=P)
        R = _round_up(int(counts.max()), 8)

        order = np.argsort(row_cluster, kind="stable")  # cluster-sorted olds
        starts = np.concatenate([[0], np.cumsum(counts)])
        pad_of_old = np.empty(n, dtype=np.int64)
        old_of_pad = np.full(P * R, n, dtype=np.int64)
        for p in range(P):
            olds = order[starts[p]:starts[p + 1]]
            pad_ids = p * R + np.arange(len(olds))
            pad_of_old[olds] = pad_ids
            old_of_pad[pad_ids] = olds

        coo = sp.tocoo()
        pr = pad_of_old[coo.row]
        pc = pad_of_old[coo.col]
        pcl = pr // R  # cluster of each entry
        lrow = pr - pcl * R
        own = (pc // R) == pcl

        M = P * R
        gkey = pcl[~own].astype(np.int64) * M + pc[~own]
        guniq, ginv = np.unique(gkey, return_inverse=True)
        ginv = ginv.ravel()
        gp = (guniq // M).astype(np.int64)
        gc = (guniq % M).astype(np.int64)
        gcounts = np.bincount(gp, minlength=P)
        G = max(int(gcounts.max()) if len(gcounts) else 1, 1)
        # the same width rule as the JAX package (W a multiple of 8 but not
        # of 128), so both packages lay out identical blocks
        G = _round_up(R + G, 8) - R
        if (R + G) % 128 == 0:
            G += 8
        gstart = np.concatenate([[0], np.cumsum(gcounts)])
        gpos = np.arange(len(guniq)) - gstart[gp]

        ghost_idx = np.full((P, G), M, dtype=np.int64)  # pad → zero slot
        ghost_idx[gp, gpos] = gc

        loc = np.where(own, pc - pcl * R, 0)
        loc[~own] = R + gpos[ginv]
        # blocks are filled on the device from the device-resident values;
        # scipy CSR→COO keeps CSR slot order, so coo entries align with
        # A.data elementwise
        flat = (pcl.astype(np.int64) * (R * (R + G))
                + lrow.astype(np.int64) * (R + G) + loc)
        blocks = torch.zeros(P * R * (R + G), dtype=dtype, device=dev)
        blocks[torch.as_tensor(flat, device=dev)] = A.data.to(dtype)
        return cls(blocks.reshape(P, R, R + G),
                   torch.as_tensor(ghost_idx, device=dev), n,
                   torch.as_tensor(pad_of_old, device=dev),
                   torch.as_tensor(old_of_pad, device=dev), dtype)

    # -- vector layout -------------------------------------------------------
    def to_padded(self, x: torch.Tensor) -> torch.Tensor:
        src = torch.cat([x.to(self.dtype),
                         torch.zeros(1, dtype=self.dtype, device=x.device)])
        return src[self.old_of_pad]

    def from_padded(self, xp: torch.Tensor) -> torch.Tensor:
        return xp[self.pad_of_old]

    # -- applies -------------------------------------------------------------
    def matvec_padded(self, xp: torch.Tensor) -> torch.Tensor:
        """xp [P*R] padded-clustered (pad lanes zero) → y [P*R] padded."""
        return dense_block_padded_op(self.padded_operator()[1], xp)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """Original-ordering convenience apply (permutes in and out)."""
        return self.from_padded(self.matvec_padded(self.to_padded(x)))

    def padded_operator(self):
        """(fn, operands) acting on PADDED-clustered vectors [P*R] — whole
        Krylov loops run in padded space (pad lanes stay zero, so dots and
        norms agree with the original ordering)."""
        return dense_block_padded_op, (self.blocks, self.ghost_idx,
                                       self.ghost_plan)


def _gather_ghosts(ghost_idx, ghost_plan, xp):
    """xp [M] padded-clustered → ghosts [P, G] through the permutation
    gather (kernel B1 for f32 on the card)."""
    P, G = ghost_idx.shape
    return permute_op(ghost_plan, xp).reshape(P, G).to(xp.dtype)


def _batched_gemv(blocks, xs):
    """f32 blocks go through kernel B3; other dtypes use the plain einsum,
    as the JAX package sends only f32 to its kernel."""
    if blocks.dtype == torch.float32 and xs.dtype == torch.float32:
        return dense_block_mv(blocks, xs)
    return torch.einsum("prs,ps->pr", blocks, xs)


def dense_block_padded_op(ops, xp):
    """Operator on padded-clustered vectors: xp [P*R] → y [P*R]."""
    blocks, ghost_idx, ghost_plan = ops
    P, R = blocks.shape[0], blocks.shape[1]
    ghosts = _gather_ghosts(ghost_idx, ghost_plan, xp)
    xs = torch.cat([xp.reshape(P, R), ghosts], dim=1)  # [P, R+G]
    return _batched_gemv(blocks, xs).reshape(-1)


class DenseBlockSchwarz:
    """Overlap-1 restricted additive Schwarz in the padded cluster space.

    Each cluster's column map [own | ghost] is its overlap-1 dof set, the
    subdomain matrix is A[ov][:, ov] in that ordering, and the Restricted
    combine (each dof updated only by its owner) keeps z_ov[:, :R] — so only
    the owned rows of the inverses are formed: inv [P, R, W].

    Factorization: on the card, in the working dtype — batched Cholesky and
    two triangular solves for symmetric matrices, else a batched LU solve;
    on the CPU, host LAPACK in f64.  `store_dtype=torch.bfloat16` stores
    the inverse in bf16 (kernel B4 applies it with f32 accumulation)."""

    def __init__(self, A: CsrMatrix, db: DenseBlockSpMV, dtype=None,
                 device_factor: Optional[bool] = None, store_dtype=None):
        dtype = dtype or db.dtype
        P, R = db.P, db.R
        W = db.blocks.shape[2]
        M = P * R
        n = db.n
        dev = db.device
        self.P, self.R, self.W = P, R, W
        self.db = db
        if device_factor is None:
            device_factor = dtype == torch.float32 and dev.type == "cuda"
        # guard exactly-singular subdomain blocks of the f32 device factor
        shift = 1e-6 if device_factor else 0.0

        old_of_pad = db.old_of_pad.cpu().numpy()  # [M], pad → n
        ghost_idx = db.ghost_idx.cpu().numpy()    # [P, G] padded ids, pad → M
        colmap = np.empty((P, W), np.int64)       # per-cluster ORIGINAL ids
        colmap[:, :R] = old_of_pad.reshape(P, R)
        gi_old = np.full(ghost_idx.shape, n, np.int64)
        valid = ghost_idx < M
        gi_old[valid] = old_of_pad[ghost_idx[valid]]
        colmap[:, R:] = gi_old

        # slot-carrying extraction of A[ov][:, ov] per cluster (values stay
        # on the device; only index plans are built on the host)
        sp = A.to_scipy()
        spi = sp.copy()
        spi.data = np.arange(sp.nnz, dtype=np.float64) + 1.0
        flat_l, slot_l = [], []
        for p in range(P):
            ov = colmap[p]
            real = np.nonzero(ov < n)[0]
            sub = spi[ov[real]][:, ov[real]].tocoo()
            flat_l.append(p * W * W + real[sub.row].astype(np.int64) * W
                          + real[sub.col])
            slot_l.append(sub.data.astype(np.int64) - 1)
        flat = torch.as_tensor(np.concatenate(flat_l), device=dev)
        slots = torch.as_tensor(np.concatenate(slot_l), device=dev)
        eye_idx = (torch.arange(P, device=dev)[:, None] * (W * W)
                   + torch.arange(W, device=dev)[None, :] * (W + 1)
                   ).reshape(-1)
        blocks_sq = torch.zeros(P * W * W, dtype=dtype, device=dev)
        blocks_sq[eye_idx] = 1.0
        blocks_sq[flat] = A.data.to(dtype)[slots]
        blocks_sq = blocks_sq.reshape(P, W, W)
        del flat, slots, eye_idx
        if shift:
            diag = torch.arange(W, device=dev)
            blocks_sq[:, diag, diag] += shift * blocks_sq.abs().max()
        # the Restricted combine reads only the owned rows: row j of A⁻¹ is
        # (A⁻ᵀ e_j)ᵀ, so one batched solve with R right-hand sides gives
        # inv[:, :R, :] and skips the ghost rows
        if device_factor:
            eye_r = torch.eye(W, R, dtype=dtype, device=dev)
            self.inv = None
            if _blocks_symmetric(A):
                L, info = torch.linalg.cholesky_ex(blocks_sq)
                if bool((info == 0).all()):
                    z = torch.linalg.solve_triangular(
                        L, eye_r.expand(P, W, R), upper=False)
                    x = torch.linalg.solve_triangular(
                        L.transpose(1, 2), z, upper=True)  # A⁻¹[:, :R]
                    del L, z
                    if bool(torch.isfinite(x).all()):
                        # symmetric A ⇒ rows == columns
                        self.inv = x.transpose(1, 2).contiguous()
                    del x
            if self.inv is None:
                x = torch.linalg.solve(blocks_sq.transpose(1, 2), eye_r)
                self.inv = x.transpose(1, 2).contiguous()  # [P, R, W]
                del x
            del blocks_sq
        else:
            import scipy.linalg as sla

            blocks_np = blocks_sq.cpu().numpy().astype(np.float64)
            del blocks_sq
            inv_r = np.empty((P, R, W), np.float64)
            eye_np = np.eye(W, R)

            def _owned_rows(p):
                a = blocks_np[p]
                try:
                    lu, piv = sla.lu_factor(a.T, check_finite=False)
                    x = sla.lu_solve((lu, piv), eye_np, check_finite=False)
                    if not np.isfinite(x).all():
                        raise np.linalg.LinAlgError
                except (np.linalg.LinAlgError, ValueError):
                    x = _robust_inverse(a)[:R, :].T
                inv_r[p] = x.T

            # LAPACK releases the GIL — factor the P blocks on a pool
            _parallel_map(_owned_rows, range(P))
            self.inv = torch.as_tensor(inv_r, dtype=dtype, device=dev)
        if store_dtype is not None:
            self.inv = self.inv.to(store_dtype)

    def padded_operator(self):
        db = self.db
        return dense_block_schwarz_op, (self.inv, db.ghost_idx,
                                        db.ghost_plan)


def dense_block_schwarz_op(ops, rp):
    """Padded-space Schwarz apply: rp [P*R] → z [P*R].

    inv is the OWNED-ROW slice [P, R, W] of the subdomain inverses — the
    Restricted combine is realized by never storing the ghost rows."""
    inv, ghost_idx, ghost_plan = ops
    P = inv.shape[0]
    R = rp.shape[0] // P
    ghosts = _gather_ghosts(ghost_idx, ghost_plan, rp)
    rs = torch.cat([rp.reshape(P, R), ghosts], dim=1)  # [P, W]
    if inv.dtype != rs.dtype:  # low-precision store, f32 accumulation
        if inv.dtype == torch.bfloat16 and rs.dtype == torch.float32:
            z = dense_block_mv_lowp(inv, rs)
        else:
            z = dense_block_mv_lowp_plain(inv, rs).to(rs.dtype)
    else:
        z = _batched_gemv(inv, rs)  # [P, R]
    return z.reshape(-1)  # Restricted combine = owned rows only


def _blocks_symmetric(A: CsrMatrix, tol: float = 1e-12) -> bool:
    """Host check that A is (numerically) symmetric — gate for the
    batched-Cholesky subdomain factorization."""
    sp = A.to_scipy().tocsr()
    d = abs(sp - sp.T)
    scale = max(abs(sp).max(), 1e-300)
    return bool(d.max() <= tol * scale)


def _blas_thread_controls():
    """(get, set) thread-count functions of every OpenBLAS library loaded
    in this process, found through /proc/self/maps (numpy and scipy each
    bring their own copy); empty where that file does not exist."""
    try:
        with open("/proc/self/maps") as f:
            paths = {line.split()[-1] for line in f if "openblas" in line}
    except OSError:
        return []
    names = [(f"{pre}openblas_get_num_threads{suf}",
              f"{pre}openblas_set_num_threads{suf}")
             for pre in ("", "scipy_") for suf in ("", "64_", "_64")]
    out = []
    for path in sorted(paths):
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        for get_name, set_name in names:
            get, set_ = getattr(lib, get_name, None), getattr(lib, set_name,
                                                              None)
            if get is not None and set_ is not None:
                get.restype, get.argtypes = ctypes.c_int, []
                set_.restype, set_.argtypes = None, [ctypes.c_int]
                out.append((get, set_))
                break
    return out


@contextlib.contextmanager
def _blas_single_threaded():
    """Run the body with every loaded OpenBLAS at one thread, then restore.  The
    setup pools below call LAPACK/SuperLU from several Python threads at
    once; a BLAS that spawns its own thread team under each of them
    oversubscribes the cores and runs several times slower.  Only OpenBLAS
    is pinned: with another BLAS (MKL) the body runs unpinned, and a log
    line says so."""
    saved = [(set_, get()) for get, set_ in _blas_thread_controls()]
    if not saved:
        logging.getLogger(__name__).info(
            "no OpenBLAS thread control found: the setup pool runs with "
            "the BLAS thread count unchanged")
    try:
        for set_, _ in saved:
            set_(1)
        yield
    finally:
        for set_, n in saved:
            set_(n)


def _parallel_map(fn, items, max_workers: Optional[int] = None):
    """Thread-pooled map for setup-phase factorization loops (after
    feddlib_tpu/la/sparse_lu.py:_parallel_map), with the BLAS libraries
    held at one thread while the pool runs."""
    from concurrent.futures import ThreadPoolExecutor

    items = list(items)
    if len(items) <= 1:
        return [fn(x) for x in items]
    w = max_workers or min(int(os.environ.get("FEDD_SETUP_THREADS", "8")),
                           os.cpu_count() or 1, len(items))
    if w <= 1:
        return [fn(x) for x in items]
    with _blas_single_threaded(), ThreadPoolExecutor(max_workers=w) as ex:
        return list(ex.map(fn, items))


#: counters of regularized subdomain factorizations since process start —
#: {"pinned": per-subdomain pressure-dof pins, "shifted": diagonal-shift
#: fallbacks, "pinv": pseudo-inverse last resorts}.  The reference relies
#: on KLU pivot perturbations and is silent about them; we count and WARN
#: (a shifted/pseudo-inverse silently changes the
#: preconditioner).
ROBUST_INVERSE_STATS = {"pinned": 0, "shifted": 0, "pinv": 0}


def _robust_inverse(block: np.ndarray) -> np.ndarray:
    """(A copy of feddlib_tpu/precond/schwarz.py:_robust_inverse.)  Dense inverse with structured fallbacks for singular subdomain
    blocks.  Saddle-point subdomains (Stokes/NS) carry a local
    constant-pressure null space: interior subdomains see div u = 0 with
    no pressure anchor, so the block is EXACTLY singular.  The reference
    gets by on KLU pivot perturbations; here the first fallback is the
    structured fix — PIN one zero-diagonal (pressure) dof per subdomain
    (unit row/column), which deflates the constant-pressure mode exactly
    and leaves every other dof's solve untouched.  Only if that still
    fails (singularity not of pressure type) do we fall back to a
    diagonal shift, then pseudo-inverse.  Every fallback is counted in
    ROBUST_INVERSE_STATS and reported."""
    import warnings

    scale = np.abs(block).max() or 1.0
    zd_all = np.flatnonzero(np.abs(np.diag(block)) <= 1e-14 * scale)
    try:
        out = np.linalg.inv(block)
        # LAPACK getri "succeeds" on numerically singular blocks with
        # ~1/eps entries.  Only blocks carrying the saddle-point
        # SIGNATURE (zero-diagonal pressure dofs) get a quality gate —
        # an ill-conditioned but nonsingular block must keep its exact
        # inverse (err grows like eps·cond(A), which would trip any
        # fixed threshold on fine/anisotropic meshes).
        if not len(zd_all):
            return out
        cols = zd_all[:8]
        err = np.abs(block @ out[:, cols]
                     - np.eye(block.shape[0])[:, cols]).max()
        if np.isfinite(err) and err < 1e-6:
            return out
    except np.linalg.LinAlgError:
        pass
    zd = zd_all
    if len(zd):
        pinned = block.copy()
        j = int(zd[0])
        pinned[j, :] = 0.0
        pinned[:, j] = 0.0
        pinned[j, j] = scale
        try:
            out = np.linalg.inv(pinned)
            ROBUST_INVERSE_STATS["pinned"] += 1
            warnings.warn(
                f"singular subdomain block: pinned local pressure dof "
                f"{j} (constant-pressure deflation; total pinned: "
                f"{ROBUST_INVERSE_STATS['pinned']})", RuntimeWarning)
            return out
        except np.linalg.LinAlgError:
            pass
    for eps in (1e-12, 1e-10, 1e-8):
        try:
            out = np.linalg.inv(block + eps * scale * np.eye(len(block)))
            ROBUST_INVERSE_STATS["shifted"] += 1
            warnings.warn(
                f"singular subdomain block regularized with diagonal "
                f"shift {eps:g}*|A| (total shifted: "
                f"{ROBUST_INVERSE_STATS['shifted']})", RuntimeWarning)
            return out
        except np.linalg.LinAlgError:
            continue
    ROBUST_INVERSE_STATS["pinv"] += 1
    warnings.warn(
        f"subdomain block pseudo-inverted (total pinv: "
        f"{ROBUST_INVERSE_STATS['pinv']}) — preconditioner differs "
        f"from an exact subdomain solve", RuntimeWarning)
    return np.linalg.pinv(block)
