"""Two-level Schwarz in the PADDED CLUSTER space — the preconditioner of
the mixed-precision solve.

Counterpart of feddlib_tpu/precond/cluster_coarse.py.  The restricted
dense-block level 1 (la/dense_blocks.DenseBlockSchwarz) gets the GDSW
coarse level in the same space:

  restrict   q[p,c]   = Φ_p^T r_p          batched einsum [P,c,R]×[P,R]
  reduce     rc       = S q.ravel()         0/1 plan-matrix SELL SpMV (B2)
  coarse     zc       = A0⁻¹ rc             dense [nc,nc] matvec
  spread     zg[p,c]  = zc[idx[p,c]]        gather
  prolong    z_p     += Φ_p zg[p]           batched einsum

Φ comes from GDSWCoarseOperator (host setup); this module re-lays it out
per cluster.  Low-precision stores (`store_dtype=torch.bfloat16`) widen to
f32 for the products and accumulate in f32.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sps
import torch

from feddlib_tpu_torch.utils import timers


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _lowp_einsum(eq, a, b, out_dtype):
    """einsum of a stored (possibly bf16) operand with a vector rounded to
    the store dtype, products and sums in `out_dtype`."""
    return torch.einsum(eq, a.to(out_dtype), b.to(a.dtype).to(out_dtype))


class PaddedClusterCoarse:
    """GDSW coarse level re-laid out over the padded clusters of a
    DenseBlockSpMV; apply acts on padded vectors [P*R]."""

    def __init__(self, phi: sps.csr_matrix, A0_inv, db,
                 dtype=torch.float32, store_dtype=None):
        from feddlib_tpu_torch.la.sell import SellMatrix

        phi = phi.tocsr()
        n, nc = phi.shape
        P, R = db.P, db.R
        dev = db.device
        old_of_pad = db.old_of_pad.cpu().numpy()  # [P*R] -> old id (pad -> n)
        self.P, self.R, self.nc = P, R, nc

        # per-cluster coarse support and dense Φ blocks [P, c, R],
        # vectorized over all clusters at once
        valid_pad = np.flatnonzero(old_of_pad < n)
        sub = phi[old_of_pad[valid_pad]].tocoo()
        vr = valid_pad[sub.row]                  # padded id per entry
        pcl = vr // R
        r_loc = vr - pcl * R
        key = pcl.astype(np.int64) * nc + sub.col
        uk, inv = np.unique(key, return_inverse=True)
        inv = inv.ravel()
        up = (uk // nc).astype(np.int64)
        ucol = (uk % nc).astype(np.int64)
        counts = np.bincount(up, minlength=P)
        c = _round_up(max(int(counts.max()) if len(counts) else 1, 1), 8)
        gstart = np.concatenate([[0], np.cumsum(counts)])
        local_c = np.arange(len(uk)) - gstart[up]
        coarse_idx = np.full((P, c), nc, np.int64)  # pad -> slot nc
        coarse_idx[up, local_c] = ucol
        phi_blocks = np.zeros((P, c, R), np.float64)
        phi_blocks[pcl, local_c[inv], r_loc] = sub.data
        self.c = c
        self.dtype = dtype
        self.store_dtype = store_dtype or dtype
        self.phi_blocks = torch.as_tensor(phi_blocks, device=dev).to(
            self.store_dtype)

        # 0/1 plan matrix S [nc, P*c]: rc = S @ q.ravel()
        pp, cc = np.nonzero(coarse_idx < nc)
        plan = sps.csr_matrix(
            (np.ones(len(pp), np.float32),
             (coarse_idx[pp, cc], pp * c + cc)), shape=(nc, P * c))
        self.plan = SellMatrix.from_csr(plan, dtype=dtype, device=dev)
        self.A0_inv = torch.as_tensor(A0_inv, device=dev).to(
            self.store_dtype)
        self.coarse_idx = torch.as_tensor(coarse_idx, device=dev)

    def operands(self):
        return (self.phi_blocks, self.plan.operands(), self.A0_inv,
                self.coarse_idx)

    def operator(self):
        """(fn, operands) on padded vectors."""
        return padded_coarse_op, self.operands()


def padded_coarse_op(ops, rp):
    from feddlib_tpu_torch.la.sell import sell_op

    phi_b, plan_ops, A0_inv, coarse_idx = ops
    P, _, R = phi_b.shape
    q = _lowp_einsum("pcr,pr->pc", phi_b, rp.reshape(P, R), rp.dtype)
    rc = sell_op(plan_ops, q.reshape(-1))
    zc = _lowp_einsum("ij,j->i", A0_inv, rc, rp.dtype)
    zg = torch.cat([zc, zc.new_zeros(1)])[coarse_idx]  # pad slot nc → 0
    z = _lowp_einsum("pcr,pc->pr", phi_b, zg, rp.dtype)
    return z.reshape(-1)


class PaddedTwoLevelSchwarz:
    """Two-level Schwarz on padded vectors: restricted dense-block level 1
    + PaddedClusterCoarse GDSW level, combined additively or
    multiplicatively.  Built from the global matrix, the mesh partition and
    the DenseBlockSpMV layout."""

    def __init__(self, A, part, db, dofs_per_node: int = 1,
                 null_space: str = "laplace", variant: str = "GDSW",
                 dirichlet_mask=None, dtype=torch.float32,
                 dof_map=None, level_combination: str = "Multiplicative",
                 A_padded_op=None, l1_store_dtype=None,
                 coarse_store_dtype=None, blocks=None):
        """l1_store_dtype=torch.bfloat16 halves the level-1 inverse's bytes
        (kernel B4, f32 accumulation).  `blocks`, the per-block specs of
        `GDSWCoarseOperator` (each field's offset, dofs per node, points,
        repeated node sets and null space), replace the coarse space of
        `part`'s own nodes (`dofs_per_node`, `null_space`), as a P2 field
        and a multi-field system need: a saddle-point system gets the
        velocity's translations and the pressure's constants on their own
        interface components, extended through the merged interior
        system (`GDSWCoarseOperator`'s 'monolithic'; one field extends
        alike either way), and `dirichlet_mask` is the merged mask of all
        blocks.  `coarse_per_block` counts the coarse functions of
        each block.  `timings` holds the seconds of the synchronised spans
        `prec.level1`, `prec.gdsw` and `prec.coarse_layout`
        (utils/timers.py)."""
        from feddlib_tpu_torch.la.dense_blocks import DenseBlockSchwarz
        from feddlib_tpu_torch.precond.gdsw import GDSWCoarseOperator

        if level_combination not in ("Additive", "Multiplicative"):
            raise ValueError(f"unknown level combination "
                             f"{level_combination!r}")
        self.level_combination = level_combination
        if level_combination == "Multiplicative":
            if A_padded_op is None:
                from feddlib_tpu_torch.la.sell import sell_padded_from

                A_padded_op = sell_padded_from(A, db, dtype=dtype).operator()
            self.A_op = A_padded_op
        else:
            self.A_op = None
        dev = db.device
        with timers.timer("prec.level1", sync=True) as level1:
            # the identity on the pad lanes only: a saddle-point block keeps
            # its zero pressure diagonal (fields with a stored diagonal
            # everywhere get the same blocks either way)
            self.level1 = DenseBlockSchwarz(A, db, dtype=dtype,
                                            store_dtype=l1_store_dtype,
                                            pad_identity_only=True)
        with timers.timer("prec.gdsw", sync=True) as gdsw:
            node_sets = None if blocks is not None else [
                np.asarray(ix) for ix in part.repeated_map.partition_indices]
            umap = part.unique_map if dof_map is None else dof_map
            co = GDSWCoarseOperator(
                A, umap, node_part_sets=node_sets,
                points=part.mesh.points, dofs_per_node=dofs_per_node,
                null_space=null_space, dirichlet_mask=dirichlet_mask,
                variant=variant, dtype=torch.float64, blocks=blocks,
                extension="monolithic")
        with timers.timer("prec.coarse_layout", sync=True) as layout:
            # A0⁻¹ on the card: ship the sparse A0 and invert in f32 there
            # (the coarse solve is preconditioner-only; the f64 outer
            # refinement absorbs the f32 inverse); on the CPU the host f64
            # inverse
            if dev.type == "cuda":
                A0s = co.A0_sparse().tocoo()
                ncc = co.n_coarse
                dense = torch.zeros((ncc, ncc), dtype=torch.float32,
                                    device=dev)
                dense[torch.as_tensor(A0s.row.astype(np.int64), device=dev),
                      torch.as_tensor(A0s.col.astype(np.int64),
                                      device=dev)] = \
                    torch.as_tensor(A0s.data, dtype=torch.float32, device=dev)
                A0_inv = torch.linalg.inv(dense)
            else:
                A0_inv = co.A0_inv.cpu().numpy()
            self.coarse = PaddedClusterCoarse(co.phi.to_scipy(), A0_inv, db,
                                              dtype=dtype,
                                              store_dtype=coarse_store_dtype)
        self.timings = {"level1_s": level1.seconds, "gdsw_s": gdsw.seconds,
                        "coarse_layout_s": layout.seconds}
        self.coarse_per_block = np.bincount(
            co.column_block, minlength=len(blocks) if blocks else 1)
        self.n_coarse = self.coarse.nc

    def padded_operator(self):
        l1_fn, l1_ops = self.level1.padded_operator()
        c_fn, c_ops = self.coarse.operator()
        if self.level_combination == "Multiplicative":
            # z = z1 + Φ A0⁻¹ Φᵀ (r − A z1): one extra padded SpMV, fewer
            # Krylov iterations (FROSch 'Level Combination')
            A_fn, A_ops = self.A_op
            return _two_level_mult_op, (l1_fn, l1_ops, c_fn, c_ops, A_fn,
                                        A_ops)
        return _two_level_add_op, (l1_fn, l1_ops, c_fn, c_ops)


def _two_level_mult_op(ops, rp):
    l1_fn, l1_ops, c_fn, c_ops, A_fn, A_ops = ops
    z1 = l1_fn(l1_ops, rp)
    return z1 + c_fn(c_ops, rp - A_fn(A_ops, z1))


def _two_level_add_op(ops, rp):
    l1_fn, l1_ops, c_fn, c_ops = ops
    return l1_fn(l1_ops, rp) + c_fn(c_ops, rp)
