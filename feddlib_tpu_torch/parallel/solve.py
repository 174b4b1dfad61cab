"""Distributed Krylov solves over the shard axis — counterpart of
feddlib_tpu/parallel/solve.py.

The JAX package runs cg_loop / gmres_loop inside one shard_map program,
with every dot a psum of the shards' local dots.  The port's own loops
(solvers/krylov.py) run on the flattened [n_local·N_o] vector of a
process's shards (the padded lanes are zero), with A = halo import +
batched ELL matvec and M = the built preconditioner, both on the
[n_local, N_o] view; each dot is the process's dot, summed over the ranks
by the axis when several processes share the shard axis (the loops'
`axis`).  In one process the arithmetic is the flattened dot's.
"""

from __future__ import annotations

from typing import Optional

import torch

from feddlib_tpu_torch.parallel.spmd import DeviceAxis, DistributedCsr
from feddlib_tpu_torch.solvers.krylov import cg_loop, gmres_loop


class DistributedSolver:
    """Bundles a DistributedCsr and its shard axis into solve methods.

    A preconditioner is given as (build, arrays): build(arrays, ctx) → M,
    a callable on the rank's [n_local, N_o] residuals, where ctx =
    (ell_data, ell_cols, owned_mask, import_fn, export_fn) carries the
    matrix slices and the halo exchange."""

    def __init__(self, dmat: DistributedCsr,
                 axis: Optional[DeviceAxis] = None):
        self.dmat = dmat
        self.axis = axis or dmat.axis
        if self.axis.n_dev != dmat.n_dev:
            raise ValueError("device axis size != matrix partition count")
        n_loc = dmat.ell_data.shape[0]
        if (self.axis.n_local != n_loc
                or (self.axis.lo, self.axis.hi) != (dmat.axis.lo,
                                                    dmat.axis.hi)):
            raise ValueError(f"axis holds shards [{self.axis.lo}, "
                             f"{self.axis.hi}), the matrix {n_loc} from "
                             f"[{dmat.axis.lo}, {dmat.axis.hi})")

    def operators(self, precond=None):
        """(A, M) on the rank's [n_local, N_o] tensors; M is None for no
        preconditioner.  precond: None | "jacobi" | (build, arrays)."""
        dm = self.dmat
        plan = dm.plan
        imp, exp = plan.importer(), plan.exporter()
        hi, ho = plan.import_arrays, plan.export_arrays
        ed, ec = dm.ell_data, dm.ell_cols

        def A(x):
            return DistributedCsr.local_matvec(ed, ec, imp(x, hi))

        if precond is None:
            return A, None
        if precond == "jacobi":
            build, arrs = _jacobi_build, [_jacobi_diag(dm)]
        else:
            build, arrs = precond
        M = build(arrs, (ed, ec, plan.owned_mask, lambda x: imp(x, hi),
                         lambda y: exp(y, ho)))
        return A, M

    def solve(self, b_dist: torch.Tensor,
              x0: Optional[torch.Tensor] = None, method: str = "cg",
              tol: float = 1e-8, maxiter: int = 1000, restart: int = 100,
              precond=None):
        """b_dist [n_local, N_o] owned RHS → (x_dist, iters, relres).

        precond: None | "jacobi" | (build_fn, [arrays])."""
        shape = b_dist.shape
        A2, M2 = self.operators(precond)

        def A(v):
            return A2(v.view(shape)).reshape(-1)

        M = ((lambda v: v) if M2 is None
             else (lambda v: M2(v.view(shape)).reshape(-1)))
        b = b_dist.reshape(-1)
        x0 = torch.zeros_like(b) if x0 is None else x0.reshape(-1)
        ax = self.axis
        if method == "cg":
            x, it, rel, _ = cg_loop(A, M, b, x0, tol, maxiter, axis=ax)
        else:
            x, it, rel, _ = gmres_loop(A, M, b, x0, tol, restart, maxiter,
                                       axis=ax)
        return x.view(shape), int(it), float(rel)


def _jacobi_diag(dm: DistributedCsr) -> torch.Tensor:
    """[n_local, N_o] inverse diagonal (0 on padding)."""
    N_o = dm.plan.N_o
    # the column-map local id of owned row i is i itself
    is_diag = dm.ell_cols == torch.arange(N_o, device=dm.device)
    d = torch.where(is_diag, dm.ell_data, 0.0).sum(1)
    return torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d), 0.0)


def _jacobi_build(prec_arrays, local_ctx):
    (dinv,) = prec_arrays

    def M(r):
        return dinv * r

    return M
