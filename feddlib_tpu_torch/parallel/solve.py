"""Distributed Krylov solves over the shard axis — counterpart of
feddlib_tpu/parallel/solve.py.

The JAX package runs cg_loop / gmres_loop inside one shard_map program,
with every dot a psum of the shards' local dots.  With the shards stacked on
one device that dot is the dot of the flattened [n_dev·N_o] vectors (the
padded lanes are zero), so the port's own loops (solvers/krylov.py) run on
the flattened stacked vector, with A = halo import + batched ELL matvec and
M = the built preconditioner, both on the [n_dev, N_o] view.
"""

from __future__ import annotations

from typing import Optional

import torch

from feddlib_tpu_torch.parallel.spmd import DeviceAxis, DistributedCsr
from feddlib_tpu_torch.solvers.krylov import cg_loop, gmres_loop


class DistributedSolver:
    """Bundles a DistributedCsr and its shard axis into solve methods.

    A preconditioner is given as (build, arrays): build(arrays, ctx) → M,
    a callable on stacked [n_dev, N_o] residuals, where ctx = (ell_data,
    ell_cols, owned_mask, import_fn, export_fn) carries the matrix slices
    and the halo exchange."""

    def __init__(self, dmat: DistributedCsr,
                 axis: Optional[DeviceAxis] = None):
        self.dmat = dmat
        self.axis = axis or DeviceAxis(dmat.n_dev, dmat.device)
        if self.axis.n_dev != dmat.n_dev:
            raise ValueError("device axis size != matrix partition count")

    def operators(self, precond=None):
        """(A, M) on stacked [n_dev, N_o] tensors; M is None for no
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
        """b_dist [n_dev, N_o] stacked owned RHS → (x_dist, iters, relres).

        precond: None | "jacobi" | (build_fn, [stacked arrays])."""
        shape = b_dist.shape
        A2, M2 = self.operators(precond)

        def A(v):
            return A2(v.view(shape)).reshape(-1)

        M = ((lambda v: v) if M2 is None
             else (lambda v: M2(v.view(shape)).reshape(-1)))
        b = b_dist.reshape(-1)
        x0 = torch.zeros_like(b) if x0 is None else x0.reshape(-1)
        if method == "cg":
            x, it, rel, _ = cg_loop(A, M, b, x0, tol, maxiter)
        else:
            x, it, rel, _ = gmres_loop(A, M, b, x0, tol, restart, maxiter)
        return x.view(shape), int(it), float(rel)


def _jacobi_diag(dm: DistributedCsr) -> torch.Tensor:
    """[n_dev, N_o] inverse diagonal (0 on padding)."""
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
