"""Mixed-precision iterative refinement — f64 accuracy from an f32 inner
solve.  Counterpart of feddlib_tpu/solvers/refinement.py
(`iterative_refinement`):

    x = 0
    repeat:  r = b − A x        (f64)
             d ≈ A⁻¹ r          (f32 preconditioned Krylov)
             x = x + d          (f64)
    until ‖r‖/‖b‖ ≤ tol

Each pass contracts the error by about the inner tolerance, so a few passes
reach 1e-8 while the inner iterations run in f32.

Also the adaptive solve loop (`adaptive_solve_cycles`, the counterpart of
the JAX module's)."""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from feddlib_tpu_torch.solvers.krylov import KrylovResult


def adaptive_solve_cycles(mesh0, source, cycles: int, theta: float = 0.5,
                          strategy: str = "Doerfler", params=None,
                          source_np=None, bc_flags=(1,), device="cuda",
                          callback=None):
    """Adaptive Poisson loop — the laplaceAdaptive driver: per cycle

        solve → estimate (P1 jump estimator) → mark (Dörfler/Maximum)
        → refine (conforming closure) → re-partition → rebuild plans

    on the port's Laplace (`device`; `source` takes torch coordinates,
    `source_np` numpy ones for the host estimator).  The refinement runs on
    the host mesh, so it is the same at any partition count; each cycle
    builds a fresh problem on the refined mesh, so the distributed paths
    ('Use Distributed Solve' / 'Use Device Pipeline') re-partition and
    rebuild every plan.

    With 'Use Distributed AMR' (2D P1) estimation runs per part on owned
    elements + one ghost layer, marking uses only allreduce-style scalars,
    and refinement is per part with cross-part tagged-edge reconciliation
    (mesh/refine.py estimate_distributed / mark_distributed /
    refine_distributed_2d) over the port's MeshPartition, its part count
    'Devices' or `multihost.default_shards`.

    Returns the history: per cycle a dict (n_elements, eta, iters) as the
    JAX package's, plus n_dofs and `seconds` by part (rebuild: domain,
    problem and assembly; solve: Problem.solve with its partition, plans
    and preconditioner; estimate; mark; refine).  `callback(cycle,
    problem, record)`, if given, runs after each cycle's estimate."""
    import numpy as np

    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.mesh.refine import (error_estimate_p1,
                                               mark_elements,
                                               refine_mesh_2d,
                                               refine_mesh_3d)
    from feddlib_tpu_torch.problems.laplace import Laplace

    dist_amr = bool(params.get("Use Distributed AMR", False)) \
        if params is not None else False
    mesh = mesh0
    history = []
    f_np = source_np or source
    for c in range(cycles):
        t0 = time.perf_counter()
        dom = Domain(mesh, device=device)
        prob = Laplace(dom, parameter_list=params, device=device)
        prob.assemble()
        prob.assemble_source(source)
        for flag in bc_flags:
            prob.add_bc(lambda x, t: 0.0, flag, 0)
        t1 = time.perf_counter()
        iters = prob.solve()
        u = prob.solution[0].cpu().numpy()
        t2 = time.perf_counter()
        sec = {"rebuild": t1 - t0, "solve": t2 - t1}
        rec = dict(n_elements=mesh.n_elements, n_dofs=int(u.shape[0]))
        if dist_amr and mesh.dim == 2:
            from feddlib_tpu_torch.mesh.partition import MeshPartition
            from feddlib_tpu_torch.mesh.refine import (estimate_distributed,
                                                       mark_distributed,
                                                       refine_distributed_2d)

            from feddlib_tpu_torch.parallel import multihost

            part = MeshPartition(mesh, int(params.get(
                "Devices", multihost.default_shards(device))))
            eta_parts = estimate_distributed(mesh, part, u, f_np)
            eta_sq = sum(float((e ** 2).sum()) for e in eta_parts)  # psum
            t3 = time.perf_counter()
            sec["estimate"] = t3 - t2
            rec.update(eta=float(np.sqrt(eta_sq)), iters=iters, seconds=sec)
            history.append(rec)
            if callback is not None:
                callback(c, prob, rec)
            if c < cycles - 1:
                marks = mark_distributed(eta_parts, strategy=strategy,
                                         theta=theta)
                t4 = time.perf_counter()
                mesh, _ = refine_distributed_2d(mesh, part, marks)
                sec.update(mark=t4 - t3, refine=time.perf_counter() - t4)
            continue
        eta = error_estimate_p1(mesh, u, f_np)
        t3 = time.perf_counter()
        sec["estimate"] = t3 - t2
        rec.update(eta=float(np.sqrt((eta ** 2).sum())), iters=iters,
                   seconds=sec)
        history.append(rec)
        if callback is not None:
            callback(c, prob, rec)
        if c < cycles - 1:
            # mesh/refine.py adapt(), step by step
            marked = mark_elements(eta, strategy, theta)
            t4 = time.perf_counter()
            mesh = (refine_mesh_3d(mesh, marked) if mesh.dim == 3
                    else refine_mesh_2d(mesh, marked))
            sec.update(mark=t4 - t3, refine=time.perf_counter() - t4)
    return history


def iterative_refinement(A64: Callable, inner_solve: Callable,
                         b: torch.Tensor, tol: float = 1e-8,
                         max_passes: int = 8,
                         x0: Optional[torch.Tensor] = None) -> KrylovResult:
    """A64: f64 matvec.  inner_solve(r32) → approximate correction in f32
    (a tensor or a KrylovResult; converted and accumulated in f64)."""
    b = b.to(torch.float64)
    x = torch.zeros_like(b) if x0 is None else x0.to(torch.float64)
    bnorm = float(torch.linalg.norm(b))
    bnorm = 1.0 if bnorm == 0 else bnorm
    total_inner = 0
    r = b - A64(x)
    rnorm = float(torch.linalg.norm(r))
    rel = rnorm / bnorm
    passes = 0
    while rel > tol and passes < max_passes:
        scale = 1.0 if rnorm == 0 else rnorm
        d = inner_solve((r / scale).to(torch.float32))
        if isinstance(d, KrylovResult):
            total_inner += d.iters
            d = d.x
        x = x + d.to(torch.float64) * scale
        r = b - A64(x)
        rnorm = float(torch.linalg.norm(r))
        rel = rnorm / bnorm
        passes += 1
    return KrylovResult(x, total_inner, rel, rel <= tol, passes=passes)
