"""LinearSolver + Preconditioner factory — counterpart of
feddlib_tpu/solvers/linear.py.

This slice ports the mixed-precision path ('Use Mixed Precision'): an f64
iterative refinement around an f32 restarted GMRES that runs in the padded
cluster space, with the padded SELL operator (`PaddedSplitSpMV`) as A and
the restricted dense-block Schwarz — optionally with the padded GDSW
coarse level (`'TwoLevel': True`) — as M.  The other solve paths raise
NotImplementedError and name their ROADMAP.md item.
"""

from __future__ import annotations

import warnings

import numpy as np

from feddlib_tpu_torch.la.block import BlockVector
from feddlib_tpu_torch.mesh.partition import MeshPartition


class Preconditioner:
    """Preconditioner factory bound to a problem.  Of the JAX factory only
    the merged dof map is ported; building the f64 Schwarz/GDSW
    preconditioners (`build`) waits for ROADMAP.md A5."""

    def __init__(self, problem):
        self.problem = problem

    def _merged_dof_map(self, part: MeshPartition):
        """Dof-level unique map for the merged monolithic system: blocks on
        the partitioned mesh (or its P2 child) use its maps, blocks on other
        meshes get their own partition of the same part count, and extra
        (domain-less) blocks go to the problem's `extra_block_owner` hook,
        else round-robin."""
        from feddlib_tpu_torch.la.map import IndexMap

        prob = self.problem
        sizes = prob.block_sizes()
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        n_parts = part.n_parts
        parts = [[] for _ in range(n_parts)]
        mesh_parts = {(id(part.mesh), 0, n_parts): part}
        ranges = prob.parameter_list.get("Mesh Rank Ranges", None)
        for b in range(len(sizes)):
            if b < len(prob.variables):
                dom, dofs, _ = prob.variables[b]
                base = dom.parent_p1 or dom
                if ranges is not None and b < len(ranges):
                    a0, a1 = int(ranges[b][0]), int(ranges[b][1])
                    if not (0 <= a0 <= a1 < n_parts):
                        raise ValueError(f"bad rank range {ranges[b]}")
                else:
                    a0, a1 = 0, n_parts - 1
                nb = a1 - a0 + 1
                key = (id(base.mesh), a0, nb)
                bp = mesh_parts.get(key)
                if bp is None:
                    bp = MeshPartition(base.mesh, nb)
                    mesh_parts[key] = bp
                node_map = (bp.unique_map if dom.mesh is bp.mesh
                            else _p2_unique_map(bp, dom))
                dmap = node_map.build_vec_field_map(dofs)
                for q in range(nb):
                    parts[a0 + q].append(dmap.partition_indices[q]
                                         + offsets[b])
            else:
                hook = getattr(prob, "extra_block_owner", None)
                owner = (hook(b, n_parts, mesh_parts) if hook is not None
                         else np.arange(sizes[b]) % n_parts)
                owner = np.asarray(owner)
                for p in range(n_parts):
                    parts[p].append(np.nonzero(owner == p)[0] + offsets[b])
        merged = [np.sort(np.concatenate(lst)) for lst in parts]
        return IndexMap(int(offsets[-1]), merged)


def _p2_unique_map(part: MeshPartition, dom):
    """Unique node map for a P2 domain built from the P1 partition: midpoint
    nodes are owned by the owner of their lower-numbered edge endpoint."""
    from feddlib_tpu_torch.la.map import IndexMap

    mesh = dom.mesh
    n_p1 = part.mesh.n_points
    owner_p1 = part.unique_map.owner_of()
    mid_owner = owner_p1[mesh.p2_edges.min(axis=1)]
    parts = []
    for p in range(part.n_parts):
        own_p1 = part.unique_map.partition_indices[p]
        own_mid = n_p1 + np.nonzero(mid_owner == p)[0]
        parts.append(np.sort(np.concatenate([own_p1, own_mid])))
    return IndexMap(mesh.n_points, parts)


class LinearSolver:
    """Monolithic Krylov solve of a (block) problem."""

    def solve_system(self, problem, b: BlockVector):
        """Solve the BC-applied system for an arbitrary rhs without touching
        problem.solution.  Returns (x: BlockVector, iters)."""
        params = problem.parameter_list
        tol = float(params.get("Convergence Tolerance", 1e-8))
        maxiter = int(params.get("Maximum Iterations", 1000))
        restart = int(params.get("Num Blocks", 100))

        system = problem.bc_system()
        if len(problem.variables) == 1:
            A = system.get_block(0, 0)
        else:
            A = system.merge()

        if bool(params.get("Use Distributed Solve", False)):
            raise NotImplementedError(
                "'Use Distributed Solve' is not ported yet (ROADMAP.md A10)")
        if bool(params.get("Use Mixed Precision", False)):
            return self._solve_mixed(problem, A, b, params, tol, maxiter,
                                     restart)
        raise NotImplementedError(
            "only the mixed-precision solve is ported ('Use Mixed "
            "Precision': True); the f64 Krylov + Schwarz path waits for "
            "ROADMAP.md A5")

    def _solve_mixed(self, problem, A, b: BlockVector, params, tol,
                     maxiter, restart):
        """f64 residual refinement around an f32 inner GMRES — padded SELL
        SpMV + dense-block restricted Schwarz (+ padded GDSW coarse level),
        the whole inner loop in PADDED cluster space."""
        import torch

        from feddlib_tpu_torch.la.dense_blocks import (DenseBlockSchwarz,
                                                       DenseBlockSpMV)
        from feddlib_tpu_torch.la.sell import PaddedSplitSpMV
        from feddlib_tpu_torch.solvers.krylov import solve
        from feddlib_tpu_torch.solvers.refinement import iterative_refinement

        inner_tol = float(params.get("Inner Tolerance", 1e-6))
        n_clusters = int(params.get("Clusters",
                                    params.get("Subdomains", 64)))
        two_level = bool(params.get("TwoLevel", params.get("Two Level",
                                                           False)))
        # the operators and the factored preconditioner are kept on the
        # problem and reused while the matrix pattern is unchanged (the
        # reassembly refresh through with_data comes with the nonlinear
        # problems, ROADMAP.md A7)
        cache = getattr(problem, "_mixed_cache", None)
        if (cache is None or cache["pattern"] is not A.pattern
                or problem._prec_stale):
            dom0 = problem.domains[0]
            base_mesh = (dom0.parent_p1.mesh if dom0.parent_p1 is not None
                         else dom0.mesh)
            part = MeshPartition(base_mesh, n_clusters)
            dof_map = problem.preconditioner._merged_dof_map(part)
            n_pts = dom0.mesh.n_points
            d0 = (int(problem.variables[0][1])
                  if getattr(problem, "variables", None) else 0)
            if len(problem.domains) == 1 and d0 > 0 \
                    and A.shape[0] == n_pts * d0:
                # count-median point RCB (balanced ±1) for the padded row
                # clusters; NodeWise dof order: dof = node*d + c
                from feddlib_tpu_torch.mesh.partition import partition_points

                node_cluster = partition_points(dom0.mesh.points,
                                                n_clusters)
                cluster = np.repeat(node_cluster, d0)
                db32 = DenseBlockSpMV.from_csr(A, cluster,
                                               dtype=torch.float32)
            else:
                cluster = np.zeros(A.shape[0], dtype=np.int32)
                for p, ix in enumerate(dof_map.partition_indices):
                    cluster[ix] = p
                db32 = DenseBlockSpMV.from_csr(A, cluster,
                                               dtype=torch.float32,
                                               balance=True)
            sell32 = PaddedSplitSpMV(A, db32, dtype=torch.float32)
            if two_level and len(problem.domains) == 1:
                from feddlib_tpu_torch.precond.cluster_coarse import (
                    PaddedTwoLevelSchwarz)

                nsp = params.get("Null Space Type", "laplace").lower()
                nsp = "elasticity" if "elas" in nsp else "laplace"
                prec32 = PaddedTwoLevelSchwarz(
                    A, part, db32,
                    dofs_per_node=A.shape[0] // base_mesh.n_points,
                    null_space=nsp,
                    variant=params.get("Coarse Space Variant", "GDSW"),
                    dirichlet_mask=problem.merged_dirichlet_mask(),
                    dof_map=dof_map,
                    level_combination=params.get("Level Combination",
                                                 "Multiplicative"),
                    A_padded_op=sell32.operator())
            else:
                prec32 = DenseBlockSchwarz(A, db32)
            cache = {"pattern": A.pattern, "db32": db32, "sell": sell32,
                     "prec": prec32, "A_op": sell32.operator(),
                     "M_op": prec32.padded_operator()}
            problem._mixed_cache = cache
            problem._prec_stale = False
        db32 = cache["db32"]
        A_fn, A_ops = cache["A_op"]
        M_fn, M_ops = cache["M_op"]

        def inner(r32):
            res = solve("gmres", A_fn, A_ops, db32.to_padded(r32),
                        M_fn=M_fn, M_ops=M_ops, tol=inner_tol,
                        maxiter=maxiter, restart=restart)
            res.x = db32.from_padded(res.x)
            return res

        res = iterative_refinement(A.matvec, inner, b.concat(), tol=tol)
        problem.last_relres = res.relres
        problem.last_passes = res.passes
        if not res.converged:
            warnings.warn(f"mixed-precision solve: relres={res.relres}")
        return BlockVector.split(res.x, problem.block_sizes()), res.iters

    def solve(self, problem, rhs=None) -> int:
        x, iters = self.solve_system(
            problem, rhs if rhs is not None else problem.rhs)
        problem.solution = x
        return iters
