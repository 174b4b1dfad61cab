"""LinearSolver + Preconditioner factory — counterpart of
feddlib_tpu/solvers/linear.py.

Two solve paths are ported.  The f64 Krylov path: restarted GMRES (or CG)
with the preconditioner that `'Preconditioner Type'` names — None, Id,
Jacobi, the one-level overlapping Schwarz ('SchwarzOneLevel' / 'Schwarz',
precond/schwarz.py) or the two-level Schwarz with a GDSW / RGDSW /
IPOUHarmonic coarse level ('SchwarzTwoLevel', the default, precond/gdsw.py;
multi-field systems get the monolithic block coarse space of
`_block_specs`) — and an A-apply that goes through a gather-free DIA /
block-DIA operator on the card when the matrix is banded
(`'SpMV Format': 'auto'`).  And the mixed-precision path ('Use Mixed
Precision'): an f64 iterative refinement around an f32 restarted GMRES that
runs in the padded cluster space, with the padded SELL operator
(`PaddedSplitSpMV`) as A and the restricted dense-block Schwarz —
optionally with the padded GDSW coarse level (`'TwoLevel': True`) — as M.
'FaCSI' (precond/facsi.py) preconditions the four-field FSI system.  And
the distributed solve ('Use Distributed Solve' + 'Devices'): the assembled
system split into owned-row shards stacked on the problem's device, halo
exchanges over the shard axis, the distributed one- / two-level Schwarz
and the Krylov loop over the stacked vectors (parallel/); with 'Use
Device Pipeline' the shards are assembled on the device from the
problem's `pipeline_blocks` (parallel/pipeline.py), no global matrix in
the chain.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from feddlib_tpu_torch.la.block import BlockVector
from feddlib_tpu_torch.mesh.partition import MeshPartition


def _hashable(v):
    """A cache-key form of a block parameter: arrays (per-element data) by
    content — an id() would miss fresh arrays and could alias a freed
    address onto a stale pipeline."""
    if isinstance(v, np.ndarray):
        import hashlib

        return ("ndarray", v.shape,
                hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest())
    return tuple(v) if isinstance(v, (list, tuple)) else v


def _jacobi_op(ops, r):
    return ops[0] * r


def _coarse_space(params):
    """(null space, 'Coarse Space Variant', IPOU options or None) of the
    GDSW coarse level from the parameter list."""
    nsp = params.get("Null Space Type", "laplace").lower()
    nsp = "elasticity" if "elas" in nsp else "laplace"
    variant = params.get("Coarse Space Variant", "GDSW")
    ipou = None
    if variant == "IPOUHarmonic":
        ipou = dict(pou_type=params.get("IPOU Type", "GDSWStar"),
                    vertices=bool(params.get("IPOU Vertices", True)),
                    edges=bool(params.get("IPOU Edges", True)),
                    faces=bool(params.get("IPOU Faces", True)))
    return nsp, variant, ipou


def _distributed_precond(problem, dmat, params, **coarse):
    """The shard-axis preconditioner 'Preconditioner Type' names for
    DistributedSolver: the two-level GDSW (`coarse` is its coarse-space
    feed: part / points / dofs_per_node / null_space, or blocks),
    'Jacobi', or the one-level Schwarz ('SchwarzOneLevel', the default)."""
    prec_type = params.get("Preconditioner Type", "SchwarzOneLevel")
    overlap = int(params.get("Overlap", 1))
    combine = params.get("Combine Values in Overlap", "Restricted")
    if prec_type in ("SchwarzTwoLevel", "GDSW", "TwoLevel"):
        from feddlib_tpu_torch.precond.gdsw import distributed_two_level

        _, variant, ipou = _coarse_space(params)
        cprocs = int(params.get("Coarse NumProcs", 0))
        return distributed_two_level(
            dmat, combine=combine, overlap=overlap,
            dirichlet_mask=problem.merged_dirichlet_mask(),
            variant=variant, ipou=ipou,
            coarse_procs=0 if cprocs <= 1 else cprocs,
            level_combination=params.get("Level Combination", "Additive"),
            coarse_solver=params.get("Coarse Solver", "dense"),
            coarse_tol=float(params.get("Coarse Tolerance", 1e-6)),
            coarse_maxiter=int(params.get("Coarse Max Iterations", 200)),
            **coarse)
    if prec_type == "Jacobi":
        return "jacobi"
    from feddlib_tpu_torch.precond.schwarz import distributed_schwarz

    return distributed_schwarz(dmat, overlap=overlap, combine=combine)


def point_cluster_operators(A, points, n_clusters: int, dofs_per_node: int):
    """The f32 padded operators of the mixed-precision solve of a one-field
    problem: count-median point RCB clusters (balanced ±1) of the mesh
    `points`, NodeWise dof order (dof = node*d + c).  Returns the
    `DenseBlockSpMV` and the `PaddedSplitSpMV` built on its clusters."""
    from feddlib_tpu_torch.la.dense_blocks import DenseBlockSpMV
    from feddlib_tpu_torch.la.sell import PaddedSplitSpMV
    from feddlib_tpu_torch.mesh.partition import partition_points

    cluster = np.repeat(partition_points(points, n_clusters), dofs_per_node)
    db32 = DenseBlockSpMV.from_csr(A, cluster, dtype=torch.float32)
    return db32, PaddedSplitSpMV(A, db32, dtype=torch.float32)


class Preconditioner:
    """Preconditioner factory bound to a problem: builds once, reusable
    across solves, rebuilt on request (reassembly)."""

    def __init__(self, problem):
        self.problem = problem
        self._built = False
        self._op = None  # (fn, operands), or None for the identity
        self.prec = None  # the built Schwarz object, for inspection

    def build(self, matrix) -> None:
        params = self.problem.parameter_list
        prec_type = params.get("Preconditioner Type", "SchwarzTwoLevel")
        self._op = self.prec = None
        if prec_type in ("None", "Id"):
            self._built = True
            return
        if prec_type == "Jacobi":
            d = matrix.diagonal()
            dinv = torch.where(d != 0, 1.0 / torch.where(d == 0, 1.0, d),
                               1.0)
            self._op = (_jacobi_op, (dinv,))
            self._built = True
            return
        if prec_type == "FaCSI":
            from feddlib_tpu_torch.precond.facsi import FaCSIPreconditioner

            prec = FaCSIPreconditioner(
                self.problem, self.problem.bc_system(),
                n_subdomains=int(params.get("Subdomains", 4)),
                overlap=int(params.get("Overlap", 1)))
            self.prec = prec
            self._op = prec.operator()
            self._built = True
            return
        # the Schwarz variants need the mesh partition of the first domain
        # — of its P1 parent when the leading space is P2, so all blocks
        # (e.g. u-P2 / p-P1) share one element partition
        n_sub = int(params.get("Subdomains", 4))
        overlap = int(params.get("Overlap", 1))
        combine = params.get("Combine Values in Overlap", "Restricted")
        # 'Subdomain Solver': auto | dense | sparse (dense [P,S,S] inverses
        # or the batched sparse LU of la/sparse_lu.py)
        sub_solver = params.get("Subdomain Solver", "auto")
        dom0 = self.problem.domains[0]
        base_mesh = (dom0.parent_p1.mesh if dom0.parent_p1 is not None
                     else dom0.mesh)
        part = MeshPartition(base_mesh, n_sub)
        dof_map = self._merged_dof_map(part)
        if prec_type in ("SchwarzTwoLevel", "GDSW", "TwoLevel"):
            from feddlib_tpu_torch.precond.gdsw import TwoLevelSchwarz

            nsp, variant, ipou = _coarse_space(params)
            common = dict(overlap=overlap, combine=combine,
                          dirichlet_mask=self.problem.merged_dirichlet_mask(),
                          variant=variant,
                          level_combination=params.get("Level Combination",
                                                       "Additive"),
                          subdomain_solver=sub_solver, ipou=ipou)
            if len(self.problem.variables) == 1:
                prec = TwoLevelSchwarz(
                    matrix, dof_map, part.repeated_map.partition_indices,
                    dom0.mesh.points, self.problem.total_dofs_per_node(),
                    null_space=nsp, **common)
            else:
                # monolithic block GDSW: per-block repeated maps, points,
                # dofs per node and null spaces
                prec = TwoLevelSchwarz(matrix, dof_map,
                                       blocks=self._block_specs(part, nsp),
                                       **common)
        else:  # "SchwarzOneLevel" / "Schwarz", as in the JAX package
            from feddlib_tpu_torch.precond.schwarz import \
                SchwarzPreconditioner

            prec = SchwarzPreconditioner(matrix, dof_map, overlap=overlap,
                                         combine=combine, solver=sub_solver)
        self.prec = prec
        self._op = prec.operator()
        self._built = True

    def built(self) -> bool:
        return self._built

    def apply(self):
        """M as a callable r → M r, or None for the identity."""
        if self._op is None:
            return None
        fn, ops = self._op
        return lambda r: fn(ops, r)

    def operator(self):
        """M as (fn, operands), or None for the identity."""
        return self._op

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

    def _block_specs(self, part: MeshPartition, null_space: str):
        """Per-block GDSW specs: each variable block brings its own mesh's
        per-part repeated node sets, node coordinates, dofs per node and
        null space; extra (domain-less) blocks get no coarse functions.
        Vector blocks use the elasticity null space only when asked;
        scalar blocks always use constants."""
        prob = self.problem
        offsets = np.concatenate([[0], np.cumsum(prob.block_sizes())])
        specs = []
        mesh_parts = {id(part.mesh): part}
        for b, (dom, dofs, _) in enumerate(prob.variables):
            base = dom.parent_p1 or dom
            bp = mesh_parts.get(id(base.mesh))
            if bp is None:
                bp = MeshPartition(base.mesh, part.n_parts)
                mesh_parts[id(base.mesh)] = bp
            if dom.mesh is bp.mesh:
                rep_sets = bp.repeated_map.partition_indices
            else:  # P2 child: repeated nodes = nodes touched by my elements
                rep_sets = [np.unique(dom.mesh.elements[bp.elem_ids[p]])
                            for p in range(part.n_parts)]
            nsp = null_space if (dofs > 1 and null_space == "elasticity") \
                else "laplace"
            specs.append(dict(offset=int(offsets[b]),
                              node_part_sets=rep_sets,
                              points=dom.mesh.points,
                              dofs_per_node=dofs, null_space=nsp))
        return specs


def _p2_unique_map(part: MeshPartition, dom):
    """Unique node map for a P2 domain built from the P1 partition: midpoint
    nodes are owned by the owner of their lower-numbered edge endpoint."""
    from feddlib_tpu_torch.parallel.pipeline import p2_unique_map

    return p2_unique_map(part, dom.mesh)


class LinearSolver:
    """Monolithic Krylov solve of a (block) problem."""

    def solve_system(self, problem, b: BlockVector):
        """Solve the BC-applied system for an arbitrary rhs without touching
        problem.solution.  Returns (x: BlockVector, iters)."""
        params = problem.parameter_list
        tol = float(params.get("Convergence Tolerance", 1e-8))
        maxiter = int(params.get("Maximum Iterations", 1000))
        restart = int(params.get("Num Blocks", 100))
        method = params.get("Solver Type", "gmres").lower()

        # Belos-style iteration output (XML keys Verbosity/Output Frequency)
        verbose = bool(params.get("Verbose", False)) or \
            "IterationDetails" in str(params.get("Verbosity", ""))
        out_freq = int(params.get("Output Frequency", 10))

        # a problem-owned distributed path (FSI's multi-mesh pipeline)
        # assembles and solves itself and returns the split solution
        hook = getattr(problem, "_distributed_solve_hook", None)
        if hook is not None:
            return hook(b)

        system = problem.bc_system()
        if len(problem.variables) == 1:
            A = system.get_block(0, 0)
        else:
            A = system.merge()

        if bool(params.get("Use Distributed Solve", False)):
            return self._solve_distributed(problem, A, b, params, tol,
                                           maxiter, restart, method)
        if bool(params.get("Use Mixed Precision", False)):
            return self._solve_mixed(problem, A, b, params, tol, maxiter,
                                     restart)

        from feddlib_tpu_torch.solvers.krylov import solve

        # 'Reuse Preconditioner': keep the built preconditioner across
        # reassemblies — valid since M need only approximate A⁻¹
        reuse = bool(params.get("Reuse Preconditioner", False))
        prec = problem.preconditioner
        if not prec.built() or (problem._prec_stale and not reuse):
            prec.build(A)
            problem._prec_stale = False
        A_fn, A_ops = self._auto_format_operator(A, problem, params) \
            or A.operator()
        M_fn, M_ops = prec.operator() or (None, ())
        res = solve("cg" if method == "cg" else "gmres", A_fn, A_ops,
                    b.concat(), M_fn=M_fn, M_ops=M_ops, tol=tol,
                    maxiter=maxiter, restart=restart, record_history=verbose)
        problem.last_relres = res.relres
        problem.last_history = res.history
        if verbose:
            res.print_history(label=f"Belos {method.upper()}", every=out_freq)
        if not res.converged:
            warnings.warn(f"linear solve not converged: relres={res.relres}")
        return BlockVector.split(res.x, problem.block_sizes()), res.iters

    def _auto_format_operator(self, A, problem, params):
        """Gather-free SpMV operator for the Krylov A-apply on the card
        (DIA / block-DIA, la/dia.py): banded operators stream their
        diagonals with unit-stride reads where the default ELL apply
        gathers.  Returns (fn, ops), or None for a non-banded pattern, a
        matrix on the CPU (as the JAX package does on its CPU backend), or
        'SpMV Format': 'ell'.

        The Krylov vectors here are NodeWise interleaved, so block formats
        run through their interleaved operator() and pay two transposes
        per apply.  The format object is cached on the problem and
        refreshed with `with_data` across reassemblies."""
        if params.get("SpMV Format", "auto") != "auto":
            return None
        if A.device.type == "cpu" or A.shape[0] != A.shape[1]:
            return None
        cache = getattr(problem, "_autofmt", None)
        if cache is not None and cache["pattern"] is A.pattern:
            if cache["fmt"] is None:
                return None
            if cache["data"] is not A.data:
                cache["fmt"] = cache["fmt"].with_data(A.data)
                cache["data"] = A.data
            return cache["fmt"].operator()
        from feddlib_tpu_torch.la.dia import BlockDiaMatrix, DiaMatrix

        # the f64 guard is 16 B/nnz: the ELL apply streams 12 B/nnz but
        # gathers x — 1.3x more bytes with unit stride wins
        guard = 16.0 if A.dtype == torch.float64 else 8.0
        fmt = None
        if len(problem.variables) == 1:
            d = int(problem.variables[0][1])
            if d > 1:
                fmt = BlockDiaMatrix.from_csr(A, d, dtype=A.dtype,
                                              max_bytes_per_nnz=guard)
        if fmt is None:
            fmt = DiaMatrix.from_csr(A, dtype=A.dtype,
                                     max_bytes_per_nnz=guard)
        problem._autofmt = {"pattern": A.pattern, "fmt": fmt,
                            "data": A.data}
        return None if fmt is None else fmt.operator()

    def _solve_mixed(self, problem, A, b: BlockVector, params, tol,
                     maxiter, restart):
        """f64 residual refinement around an f32 inner GMRES — padded SELL
        SpMV + dense-block restricted Schwarz (+ padded GDSW coarse level),
        the whole inner loop in PADDED cluster space."""
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
        # problem and reused while the matrix pattern is unchanged
        cache = getattr(problem, "_mixed_cache", None)
        if (cache is not None and cache["pattern"] is A.pattern
                and problem._prec_stale
                and bool(params.get("Reuse Preconditioner", True))):
            # reassembly with an unchanged pattern: refresh the OPERATOR
            # values on the device (with_data) and keep the factorized
            # Schwarz/coarse level — M need only approximate A⁻¹, and the
            # f64 outer refinement guards accuracy.  'Reuse
            # Preconditioner': False forces the full rebuild.
            sell32 = cache["sell"].with_data(A.data)
            cache["sell"] = sell32
            cache["A_op"] = sell32.operator()
            problem._prec_stale = False
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
                db32, sell32 = point_cluster_operators(
                    A, dom0.mesh.points, n_clusters, d0)
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

    def _solve_distributed(self, problem, A, b: BlockVector, params, tol,
                           maxiter, restart, method):
        """Solve the merged system over a shard axis: owned-row shards of
        A stacked on the problem's device, halo imports, the distributed
        Schwarz (one level, or two with the GDSW coarse level) and the
        Krylov loop with its dots over every shard.  The axis comes from
        `multihost.global_device_axis`: inside a program of several ranks
        (parallel/multihost.py) each rank holds its range of the shards on
        its own device, and every rank must make the same call.

        'Devices' is the shard count; it defaults to
        `multihost.default_shards`: one shard a rank with several ranks,
        else the device count of the problem's device type (the JAX
        package's len(jax.devices()), 8 virtual devices in its test
        harness), so tests and the card's smoke run pass it.  The shards,
        plans and preconditioner are cached on the problem (`_dist_cache`) while A's pattern is unchanged and
        the preconditioner is not stale.  With 'Use Device Pipeline' and a
        problem that has `pipeline_blocks`, `_solve_pipeline` assembles
        the shards on the device instead."""
        from feddlib_tpu_torch.parallel import multihost
        from feddlib_tpu_torch.parallel.solve import DistributedSolver
        from feddlib_tpu_torch.parallel.spmd import (DistributedCsr,
                                                     lane_index, local_lanes)

        dev = problem.device
        n_dev = int(params.get("Devices", multihost.default_shards(dev)))
        hook = getattr(problem, "pipeline_blocks", None)
        if hook is not None and bool(params.get("Use Device Pipeline",
                                                False)):
            return self._solve_pipeline(problem, hook(), b, params, tol,
                                        maxiter, restart, method, n_dev)
        cache = getattr(problem, "_dist_cache", None)
        if (cache is None or cache["pattern"] is not A.pattern
                or problem._prec_stale):
            dom0 = problem.domains[0]
            base_mesh = (dom0.parent_p1.mesh if dom0.parent_p1 is not None
                         else dom0.mesh)
            t0 = time.perf_counter()
            part = MeshPartition(base_mesh, n_dev)
            dof_map = problem.preconditioner._merged_dof_map(part)
            t_p = time.perf_counter()
            axis = multihost.global_device_axis(n_dev, dev)
            dmat = DistributedCsr(A, dof_map, axis=axis)
            t1 = time.perf_counter()
            solver = DistributedSolver(dmat, axis)
            nsp, _, _ = _coarse_space(params)
            # the coarse-space feed: one field's partition, points and dofs
            # per node, or the monolithic block GDSW of the serial path
            precond = _distributed_precond(
                problem, dmat, params,
                **(dict(part=part, points=dom0.mesh.points,
                        dofs_per_node=problem.total_dofs_per_node(),
                        null_space=nsp) if len(problem.variables) == 1
                   else dict(blocks=problem.preconditioner._block_specs(
                       part, nsp))))
            # the stacked lane of each global dof, for the vector scatter /
            # gather on the device (the rank's own, and all of them)
            gids, lanes = local_lanes(dof_map, dmat.plan.N_o, axis)
            g_all, l_all = lane_index(dof_map, dmat.plan.N_o)
            xdev = axis.device
            cache = {"pattern": A.pattern, "dmat": dmat, "solver": solver,
                     "precond": precond, "dof_map": dof_map,
                     "gids": torch.as_tensor(gids, device=xdev),
                     "lanes": torch.as_tensor(lanes, device=xdev),
                     "gids_all": torch.as_tensor(g_all, device=xdev),
                     "lanes_all": torch.as_tensor(l_all, device=xdev),
                     "timings": {"partition_s": t_p - t0,
                                 "dmat_s": t1 - t_p,
                                 "precond_s": time.perf_counter() - t1}}
            problem._dist_cache = cache
            problem._prec_stale = False
        dmat, solver = cache["dmat"], cache["solver"]
        gids, lanes = cache["gids"], cache["lanes"]
        axis = solver.axis
        bf = b.concat().to(axis.device)
        b_dist = bf.new_zeros(axis.n_local * dmat.plan.N_o)
        b_dist[lanes] = bf[gids]
        x, iters, rel = solver.solve(
            b_dist.view(axis.n_local, -1),
            method="cg" if method == "cg" else "gmres", tol=tol,
            maxiter=maxiter, restart=restart, precond=cache["precond"])
        problem.last_relres = rel
        if rel > tol:
            warnings.warn(f"distributed solve not converged: relres={rel}")
        if axis.group is not None:  # every rank gets the whole solution
            x = axis.all_gather(x)
            gids, lanes = cache["gids_all"], cache["lanes_all"]
        xg = bf.new_zeros(bf.shape[0])
        xg[gids] = x.reshape(-1)[lanes]
        return (BlockVector.split(xg.to(dev), problem.block_sizes()),
                iters)

    def _solve_pipeline(self, problem, pblocks, b: BlockVector, params,
                        tol, maxiter, restart, method, n_dev):
        """The device-resident chain of 'Use Device Pipeline': the
        pipeline assembles the shards from the problem's block kernels
        (no global matrix), Dirichlet rows are eliminated on the shards,
        and the distributed preconditioner and Krylov loop solve.

        The pipeline is cached on the problem (`_pipe_cache`) under a key
        of the block kinds and parameters (per-element data by content)
        and the shard count; the solution and the RHS ride their shard
        mirrors (`BlockVector._dist_mirror`), so a Newton loop uploads the
        solution once."""
        from feddlib_tpu_torch.parallel import multihost
        from feddlib_tpu_torch.parallel.pipeline import DistributedPipeline

        pkey = (tuple((i, j, kind, tuple(sorted((k, _hashable(v))
                                                for k, v in prm.items())))
                      for i, j, kind, prm in pblocks), n_dev)
        pc = getattr(problem, "_pipe_cache", None)
        if pc is None or pc["key"] != pkey:
            dom0 = problem.domains[0]
            base_mesh = (dom0.parent_p1.mesh if dom0.parent_p1 is not None
                         else dom0.mesh)
            t0 = time.perf_counter()
            part = MeshPartition(base_mesh, n_dev)
            t1 = time.perf_counter()
            pipe = DistributedPipeline(
                part, [(dom, dofs) for dom, dofs, _ in problem.variables])
            for i, j, kind, prm in pblocks:
                pipe.add_block(i, j, kind, **prm)
            pipe.finalize(multihost.global_device_axis(n_dev,
                                                       problem.device))
            pc = {"key": pkey, "pipe": pipe, "part": part,
                  "timings": {"partition_s": t1 - t0,
                              "finalize_s": time.perf_counter() - t1}}
            problem._pipe_cache = pc
        pipe = pc["pipe"]
        x_dist = None
        if (problem.solution is not None
                and any(k in ("advection", "advection_in_u", "hyperelastic")
                        for _, _, k, _ in pblocks)):
            # the solution's shards: Newton / time updates propagate them
            # (BlockVector.axpy), so only the first assembly uploads
            mir = problem.solution._dist_mirror
            if mir is not None and mir[0] is pipe:
                x_dist = mir[1]
            else:
                x_dist = pipe.distribute(problem.solution.concat())
                problem.solution._dist_mirror = (pipe, x_dist)
        dmat = pipe.assemble(x=x_dist)
        dmat, _ = pipe.apply_dirichlet(dmat, None,
                                       problem.merged_dirichlet_mask())
        bmir = b._dist_mirror
        b_dist = (bmir[1] if bmir is not None and bmir[0] is pipe
                  else pipe.distribute(b.concat()))
        x, iters, rel = self._dist_precond_solve(
            problem, dmat, b_dist, params, tol, maxiter, restart, method,
            pipe.axis, pipe.block_specs(
                params.get("Null Space Type", "laplace").lower()))
        problem.last_relres = rel
        if rel > tol:
            warnings.warn(f"distributed solve not converged: relres={rel}")
        out = BlockVector.split(pipe.gather(x), problem.block_sizes())
        out._dist_mirror = (pipe, x)
        return out, iters

    def _dist_precond_solve(self, problem, dmat, b_dist, params, tol,
                            maxiter, restart, method, axis, block_specs):
        """The preconditioner build and the Krylov loop of the pipeline
        path.  The preconditioner and the solver are cached on the problem
        (`_pipe_prec`) and reused while not stale and on the same halo
        plan; the matrix values always come from the fresh dmat."""
        from feddlib_tpu_torch.parallel.solve import DistributedSolver

        cache = getattr(problem, "_pipe_prec", None)
        if (cache is None or problem._prec_stale
                or cache["plan"] is not dmat.plan):
            t0 = time.perf_counter()
            precond = _distributed_precond(problem, dmat, params,
                                           blocks=block_specs)
            cache = {"plan": dmat.plan, "precond": precond,
                     "solver": DistributedSolver(dmat, axis),
                     "precond_s": time.perf_counter() - t0}
            problem._pipe_prec = cache
            problem._prec_stale = False
        solver = cache["solver"]
        solver.dmat = dmat  # fresh values, the same plan and shapes
        return solver.solve(b_dist, method="cg" if method == "cg"
                            else "gmres", tol=tol, maxiter=maxiter,
                            restart=restart, precond=cache["precond"])

    def solve(self, problem, rhs=None) -> int:
        x, iters = self.solve_system(
            problem, rhs if rhs is not None else problem.rhs)
        problem.solution = x
        return iters
