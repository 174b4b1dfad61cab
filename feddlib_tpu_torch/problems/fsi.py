"""Monolithic fluid–structure interaction — counterpart of
feddlib_tpu/problems/fsi.py.

Geometry-explicit (GE) formulation with conforming interface meshes.
Unknowns per time step  x = (u, p, d, λ):
  block 0: fluid velocity  u   (P2 on the fluid mesh, ALE/moving)
  block 1: fluid pressure  p   (P1 fluid mesh)
  block 2: solid displacement d (P2 solid mesh)
  block 3: interface traction  λ (matched interface nodes × dim)

Coupling blocks are nodal identities on the matched interface:
  (3,0)  C1 = I_Γ(u)              kinematic constraint rows
  (3,2)  C2 = −(1/dt) I_Γ(d)     → u = (d − dⁿ)/dt on Γ
  (0,3)  C1ᵀ                      traction on the fluid
  (2,3)  C3ᵀ = −I_Γ(d)ᵀ          action–reaction on the solid

Per GE step: solve the geometry problem from the current interface
displacement → move the fluid mesh (ALE) → reassemble the fluid operators
with ALE convection N(u−w) → Newton-solve the monolithic four-block system
with the BDF fluid mass and the Newmark solid → update the histories.

The geometry-implicit (GI) loop `advance_gi` adds the mesh displacement g
as a fifth field, with the shape-derivative blocks of
fe/shape_derivatives.py.

With 'Use Distributed Solve' ('Devices', 'Solid Devices') every Newton
Jacobian of either loop is assembled on the shard axis by a multi-mesh
DistributedPipeline (parallel/pipeline.py: the fluid on shards [0, nf),
the solid on [nf, n_dev), λ on shard 0, the interface identities as
constant couplings), no global matrix formed, and solved with the
distributed FaCSI (precond/facsi.py) through `_distributed_solve_hook`.
The pipeline is built once per dt: moved meshes enter as vertex
coordinates, the solution rides its shard mirror across Newton steps.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from feddlib_tpu_torch.fe import assembly as asm
from feddlib_tpu_torch.fe import ops
from feddlib_tpu_torch.fe.domain import Domain
from feddlib_tpu_torch.la.block import BlockMatrix, BlockVector
from feddlib_tpu_torch.la.csr import CsrMatrix, SparsityPattern
from feddlib_tpu_torch.mesh.interface import MeshInterface, determine_interface
from feddlib_tpu_torch.precond.facsi import _rows_to_identity
from feddlib_tpu_torch.problems.base import NonLinearProblem
from feddlib_tpu_torch.problems.geometry import Geometry
from feddlib_tpu_torch.problems.nonlin_elasticity import assemble_hyper
from feddlib_tpu_torch.utils import timers

# elements per chunk of the GI residual
_CHUNK = 16384


def _interface_identity(n_rows: int, n_cols: int, rows: np.ndarray,
                        cols: np.ndarray, scale: float, device) -> CsrMatrix:
    m = CsrMatrix(SparsityPattern.from_coo(rows, cols, n_rows, n_cols),
                  device=device)
    m.assemble(torch.full((len(rows),), scale, dtype=torch.float64,
                          device=m.device))
    return m


class FSI(NonLinearProblem):
    def __init__(self, domain_u: Domain, domain_p: Domain,
                 domain_d: Domain, interface_flags: Sequence[int],
                 parameter_list=None, geometry_params=None, device="cuda"):
        super().__init__(parameter_list, device=device)
        dim = domain_u.dim
        self.dim = dim
        self.add_variable(domain_u, dim, "u")
        self.add_variable(domain_p, 1, "p")
        self.add_variable(domain_d, dim, "d")

        # matched interface (fluid P2 mesh ↔ solid P2 mesh)
        self.interface: MeshInterface = determine_interface(
            domain_u.mesh, domain_d.mesh, interface_flags)
        self.n_lam = self.interface.n_nodes * dim

        pl = self.parameter_list
        self.viscosity = float(pl.get("Viscosity", 1.0))
        self.density_f = float(pl.get("Density Fluid", 1.0))
        self.density_s = float(pl.get("Density Solid", 1.0))
        mu, lam_ = ops.lame_parameters(float(pl.get("E", 1.0)),
                                       float(pl.get("Poisson Ratio", 0.3)))
        self.mu_s, self.lam_s = mu, lam_
        self.newmark_beta = float(pl.get("beta", 0.25))
        self.newmark_gamma = float(pl.get("gamma", 0.5))
        # 'Material Model': linear | Neo-Hooke | Mooney-Rivlin | StVK
        self.material = pl.get("Material Model", "linear")
        if self.material == "Mooney-Rivlin":
            self.params_s = (float(pl.get("C1", mu / 4.0)),
                             float(pl.get("C2", mu / 4.0)),
                             float(pl.get("Kappa", lam_ + 2 * mu / 3.0)))
        else:
            self.params_s = (mu, lam_)

        # mesh motion on the fluid mesh; the outer boundary held fixed is
        # flag 1 unless 'Geometry Boundary Flags' lists others
        self.geometry = Geometry(domain_u, parameter_list=geometry_params,
                                 device=self.device)
        self.geometry_boundary_flags = tuple(
            pl.get("Geometry Boundary Flags", (1,)))
        domain_u.mesh.save_reference_configuration()

        # interface coupling matrices (nodal identities, built once)
        iface_f, iface_s = self.interface.nodes_a, self.interface.nodes_b
        comp = np.tile(np.arange(dim), self.interface.n_nodes)
        rows = np.repeat(np.arange(self.interface.n_nodes), dim) * dim + comp
        uf_cols = np.repeat(iface_f, dim) * dim + comp
        ds_cols = np.repeat(iface_s, dim) * dim + comp
        self._iface_rows, self._uf_cols, self._ds_cols = rows, uf_cols, ds_cols
        n_u = domain_u.n_dofs(dim)
        self.C1 = _interface_identity(self.n_lam, n_u, rows, uf_cols, 1.0,
                                      self.device)
        self.C1T = self.C1.transpose()
        self._ident = {}  # the other interface identities, built on demand
        dev = self.device
        self._t_rows = torch.as_tensor(rows, device=dev)
        self._t_uf = torch.as_tensor(uf_cols, device=dev)
        self._t_ds = torch.as_tensor(ds_cols, device=dev)

        # state
        self.dt = float(pl.get("dt", 0.01))
        self.solid_v = None
        self.solid_a = None
        self.u_prev = None
        self.g_prev = None  # previous mesh displacement (mesh velocity)

    def _identity(self, key, n_rows, n_cols, rows, cols, scale):
        m = self._ident.get(key)
        if m is None:
            m = _interface_identity(n_rows, n_cols, rows, cols, scale,
                                    self.device)
            self._ident[key] = m
        return m

    def _zeros(self, n):
        return torch.zeros(n, dtype=torch.float64, device=self.device)

    def init_vectors(self):
        sizes = self.block_sizes()
        if self.rhs is None:
            self.rhs = BlockVector.zeros(sizes, device=self.device)
        if self.solution is None:
            self.solution = BlockVector.zeros(sizes, device=self.device)
        if self.solid_v is None:
            self.solid_v = self._zeros(sizes[2])
            self.solid_a = self._zeros(sizes[2])
            self.u_prev = self._zeros(sizes[0])

    # -- assembly ------------------------------------------------------------
    def assemble(self) -> None:
        dom_d = self.variables[2][0]
        self._assemble_fluid_constant()
        self.Ks = ops.assemble_lin_elasticity(dom_d, self.mu_s, self.lam_s)
        self.Ms = ops.assemble_mass(dom_d, self.dim).scale(self.density_s)
        self.geometry.assemble()
        self.init_vectors()

    def _assemble_fluid_constant(self) -> None:
        """(Re)assemble the mesh-dependent fluid operators — after every
        mesh move."""
        dom_u, dom_p = self.variables[0][0], self.variables[1][0]
        self.Af = ops.assemble_laplace_vec(dom_u, self.viscosity)
        self.Bf, self.BfT = ops.assemble_divergence(dom_u, dom_p)
        self.Mf = ops.assemble_mass(dom_u, self.dim).scale(self.density_f)

    def _solid_forces_tangent(self, d: torch.Tensor):
        """Hyperelastic internal forces and consistent tangent at d
        (fe/hyperelastic.py, torch.func)."""
        return assemble_hyper(self.variables[2][0], d, self.material,
                              self.params_s)

    def _solid_internal(self, d: torch.Tensor) -> torch.Tensor:
        if self.material == "linear":
            return self.Ks.matvec(d)
        return self._solid_forces_tangent(d)[0]

    def _build_system(self, mode: str, w: torch.Tensor, beta0_dt: float,
                      newmark_m: float,
                      P: Optional[CsrMatrix] = None) -> None:
        dom_u = self.variables[0][0]
        u = self.solution[0]
        N = ops.assemble_advection(dom_u, (u - w) * self.density_f)
        Auu = self.Mf.scale(beta0_dt).add(self.Af).add(N)
        if P is not None:  # ALE additional convection −ρ(∇·w)u·v
            Auu = Auu.add(P)
        if mode == "Newton":
            Auu = Auu.add(ops.assemble_advection_in_u(dom_u,
                                                      u * self.density_f))
        if self.material == "linear":
            Add = self.Ms.scale(newmark_m).add(self.Ks)
        else:
            _, KT = self._solid_forces_tangent(self.solution[2])
            Add = self.Ms.scale(newmark_m).add(KT)
        sizes = self.block_sizes()
        S = BlockMatrix(sizes)
        S.add_block(0, 0, Auu)
        S.add_block(0, 1, self.BfT)
        S.add_block(1, 0, self.Bf)
        S.add_block(0, 3, self.C1T)
        S.add_block(2, 2, Add)
        S.add_block(2, 3, self._identity(
            "C3T", sizes[2], self.n_lam, self._ds_cols, self._iface_rows,
            -1.0))
        S.add_block(3, 0, self.C1)
        S.add_block(3, 2, self._identity(
            ("C2", self.dt), self.n_lam, sizes[2], self._iface_rows,
            self._ds_cols, -1.0 / self.dt))
        self.system = S
        self._prec_stale = True

    def _solid_update(self, d_old, v_old, a_old, newmark_m):
        """Newmark velocity and acceleration after a step."""
        be, ga, dt = self.newmark_beta, self.newmark_gamma, self.dt
        a_new = ((self.solution[2] - d_old) * newmark_m - v_old / (be * dt)
                 - (0.5 / be - 1.0) * a_old)
        self.solid_v = v_old + dt * (1 - ga) * a_old + dt * ga * a_new
        self.solid_a = a_new

    def _solid_history(self, d_old, v_old, a_old, newmark_m):
        be, dt = self.newmark_beta, self.dt
        return self.Ms.matvec(d_old * newmark_m + v_old / (be * dt)
                              + (0.5 / be - 1.0) * a_old)

    def _solid_residual(self, d, lam, newmark_m, solid_hist):
        Fd = (self.Ms.matvec(d) * newmark_m + self._solid_internal(d)
              - solid_hist)
        return Fd.index_add(0, self._t_ds, -lam[self._t_rows])

    def _lam_rows(self, vals):
        out = self._zeros(self.n_lam)
        out[self._t_rows] = vals
        return out

    def _solve_step(self, solver, t_new, residual, reassemble,
                    distributed: bool = False) -> None:
        """Newton on the step's residual and reassembly, swapped onto the
        instance for the step (NonLinearSolver calls them through it);
        `distributed` routes its linear solves to `_fsi_dist_solve`."""
        base_res, base_rea = self.calculate_residual, self.reassemble
        self.calculate_residual = residual
        self.reassemble = reassemble
        if distributed:
            self._distributed_solve_hook = self._fsi_dist_solve
        try:
            solver.solve(self, t_new)
        finally:
            self.calculate_residual = base_res
            self.reassemble = base_rea
            self._distributed_solve_hook = None

    # -- distributed device-resident system ----------------------------------
    def _pipeline_parts(self, n_dev: int, solid_devices: Optional[int]):
        """(fluid partition, solid partition, nf) over the shard axis: the
        fluid mesh on shards [0, nf), the solid on [nf, n_dev)."""
        from feddlib_tpu_torch.mesh.partition import MeshPartition

        dom_u, dom_d = self.variables[0][0], self.variables[2][0]
        ns = solid_devices if solid_devices is not None else max(
            1, n_dev // 4)
        nf = n_dev - ns
        if nf < 1 or ns < 1:
            raise ValueError("need at least one fluid and one solid device")
        return (MeshPartition((dom_u.parent_p1 or dom_u).mesh, nf),
                MeshPartition((dom_d.parent_p1 or dom_d).mesh, ns), nf)

    def _add_ge_blocks(self, pipe) -> None:
        """The GE four-field Jacobian's element blocks and couplings."""
        dim = self.dim
        beta0_dt = 1.0 / self.dt
        newmark_m = 1.0 / (self.newmark_beta * self.dt * self.dt)
        # fluid momentum: ρ/dt M + A + N(ρ(u−w)) + W(ρu) − ρ(∇·w)M̃
        pipe.add_block(0, 0, "mass", coeff=self.density_f * beta0_dt,
                       dofs_per_node=dim)
        pipe.add_block(0, 0, "laplace_vec", viscosity=self.viscosity)
        # N(ρ(u−w)) split by linearity into N(ρu) (the solution shards, no
        # upload a Newton step) − N(ρw) (w changes once a time step)
        pipe.add_block(0, 0, "advection", coeff=self.density_f)
        pipe.add_block(0, 0, "advection", coeff=-self.density_f,
                       field_src="ext:w")
        pipe.add_block(0, 0, "advection_in_u", coeff=self.density_f)
        pipe.add_block(0, 0, "ale_divergence", coeff=-self.density_f,
                       field_src="ext:w")
        pipe.add_block(0, 1, "divergence_T")
        pipe.add_block(1, 0, "divergence")
        # solid: Newmark mass + material tangent
        pipe.add_block(2, 2, "mass", coeff=self.density_s * newmark_m,
                       dofs_per_node=dim)
        if self.material == "linear":
            pipe.add_block(2, 2, "lin_elasticity", mu=self.mu_s,
                           lam=self.lam_s)
        else:
            pipe.add_block(2, 2, "hyperelastic", material=self.material,
                           mat_params=self.params_s)

    def _add_couplings(self, pipe) -> None:
        """The interface identities C1ᵀ, C1, C3ᵀ, C2 as constant entries."""
        ones = np.ones(len(self._iface_rows))
        pipe.add_coo_block(0, 3, self._uf_cols, self._iface_rows, ones)
        pipe.add_coo_block(3, 0, self._iface_rows, self._uf_cols, ones)
        pipe.add_coo_block(2, 3, self._ds_cols, self._iface_rows, -ones)
        pipe.add_coo_block(3, 2, self._iface_rows, self._ds_cols,
                           -ones / self.dt)

    def build_pipeline(self, n_dev: int, solid_devices: Optional[int] = None,
                       axis=None):
        """Multi-mesh DistributedPipeline of the GE four-field Jacobian:
        fluid (u P2, p P1) on shards [0, nf), solid (d P2) on [nf, n_dev),
        λ owned by shard 0; the interface identities enter as constant
        couplings, the (3,2) factor −1/dt baked into the plan (rebuilt if
        dt changes)."""
        from feddlib_tpu_torch.parallel import multihost
        from feddlib_tpu_torch.parallel.pipeline import DistributedPipeline

        dom_u, dom_p = self.variables[0][0], self.variables[1][0]
        dom_d = self.variables[2][0]
        dim = self.dim
        part_f, part_s, nf = self._pipeline_parts(n_dev, solid_devices)
        pipe = DistributedPipeline(
            part_f, [(dom_u, dim, 0), (dom_p, 1, 0), (dom_d, dim, 1),
                     {"extra": self.n_lam, "owner": 0}],
            aux_parts=[{"part": part_s, "range": (nf, n_dev)}])
        self._add_ge_blocks(pipe)
        self._add_couplings(pipe)
        pipe.finalize(axis or multihost.global_device_axis(n_dev,
                                                           self.device))
        return pipe

    def assemble_distributed(self, pipe, w=None):
        """One device-resident GE Jacobian (mode 'Newton') at the current
        solution, no global matrix formed.  `w` is the mesh velocity on
        the fluid velocity space (zeros if None)."""
        n_u = self.variables[0][0].n_dofs(self.dim)
        ext = {"w": pipe.distribute_field(
            0, np.zeros(n_u) if w is None else w)}
        x = pipe.distribute(self.solution.concat()
                            if self.solution is not None
                            else np.zeros(int(pipe.offsets[-1])))
        return pipe.assemble(x=x, ext_fields=ext)

    def _dist_devices(self):
        """('Devices', 'Solid Devices'): the shard count defaults to
        `multihost.default_shards` (one a rank inside a program of ranks)."""
        from feddlib_tpu_torch.parallel import multihost

        pl = self.parameter_list
        sdev = pl.get("Solid Devices", None)
        n_dev = pl.get("Devices", None)
        if n_dev is None:
            n_dev = multihost.default_shards(self.device)
        return (int(n_dev),
                None if sdev is None else int(sdev))

    def _ensure_pipeline(self, n_dev: int, solid_devices: Optional[int]):
        """The cached multi-mesh pipeline of the distributed GE loop: the
        plans are coordinate-independent (one build serves every mesh
        move); a new dt rebuilds (its −1/dt couplings are plan
        constants).  A build opens the synchronised span `fsi.pipeline`
        (utils/timers.py), as the GI loop's does."""
        key = (n_dev, solid_devices, self.dt)
        cache = getattr(self, "_pipe_ge", None)
        if cache is None or cache["key"] != key:
            with timers.timer("fsi.pipeline", sync=True):
                pipe = self.build_pipeline(n_dev,
                                           solid_devices=solid_devices)
            cache = {"key": key, "pipe": pipe, "prec": None, "solver": None,
                     "locator": None, "builds": 0}
            self._pipe_ge = cache
        return cache

    def _dist_finish(self, cache, dmat) -> None:
        """The shared tail of the distributed reassemblies: Dirichlet rows,
        the plan-static locator, the FaCSI build or refresh (one
        synchronised span `facsi.setup` each, utils/timers.py), the
        solver's new values."""
        from feddlib_tpu_torch.parallel.solve import DistributedSolver
        from feddlib_tpu_torch.precond.facsi import distributed_facsi

        pipe = cache["pipe"]
        dmat, _ = pipe.apply_dirichlet(dmat, None,
                                       self.merged_dirichlet_mask())
        if cache["locator"] is None:
            cache["locator"] = dmat.locator()
        else:  # the symbolic pattern is plan-static
            dmat._locator = cache["locator"]
        pl = self.parameter_list
        with timers.timer("facsi.setup", sync=True):
            if cache["prec"] is None:
                cache["prec"] = distributed_facsi(
                    dmat, pipe.offsets, self._uf_cols, self._ds_cols,
                    self._iface_rows, self.dt,
                    overlap=int(pl.get("Overlap", 1)))
                cache["builds"] += 1
            elif not bool(pl.get("Reuse Preconditioner", False)):
                build, _ = cache["prec"]
                cache["prec"] = (build, build.refresh(dmat))
        if cache["solver"] is None:
            cache["solver"] = DistributedSolver(dmat, pipe.axis)
        else:
            cache["solver"].dmat = dmat  # fresh values, identical plans

    def _solution_shards(self, pipe):
        """The solution's shards: its mirror, else one upload."""
        mir = self.solution._dist_mirror
        if mir is not None and mir[0] is pipe:
            return mir[1]
        x = pipe.distribute(self.solution.concat())
        self.solution._dist_mirror = (pipe, x)
        return x

    def _dist_reassemble(self, cache, w: torch.Tensor) -> None:
        """Device-resident GE Jacobian at the current Newton iterate on the
        moved (ALE) fluid mesh; the serial merged system is never
        formed."""
        pipe = cache["pipe"]
        dom_u = self.variables[0][0]
        # w and the moved coordinates change once a TIME step
        if cache.get("w_obj") is not w:
            cache["w_ext"] = {"w": pipe.distribute_field(0, w)}
            cache["w_obj"] = w
            cache["vc"] = pipe.mesh_vert_coords(0, dom_u.mesh.points)
        dmat = pipe.assemble(x=self._solution_shards(pipe),
                             ext_fields=cache["w_ext"],
                             vert_coords={0: cache["vc"]})
        self._dist_finish(cache, dmat)

    def _dist_reassemble_gi(self, cache, gp_vec, u_old) -> None:
        """Device-resident five-field GI Jacobian at the current Newton
        iterate: the fluid blocks on the moved (ref + g) coordinates, the
        shape blocks differentiated around the reference configuration —
        no serial system, no host mesh move."""
        pipe = cache["pipe"]
        dom_u = self.variables[0][0]
        if cache.get("step_obj") is not gp_vec:  # per-time-step fields
            cache["gp_ext"] = pipe.distribute_field(4, gp_vec)
            cache["uold_ext"] = pipe.distribute_field(0, u_old)
            cache["step_obj"] = gp_vec
        g = self.solution[4]
        ext = {"w": pipe.distribute_field(0, (g - gp_vec) / self.dt),
               "gp": cache["gp_ext"], "uold": cache["uold_ext"]}
        vc = pipe.mesh_vert_coords(
            0, dom_u.mesh.ref_points + g.cpu().numpy().reshape(-1, self.dim))
        dmat = pipe.assemble(x=self._solution_shards(pipe), ext_fields=ext,
                             vert_coords={0: vc})
        self._dist_finish(cache, dmat)

    def _fsi_dist_solve(self, b):
        """The `_distributed_solve_hook` of Newton's linear solve: J δ = b
        by the shard-axis GMRES with the distributed FaCSI."""
        cache = self._dist_active
        pipe = cache["pipe"]
        pl = self.parameter_list
        tol = float(pl.get("Convergence Tolerance", 1e-8))
        x, iters, rel = cache["solver"].solve(
            pipe.distribute(b.concat()), method="gmres", tol=tol,
            maxiter=int(pl.get("Maximum Iterations", 1000)),
            restart=int(pl.get("Num Blocks", 200)), precond=cache["prec"])
        self.last_relres = rel
        if rel > tol:
            warnings.warn(f"distributed FSI solve: relres={rel}")
        out = BlockVector.split(pipe.gather(x), self.block_sizes())
        # δ carries its shards: the Newton update (BlockVector.axpy) moves
        # them into the solution's mirror, no upload
        out._dist_mirror = (pipe, x)
        return out, iters

    # -- time loop (GE) -------------------------------------------------------
    def advance(self, t_end: float, source_f: Optional[Callable] = None,
                observer: Optional[Callable] = None,
                newton_method: str = "Newton") -> None:
        from feddlib_tpu_torch.solvers.nonlinear import NonLinearSolver

        dom_u = self.variables[0][0]
        dim, dt = self.dim, self.dt
        self.init_vectors()
        t = 0.0
        solver = NonLinearSolver(newton_method)
        self.nonlinear_solver = solver
        if self.g_prev is None:
            self.g_prev = np.zeros((dom_u.n_nodes, dim))
        # distributed: every Newton Jacobian assembles on the shard axis
        # through the multi-mesh pipeline and solves with distributed FaCSI
        dist_cache = None
        if bool(self.parameter_list.get("Use Distributed Solve", False)):
            if newton_method != "Newton":
                raise ValueError("the distributed FSI pipeline registers "
                                 "the Newton linearisation W(u); use "
                                 "newton_method='Newton'")
            dist_cache = self._ensure_pipeline(*self._dist_devices())
            self._dist_active = dist_cache

        while t < t_end - 1e-12:
            t_new = t + dt
            # 1) geometry: harmonic extension of the interface displacement
            d_np = self.solution[2].cpu().numpy().reshape(-1, dim)
            with timers.timer("fsi.geometry", sync=True):
                g = self.geometry.solve_motion(
                    self.interface.nodes_a, d_np[self.interface.nodes_b],
                    boundary_flags=self.geometry_boundary_flags)
            # 2) ALE move + mesh velocity w
            dom_u.mesh.move(g)
            dom_u.invalidate_geometry()
            self._assemble_fluid_constant()
            w = torch.as_tensor((g - self.g_prev).ravel() / dt,
                                dtype=torch.float64, device=self.device)
            self.g_prev = g
            # ALE additional convection P = −ρ ∫(∇·w) u·v, constant within
            # the GE step (w fixed)
            Pmat = ops.assemble_ale_divergence(dom_u, w).scale(
                -self.density_f)

            # 3) histories
            d_old = self.solution[2]
            v_old, a_old = self.solid_v, self.solid_a
            u_old = self.solution[0]
            newmark_m = 1.0 / (self.newmark_beta * dt * dt)
            solid_hist = self._solid_history(d_old, v_old, a_old, newmark_m)
            fluid_hist = self.Mf.matvec(u_old) * (1.0 / dt)
            lam_hist = self._lam_rows(-d_old[self._t_ds] / dt)
            fsrc = (ops.assemble_rhs(dom_u, lambda x: source_f(x, t_new),
                                     dim) if source_f else
                    self._zeros(self.block_sizes()[0]))

            prob = self

            def residual(tt=0.0):
                u, p, d, lam = (prob.solution[i] for i in range(4))
                Nmat = ops.assemble_advection(dom_u,
                                              (u - w) * prob.density_f)
                Fu = (prob.Mf.matvec(u) * (1.0 / dt) + prob.Af.matvec(u)
                      + Nmat.matvec(u) + Pmat.matvec(u) + prob.BfT.matvec(p)
                      + prob.C1T.matvec(lam) - fluid_hist - fsrc)
                Fp = prob.Bf.matvec(u)
                Fd = prob._solid_residual(d, lam, newmark_m, solid_hist)
                Flam = prob._lam_rows(u[prob._t_uf] - d[prob._t_ds] / dt) \
                    - lam_hist
                r = BlockVector([Fu, Fp, Fd, Flam])
                return prob.bc_builder.set_vector_minus_bc(
                    r, prob.solution, tt)

            def reassemble(mode="Newton"):
                if dist_cache is not None:
                    prob._dist_reassemble(dist_cache, w)
                else:
                    prob._build_system(mode, w, 1.0 / dt, newmark_m, P=Pmat)

            self._solve_step(solver, t_new, residual, reassemble,
                             distributed=dist_cache is not None)

            # 4) Newmark updates
            self._solid_update(d_old, v_old, a_old, newmark_m)
            self.u_prev = self.solution[0]
            if observer:
                observer(t_new, self.solution)
            t = t_new

    # -- GI helpers -----------------------------------------------------------
    def _gi_g_dirichlet(self) -> np.ndarray:
        """Dirichlet mask of the GI geometry block: the outer fluid boundary
        (g = 0) and the interface rows (g = d, coupled through the (4,2)
        block)."""
        dom_u = self.variables[0][0]
        dim = self.dim
        g_dirichlet = np.zeros(dom_u.n_dofs(dim), dtype=bool)
        outer = (dom_u.mesh.point_flags > 0) & ~np.isin(
            np.arange(dom_u.n_nodes), self.interface.nodes_a)
        for c in range(dim):
            g_dirichlet[np.nonzero(outer)[0] * dim + c] = True
        g_dirichlet[self._uf_cols] = True
        return g_dirichlet

    def _gi_geometry_operator(self):
        """(Lg_bc, g_dirichlet): the vector Laplace on the REFERENCE fluid
        configuration with the GI Dirichlet rows built in."""
        dom_u = self.variables[0][0]
        if dom_u.mesh.ref_points is None:
            dom_u.mesh.save_reference_configuration()
        cur_pts = dom_u.mesh.points.copy()
        dom_u.mesh.points = dom_u.mesh.ref_points.copy()
        dom_u.invalidate_geometry()
        Lg = ops.assemble_laplace_vec(dom_u)
        dom_u.mesh.points = cur_pts
        dom_u.invalidate_geometry()
        g_dirichlet = self._gi_g_dirichlet()
        return _rows_to_identity(Lg, g_dirichlet), g_dirichlet

    # -- geometry-implicit (GI) time loop ------------------------------------
    # Five-field monolithic system (u, p, d, λ, g): the geometry is an
    # unknown with rows L_g g = 0 inside, g = 0 on the outer boundary and
    # g = d on Γ, and the fluid rows carry the exact ∂F/∂g blocks of
    # fe/shape_derivatives.py.  The fluid residual is evaluated through the
    # SAME element function that is differentiated, so Jacobian and
    # residual agree to machine precision.
    def advance_gi(self, t_end: float, observer: Optional[Callable] = None
                   ) -> None:
        from torch.func import vmap

        from feddlib_tpu_torch.fe.shape_derivatives import (
            _fluid_elem_residual, assemble_shape_derivative_blocks)
        from feddlib_tpu_torch.solvers.nonlinear import NonLinearSolver

        dom_u, dom_p = self.variables[0][0], self.variables[1][0]
        dim, dt = self.dim, self.dt
        dev = self.device
        self._gi = True
        self.init_vectors()
        n_u = self.block_sizes()[0]
        if len(self.solution) == 4:
            self.solution.blocks.append(self._zeros(n_u))
            self.rhs.blocks.append(self._zeros(n_u))

        # geometry operator on the REFERENCE mesh with built-in BC rows
        Lg_bc, _ = self._gi_geometry_operator()
        C4 = self._identity("C4", n_u, self.block_sizes()[2], self._uf_cols,
                            self._ds_cols, -1.0)

        res_fn = vmap(_fluid_elem_residual(
            dim, dom_u.fe_type, dom_p.fe_type, self.viscosity,
            self.density_f, dt, 1.0 / dt))
        conn_u = torch.as_tensor(dom_u.elem_nodes(), device=dev)
        conn_p = torch.as_tensor(dom_p.elem_nodes(), device=dev)
        udofs, pdofs = dom_u.elem_dofs(dim), dom_p.elem_nodes()
        nv = dim + 1
        ref_verts = torch.as_tensor(
            dom_u.mesh.ref_points[dom_u.mesh.elements[:, :nv]],
            dtype=torch.float64, device=dev)

        solver = NonLinearSolver("Newton")
        self.nonlinear_solver = solver
        if self.g_prev is None:
            self.g_prev = np.zeros((dom_u.n_nodes, dim))
        t = 0.0
        prob = self
        # distributed: five-field GI Jacobians assemble on the shard axis
        # through the GI pipeline; the solves ride five-field FaCSI
        dist_cache = None
        if bool(self.parameter_list.get("Use Distributed Solve", False)):
            n_dev, sdev = self._dist_devices()
            key = ("gi", n_dev, sdev, self.dt)
            dist_cache = getattr(self, "_pipe_gi", None)
            if dist_cache is None or dist_cache["key"] != key:
                with timers.timer("fsi.pipeline", sync=True):
                    pipe = self.build_pipeline_gi(n_dev, solid_devices=sdev)
                dist_cache = {"key": key, "prec": None, "solver": None,
                              "locator": None, "builds": 0, "pipe": pipe}
                self._pipe_gi = dist_cache
            self._dist_active = dist_cache

        def fluid_residual(u, p, g, gp_vec, u_old):
            fields = [v.reshape(-1, dim)[conn_u] for v in (u, g, gp_vec,
                                                           u_old)]
            pe = p[conn_p]
            Rus, Rps = [], []
            for s in range(0, conn_u.shape[0], _CHUNK):
                sl = slice(s, s + _CHUNK)
                ue, ge, gpe, uoe = (f[sl] for f in fields)
                Ru, Rp = res_fn(ue, pe[sl], ge, gpe, ref_verts[sl], uoe)
                Rus.append(Ru.reshape(Ru.shape[0], -1))
                Rps.append(Rp)
            Fu = asm.assemble_vector(udofs, torch.cat(Rus), n_u)
            Fp = asm.assemble_vector(pdofs, torch.cat(Rps), dom_p.n_nodes)
            return Fu, Fp

        while t < t_end - 1e-12:
            t_new = t + dt
            d_old = self.solution[2]
            v_old, a_old = self.solid_v, self.solid_a
            u_old = self.solution[0]
            newmark_m = 1.0 / (self.newmark_beta * dt * dt)
            solid_hist = self._solid_history(d_old, v_old, a_old, newmark_m)
            gp_vec = torch.as_tensor(self.g_prev.ravel(), dtype=torch.float64,
                                     device=dev)
            dG_hist = d_old[self._t_ds] / dt

            def residual(tt=0.0):
                u, p, d, lam, g = (prob.solution[i] for i in range(5))
                Fu, Fp = fluid_residual(u, p, g, gp_vec, u_old)
                Fu = Fu + prob.C1T.matvec(lam)
                Fd = prob._solid_residual(d, lam, newmark_m, solid_hist)
                Flam = prob._lam_rows(u[prob._t_uf] - d[prob._t_ds] / dt
                                      + dG_hist)
                Fg = Lg_bc.matvec(g).index_add(0, prob._t_uf,
                                               -d[prob._t_ds])
                r = BlockVector([Fu, Fp, Fd, Flam, Fg])
                return prob.bc_builder.set_vector_minus_bc(
                    r, prob.solution, tt)

            def reassemble(mode="Newton"):
                if dist_cache is not None:
                    prob._dist_reassemble_gi(dist_cache, gp_vec, u_old)
                    return
                u, p, d, lam, g = (prob.solution[i] for i in range(5))
                # move the fluid mesh to the CURRENT geometry iterate
                dom_u.mesh.move(g.cpu().numpy().reshape(-1, dim))
                dom_u.invalidate_geometry()
                prob._assemble_fluid_constant()
                w = (g - gp_vec) / dt
                Pmat = ops.assemble_ale_divergence(dom_u, w).scale(
                    -prob.density_f)
                prob._build_system("Newton", w, 1.0 / dt, newmark_m, P=Pmat)
                Dug, Dpg = assemble_shape_derivative_blocks(
                    dom_u, dom_p, u, p, g, gp_vec, u_old,
                    prob.viscosity, prob.density_f, dt, 1.0 / dt)
                S = prob.system
                S.add_block(0, 4, Dug)
                S.add_block(1, 4, Dpg)
                S.add_block(4, 4, Lg_bc)
                S.add_block(4, 2, C4)
                prob._prec_stale = True

            self._solve_step(solver, t_new, residual, reassemble,
                             distributed=dist_cache is not None)

            self._solid_update(d_old, v_old, a_old, newmark_m)
            self.g_prev = self.solution[4].cpu().numpy().reshape(-1, dim)
            if observer:
                observer(t_new, self.solution)
            t = t_new

    def build_pipeline_gi(self, n_dev: int,
                          solid_devices: Optional[int] = None, axis=None):
        """Multi-mesh DistributedPipeline of the five-field GI Jacobian:
        the GE blocks, the shape-derivative kinds (0,4) / (1,4)
        (∂(fluid)/∂(mesh) differentiated inside the assembly), the
        reference-configuration geometry block (4,4) with built-in
        Dirichlet rows, and the (4,2) interface coupling g = d."""
        from feddlib_tpu_torch.parallel import multihost
        from feddlib_tpu_torch.parallel.pipeline import DistributedPipeline

        self._gi = True
        dom_u, dom_p = self.variables[0][0], self.variables[1][0]
        dom_d = self.variables[2][0]
        dim = self.dim
        if dom_u.mesh.ref_points is None:
            dom_u.mesh.save_reference_configuration()
        part_f, part_s, nf = self._pipeline_parts(n_dev, solid_devices)
        pipe = DistributedPipeline(
            part_f, [(dom_u, dim, 0), (dom_p, 1, 0), (dom_d, dim, 1),
                     {"extra": self.n_lam, "owner": 0}, (dom_u, dim, 0)],
            aux_parts=[{"part": part_s, "range": (nf, n_dev)}])
        self._add_ge_blocks(pipe)
        # shape-derivative blocks (differentiated around the REFERENCE
        # configuration; fields u, p, g, g_prev, u_old)
        for i, kind in ((0, "shape_u"), (1, "shape_p")):
            pipe.add_block(i, 4, kind, viscosity=self.viscosity,
                           density=self.density_f, dt=self.dt,
                           mass_coef=1.0 / self.dt)
        # geometry block: interior Laplace on the reference configuration;
        # the Dirichlet rows (outer boundary g = 0, interface g = d) enter
        # as zero row weights, unit diagonals and the (4,2) coupling
        g_dir = self._gi_g_dirichlet()
        pipe.add_block(4, 4, "laplace_vec", geom="ref",
                       row_weights=(~g_dir).astype(np.float64))
        diag = np.flatnonzero(g_dir)
        pipe.add_coo_block(4, 4, diag, diag, np.ones(len(diag)))
        pipe.add_coo_block(4, 2, self._uf_cols, self._ds_cols,
                           -np.ones(len(self._uf_cols)))
        self._add_couplings(pipe)
        pipe.finalize(axis or multihost.global_device_axis(n_dev,
                                                           self.device))
        return pipe

    def assemble_distributed_gi(self, pipe, gp_vec, u_old):
        """One device-resident GI Jacobian at the current five-field
        solution: the fluid blocks on the MOVED coordinates (ref + g), the
        shape blocks around the reference configuration."""
        dom_u = self.variables[0][0]
        g = torch.as_tensor(self.solution[4], dtype=torch.float64)
        gp = torch.as_tensor(gp_vec, dtype=torch.float64, device=g.device)
        ext = {"w": pipe.distribute_field(0, (g - gp) / self.dt),
               "gp": pipe.distribute_field(4, gp),
               "uold": pipe.distribute_field(0, u_old)}
        x = pipe.distribute(self.solution.concat())
        ref = (dom_u.mesh.ref_points if dom_u.mesh.ref_points is not None
               else dom_u.mesh.points)
        vc = pipe.mesh_vert_coords(
            0, ref + g.cpu().numpy().reshape(-1, self.dim))
        return pipe.assemble(x=x, ext_fields=ext, vert_coords={0: vc})

    def block_sizes(self):
        base = [self.variables[0][0].n_dofs(self.dim),
                self.variables[1][0].n_dofs(1),
                self.variables[2][0].n_dofs(self.dim),
                self.n_lam]
        if getattr(self, "_gi", False):
            base.append(self.variables[0][0].n_dofs(self.dim))
        return base

    def extra_block_owner(self, block: int, n_parts: int,
                          mesh_parts: dict) -> np.ndarray:
        """Part of each dof of a domain-less block (λ, geometry) in the
        monolithic Schwarz and mixed-precision cluster maps: λ dofs follow
        the owner of their matched fluid interface node; the geometry
        follows the velocity space."""
        from feddlib_tpu_torch.mesh.partition import MeshPartition
        from feddlib_tpu_torch.solvers.linear import _p2_unique_map

        dom_u = self.variables[0][0]
        base = (dom_u.parent_p1 or dom_u).mesh
        bp, a0 = None, 0  # mesh_parts keys: (id(mesh), range_start, n_parts)
        for k, v in mesh_parts.items():
            if (k[0] if isinstance(k, tuple) else k) == id(base):
                bp = v
                a0 = k[1] if isinstance(k, tuple) else 0
                break
        if bp is None:
            bp = MeshPartition(base, n_parts)
            mesh_parts[(id(base), 0, n_parts)] = bp
        node_map = (bp.unique_map if dom_u.mesh is bp.mesh
                    else _p2_unique_map(bp, dom_u))
        if block == 3:  # λ follows its matched fluid node's owner
            owner = a0 + node_map.owner_of()[self.interface.nodes_a]
            return np.repeat(owner, self.dim)
        # geometry block: the layout of the velocity space
        return a0 + node_map.build_vec_field_map(self.dim).owner_of()

    # -- observables ---------------------------------------------------------
    def tip_displacement(self, point) -> np.ndarray:
        """Displacement at the solid node closest to `point` (the Turek
        FSI2 observable)."""
        dom_d = self.variables[2][0]
        i = int(np.argmin(np.linalg.norm(
            dom_d.mesh.points - np.asarray(point), axis=1)))
        return self.solution[2].cpu().numpy().reshape(-1, self.dim)[i]

    def surface_forces(self, flags) -> np.ndarray:
        """Consistent force on the flagged fluid boundaries: minus the
        momentum residual, without BC masking, summed over their nodes."""
        dom_u = self.variables[0][0]
        u, p = self.solution[0], self.solution[1]
        N = ops.assemble_advection(dom_u, u * self.density_f)
        Fu = self.Af.matvec(u) + N.matvec(u) + self.BfT.matvec(p)
        mask = np.isin(dom_u.mesh.point_flags, np.asarray(flags))
        Fn = Fu.cpu().numpy().reshape(-1, self.dim)
        return -Fn[np.nonzero(mask)[0]].sum(axis=0)

    def values_of_interest(self, tip_point=(0.6, 0.2),
                           force_flags=(4, 5)) -> dict:
        """The FSI2 benchmark observables in one record: the tip
        displacement at `tip_point` and the total fluid force (drag, lift)
        on the `force_flags` boundaries."""
        tip = self.tip_displacement(tip_point)
        F = self.surface_forces(force_flags)
        return {"tip_x": float(tip[0]), "tip_y": float(tip[1]),
                "drag": float(F[0]), "lift": float(F[1])}


def oscillation_stats(times, values) -> dict:
    """Amplitude / mean / frequency of a (developed) periodic observable
    series; the frequency from zero crossings of the demeaned signal."""
    t = np.asarray(times, dtype=float)
    v = np.asarray(values, dtype=float)
    mean = 0.5 * (v.max() + v.min())
    amp = 0.5 * (v.max() - v.min())
    s = np.sign(v - mean)
    cross = np.flatnonzero(np.diff(s) != 0)
    freq = 0.0
    if len(cross) >= 2 and t[cross[-1]] > t[cross[0]]:
        # two zero crossings per period
        freq = 0.5 * (len(cross) - 1) / (t[cross[-1]] - t[cross[0]])
    return {"mean": float(mean), "amplitude": float(amp),
            "frequency": float(freq)}
