"""Time integration — TimeProblem + DAESolverInTime + TimeSteppingTools.

Counterpart of feddlib_tpu/solvers/timestepping.py (reference:
problems/abstract/TimeProblem_decl.hpp,
problems/Solver/DAESolverInTime_decl.hpp:25, TimeSteppingTools.cpp).  The
vectors live on the problem's device; checkpoints are the JAX package's
.npz format (utils/checkpoint.py).

Schemes (reference: TimeSteppingTools.cpp:315-350 Butcher/θ tables,
setInformationBDF :131, Newmark in DAESolverInTime_def.hpp:519+):

- θ single-step (explicit/implicit Euler, Crank–Nicolson):
    (M/dt + θ A) uⁿ⁺¹ = (M/dt − (1−θ)A) uⁿ + θ fⁿ⁺¹ + (1−θ) fⁿ
- BDF-k multistep (BDF2 default for fluids, DAESolverInTime_def.hpp:1209):
    (β₀/dt M + A) uⁿ⁺¹ = M Σᵢ βᵢ/dt uⁿ⁺¹⁻ᵢ + fⁿ⁺¹
- Newmark (solid dynamics, :519):  M a + K d = f with
    dⁿ⁺¹ = dⁿ + dt vⁿ + dt²[(1/2−β)aⁿ + β aⁿ⁺¹]
    vⁿ⁺¹ = vⁿ + dt[(1−γ)aⁿ + γ aⁿ⁺¹]

`TimeProblem` wraps a steady problem and carries the mass system + the
combineSystems() logic (TimeProblem_def.hpp:359): only blocks flagged in
`time_step_def` (the reference's SmallMatrix<int> mask,
DAESolverInTime_def.hpp:126) receive mass contributions.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from feddlib_tpu_torch.fe import ops
from feddlib_tpu_torch.la.block import BlockMatrix, BlockVector


def butcher_table(name: str):
    """Butcher tables (reference TimeSteppingTools.cpp:315-350).
    Returns (A, b, c) as numpy arrays."""
    if name in ("Euler", "ExplicitEuler"):
        return np.zeros((1, 1)), np.array([1.0]), np.array([0.0])
    if name in ("ImplicitEuler", "BackwardEuler"):
        return np.array([[1.0]]), np.array([1.0]), np.array([1.0])
    if name in ("CrankNicolson", "Crank-Nicolson"):
        return (np.array([[0.0, 0.0], [0.5, 0.5]]),
                np.array([0.5, 0.5]), np.array([0.0, 1.0]))
    raise ValueError(f"unknown Butcher table {name!r}")


# fractional-step-θ sub-step parameters (reference fractional-θ table):
# θ = 1 − √2/2, θ' = 1 − 2θ, α = (1−2θ)/(1−θ), β = 1 − α;
# three sub-steps [θΔt (α-implicit), θ'Δt (β-implicit), θΔt (α-implicit)]
def fractional_theta_parameters():
    theta = 1.0 - np.sqrt(2.0) / 2.0
    thetap = 1.0 - 2.0 * theta
    alpha = thetap / (1.0 - theta)
    beta = 1.0 - alpha
    return theta, thetap, alpha, beta


def bdf_coefficients(order: int):
    """(beta0, [alpha_1..alpha_k]) with  (β₀ uⁿ⁺¹ − Σ αᵢ uⁿ⁺¹⁻ⁱ)/dt ≈ u̇
    (reference: TimeSteppingTools::setInformationBDF)."""
    if order == 1:
        return 1.0, [1.0]
    if order == 2:
        return 1.5, [2.0, -0.5]
    if order == 3:
        return 11.0 / 6.0, [3.0, -1.5, 1.0 / 3.0]
    raise ValueError(f"BDF order {order} unsupported")


class TimeProblem:
    """Wraps a (Non)LinearProblem for time stepping."""

    def __init__(self, problem, time_step_def: Optional[List[int]] = None):
        self.problem = problem
        nb = len(problem.variables)
        self.time_step_def = time_step_def or [1] * nb
        self.mass: Dict[int, object] = {}
        self.assemble_mass_system()

    def assemble_mass_system(self) -> None:
        """Per-block mass matrices for flagged blocks
        (TimeProblem::assembleMassSystem, TimeProblem_def.hpp:599)."""
        for b, (dom, dofs, _) in enumerate(self.problem.variables):
            if self.time_step_def[b]:
                self.mass[b] = ops.assemble_mass(dom, dofs)

    def combined_system(self, mass_coef: float, system_coef: float = 1.0):
        """systemCombined = mass_coef·M + system_coef·A per flagged block
        (TimeProblem::combineSystems, TimeProblem_def.hpp:359)."""
        sys = self.problem.system
        out = BlockMatrix(sys.row_sizes, sys.col_sizes)
        for (i, j), m in sys.blocks.items():
            if i == j and i in self.mass:
                out.add_block(i, j, self.mass[i].add(m, alpha=mass_coef,
                                                     beta=system_coef))
            else:
                out.add_block(i, j, m.scale(system_coef))
        for i, M in self.mass.items():
            if (i, i) not in sys.blocks:
                out.add_block(i, i, M.scale(mass_coef))
        return out

    def mass_apply(self, x: BlockVector) -> BlockVector:
        out = []
        for b in range(len(x)):
            if b in self.mass:
                out.append(self.mass[b].matvec(x[b]))
            else:
                out.append(torch.zeros_like(x[b]))
        return BlockVector(out)


class DAESolverInTime:
    """Time-integration driver (reference: DAESolverInTime_decl.hpp:25,
    advanceInTime dispatch at DAESolverInTime_def.hpp:133-190)."""

    def __init__(self, time_problem: TimeProblem, dt: float, t_end: float,
                 scheme: str = "BDF2", theta: float = 1.0,
                 newmark_beta: float = 0.25, newmark_gamma: float = 0.5,
                 rhs_func: Optional[Callable] = None,
                 observer: Optional[Callable] = None,
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 1,
                 resume_from: Optional[str] = None):
        self.tp = time_problem
        self.dt = dt
        self.t_end = t_end
        self.scheme = scheme
        self.theta = theta
        self.beta = newmark_beta
        self.gamma = newmark_gamma
        self.rhs_func = rhs_func  # rhs_func(t) -> BlockVector
        self.observer = observer  # observer(t, solution)
        # checkpoint/resume (capability ADD over the reference — SURVEY §5:
        # the reference has output-only persistence): solution + integrator
        # history saved every `checkpoint_every` steps; `resume_from`
        # restores state and continues from the saved time.  Supported by
        # the linear θ / BDF / Newmark loops.
        self.checkpoint_path = checkpoint_path
        self.checkpoint_every = max(int(checkpoint_every), 1)
        self._step_count = 0
        self._resume = None
        if resume_from is not None:
            from feddlib_tpu_torch.utils.checkpoint import load_checkpoint

            self._resume = load_checkpoint(
                resume_from, device=time_problem.problem.device)

    def _zeros(self) -> BlockVector:
        prob = self.tp.problem
        return BlockVector.zeros(prob.block_sizes(), device=prob.device)

    def _dev(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.tp.problem.device)

    # -- checkpoint plumbing --------------------------------------------------
    def _resume_state(self):
        """Restore solution + time from a loaded checkpoint (if any);
        returns (t_start, aux dict)."""
        if self._resume is None:
            return 0.0, {}
        sol, t, aux, _meta = self._resume
        self.tp.problem.solution = sol
        return t, aux

    def _checkpoint(self, t, aux=None):
        if not self.checkpoint_path:
            return
        self._step_count += 1
        if self._step_count % self.checkpoint_every:
            return
        from feddlib_tpu_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(self.checkpoint_path, self.tp.problem.solution, t,
                        aux=aux)

    # -- linear θ-scheme (advanceInTimeLinear, :190) -------------------------
    def advance_linear_theta(self) -> None:
        tp, prob = self.tp, self.tp.problem
        dt, th = self.dt, self.theta
        prob.init_vectors()
        t, _ = self._resume_state()
        u = prob.solution
        lhs = tp.combined_system(1.0 / dt, th)
        f_prev = self.rhs_func(t) if self.rhs_func else self._zeros()
        while t < self.t_end - 1e-12:
            t_new = t + dt
            f_new = self.rhs_func(t_new) if self.rhs_func else f_prev
            # rhs = (M/dt − (1−θ)A) uⁿ + θ fⁿ⁺¹ + (1−θ)fⁿ
            Mu = tp.mass_apply(u).scale(1.0 / dt)
            Au = prob.system.apply(u)
            rhs = Mu.axpy(-(1 - th), Au).axpy(th, f_new).axpy(1 - th, f_prev)
            u = self._solve_linear_step(lhs, rhs, t_new)
            prob.solution = u
            if self.observer:
                self.observer(t_new, u)
            self._checkpoint(t_new)
            t, f_prev = t_new, f_new

    # -- linear BDF-k (advanceInTimeLinearMultistep, :1209) ------------------
    def advance_linear_bdf(self, order: int = 2) -> None:
        tp, prob = self.tp, self.tp.problem
        dt = self.dt
        beta0, alphas = bdf_coefficients(order)
        prob.init_vectors()
        t, aux = self._resume_state()
        if aux:
            hist_keys = sorted(k for k in aux if k.startswith("hist_"))
            history = [BlockVector.split(self._dev(aux[k]),
                                         prob.block_sizes())
                       for k in hist_keys]
        else:
            history = [prob.solution.copy()]
        lhs = tp.combined_system(beta0 / dt, 1.0)
        lhs1 = tp.combined_system(1.0 / dt, 1.0)  # BDF1 startup
        while t < self.t_end - 1e-12:
            t_new = t + dt
            f = self.rhs_func(t_new) if self.rhs_func else self._zeros()
            k = min(order, len(history))
            if k < order:
                b0, al = bdf_coefficients(k)
                A = lhs1
            else:
                b0, al = beta0, alphas
                A = lhs
            acc = self._zeros()
            for i, a in enumerate(al):
                acc = acc.axpy(a / dt, history[-(i + 1)])
            rhs = tp.mass_apply(acc).axpy(1.0, f)
            u = self._solve_linear_step(A, rhs, t_new)
            prob.solution = u
            history.append(u.copy())
            if len(history) > order:
                history.pop(0)
            if self.observer:
                self.observer(t_new, u)
            self._checkpoint(t_new, aux={
                f"hist_{i}": h.concat() for i, h in enumerate(history)})
            t = t_new

    # -- linear Newmark (advanceInTimeLinearNewmark, :519) -------------------
    def advance_linear_newmark(self) -> None:
        """Second-order system M d̈ + K d = f (single-block elasticity)."""
        tp, prob = self.tp, self.tp.problem
        dt, be, ga = self.dt, self.beta, self.gamma
        prob.init_vectors()
        t, aux = self._resume_state()
        d = prob.solution
        if aux:
            v = BlockVector.split(self._dev(aux["velocity"]),
                                  prob.block_sizes())
            a = BlockVector.split(self._dev(aux["acceleration"]),
                                  prob.block_sizes())
        else:
            v = self._zeros()
            a = self._zeros()
        # effective lhs: M/(β dt²) + K
        lhs = tp.combined_system(1.0 / (be * dt * dt), 1.0)
        while t < self.t_end - 1e-12:
            t_new = t + dt
            f = self.rhs_func(t_new) if self.rhs_func else self._zeros()
            # predictor terms: M [d/(βdt²) + v/(βdt) + (1/(2β)−1) a]
            pred = (d.scale(1.0 / (be * dt * dt))
                    .axpy(1.0 / (be * dt), v)
                    .axpy(1.0 / (2 * be) - 1.0, a))
            rhs = tp.mass_apply(pred).axpy(1.0, f)
            d_new = self._solve_linear_step(lhs, rhs, t_new)
            a_new = (d_new.axpy(-1.0, d).scale(1.0 / (be * dt * dt))
                     .axpy(-1.0 / (be * dt), v)
                     .axpy(-(1.0 / (2 * be) - 1.0), a))
            v = v.axpy(dt * (1 - ga), a).axpy(dt * ga, a_new)
            d, a = d_new, a_new
            prob.solution = d
            if self.observer:
                self.observer(t_new, d)
            self._checkpoint(t_new, aux={"velocity": v.concat(),
                                         "acceleration": a.concat()})
            t = t_new
        self.velocity, self.acceleration = v, a

    # -- fractional-step-θ (reference: fractional-θ table,
    # TimeSteppingTools.cpp:315-350) — three unequal θ-substeps per step,
    # 2nd order and strongly A-stable; linear problems
    def advance_linear_fractional_theta(self) -> None:
        tp, prob = self.tp, self.tp.problem
        dt = self.dt
        th, thp, al, be_ = fractional_theta_parameters()
        prob.init_vectors()
        u = prob.solution
        t = 0.0
        subs = [(th * dt, al), (thp * dt, be_), (th * dt, al)]
        lhs_cache = {}
        while t < self.t_end - 1e-12:
            for sub_dt, w_impl in subs:
                key = (sub_dt, w_impl)
                if key not in lhs_cache:
                    lhs_cache[key] = tp.combined_system(1.0 / sub_dt, w_impl)
                f = (self.rhs_func(t + sub_dt) if self.rhs_func
                     else self._zeros())
                Mu = tp.mass_apply(u).scale(1.0 / sub_dt)
                Au = prob.system.apply(u)
                rhs = Mu.axpy(-(1 - w_impl), Au).axpy(1.0, f)
                u = self._solve_linear_step(lhs_cache[key], rhs, t + sub_dt)
                t += sub_dt
            prob.solution = u
            if self.observer:
                self.observer(t, u)

    # -- semi-implicit NS: "Extrapolation" variant (reference
    # NavierStokes::reAssemble("Extrapolation"), NavierStokes_def.hpp:324) —
    # convection frozen at the extrapolated velocity 2uⁿ − uⁿ⁻¹, ONE linear
    # solve per step (no Newton)
    def advance_navier_stokes_extrapolation(self, order: int = 2) -> None:
        from feddlib_tpu_torch.fe import ops as fe_ops

        tp, prob = self.tp, self.tp.problem
        dt = self.dt
        dom_u = prob.variables[0][0]
        prob.init_vectors()
        history = [prob.solution.copy()]
        t = 0.0
        beta0, alphas = bdf_coefficients(min(order, 2))
        while t < self.t_end - 1e-12:
            t_new = t + dt
            k = min(order, len(history))
            b0, al = bdf_coefficients(k)
            # extrapolated advecting velocity
            if len(history) >= 2:
                u_ext = history[-1][0] * 2.0 - history[-2][0]
            else:
                u_ext = history[-1][0]
            N = fe_ops.assemble_advection(dom_u, u_ext * prob.density)
            Auu = prob.A.add(N)
            prob._build_system(Auu)
            acc = self._zeros()
            for i, a_ in enumerate(al):
                acc = acc.axpy(a_ / dt, history[-(i + 1)])
            f = (self.rhs_func(t_new) if self.rhs_func
                 else self._zeros())
            rhs = tp.mass_apply(acc).axpy(1.0, f)
            lhs = tp.combined_system(b0 / dt, 1.0)
            u = self._solve_linear_step(lhs, rhs, t_new)
            self._lhs_cache_key = None  # lhs changes every step
            prob.solution = u
            history.append(u.copy())
            if len(history) > order:
                history.pop(0)
            if self.observer:
                self.observer(t_new, u)
            t = t_new

    # -- nonlinear BDF (advanceInTimeNonLinearMultistep) ---------------------
    def advance_nonlinear_bdf(self, order: int = 2,
                              newton_method: str = "Newton") -> None:
        """Each step solves the nonlinear system with the mass term folded
        in: F_dt(u) = β₀/dt M u − M acc + F(u) − f  (reference
        updateMultistepRhs + TimeProblem residual path)."""
        from feddlib_tpu_torch.solvers.nonlinear import NonLinearSolver

        tp, prob = self.tp, self.tp.problem
        dt = self.dt
        prob.init_vectors()
        history = [prob.solution.copy()]
        t = 0.0
        solver = NonLinearSolver(newton_method)
        base_residual = prob.calculate_residual
        base_reassemble = prob.reassemble
        base_bc_system = prob.bc_system
        try:
            while t < self.t_end - 1e-12:
                t_new = t + dt
                k = min(order, len(history))
                b0, al = bdf_coefficients(k)
                acc = self._zeros()
                for i, a_ in enumerate(al):
                    acc = acc.axpy(a_ / dt, history[-(i + 1)])
                M_acc = tp.mass_apply(acc)
                f = (self.rhs_func(t_new) if self.rhs_func
                     else self._zeros())

                def residual(tt=0.0, _Macc=M_acc, _f=f, _b0=b0):
                    r = base_residual(tt)
                    Mu = tp.mass_apply(prob.solution).scale(_b0 / dt)
                    r2 = r.axpy(1.0, Mu).axpy(-1.0, _Macc).axpy(-1.0, _f)
                    return prob.bc_builder.set_vector_minus_bc(
                        r2, prob.solution, tt)

                def bc_system(_b0=b0):
                    combined = tp.combined_system(_b0 / dt, 1.0)
                    return prob.bc_builder.apply_to_system(combined)

                prob.calculate_residual = residual
                prob.bc_system = bc_system
                solver.solve(prob, t_new)
                history.append(prob.solution.copy())
                if len(history) > order:
                    history.pop(0)
                if self.observer:
                    self.observer(t_new, prob.solution)
                t = t_new
        finally:
            prob.calculate_residual = base_residual
            prob.bc_system = base_bc_system
            prob.reassemble = base_reassemble

    # -- adaptive θ-scheme (step-doubling error control) ---------------------
    # The reference only scaffolds adaptivity (TimeSteppingTools.hpp:50
    # timeSteppingType {NON_ADAPTIVE, ADAPTIVE} with no implementation) —
    # this is a working addition: each step is computed once with dt and
    # once with two dt/2 substeps; the Richardson error estimate drives a
    # standard PI step-size controller within [dt_min, dt_max].
    def advance_linear_theta_adaptive(self, rel_tol: float = 1e-4,
                                      dt_min: float = 1e-6,
                                      dt_max: float = 1.0,
                                      safety: float = 0.9) -> None:
        tp, prob = self.tp, self.tp.problem
        th = self.theta
        prob.init_vectors()
        u = prob.solution
        t = 0.0
        dt = self.dt
        p_order = 2 if abs(th - 0.5) < 1e-12 else 1
        self.dt_history = []

        def one_step(u, dt, t):
            lhs = tp.combined_system(1.0 / dt, th)
            f = (self.rhs_func(t + dt) if self.rhs_func
                 else self._zeros())
            f0 = (self.rhs_func(t) if self.rhs_func else f)
            Mu = tp.mass_apply(u).scale(1.0 / dt)
            Au = prob.system.apply(u)
            rhs = Mu.axpy(-(1 - th), Au).axpy(th, f).axpy(1 - th, f0)
            return self._solve_linear_step(lhs, rhs, t + dt)

        while t < self.t_end - 1e-12:
            dt = min(dt, self.t_end - t)
            u_big = one_step(u, dt, t)
            u_half = one_step(u, dt / 2, t)
            u_small = one_step(u_half, dt / 2, t + dt / 2)
            err = float(u_big.axpy(-1.0, u_small).norm2())
            scale = max(float(u_small.norm2()), 1e-14)
            rel = err / scale
            if rel <= rel_tol or dt <= dt_min * 1.001:
                u = u_small
                prob.solution = u
                t += dt
                self.dt_history.append(dt)
                if self.observer:
                    self.observer(t, u)
            factor = safety * (rel_tol / max(rel, 1e-16)) ** (
                1.0 / (p_order + 1))
            dt = float(np.clip(dt * np.clip(factor, 0.2, 5.0),
                               dt_min, dt_max))

    # -- helpers -------------------------------------------------------------
    # The BC-applied lhs and its preconditioner are cached per lhs object:
    # for linear problems the combined system is constant in time, so the
    # preconditioner is built ONCE per run (the reference's "Reuse
    # Preconditioner" behavior), not per step.
    def _solve_linear_step(self, lhs: BlockMatrix, rhs: BlockVector,
                           t: float) -> BlockVector:
        prob = self.tp.problem
        bcb = prob.bc_builder
        if getattr(self, "_lhs_cache_key", None) is not lhs:
            self._lhs_cache_key = lhs
            self._lhs_bc = bcb.apply_to_system(lhs)
            prob._prec_stale = True
        sys_bc = self._lhs_bc
        rhs_bc = bcb.apply_to_rhs(rhs, t)
        base, prob.bc_system = prob.bc_system, (lambda: sys_bc)
        try:
            x, _ = prob.linear_solver.solve_system(prob, rhs_bc)
        finally:
            prob.bc_system = base
        return x
