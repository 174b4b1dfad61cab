"""The port's serial FSI (feddlib_tpu_torch.problems.fsi: the GE and GI
time loops, FaCSI, mixed precision on the four-field system) against the
JAX package, on the two-box scenario of tests/test_fsi.py:24: lid-driven
fluid over a clamped elastic slab, Viscosity 0.1, E 50, ν 0.3, dt 0.02.

Tolerances: linear iterations a Newton step equal to the JAX package's
±2 — on the f64 paths they are equal; the f32 inner sums of the mixed
path round in another order, so there they are held ±2 to the JAX
counts [166, 165, 160, 162] (the f32 noise of the second refinement pass
moves them by a few iterations with torch's thread count; this file runs
at the suite's 2 threads).  Solutions within 1e-8 of max |x|.  The GI
loop, the 3D step and the resumed steps are in test_torch_fsi_gi.py,
which imports this file's helpers.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.mesh.structured import \
    build_structured_mesh as j_build  # noqa: E402
from feddlib_tpu.problems.fsi import FSI as JFSI  # noqa: E402
from feddlib_tpu.problems.fsi import \
    oscillation_stats as j_osc  # noqa: E402
from feddlib_tpu.solvers import linear as jlin  # noqa: E402
from feddlib_tpu.utils.config import ParameterList as JPL  # noqa: E402

from feddlib_tpu_torch.fe.domain import Domain as TDomain  # noqa: E402
from feddlib_tpu_torch.mesh.structured import \
    build_structured_mesh as t_build  # noqa: E402
from feddlib_tpu_torch.problems import FSI as TFSI  # noqa: E402
from feddlib_tpu_torch.problems import \
    oscillation_stats as t_osc  # noqa: E402
from feddlib_tpu_torch.solvers import linear as tlin  # noqa: E402
from feddlib_tpu_torch.utils import timers  # noqa: E402
from feddlib_tpu_torch.utils.config import ParameterList as TPL  # noqa: E402

IFACE = 9
PHYS = {"Viscosity": 0.1, "E": 50.0, "dt": 0.02, "Poisson Ratio": 0.3,
        "Density Fluid": 1.0, "Density Solid": 1.0}
JACOBI = {"Preconditioner Type": "Jacobi", "Maximum Iterations": 8000,
          "Convergence Tolerance": 1e-9, "relNonLinTol": 1e-6,
          "MaxNonLinIts": 12}
FACSI = {"Preconditioner Type": "FaCSI", "Subdomains": 4,
         "Maximum Iterations": 8000, "Convergence Tolerance": 1e-9,
         "MaxNonLinIts": 12}
MIXED = {"Use Mixed Precision": True, "Preconditioner Type": "SchwarzOneLevel",
         "Clusters": 4, "Maximum Iterations": 8000,
         "Convergence Tolerance": 1e-9, "MaxNonLinIts": 12}
GI = {"Preconditioner Type": "SchwarzOneLevel", "Subdomains": 8,
      "MaxNonLinIts": 12}


@pytest.fixture(scope="module", autouse=True)
def blas1():
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(1, user_api="blas"):
        yield


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _two_box(pkg, n, dim):
    """Fluid box over solid box, interface x_{dim-1} = 0.5 flagged IFACE
    on both (tests/test_fsi.py:24; in 3D (n, n, ⌈n/2⌉) cells a box)."""
    build, Domain, kw = ((j_build, JDomain, {}) if pkg == "jax"
                         else (t_build, TDomain, {"device": "cpu"}))
    cells = (n, n) if dim == 2 else (n, n, (n + 1) // 2)
    lo_f, hi_s = [0.0] * dim, [1.0] * dim
    lo_f[-1] = hi_s[-1] = 0.5
    fluid = build(dim, cells, lower=lo_f, upper=[1.0] * dim)
    solid = build(dim, cells, lower=[0.0] * dim, upper=hi_s)
    for mesh in (fluid, solid):
        mesh.point_flags[np.isclose(mesh.points[:, -1], 0.5)] = IFACE
        on = np.all(np.isclose(mesh.points[mesh.surfaces][:, :, -1], 0.5),
                    axis=1)
        mesh.surface_flags[on] = IFACE
    dom_fp, dom_sp = Domain(fluid, **kw), Domain(solid, **kw)
    return dom_fp.p2_domain(), dom_fp, dom_sp.p2_domain()


def _problem(pkg, n, params, dim=2, bcs=True):
    """The assembled FSI problem with the lid (u = 0.5 e_0 on the top)
    and no-slip walls on flag 1, the solid clamped on flag 1."""
    dom_u, dom_p, dom_d = _two_box(pkg, n, dim)
    if pkg == "jax":
        prob = JFSI(dom_u, dom_p, dom_d, [IFACE],
                    parameter_list=JPL("P", dict(PHYS, **params)))
        lid_v = jnp.zeros(dim).at[0].set(0.5)
        lid = (lambda x, t: jnp.where(jnp.isclose(x[dim - 1], 1.0), lid_v,
                                      jnp.zeros(dim)))
        zero = (lambda x, t: jnp.zeros(dim))
    else:
        prob = TFSI(dom_u, dom_p, dom_d, [IFACE],
                    parameter_list=TPL("P", dict(PHYS, **params)),
                    device="cpu")

        def lid(x, t):
            on = torch.isclose(x[dim - 1], torch.ones((), dtype=x.dtype))
            return torch.stack([0.5 * on.double()] + [0.0 * x[0]] * (dim - 1))

        zero = (lambda x, t: [0.0] * dim)
    prob.assemble()
    if bcs:
        prob.add_bc(lid, 1, 0)
        prob.add_bc(zero, 1, 2)
    return prob


def _solution(prob):
    return [np.array(b) if not isinstance(b, torch.Tensor) else b.numpy()
            for b in prob.solution.blocks]


def _run(pkg, n, params, mode="GE", t_end=0.04, dim=2, observer=None):
    """(linear iterations of every Newton step, solution blocks, problem)."""
    lin = jlin if pkg == "jax" else tlin
    log = []
    orig = lin.LinearSolver.solve_system

    def counted(self, problem, b):
        x, it = orig(self, problem, b)
        log.append(it)
        return x, it

    lin.LinearSolver.solve_system = counted
    try:
        prob = _problem(pkg, n, params, dim)
        (prob.advance if mode == "GE" else prob.advance_gi)(
            t_end=t_end, observer=observer)
    finally:
        lin.LinearSolver.solve_system = orig
    return log, _solution(prob), prob


_JAX = {}


def _jax_run(key, *args, **kw):
    """The JAX package's run of a case, once per module."""
    if key not in _JAX:
        _JAX[key] = _run("jax", *args, **kw)
    return _JAX[key]


def _same_solution(sol_t, sol_j, tol=1e-8):
    assert len(sol_t) == len(sol_j)
    for a, b in zip(sol_t, sol_j):
        assert a.dtype == np.float64 and np.isfinite(a).all()
        assert _rel(a, b) < tol


@pytest.mark.parametrize("case,n,params,expected", [
    ("Jacobi", 3, JACOBI, None),
    ("FaCSI", 4, FACSI, [21, 21, 21, 21]),
    ("mixed", 4, MIXED, [166, 165, 160, 162]),
])
def test_ge_matches_jax(case, n, params, expected):
    """Two GE steps: linear iterations a Newton step and the solutions
    against the JAX package's; FaCSI and mixed also against the counts
    the JAX package gives (tests/test_fsi.py:88 and :123)."""
    its_j, sol_j, _ = _jax_run(case, n, params)
    spans = []
    timers.subscribe(spans.append)
    try:
        its_t, sol_t, prob = _run("torch", n, params)
    finally:
        timers.unsubscribe(spans.append)
    if expected is not None:
        assert its_j == expected
        assert len(its_t) == len(expected)
        assert all(abs(a - b) <= 2 for a, b in zip(its_t, expected)), its_t
    if case != "mixed":
        assert its_t == its_j
    _same_solution(sol_t, sol_j)
    # the interface constraint u = (d − dⁿ)/dt holds; traction transferred
    assert np.abs(sol_t[3]).max() > 0 and np.abs(sol_t[0]).max() > 1e-3
    if case == "FaCSI":
        assert type(prob.preconditioner.prec).__name__ == \
            "FaCSIPreconditioner"
        # each build opens its two synchronised set-up spans
        names = [r.name for r in spans if isinstance(r, timers.Span)]
        builds = names.count("facsi.solid")
        assert builds >= 1 and names.count("facsi.fluid") == builds
        assert all(r.sync for r in spans if isinstance(r, timers.Span)
                   and r.name.startswith("facsi."))
        assert not hasattr(prob.preconditioner.prec, "timings")


def test_nonlinear_solid():
    """'Material Model': 'Neo-Hooke' (the torch.func tangent on the solid
    block): two FaCSI steps equal the JAX package's, and at small strains
    the tip tracks the linear solid within 20 % (tests/test_fsi.py:294)."""
    params = dict(FACSI, **{"Material Model": "Neo-Hooke",
                            "relNonLinTol": 1e-6, "MaxNonLinIts": 15})
    its_j, sol_j, _ = _jax_run("NH", 3, params)
    its_t, sol_t, prob = _run("torch", 3, params)
    assert its_t == its_j
    _same_solution(sol_t, sol_j)
    tip_nh = prob.tip_displacement([0.5, 0.5])
    tip_lin = _run("torch", 3, dict(FACSI, **{"MaxNonLinIts": 15}))[2] \
        .tip_displacement([0.5, 0.5])
    assert np.linalg.norm(tip_nh - tip_lin) <= 0.2 * max(
        np.linalg.norm(tip_lin), 1e-8)


def test_values_of_interest_and_oscillation_stats():
    """values_of_interest after a FaCSI step equal to the JAX package's,
    and oscillation_stats on a synthetic signal (tests/test_fsi.py:387)."""
    _, _, pj = _jax_run("FaCSI", 4, FACSI)
    _, _, pt = _run("torch", 4, FACSI)
    kw = dict(tip_point=(0.5, 0.5), force_flags=(1,))
    vj, vt = pj.values_of_interest(**kw), pt.values_of_interest(**kw)
    assert set(vt) == {"tip_x", "tip_y", "drag", "lift"}
    for k in vt:
        assert abs(vt[k] - vj[k]) <= 1e-8 * max(abs(v) for v in vj.values())
    t = np.linspace(0.0, 5.0, 1000)
    y = 1.2 + 0.08 * np.sin(2 * np.pi * 2.0 * t)
    st = t_osc(t, y)
    assert st == j_osc(t, y)
    assert abs(st["mean"] - 1.2) < 1e-3 and abs(st["amplitude"] - 0.08) \
        < 1e-3 and abs(st["frequency"] - 2.0) < 0.05


def test_mesh_rank_ranges():
    """'Mesh Rank Ranges' (tests/test_fsi.py:232): fluid u/p on parts 0-2,
    solid on 3-5.  The merged dof map equals the JAX package's and places
    each mesh's dofs only in its range; the one-level Schwarz solve
    runs."""
    from feddlib_tpu.mesh.partition import MeshPartition as JPart

    from feddlib_tpu_torch.mesh.partition import MeshPartition as TPart

    params = {"Preconditioner Type": "SchwarzOneLevel", "Subdomains": 6,
              "Maximum Iterations": 8000, "Convergence Tolerance": 1e-9,
              "MaxNonLinIts": 12,
              "Mesh Rank Ranges": [[0, 2], [0, 2], [3, 5]]}
    _, sol, prob = _run("torch", 3, params, t_end=0.02)
    assert np.isfinite(sol[2]).all()
    maps = []
    for pr, Part in ((prob, TPart), (_problem("jax", 3, params), JPart)):
        dom_u = pr.variables[0][0]
        maps.append(pr.preconditioner._merged_dof_map(
            Part((dom_u.parent_p1 or dom_u).mesh, 6)))
    dmap = maps[0]
    for a, b in zip(dmap.partition_indices, maps[1].partition_indices):
        assert np.array_equal(a, b)
    off = np.concatenate([[0], np.cumsum(prob.block_sizes())])
    for p in range(6):
        ix = dmap.partition_indices[p]
        fluid = ix[ix < off[2]]
        solid = ix[(ix >= off[2]) & (ix < off[3])]
        if p <= 2:
            assert len(solid) == 0
        else:
            assert len(fluid) == 0 and len(solid) > 0
    assert dmap.is_unique()
