"""The port's adaptive mesh refinement (feddlib_tpu_torch/mesh/refine.py,
solvers/refinement.py `adaptive_solve_cycles`) against the JAX package, on
the scenarios of the 16 tests of tests/test_amr.py.  Meshes go from the JAX
package to the port through utils/convert.py `mesh_from_numpy`; both
packages refine, estimate and mark the same arrays.  Tolerances: refined
meshes (points, elements, point and element flags, surfaces) bitwise;
estimators 1e-12 relative; marks equal; the adaptive histories' element
counts and iterations equal, eta within rtol 1e-8 (the serial history
from its first refinement on: the JAX package's refinement of the port's
own solution, see test_adaptive_solve_cycles_serial)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from feddlib_tpu.mesh import refine as jr  # noqa: E402
from feddlib_tpu.mesh.partition import MeshPartition as JPart  # noqa: E402
from feddlib_tpu.mesh.structured import build_structured_mesh  # noqa: E402

from feddlib_tpu_torch.mesh import refine as tr  # noqa: E402
from feddlib_tpu_torch.mesh.partition import MeshPartition as TPart  # noqa: E402
from feddlib_tpu_torch.utils import convert  # noqa: E402


def _tmesh(m):
    return convert.mesh_from_numpy(
        m.points, m.elements, m.point_flags, m.element_flags,
        fe_type=m.fe_type, surfaces=m.surfaces,
        surface_flags=m.surface_flags, lines=getattr(m, "lines", None),
        line_flags=getattr(m, "line_flags", None))


def _same_mesh(a, b):
    """a (JAX) and b (port) hold the same arrays, bit for bit."""
    assert a.dim == b.dim and a.fe_type == b.fe_type
    for k in ("points", "elements", "point_flags", "element_flags",
              "surfaces", "surface_flags"):
        x, y = getattr(a, k, None), getattr(b, k, None)
        assert (x is None) == (y is None), k
        if x is not None:
            assert np.array_equal(np.asarray(x), np.asarray(y)), k
            assert np.asarray(x).dtype == np.asarray(y).dtype, k


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-300)


def _tpart(jpart, tmesh):
    part = TPart(tmesh, jpart.n_parts)
    for p in range(jpart.n_parts):
        assert np.array_equal(np.asarray(part.elem_ids[p]),
                              np.asarray(jpart.elem_ids[p]))
    return part


def _poisson_u(mesh, f_jax):
    """The JAX package's Poisson solution on mesh (tests/test_amr.py's
    solve_on), the u both packages estimate."""
    from feddlib_tpu.bc import BCBuilder
    from feddlib_tpu.fe import ops
    from feddlib_tpu.fe.domain import Domain
    from feddlib_tpu.solvers.krylov import cg

    dom = Domain(mesh)
    K = ops.assemble_laplace(dom)
    b = ops.assemble_rhs(dom, f_jax, degree=4)
    bcb = BCBuilder()
    bcb.add_bc(lambda x, t: 0.0, 1, 0, dom, "Dirichlet", 1)
    Kb, bb = bcb.apply_symmetric(K, b, 0)
    return np.asarray(cg(Kb.matvec, bb, tol=1e-10, maxiter=3000).x)


@pytest.mark.parametrize("dim", [2, 3])
def test_uniform_refine(dim):
    m = build_structured_mesh(dim, 2)
    _same_mesh(jr.refine_uniform(m), tr.refine_uniform(_tmesh(m)))


def test_partial_refine():
    m = build_structured_mesh(2, 4)
    marked = np.zeros(m.n_elements, dtype=bool)
    marked[:5] = True
    _same_mesh(jr.refine_mesh_2d(m, marked),
               tr.refine_mesh_2d(_tmesh(m), marked))


def test_estimator_singularity():
    m = build_structured_mesh(2, 8)
    pts = m.points
    u = np.sqrt((pts[:, 0] - 0.5) ** 2 + (pts[:, 1] - 0.5) ** 2)
    _close(tr.error_estimate_p1(_tmesh(m), u), jr.error_estimate_p1(m, u))


def test_amr_cycle_adapt():
    """One adapt() cycle of the peak-source Poisson solve."""
    mesh = build_structured_mesh(2, 6)
    fj = lambda x: jnp.exp(-100 * ((x[0] - .5) ** 2 + (x[1] - .5) ** 2))  # noqa: E731
    fnp = lambda x: float(np.exp(-100 * ((x[0] - .5) ** 2  # noqa: E731
                                         + (x[1] - .5) ** 2)))
    u0 = _poisson_u(mesh, fj)
    m1, eta = jr.adapt(mesh, u0, fnp, strategy="Doerfler", theta=0.6)
    t1, teta = tr.adapt(_tmesh(mesh), u0, fnp, strategy="Doerfler",
                        theta=0.6)
    _same_mesh(m1, t1)
    _close(teta, eta)
    u1 = _poisson_u(m1, fj)
    _close(tr.error_estimate_p1(t1, u1, fnp), jr.error_estimate_p1(m1, u1,
                                                                   fnp))


@pytest.mark.parametrize("strategy,theta", [("Maximum", 0.5),
                                            ("Doerfler", 0.5),
                                            ("Uniform", 0.5),
                                            ("Doerfler", 0.6)])
def test_marking(strategy, theta):
    eta = np.concatenate([[1.0, 2.0, 3.0, 10.0],
                          np.random.default_rng(3).random(40)])
    assert np.array_equal(tr.mark_elements(eta, strategy, theta),
                          jr.mark_elements(eta, strategy, theta))


@pytest.mark.parametrize("dim", [2, 3])
def test_bisection(dim):
    m = build_structured_mesh(dim, 3 if dim == 2 else 2)
    cur, tcur = m, _tmesh(m)
    for _ in range(2):
        cent = cur.points[cur.elements[:, :dim + 1]].mean(axis=1)
        order = np.argsort(np.linalg.norm(cent - 0.5, axis=1))
        marked = np.zeros(cur.n_elements, dtype=bool)
        marked[order[: max(4, cur.n_elements // 8)]] = True
        cur = jr.refine_bisection(cur, marked)
        tcur = tr.refine_bisection(tcur, marked)
        _same_mesh(cur, tcur)


def test_3d_estimator_and_bisection_adapt():
    f = lambda x: np.exp(-50.0 * ((x[0] - 0.5) ** 2 + (x[1] - 0.5) ** 2  # noqa: E731
                                  + (x[2] - 0.5) ** 2))
    mesh = build_structured_mesh(3, 4)
    u = np.random.default_rng(4).standard_normal(mesh.n_points)
    jm, jeta = jr.adapt(mesh, u, f, theta=0.5, method="bisection")
    tm, teta = tr.adapt(_tmesh(mesh), u, f, theta=0.5, method="bisection")
    _same_mesh(jm, tm)
    _close(teta, jeta)


@pytest.mark.parametrize("blue", [True, False])
def test_blue_red_2d(blue):
    m = build_structured_mesh(2, 6)
    rng = np.random.default_rng(0)
    marked = np.zeros(m.n_elements, dtype=bool)
    marked[rng.choice(m.n_elements, 12, replace=False)] = True
    _same_mesh(jr.refine_mesh_2d(m, marked, blue=blue),
               tr.refine_mesh_2d(_tmesh(m), marked, blue=blue))


def test_redgreen_3d_two_cycles():
    m = build_structured_mesh(3, 3)
    rng = np.random.default_rng(1)
    marked = np.zeros(m.n_elements, dtype=bool)
    marked[rng.choice(m.n_elements, 8, replace=False)] = True
    r, t = jr.refine_mesh_3d(m, marked), tr.refine_mesh_3d(_tmesh(m), marked)
    _same_mesh(r, t)
    marked2 = np.zeros(r.n_elements, dtype=bool)
    marked2[rng.choice(r.n_elements, 10, replace=False)] = True
    _same_mesh(jr.refine_mesh_3d(r, marked2), tr.refine_mesh_3d(t, marked2))


@pytest.mark.parametrize("dim,n", [(2, 6), (3, 3)])
def test_p2_estimator(dim, n):
    from feddlib_tpu.fe.domain import Domain

    msh = Domain.structured(dim, n, fe_type="P2").mesh
    tm = convert.mesh_from_numpy(msh.points, msh.elements, msh.point_flags,
                                 msh.element_flags, fe_type="P2",
                                 p2_edges=getattr(msh, "p2_edges", None))
    pts = msh.points
    for u, f in (((pts ** 2).sum(axis=1), lambda x: -2.0 * len(x)),
                 (np.sqrt(((pts - 0.5) ** 2).sum(axis=1) + 1e-12), None)):
        a, b = tr.error_estimate_p2(tm, u, f), jr.error_estimate_p2(msh, u, f)
        assert np.abs(a - b).max() <= 1e-12 * max(np.abs(b).max(), 1e-9)


def test_amr_3d_redgreen_cycles():
    """The Dörfler red-green cycles of test_amr_3d_beats_uniform on the
    same solutions."""
    fj = lambda x: jnp.exp(-60 * jnp.sum((x - 0.3) ** 2))  # noqa: E731
    fnp = lambda x: float(np.exp(-60 * np.sum((x - 0.3) ** 2)))  # noqa: E731
    cur = build_structured_mesh(3, 4)
    tcur = _tmesh(cur)
    for _ in range(2):
        u = _poisson_u(cur, fj)
        eta = jr.error_estimate_p1(cur, u, fnp)
        teta = tr.error_estimate_p1(tcur, u, fnp)
        _close(teta, eta)
        mk = jr.mark_elements(eta, "Doerfler", 0.6)
        assert np.array_equal(tr.mark_elements(teta, "Doerfler", 0.6), mk)
        cur, tcur = jr.refine_mesh_3d(cur, mk), tr.refine_mesh_3d(tcur, mk)
        _same_mesh(cur, tcur)


@pytest.fixture(scope="module")
def amr_histories():
    """adaptive_solve_cycles of tests/test_amr.py:329 in both packages:
    serial, distributed (+ pipeline) and distributed AMR, 3 cycles."""
    from feddlib_tpu.solvers.refinement import adaptive_solve_cycles as jasc
    from feddlib_tpu.utils.config import ParameterList as JPL
    from feddlib_tpu_torch.solvers.refinement import \
        adaptive_solve_cycles as tasc
    from feddlib_tpu_torch.utils.config import ParameterList as TPL

    mesh = build_structured_mesh(2, 6)

    def fj(x):
        return jnp.exp(-100 * ((x[0] - 0.5) ** 2 + (x[1] - 0.5) ** 2))

    def ft(x):
        return torch.exp(-100 * ((x[0] - 0.5) ** 2 + (x[1] - 0.5) ** 2))

    def f_np(x):
        return float(np.exp(-100 * ((x[0] - .5) ** 2 + (x[1] - .5) ** 2)))

    base = {"Preconditioner Type": "SchwarzOneLevel", "Subdomains": 4,
            "Convergence Tolerance": 1e-10, "Maximum Iterations": 2000}
    out = {}
    for mode in ("serial", "dist", "dist_amr"):
        opts = dict(base)
        if mode != "serial":
            opts.update({"Use Distributed Solve": True, "Devices": 4,
                         "Use Device Pipeline": True})
        if mode == "dist_amr":
            opts["Use Distributed AMR"] = True
        out[mode] = (
            jasc(mesh, fj, cycles=3, theta=0.6, params=JPL("P", opts),
                 source_np=f_np),
            tasc(_tmesh(mesh), ft, cycles=3, theta=0.6,
                 params=TPL("P", opts), source_np=f_np, device="cpu"))
    return out


@pytest.mark.parametrize("mode", ["dist", "dist_amr"])
def test_adaptive_solve_cycles(amr_histories, mode):
    jh, th = amr_histories[mode]
    assert [c["n_elements"] for c in th] == [c["n_elements"] for c in jh]
    assert [c["iters"] for c in th] == [c["iters"] for c in jh]
    for a, b in zip(th, jh):
        assert np.isclose(a["eta"], b["eta"], rtol=1e-8)
        assert set(a["seconds"]) >= {"rebuild", "solve", "estimate"}
    assert th[2]["eta"] < th[1]["eta"] < th[0]["eta"]


def test_adaptive_solve_cycles_serial(amr_histories):
    """The serial mode on the first mesh equals the JAX package's; after
    it, each cycle's refinement must be the JAX package's estimate, mark
    and refine of the port's own solution.  (The JAX history itself is not
    the target here: on this symmetric mesh the Dörfler cut of cycle 0
    falls inside a group of four exactly tied indicators, so the marked
    count follows the last bit of u — the port's serial RHS is summed in
    another order than the JAX package's, one ulp apart.)"""
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.problems.laplace import Laplace
    from feddlib_tpu_torch.utils.config import ParameterList as TPL

    jh, th = amr_histories["serial"]
    assert (th[0]["n_elements"], th[0]["iters"]) == (jh[0]["n_elements"],
                                                     jh[0]["iters"])
    assert np.isclose(th[0]["eta"], jh[0]["eta"], rtol=1e-8)
    opts = {"Preconditioner Type": "SchwarzOneLevel", "Subdomains": 4,
            "Convergence Tolerance": 1e-10, "Maximum Iterations": 2000}

    def ft(x):
        return torch.exp(-100 * ((x[0] - 0.5) ** 2 + (x[1] - 0.5) ** 2))

    def f_np(x):
        return float(np.exp(-100 * ((x[0] - .5) ** 2 + (x[1] - .5) ** 2)))

    jmesh = build_structured_mesh(2, 6)
    for c in range(3):
        prob = Laplace(Domain(_tmesh(jmesh), device="cpu"),
                       parameter_list=TPL("P", opts), device="cpu")
        prob.assemble()
        prob.assemble_source(ft)
        prob.add_bc(lambda x, t: 0.0, 1, 0)
        assert prob.solve() == th[c]["iters"]
        u = prob.solution[0].numpy()
        assert jmesh.n_elements == th[c]["n_elements"]
        eta = jr.error_estimate_p1(jmesh, u, f_np)
        assert np.isclose(np.sqrt((eta ** 2).sum()), th[c]["eta"],
                          rtol=1e-12)
        jmesh, _ = jr.adapt(jmesh, u, f_np, strategy="Doerfler", theta=0.6)
    assert th[2]["eta"] < th[1]["eta"] < th[0]["eta"]


@pytest.mark.parametrize("n_parts", [3, 5])
def test_distributed_estimate(n_parts):
    mesh = build_structured_mesh(2, 12)
    u = np.random.default_rng(0).standard_normal(mesh.n_points)

    def f(x):
        return float(np.sin(x[0]) + x[1])

    jpart = JPart(mesh, n_parts)
    tm = _tmesh(mesh)
    tparts = tr.estimate_distributed(tm, _tpart(jpart, tm), u, f)
    jparts = jr.estimate_distributed(mesh, jpart, u, f)
    ser = tr.error_estimate_p1(tm, u, f)
    for p in range(n_parts):
        _close(tparts[p], jparts[p])
        _close(tparts[p], ser[np.asarray(jpart.elem_ids[p])])


@pytest.mark.parametrize("strategy", ["Maximum", "Doerfler"])
def test_distributed_mark(strategy):
    mesh = build_structured_mesh(2, 10)
    eta = np.random.default_rng(1).random(mesh.n_elements)
    part = JPart(mesh, 4)
    eids = [np.asarray(part.elem_ids[p]) for p in range(4)]
    jm = jr.mark_distributed([eta[e] for e in eids], strategy=strategy,
                             theta=0.5)
    tm = tr.mark_distributed([eta[e] for e in eids], strategy=strategy,
                             theta=0.5)
    for a, b in zip(tm, jm):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("blue", [True, False])
@pytest.mark.parametrize("n_parts", [1, 4, 7])
def test_distributed_refine(blue, n_parts):
    mesh = build_structured_mesh(2, 8)
    marked = np.random.default_rng(2).random(mesh.n_elements) < 0.25
    jpart = JPart(mesh, n_parts)
    tm = _tmesh(mesh)
    tpart = _tpart(jpart, tm)
    mp = [marked[np.asarray(jpart.elem_ids[p])] for p in range(n_parts)]
    jref, jx = jr.refine_distributed_2d(mesh, jpart, mp, blue=blue)
    tref, tx = tr.refine_distributed_2d(tm, tpart, mp, blue=blue)
    _same_mesh(jref, tref)
    assert list(tx) == list(jx)
