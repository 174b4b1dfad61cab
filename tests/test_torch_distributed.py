"""The port's distributed preconditioners and solve (feddlib_tpu_torch:
`distributed_schwarz`, `distributed_two_level`, `LinearSolver.
_solve_distributed`) against the JAX package, on the scenarios of
tests/test_components.py, test_sparse_lu.py, test_pipeline.py and
test_problems.py.  Both packages get the same matrix (the JAX one, carried
over with utils/convert.py) and the same partition (identical RCB); the
port stacks its shards on the CPU.  Each distributed solve must take the
JAX distributed run's iteration count and the port's serial count, with x
within 1e-9 of both (the anchors' tolerance)."""

import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from feddlib_tpu.bc import BCBuilder as JBC  # noqa: E402
from feddlib_tpu.fe import ops as jops  # noqa: E402
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.mesh.partition import MeshPartition as JPart  # noqa: E402
from feddlib_tpu.parallel import spmd as jspmd  # noqa: E402
from feddlib_tpu.parallel.solve import DistributedSolver as JSolver  # noqa: E402
from feddlib_tpu.precond import gdsw as jgdsw  # noqa: E402
from feddlib_tpu.precond import schwarz as jsch  # noqa: E402
from feddlib_tpu.problems import Laplace as JLaplace  # noqa: E402
from feddlib_tpu.problems import LinElas as JLinElas  # noqa: E402
from feddlib_tpu.problems import Stokes as JStokes  # noqa: E402
from feddlib_tpu.utils.config import ParameterList as JPL  # noqa: E402

from feddlib_tpu_torch.fe.domain import Domain as TDomain  # noqa: E402
from feddlib_tpu_torch.la.map import IndexMap as TMap  # noqa: E402
from feddlib_tpu_torch.mesh.partition import MeshPartition as TPart  # noqa: E402
from feddlib_tpu_torch.parallel import spmd as tspmd  # noqa: E402
from feddlib_tpu_torch.parallel.solve import DistributedSolver as TSolver  # noqa: E402
from feddlib_tpu_torch.precond import gdsw as tgdsw  # noqa: E402
from feddlib_tpu_torch.precond import schwarz as tsch  # noqa: E402
from feddlib_tpu_torch.problems import Laplace as TLaplace  # noqa: E402
from feddlib_tpu_torch.problems import LinElas as TLinElas  # noqa: E402
from feddlib_tpu_torch.problems import Stokes as TStokes  # noqa: E402
from feddlib_tpu_torch.solvers.krylov import gmres as tgmres  # noqa: E402
from feddlib_tpu_torch.utils import convert  # noqa: E402
from feddlib_tpu_torch.utils.config import ParameterList as TPL  # noqa: E402

ATOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def blas1():
    """Host LAPACK single-threaded under the JAX package's factor thread
    pool (the port pins its own)."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(1, user_api="blas"):
        yield


_SYS = {}


def _poisson(n):
    """The anchors' Dirichlet Poisson system on Domain.structured(2, n), in
    both packages, with its Dirichlet mask."""
    if n not in _SYS:
        dom = JDomain.structured(2, n)
        K = jops.assemble_laplace(dom)
        bcb = JBC()
        bcb.add_bc(lambda x, t: 0.0, 1, 0, dom, "Dirichlet", 1)
        b = jops.assemble_rhs(dom, lambda x: 1.0 + 0 * x[0])
        Kj, bj = bcb.apply_symmetric(K, b, 0)
        _SYS[n] = (dom, Kj, np.array(bj), _port_csr(Kj),
                   bcb.dirichlet_mask(0, dom.n_nodes))
    return _SYS[n]


def _port_csr(Kj):
    sp = Kj.to_scipy()
    return convert.csr_from_numpy(sp.indptr, sp.indices, sp.data, sp.shape,
                                  device="cpu")


def _tmap(jmap):
    return TMap(jmap.n_global, [np.array(ix)
                                for ix in jmap.partition_indices])


class _Pair:
    """The same system distributed in both packages over one map."""

    def __init__(self, Kj, Kt, b, jmap):
        self.jmap, self.tmap = jmap, _tmap(jmap)
        self.dj = jspmd.DistributedCsr(Kj, jmap)
        self.dt = tspmd.DistributedCsr(Kt, self.tmap)
        self.sj = JSolver(self.dj, jspmd.DeviceAxis.make(jmap.n_parts))
        self.st = TSolver(self.dt)
        self.bj = jspmd.distribute_vector(b, jmap, self.dj.plan.N_o)
        self.bt = tspmd.distribute_vector(b, self.tmap, self.dt.plan.N_o,
                                          device="cpu")

    def solve(self, prec_j, prec_t, **kw):
        """(iters, x) of the JAX and the port's distributed GMRES."""
        kw = dict(dict(method="gmres", tol=1e-8, maxiter=500), **kw)
        xj, it_j, _ = self.sj.solve(self.bj, precond=prec_j, **kw)
        xt, it_t, rel = self.st.solve(self.bt, precond=prec_t, **kw)
        assert rel <= kw["tol"]
        return ((it_j, jspmd.collect_vector(xj, self.jmap)),
                (it_t, tspmd.collect_vector(xt, self.tmap)))


def _serial(Kt, b, M):
    res = tgmres(Kt.matvec, torch.as_tensor(b), M=M, tol=1e-8, maxiter=500)
    assert res.converged
    return res.iters, res.x.numpy()


def _agree(jax_run, port_run, serial_run=None):
    (it_j, xj), (it_t, xt) = jax_run, port_run
    assert it_t == it_j, (it_t, it_j)
    np.testing.assert_allclose(xt, xj, atol=ATOL)
    if serial_run is not None:
        assert it_t == serial_run[0], (it_t, serial_run[0])
        np.testing.assert_allclose(xt, serial_run[1], atol=ATOL)


@pytest.mark.parametrize("combine", ["Restricted", "Full", "Averaging"])
def test_distributed_schwarz_matches_serial(combine):
    """tests/test_components.py:116: one-level Schwarz on 4 shards, each
    combine mode."""
    dom, Kj, b, Kt, _ = _poisson(12)
    part = JPart(dom.mesh, 4)
    pr = _Pair(Kj, Kt, b, part.unique_map)
    runs = pr.solve(jsch.distributed_schwarz(pr.dj, combine=combine),
                    tsch.distributed_schwarz(pr.dt, combine=combine))
    ser = tsch.SchwarzPreconditioner(Kt, pr.tmap, overlap=1, combine=combine)
    _agree(*runs, _serial(Kt, b, ser.apply))


def _two_level_serial(Kt, b, tmap, part, dmask, **kw):
    tls = tgdsw.TwoLevelSchwarz(Kt, tmap, part.repeated_map.partition_indices,
                                part.mesh.points, 1, overlap=1,
                                dirichlet_mask=dmask, **kw)
    return _serial(Kt, b, tls.apply)


def test_distributed_two_level_matches_serial():
    """tests/test_components.py:180: two-level GDSW on 8 shards (coarse
    residual through psum)."""
    dom, Kj, b, Kt, dmask = _poisson(16)
    part = JPart(dom.mesh, 8)
    pr = _Pair(Kj, Kt, b, part.unique_map)
    runs = pr.solve(
        jgdsw.distributed_two_level(pr.dj, part, dom.mesh.points, 1,
                                    dirichlet_mask=dmask),
        tgdsw.distributed_two_level(pr.dt, part, dom.mesh.points, 1,
                                    dirichlet_mask=dmask))
    _agree(*runs, _two_level_serial(Kt, b, pr.tmap, part, dmask))


def test_dedicated_coarse_ranks():
    """tests/test_components.py:283: the rows on the first 6 of 8 shards
    (with_free_parts), the JAX package's A₀⁻¹ row-sharded over the 2 free
    ones (the port's stacked shards solve the coarse problem once); the
    serial reference is the 6-part two-level operator."""
    dom, Kj, b, Kt, dmask = _poisson(16)
    part = JPart(dom.mesh, 6)
    umap8 = part.unique_map.with_free_parts(2)
    pr = _Pair(Kj, Kt, b, umap8)
    assert pr.tmap.n_parts == 8 and pr.tmap.is_unique()
    runs = pr.solve(
        jgdsw.distributed_two_level(pr.dj, part, dom.mesh.points, 1,
                                    dirichlet_mask=dmask, coarse_ranks=2),
        tgdsw.distributed_two_level(pr.dt, part, dom.mesh.points, 1,
                                    dirichlet_mask=dmask, coarse_ranks=2))
    _agree(*runs, _two_level_serial(Kt, b, _tmap(part.unique_map), part,
                                    dmask))
    with pytest.raises(ValueError, match="own no matrix rows"):
        tgdsw.distributed_two_level(
            tspmd.DistributedCsr(Kt, _tmap(JPart(dom.mesh, 8).unique_map)),
            part, dom.mesh.points, 1, dirichlet_mask=dmask, coarse_ranks=2)


def test_coarse_numprocs_matches_replicated():
    """tests/test_components.py:436: 'Coarse NumProcs' 2 (in the JAX
    package A₀⁻¹ row-sharded over the first 2 shards) in the replicated
    count, and in the JAX package's."""
    dom, Kj, b, Kt, dmask = _poisson(16)
    part = JPart(dom.mesh, 8)
    pr = _Pair(Kj, Kt, b, part.unique_map)
    runs = {}
    for cp in (0, 2):
        runs[cp] = pr.solve(
            jgdsw.distributed_two_level(pr.dj, part, dom.mesh.points, 1,
                                        dirichlet_mask=dmask,
                                        coarse_procs=cp),
            tgdsw.distributed_two_level(pr.dt, part, dom.mesh.points, 1,
                                        dirichlet_mask=dmask,
                                        coarse_procs=cp))
        _agree(*runs[cp])
    _agree(runs[0][1], runs[2][1])


@pytest.mark.parametrize("combo,csolver", [("Multiplicative", "dense"),
                                           ("Additive", "sparse"),
                                           ("Multiplicative", "sparse")])
def test_distributed_two_level_variants_match_serial(combo, csolver):
    """tests/test_components.py:475: the multiplicative level combination
    and the sparse-LU coarse solve."""
    dom, Kj, b, Kt, dmask = _poisson(16)
    part = JPart(dom.mesh, 8)
    pr = _Pair(Kj, Kt, b, part.unique_map)
    kw = dict(dirichlet_mask=dmask, level_combination=combo,
              coarse_solver=csolver)
    runs = pr.solve(
        jgdsw.distributed_two_level(pr.dj, part, dom.mesh.points, 1, **kw),
        tgdsw.distributed_two_level(pr.dt, part, dom.mesh.points, 1, **kw))
    _agree(*runs, _two_level_serial(Kt, b, pr.tmap, part, dmask,
                                    level_combination=combo))


def test_distributed_two_level_iterative_coarse():
    """tests/test_components.py:517: the GMRES coarse solve (tol 1e-6)
    against the exact dense one: outer counts within one, and each equal
    to the JAX package's."""
    dom, Kj, b, Kt, dmask = _poisson(16)
    part = JPart(dom.mesh, 8)
    pr = _Pair(Kj, Kt, b, part.unique_map)
    its = {}
    for csolver in ("dense", "iterative"):
        (it_j, xj), (it_t, xt) = pr.solve(
            jgdsw.distributed_two_level(pr.dj, part, dom.mesh.points, 1,
                                        dirichlet_mask=dmask,
                                        coarse_solver=csolver),
            tgdsw.distributed_two_level(pr.dt, part, dom.mesh.points, 1,
                                        dirichlet_mask=dmask,
                                        coarse_solver=csolver))
        assert it_t == it_j
        np.testing.assert_allclose(xt, xj, atol=ATOL)
        res = Kt.to_scipy() @ xt - b
        cap = 1e-7 if csolver == "dense" else 2e-5
        assert np.linalg.norm(res) / np.linalg.norm(b) < cap
        its[csolver] = it_t
    assert abs(its["iterative"] - its["dense"]) <= 1, its


def test_distributed_iterative_coarse_nonsymmetric():
    """tests/test_components.py:564: vector Laplace + advection (a
    nonsymmetric A₀) on 8 shards, dense against GMRES coarse solves."""
    dom = JDomain.structured(2, 12)
    n_u = dom.n_dofs(2)
    adv = jnp.asarray(np.tile([1.0, 0.3], dom.n_nodes))
    A = jops.assemble_laplace_vec(dom, 0.1).add(
        jops.assemble_advection(dom, adv))
    bcb = JBC()
    bcb.add_bc(lambda x, t: np.zeros(2), 1, 0, dom, "Dirichlet", 2)
    bb = jnp.asarray(np.random.default_rng(3).standard_normal(n_u))
    Ab, bb = bcb.apply_symmetric(A, bb, 0)
    dmask = bcb.dirichlet_mask(0, n_u)
    part = JPart(dom.mesh, 8)
    pr = _Pair(Ab, _port_csr(Ab), np.array(bb),
               part.unique_map.build_vec_field_map(2))
    its = {}
    for csolver in ("dense", "iterative"):
        runs = pr.solve(
            jgdsw.distributed_two_level(pr.dj, part, dom.mesh.points, 2,
                                        dirichlet_mask=dmask,
                                        coarse_solver=csolver),
            tgdsw.distributed_two_level(pr.dt, part, dom.mesh.points, 2,
                                        dirichlet_mask=dmask,
                                        coarse_solver=csolver))
        _agree(*runs)
        its[csolver] = runs[1][0]
    assert abs(its["iterative"] - its["dense"]) <= 1, its


@pytest.mark.parametrize("csolver", ["sparse", "iterative"])
def test_distributed_coarse_solver_with_numprocs(csolver):
    """tests/test_components.py:604: the scalable coarse solvers under
    'Coarse NumProcs' 2, in the replicated count."""
    dom, Kj, b, Kt, dmask = _poisson(16)
    part = JPart(dom.mesh, 8)
    pr = _Pair(Kj, Kt, b, part.unique_map)
    runs = {}
    for cp in (0, 2):
        kw = dict(dirichlet_mask=dmask, coarse_solver=csolver,
                  coarse_procs=cp)
        runs[cp] = pr.solve(
            jgdsw.distributed_two_level(pr.dj, part, dom.mesh.points, 1,
                                        **kw),
            tgdsw.distributed_two_level(pr.dt, part, dom.mesh.points, 1,
                                        **kw))
        _agree(*runs[cp])
    assert runs[2][1][0] == runs[0][1][0]


def test_distributed_schwarz_sparse_matches_dense():
    """tests/test_sparse_lu.py:75: overlap-2 one-level Schwarz on 8 shards
    with the sparse-LU subdomain solves (all shards in one batched LU) in
    the dense inverses' count."""
    dom, Kj, b, Kt, _ = _poisson(16)
    part = JPart(dom.mesh, 8)
    pr = _Pair(Kj, Kt, b, part.unique_map)
    runs = {}
    for factor in ("host", "sparse"):
        runs[factor] = pr.solve(
            jsch.distributed_schwarz(pr.dj, overlap=2, factor=factor),
            tsch.distributed_schwarz(pr.dt, overlap=2, factor=factor))
        _agree(*runs[factor])
    assert runs["sparse"][1][0] == runs["host"][1][0]


def test_distributed_overlap2_matches_serial():
    """tests/test_pipeline.py:168: overlap 2 (its own halo plan beyond the
    SpMV column map), Restricted and Averaging, equal to the serial
    overlap-2 operator."""
    dom, Kj, b, Kt, _ = _poisson(16)
    part = JPart(dom.mesh, 8)
    pr = _Pair(Kj, Kt, b, part.unique_map)
    for combine in ("Restricted", "Averaging"):
        runs = pr.solve(
            jsch.distributed_schwarz(pr.dj, overlap=2, combine=combine),
            tsch.distributed_schwarz(pr.dt, overlap=2, combine=combine))
        ser = tsch.SchwarzPreconditioner(Kt, pr.tmap, overlap=2,
                                         combine=combine)
        _agree(*runs, _serial(Kt, b, ser.apply))


def test_distributed_device_factor_matches_host():
    """factor="device" (the blocks scattered from the stacked ELL values,
    a diagonal guard, one batched inverse) against the JAX branch: one
    apply within 1e-10 of max |z| (the guard shifts the f64 blocks by
    1e-12 |A|), the same GMRES count."""
    dom, Kj, b, Kt, _ = _poisson(12)
    part = JPart(dom.mesh, 4)
    pr = _Pair(Kj, Kt, b, part.unique_map)
    pj = jsch.distributed_schwarz(pr.dj, factor="device")
    pt = tsch.distributed_schwarz(pr.dt, factor="device")
    (it_j, xj), (it_t, xt) = pr.solve(pj, pt)
    assert it_t == it_j
    np.testing.assert_allclose(xt, xj, atol=ATOL)
    host = tsch.distributed_schwarz(pr.dt)
    _, M_dev = pr.st.operators(pt)
    _, M_host = pr.st.operators(host)
    z_dev, z_host = M_dev(pr.bt), M_host(pr.bt)
    assert float((z_dev - z_host).abs().max()) <= 1e-10 * float(
        z_host.abs().max())


def _laplace_run(D, L, PL, params, **kw):
    prob = L(D.structured(2, 16, **kw), parameter_list=PL("P", params), **kw)
    prob.assemble()
    prob.assemble_source(lambda x: 1.0 + 0 * x[0])
    prob.add_bc(lambda x, t: 0.0, 1, 0)
    prob.set_boundaries_rhs()
    iters = prob.solve()
    sol = prob.solution[0]
    return iters, (sol.numpy() if torch.is_tensor(sol) else np.asarray(sol))


def test_problem_distributed_backend():
    """tests/test_problems.py:155: 'Use Distributed Solve' with 8 shards
    through Problem.solve() ('SchwarzOneLevel'): the serial count, and the
    JAX distributed run's."""
    res = {}
    for pkg, D, L, PL, kw in (("jax", JDomain, JLaplace, JPL, {}),
                              ("torch", TDomain, TLaplace, TPL,
                               {"device": "cpu"})):
        for dist in (False, True):
            res[pkg, dist] = _laplace_run(D, L, PL, {
                "Preconditioner Type": "SchwarzOneLevel",
                "Use Distributed Solve": dist, "Devices": 8,
                "Subdomains": 8}, **kw)
    _agree(res["jax", True], res["torch", True], res["torch", False])
    assert res["torch", True][0] == res["jax", False][0]


def test_use_distributed_solve_two_level_laplace():
    """The pipe_on=False half of tests/test_pipeline.py:270: 4 shards,
    'SchwarzTwoLevel', tol 1e-9, through Problem.solve(); a second solve
    reuses the cached shards and preconditioner and gives the same x."""
    params = {"Use Distributed Solve": True, "Devices": 4,
              "Preconditioner Type": "SchwarzTwoLevel", "Overlap": 1,
              "Convergence Tolerance": 1e-9, "Maximum Iterations": 500}
    it_j, xj = _laplace_run(JDomain, JLaplace, JPL, params)
    prob = TLaplace(TDomain.structured(2, 16, device="cpu"),
                    parameter_list=TPL("P", params), device="cpu")
    prob.assemble()
    prob.assemble_source(lambda x: 1.0 + 0 * x[0])
    prob.add_bc(lambda x, t: 0.0, 1, 0)
    prob.set_boundaries_rhs()
    it_t = prob.solve()
    xt = prob.solution[0].numpy().copy()
    cache = prob._dist_cache
    assert it_t == it_j and prob.last_relres <= 1e-9
    np.testing.assert_allclose(xt, xj, atol=ATOL)
    assert prob.solve() == it_t and prob._dist_cache is cache
    assert np.array_equal(prob.solution[0].numpy(), xt)
    ser = dict(params, **{"Use Distributed Solve": False, "Subdomains": 4})
    _agree((it_j, xj), (it_t, xt),
           _laplace_run(TDomain, TLaplace, TPL, ser, device="cpu"))


def test_distributed_solve_elasticity_and_stokes():
    """'Use Distributed Solve' on the other problem kinds of the
    assembled-matrix branch: 2D LinElas with the elasticity null space
    (tests/test_schwarz.py:209's setup, 8 shards) and the P2/P1 Stokes
    system through the monolithic block GDSW (tests/test_schwarz.py:81's,
    4 shards); each count equal to the JAX distributed run's and the
    port's serial one."""
    def elas(D, L, PL, load, dist, **kw):
        dom = D.structured(2, 12, **kw)
        prob = L(dom, parameter_list=PL("p", {
            "E": 10.0, "Poisson Ratio": 0.3,
            "Preconditioner Type": "SchwarzTwoLevel", "Subdomains": 8,
            "Devices": 8, "Use Distributed Solve": dist,
            "Null Space Type": "Elasticity", "Maximum Iterations": 3000,
            "Convergence Tolerance": 1e-8}), **kw)
        prob.assemble()
        dom.mesh.point_flags = dom.mesh.point_flags.copy()
        dom.mesh.point_flags[np.isclose(dom.mesh.points[:, 0], 0.0)] = 8
        prob.add_bc(lambda x, t: 0.0 * x[0], 8, 0)
        prob.assemble_source(load)
        prob.set_boundaries_rhs()
        it = prob.solve()
        s = prob.solution[0]
        return it, (s.numpy() if torch.is_tensor(s) else np.asarray(s))

    _agree(elas(JDomain, JLinElas, JPL, lambda x: jnp.array([0.0, -1.0]),
                True),
           elas(TDomain, TLinElas, TPL, lambda x: [0.0, -1.0], True,
                device="cpu"),
           elas(TDomain, TLinElas, TPL, lambda x: [0.0, -1.0], False,
                device="cpu"))

    def stokes(D, S, PL, lid, dist, **kw):
        dom_p = D.structured(2, 8, **kw)
        prob = S(dom_p.p2_domain(), dom_p, parameter_list=PL("p", {
            "Viscosity": 1.0, "Preconditioner Type": "SchwarzTwoLevel",
            "Subdomains": 4, "Devices": 4, "Use Distributed Solve": dist,
            "Maximum Iterations": 4000}), **kw)
        prob.assemble()
        prob.add_bc(lid, 1, 0)
        dom_p.mesh.point_flags = dom_p.mesh.point_flags.copy()
        dom_p.mesh.point_flags[0] = 77
        prob.bc_builder.add_bc(lambda x, t: 0.0, 77, 1, dom_p, "Dirichlet", 1)
        prob.set_boundaries_rhs()
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # a one-level fallback fails
            it = prob.solve()
        assert prob.last_relres <= 1e-8
        s = prob.solution.concat()
        return it, (s.numpy() if torch.is_tensor(s) else np.asarray(s))

    lid_j = lambda x, t: jnp.where(jnp.isclose(x[1], 1.0),  # noqa: E731
                                   jnp.array([1.0, 0.0]), jnp.zeros(2))
    lid_t = lambda x, t: torch.stack(  # noqa: E731
        [torch.isclose(x[1], torch.tensor(1.0, dtype=x.dtype)).double(),
         0.0 * x[0]])
    _agree(stokes(JDomain, JStokes, JPL, lid_j, True),
           stokes(TDomain, TStokes, TPL, lid_t, True, device="cpu"),
           stokes(TDomain, TStokes, TPL, lid_t, False, device="cpu"))
