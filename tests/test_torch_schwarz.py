"""The port's f64 Schwarz preconditioner types (feddlib_tpu_torch:
la/sparse_lu.py, precond/schwarz.py, TwoLevelSchwarz in precond/gdsw.py,
the Schwarz branches of solvers/linear.py) against the JAX package, on the
scenarios of tests/test_schwarz.py, test_sparse_lu.py, test_ipou.py,
test_goldens.py and test_problems.py.  Both packages get the same matrix
(the JAX one, carried over with utils/convert.py) and the same partition
(identical RCB).  Operator applies agree within 1e-12 relative to max|z|
in f64; GMRES iteration counts agree exactly."""

import warnings

import numpy as np
import pytest
import scipy.sparse as sps
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from feddlib_tpu.bc import BCBuilder as JBC  # noqa: E402
from feddlib_tpu.fe import ops as jops  # noqa: E402
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.la.map import IndexMap as JMap  # noqa: E402
from feddlib_tpu.la.sparse_lu import BatchedSparseLU as JSLU  # noqa: E402
from feddlib_tpu.mesh.partition import MeshPartition as JPart  # noqa: E402
from feddlib_tpu.precond import gdsw as jgdsw  # noqa: E402
from feddlib_tpu.precond import schwarz as jsch  # noqa: E402
from feddlib_tpu.problems import Laplace as JLaplace  # noqa: E402
from feddlib_tpu.problems import LinElas as JLinElas  # noqa: E402
from feddlib_tpu.problems import Stokes as JStokes  # noqa: E402
from feddlib_tpu.solvers.krylov import gmres as jgmres  # noqa: E402
from feddlib_tpu.utils.config import ParameterList as JPL  # noqa: E402

from feddlib_tpu_torch.fe.domain import Domain as TDomain  # noqa: E402
from feddlib_tpu_torch.la.map import IndexMap as TMap  # noqa: E402
from feddlib_tpu_torch.la.sparse_lu import BatchedSparseLU as TSLU  # noqa: E402
from feddlib_tpu_torch.precond import gdsw as tgdsw  # noqa: E402
from feddlib_tpu_torch.precond import schwarz as tsch  # noqa: E402
from feddlib_tpu_torch.problems import Laplace as TLaplace  # noqa: E402
from feddlib_tpu_torch.problems import LinElas as TLinElas  # noqa: E402
from feddlib_tpu_torch.problems import Stokes as TStokes  # noqa: E402
from feddlib_tpu_torch.solvers.krylov import gmres as tgmres  # noqa: E402
from feddlib_tpu_torch.utils import convert  # noqa: E402
from feddlib_tpu_torch.utils.config import ParameterList as TPL  # noqa: E402

RTOL = 1e-12


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


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


_POISSON = {}


def _poisson(n, dim=2):
    """The Dirichlet Poisson system of JDomain.structured(dim, n) (the
    anchors' fixture), in both packages, with its partition maps."""
    if (n, dim) not in _POISSON:
        dom = JDomain.structured(dim, n)
        K = jops.assemble_laplace(dom)
        bcb = JBC()
        bcb.add_bc(lambda x, t: 0.0, 1, 0, dom, "Dirichlet", 1)
        b = jops.assemble_rhs(dom, lambda x: 1.0 + 0 * x[0])
        Kj, bj = bcb.apply_symmetric(K, b, 0)
        sp = Kj.to_scipy()
        Kt = convert.csr_from_numpy(sp.indptr, sp.indices, sp.data, sp.shape,
                                    device="cpu")
        _POISSON[(n, dim)] = (dom, Kj, bj, Kt, torch.as_tensor(np.array(bj)),
                              bcb.dirichlet_mask(0, dom.n_nodes))
    return _POISSON[(n, dim)]


def _tmap(jmap):
    return TMap(jmap.n_global, [np.array(ix)
                                for ix in jmap.partition_indices])


def _r(n, seed=1):
    r = np.random.default_rng(seed).standard_normal(n)
    return jnp.asarray(r), torch.as_tensor(r)


def _iters_both(Kj, bj, Kt, bt, Mj, Mt, maxiter=500):
    rj = jgmres(Kj.matvec, bj, M=Mj, tol=1e-8, maxiter=maxiter)
    rt = tgmres(Kt.matvec, bt, M=Mt, tol=1e-8, maxiter=maxiter)
    assert rj.converged and rt.converged
    assert _rel(rt.x.numpy(), rj.x) < 1e-7
    return rj.iters, rt.iters


# -- one level ----------------------------------------------------------------

def test_overlap_growth_exact():
    dom, Kj, _, Kt, _, _ = _poisson(8)
    part = JPart(dom.mesh, 4)
    owned = part.unique_map.partition_indices[0]
    for layers in (0, 1, 2):
        assert np.array_equal(
            tsch.grow_overlap(Kt.to_scipy(), owned.copy(), layers),
            jsch.grow_overlap(Kj.to_scipy(), owned, layers))


@pytest.mark.parametrize("combine", ["Restricted", "Averaging", "Full"])
def test_schwarz_combine_modes(combine):
    """tests/test_schwarz.py:43: each combine mode's apply, and GMRES with
    it beats the unpreconditioned solve in the same count as JAX."""
    dom, Kj, bj, Kt, bt, _ = _poisson(16)
    part = JPart(dom.mesh, 4)
    Mj = jsch.SchwarzPreconditioner(Kj, part.unique_map, combine=combine)
    Mt = tsch.SchwarzPreconditioner(Kt, _tmap(part.unique_map),
                                    combine=combine)
    assert Mt.solver == "dense" and Mt.inv.dtype == torch.float64
    rj, rt = _r(Kj.shape[0])
    assert _rel(Mt.apply(rt).numpy(), Mj.apply(rj)) < RTOL
    fn, ops = Mt.operator()
    assert _rel(fn(ops, rt).numpy(), Mj.apply(rj)) < RTOL
    it_j, it_t = _iters_both(Kj, bj, Kt, bt, Mj.apply, Mt.apply)
    assert it_t == it_j
    assert it_t < tgmres(Kt.matvec, bt, tol=1e-8, maxiter=500).iters


def test_schwarz_exact_single_subdomain():
    """tests/test_schwarz.py:55: one subdomain, no overlap → a direct
    solve."""
    dom, Kj, bj, Kt, bt, _ = _poisson(16)
    Mj = jsch.SchwarzPreconditioner(Kj, JMap.contiguous(dom.n_nodes, 1),
                                    overlap=0)
    Mt = tsch.SchwarzPreconditioner(Kt, TMap.contiguous(dom.n_nodes, 1),
                                    overlap=0)
    it_j, it_t = _iters_both(Kj, bj, Kt, bt, Mj.apply, Mt.apply, 10)
    assert it_t == it_j <= 2


def test_overlap_reduces_iterations():
    """tests/test_schwarz.py:68: 8 parts, overlap 0, 1, 2."""
    dom, Kj, bj, Kt, bt, _ = _poisson(16)
    part = JPart(dom.mesh, 8)
    its = []
    for ov in (0, 1, 2):
        Mj = jsch.SchwarzPreconditioner(Kj, part.unique_map, overlap=ov)
        Mt = tsch.SchwarzPreconditioner(Kt, _tmap(part.unique_map),
                                        overlap=ov)
        np.testing.assert_array_equal(Mt.ov_idx.numpy(),
                                      np.asarray(Mj.ov_idx))
        it_j, it_t = _iters_both(Kj, bj, Kt, bt, Mj.apply, Mt.apply)
        assert it_t == it_j
        its.append(it_t)
    assert its[2] <= its[1] <= its[0]


def test_schwarz_carried_over_field_by_field():
    """The port builds the same ov_idx / keep / inv as the JAX package, and
    the JAX object's arrays carried over apply alike."""
    dom, Kj, _, Kt, _, _ = _poisson(12)
    part = JPart(dom.mesh, 4)
    Mj = jsch.SchwarzPreconditioner(Kj, part.unique_map, combine="Averaging")
    Mt = tsch.SchwarzPreconditioner(Kt, _tmap(part.unique_map),
                                    combine="Averaging")
    Mc = convert.schwarz_from_numpy(
        Kj.shape[0], np.array(Mj.ov_idx), np.array(Mj.keep),
        np.array(Mj.inv), np.array(Mj.avg_scale), combine="Averaging",
        device="cpu")
    assert np.array_equal(Mt.ov_idx.numpy(), Mc.ov_idx.numpy())
    assert np.array_equal(Mt.keep.numpy(), Mc.keep.numpy())
    assert _rel(Mt.inv.numpy(), Mc.inv.numpy()) < RTOL
    assert _rel(Mt.avg_scale.numpy(), Mc.avg_scale.numpy()) < RTOL
    for a, b in zip(Mt.ov_sets, Mc.ov_sets):
        assert np.array_equal(a, b)
    rj, rt = _r(Kj.shape[0])
    assert _rel(Mc.apply(rt).numpy(), Mj.apply(rj)) < RTOL


def test_schwarz_device_factor_matches_jax():
    """The f32 device-factor branch (the blocks scattered from the matrix
    values through a slot-carrying copy, a diagonal guard, one batched
    inverse), run on the CPU: the same inverses as the JAX branch within
    f32 roundoff (1e-5 relative)."""
    dom, Kj, _, Kt, _, _ = _poisson(8)
    part = JPart(dom.mesh, 4)
    Mj = jsch.SchwarzPreconditioner(Kj, part.unique_map, dtype=jnp.float32,
                                    device_factor=True)
    Mt = tsch.SchwarzPreconditioner(Kt, _tmap(part.unique_map),
                                    dtype=torch.float32, device_factor=True)
    assert Mt.inv.dtype == torch.float32
    assert _rel(Mt.inv.numpy(), np.asarray(Mj.inv)) < 1e-5
    rj, rt = _r(Kj.shape[0])
    assert _rel(Mt.apply(rt.float()).numpy(),
                Mj.apply(rj.astype(jnp.float32))) < 1e-5


# -- sparse LU -----------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 40, 300])
def test_tri_plan_matches_jax(n):
    """The port's level plan (vectorized but for its level recursion) is
    array for array the JAX package's loop-built plan, for both factors,
    unpadded and padded."""
    from feddlib_tpu.la import sparse_lu as jslu

    from feddlib_tpu_torch.la import sparse_lu as tslu

    rng = np.random.default_rng(n)
    A = sps.random(n, n, density=0.05, random_state=int(rng.integers(1 << 30)),
                   format="csr")
    lu = sps.linalg.splu((A + A.T + 10 * sps.identity(n)).tocsc())
    for F, lower in ((lu.L, True), (lu.U, False)):
        for S in (n, n + 7):
            pj = jslu._tri_plan(F.tocsr(), lower, S)
            pt = tslu._tri_plan(F.tocsr(), lower, S)
            assert pj.keys() == pt.keys()
            for k in pj:
                assert np.array_equal(np.asarray(pt[k]), np.asarray(pj[k])), k


def test_batched_sparse_lu_exact():
    """tests/test_sparse_lu.py:31: exact against spsolve, padding lanes
    zero, and equal to the JAX package's sweeps."""
    rng = np.random.default_rng(0)
    blocks = []
    for n in (40, 57, 64):
        A = sps.random(n, n, density=0.08,
                       random_state=rng.integers(1 << 30), format="csr")
        blocks.append((A + A.T + 10 * sps.identity(n)).tocsr())
    S = max(b.shape[0] for b in blocks)
    slu = TSLU(blocks, S, device="cpu")
    sj = JSLU(blocks, S)
    assert slu.dims == sj.dims and slu.nnz_factors == sj.nnz_factors
    r = np.zeros((len(blocks), S))
    for i, b in enumerate(blocks):
        r[i, : b.shape[0]] = rng.standard_normal(b.shape[0])
    x = slu.solve(torch.as_tensor(r)).numpy()
    assert _rel(x, sj.solve(jnp.asarray(r))) < RTOL
    for i, A in enumerate(blocks):
        n = A.shape[0]
        xe = sps.linalg.spsolve(A.tocsc(), r[i, :n])
        assert np.abs(x[i, :n] - xe).max() < 1e-10
        if n < S:
            assert np.abs(x[i, n:]).max() == 0.0


@pytest.mark.parametrize("combine", ["Restricted", "Averaging"])
def test_schwarz_sparse_matches_dense(combine):
    """tests/test_sparse_lu.py:53: 'sparse' subdomain solves reproduce the
    dense inverses iteration for iteration, through apply and operator."""
    dom, Kj, bj, Kt, bt, _ = _poisson(16)
    part = JPart(dom.mesh, 8)
    um = _tmap(part.unique_map)
    pd = tsch.SchwarzPreconditioner(Kt, um, combine=combine, solver="dense")
    ps = tsch.SchwarzPreconditioner(Kt, um, combine=combine, solver="sparse")
    pj = jsch.SchwarzPreconditioner(Kj, part.unique_map, combine=combine,
                                    solver="sparse")
    assert ps.inv is None and ps.slu.dims == pj.slu.dims
    rj, rt = _r(Kj.shape[0])
    assert _rel(ps.apply(rt).numpy(), pd.apply(rt).numpy()) < 1e-10
    fn, ops = ps.operator()
    assert fn is tsch.schwarz_sparse_op_apply
    assert _rel(fn(ops, rt).numpy(), pj.apply(rj)) < RTOL
    ref = tgmres(Kt.matvec, bt, M=pd.apply, tol=1e-8, maxiter=300)
    res = tgmres(Kt.matvec, bt, M=ps.apply, tol=1e-8, maxiter=300)
    assert res.iters == ref.iters


# -- two levels ----------------------------------------------------------------

def _two_level_both(n, dim, parts, **kw):
    dom, Kj, bj, Kt, bt, mask = _poisson(n, dim)
    part = JPart(dom.mesh, parts)
    reps = part.repeated_map.partition_indices
    Mj = jgdsw.TwoLevelSchwarz(Kj, part.unique_map, reps, dom.mesh.points, 1,
                               dirichlet_mask=mask, **kw)
    Mt = tgdsw.TwoLevelSchwarz(Kt, _tmap(part.unique_map),
                               [np.array(x) for x in reps],
                               np.array(dom.mesh.points), 1,
                               dirichlet_mask=mask.copy(), **kw)
    return Kj, bj, Kt, bt, Mj, Mt


@pytest.mark.parametrize("lc", ["Additive", "Multiplicative"])
def test_level_combination(lc):
    """tests/test_schwarz.py:172: the operator form equals apply and the
    JAX apply; multiplicative takes no more iterations than additive."""
    Kj, bj, Kt, bt, Mj, Mt = _two_level_both(32, 2, 16,
                                             level_combination=lc)
    assert Mt.coarse.n_coarse == Mj.coarse.n_coarse > 0
    rj, rt = _r(Kj.shape[0], 7)
    fn, ops = Mt.operator()
    zt = fn(ops, rt).numpy()
    assert _rel(zt, Mj.apply(rj)) < RTOL
    assert _rel(Mt.apply(rt).numpy(), zt) < RTOL
    it_j, it_t = _iters_both(Kj, bj, Kt, bt, Mj.apply, Mt.apply)
    assert it_t == it_j


def test_gdsw_iteration_flatness_goldens():
    """tests/test_goldens.py:29 on 48² cells: one level 24 → 29 and two
    levels 23 → 23 GMRES iterations at 16 → 64 subdomains."""
    dom, _, _, Kt, bt, mask = _poisson(48)
    mesh = convert.mesh_from_numpy(dom.mesh.points, dom.mesh.elements,
                                   dom.mesh.point_flags)
    from feddlib_tpu_torch.mesh.partition import MeshPartition

    one, two = {}, {}
    for n_sub in (16, 64):
        part = MeshPartition(mesh, n_sub)
        l1 = tsch.SchwarzPreconditioner(Kt, part.unique_map)
        one[n_sub] = tgmres(Kt.matvec, bt, M=l1.apply, tol=1e-8,
                            maxiter=500).iters
        tl = tgdsw.TwoLevelSchwarz(Kt, part.unique_map,
                                   part.repeated_map.partition_indices,
                                   mesh.points, 1, dirichlet_mask=mask)
        two[n_sub] = tgmres(Kt.matvec, bt, M=tl.apply, tol=1e-8,
                            maxiter=500).iters
    assert one == {16: 24, 64: 29} and two == {16: 23, 64: 23}, (one, two)


def test_ipou_groups_match():
    """tests/test_ipou.py:42: the same IPOU groups, a partition of unity."""
    dom = JDomain.structured(2, 12)
    part = JPart(dom.mesh, 4)
    reps = part.repeated_map.partition_indices
    cj, _, sj = jgdsw.interface_components(reps, dom.n_nodes,
                                           return_sets=True)
    ct, _, st = tgdsw.interface_components([np.array(x) for x in reps],
                                           dom.n_nodes, return_sets=True)
    assert sj == st
    for opts in (dict(pou_type="GDSWStar"), dict(pou_type="GDSW"),
                 dict(pou_type="GDSW", edges=False)):
        gj = jgdsw.ipou_groups(cj, sj, 2, opts)
        gt = tgdsw.ipou_groups(ct, st, 2, opts)
        assert [[(c, float(w)) for c, w in g] for g in gt] == \
            [[(c, float(w)) for c, w in g] for g in gj]
    wsum = {}
    for g in tgdsw.ipou_groups(ct, st, 2, dict(pou_type="GDSWStar")):
        for ci, w in g:
            wsum[ci] = wsum.get(ci, 0.0) + w
    assert np.allclose(list(wsum.values()), 1.0)


@pytest.mark.parametrize("dim,n,parts", [(2, 24, 8), (3, 8, 8)])
def test_ipou_iterations(dim, n, parts):
    """tests/test_ipou.py:64: IPOUHarmonic within 6 iterations of GDSW, and
    each variant's count equal to the JAX package's."""
    its = {}
    for variant in ("GDSW", "IPOUHarmonic"):
        Kj, bj, Kt, bt, Mj, Mt = _two_level_both(n, dim, parts,
                                                 variant=variant)
        it_j, it_t = _iters_both(Kj, bj, Kt, bt, Mj.apply, Mt.apply, 300)
        assert it_t == it_j
        its[variant] = it_t
    assert its["IPOUHarmonic"] <= its["GDSW"] + 6, its


def test_padded_two_level_matches_serial():
    """tests/test_schwarz.py:248, port against port: the padded two-level
    apply of the mixed-precision path (f64 here) equals the port's
    TwoLevelSchwarz(overlap=1, Restricted), which equals the JAX one."""
    from feddlib_tpu.fe.host_assembly import host_poisson_dirichlet

    from feddlib_tpu_torch.la.dense_blocks import DenseBlockSpMV
    from feddlib_tpu_torch.mesh.partition import MeshPartition
    from feddlib_tpu_torch.precond.cluster_coarse import \
        PaddedTwoLevelSchwarz

    dom = JDomain.structured(3, 8)
    K, _ = host_poisson_dirichlet(dom)
    Kt = convert.csr_from_numpy(K.indptr, K.indices, K.data, K.shape,
                                device="cpu")
    mesh = convert.mesh_from_numpy(dom.mesh.points, dom.mesh.elements,
                                   dom.mesh.point_flags)
    part = MeshPartition(mesh, 8)
    db = DenseBlockSpMV.from_csr(Kt, part.unique_map.owner_of(),
                                 dtype=torch.float64)
    mask = np.asarray(mesh.point_flags) == 1
    ptl = PaddedTwoLevelSchwarz(Kt, part, db, dirichlet_mask=mask,
                                dtype=torch.float64,
                                level_combination="Multiplicative")
    ref = tgdsw.TwoLevelSchwarz(
        Kt, part.unique_map, node_part_sets=part.repeated_map.partition_indices,
        points=mesh.points, dirichlet_mask=mask,
        level_combination="Multiplicative")
    assert ptl.n_coarse == ref.coarse.n_coarse > 0
    r = torch.as_tensor(np.random.default_rng(0).standard_normal(K.shape[0]))
    z_ref = ref.apply(r)
    fn, ops = ptl.padded_operator()
    z = db.from_padded(fn(ops, db.to_padded(r)))
    assert _rel(z.numpy(), z_ref.numpy()) < RTOL
    from feddlib_tpu.la.csr import CsrMatrix as JCsr

    jpart = JPart(dom.mesh, 8)
    Mj = jgdsw.TwoLevelSchwarz(
        JCsr.from_scipy(K), jpart.unique_map,
        node_part_sets=jpart.repeated_map.partition_indices,
        points=dom.mesh.points, dirichlet_mask=mask,
        level_combination="Multiplicative")
    assert _rel(z_ref.numpy(), Mj.apply(jnp.asarray(r.numpy()))) < RTOL


# -- through Problem.solve -------------------------------------------------------

def _laplace_problem(D, L, PL, params, **kw):
    prob = L(D.structured(2, 16, **kw), parameter_list=PL("P", params), **kw)
    prob.assemble()
    prob.assemble_source(lambda x: 1.0 + 0 * x[0])
    prob.add_bc(lambda x, t: 0.0, 1, 0)
    prob.set_boundaries_rhs()
    return prob


@pytest.mark.parametrize("params", [
    {"Subdomains": 4},
    {"Subdomains": 4, "Preconditioner Type": "SchwarzOneLevel"},
    {"Subdomains": 4, "Subdomain Solver": "sparse"},
    {"Subdomains": 8, "Level Combination": "Multiplicative",
     "Coarse Space Variant": "RGDSW"},
    {"Subdomains": 8, "Coarse Space Variant": "IPOUHarmonic",
     "IPOU Type": "GDSW", "IPOU Edges": False},
], ids=["default", "one-level", "sparse", "rgdsw-mult", "ipou"])
def test_problem_solve_schwarz_types(params):
    """tests/test_problems.py:42 (default parameters: 'SchwarzTwoLevel' on
    Domain.structured(2, 16) with 4 subdomains) and the other Schwarz
    options of Preconditioner.build: converged to 1e-8 in the JAX
    package's iteration count."""
    pj = _laplace_problem(JDomain, JLaplace, JPL, params)
    pt = _laplace_problem(TDomain, TLaplace, TPL, params, device="cpu")
    it_j, it_t = pj.solve(), pt.solve()
    assert pt.last_relres <= 1e-8 and it_t == it_j
    if params == {"Subdomains": 4}:
        assert it_t < 40
    assert _rel(pt.solution[0].numpy(), pj.solution[0]) < 1e-7


@pytest.mark.parametrize("prec", ["SchwarzOneLevel", "SchwarzTwoLevel"])
def test_gdsw_elasticity_rotations(prec):
    """tests/test_schwarz.py:209: 2D LinElas, left edge clamped, elasticity
    null space, 16 subdomains; the port's counts equal the JAX ones (and
    two levels beat one, as the JAX test holds)."""
    def run(D, L, PL, load, **kw):
        dom = D.structured(2, 24, **kw)
        prob = L(dom, parameter_list=PL("p", {
            "E": 10.0, "Poisson Ratio": 0.3, "Preconditioner Type": prec,
            "Subdomains": 16, "Null Space Type": "Elasticity",
            "Maximum Iterations": 3000, "Convergence Tolerance": 1e-8}),
            **kw)
        prob.assemble()
        dom.mesh.point_flags = dom.mesh.point_flags.copy()
        dom.mesh.point_flags[np.isclose(dom.mesh.points[:, 0], 0.0)] = 8
        prob.add_bc(lambda x, t: 0.0 * x[0], 8, 0)
        prob.assemble_source(load)
        prob.set_boundaries_rhs()
        return prob.solve(), prob

    it_j, _ = run(JDomain, JLinElas, JPL, lambda x: jnp.array([0.0, -1.0]))
    it_t, pt = run(TDomain, TLinElas, TPL, lambda x: [0.0, -1.0],
                   device="cpu")
    assert pt.last_relres <= 1e-8 and it_t == it_j
    if prec == "SchwarzTwoLevel":
        assert it_t < 60 and pt.preconditioner.prec.coarse.n_coarse > 0


def test_monolithic_block_gdsw_stokes():
    """tests/test_schwarz.py:81: monolithic block GDSW on the P2/P1 Stokes
    saddle point at 16 subdomains — no one-level fallback warning, fewer
    iterations than one level, each count equal to the JAX package's."""
    def run(D, S, PL, prec, lid, **kw):
        dom_p = D.structured(2, 16, **kw)
        prob = S(dom_p.p2_domain(), dom_p, parameter_list=PL("p", {
            "Viscosity": 1.0, "Preconditioner Type": prec, "Subdomains": 16,
            "Maximum Iterations": 4000}), **kw)
        prob.assemble()
        prob.add_bc(lid, 1, 0)
        dom_p.mesh.point_flags = dom_p.mesh.point_flags.copy()
        dom_p.mesh.point_flags[0] = 77
        prob.bc_builder.add_bc(lambda x, t: 0.0, 77, 1, dom_p, "Dirichlet", 1)
        prob.set_boundaries_rhs()
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # a fallback warning fails
            its = prob.solve()
        assert prob.last_relres <= 1e-8
        return its

    lid_j = lambda x, t: jnp.where(jnp.isclose(x[1], 1.0),  # noqa: E731
                                   jnp.array([1.0, 0.0]), jnp.zeros(2))
    lid_t = lambda x, t: torch.stack(  # noqa: E731
        [torch.isclose(x[1], torch.tensor(1.0, dtype=x.dtype)).double(),
         0.0 * x[0]])
    its = {}
    for prec in ("SchwarzOneLevel", "SchwarzTwoLevel"):
        its[prec] = run(TDomain, TStokes, TPL, prec, lid_t, device="cpu")
        assert its[prec] == run(JDomain, JStokes, JPL, prec, lid_j), prec
    assert its["SchwarzTwoLevel"] < its["SchwarzOneLevel"], its
