"""Quadratic (P2) 3D linear elasticity on the port's mixed-precision
two-level path, against the plain P2 reference of the benchmark
(`benchmark/reference/fem_p2.py`, which imports nothing of the port):

- the port's P2 `LinElas` matrix equals the reference's (seeded E, nu);
- `Problem.solve` with 'Use Mixed Precision', 'TwoLevel' and the
  elasticity null space reaches the f64 relative residual 1e-8 on the
  reference's matrix and agrees with its direct solve;
- the GDSW coarse functions, whose harmonic extension solves only the
  coarse columns with a nonzero right-hand side on each subdomain, equal
  a full harmonic extension written here, and the counter
  `gdsw.extension_columns` counts the columns solved;
- the P1 mixed solves keep the JAX package's iteration counts and
  refinement passes;
- the level-1 device factor in chunks of clusters equals the JAX
  package's host inverses of the same blocks.

Run from the repository root:
    python -m pytest tests/test_torch_p2_elasticity.py -q
"""

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.linalg as spla
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.la import dense_blocks as jdb  # noqa: E402
from feddlib_tpu.la.csr import CsrMatrix as JCsr  # noqa: E402
from feddlib_tpu.mesh.partition import partition_points as jpartition_points  # noqa: E402
from feddlib_tpu.problems import Laplace as JLaplace  # noqa: E402
from feddlib_tpu.problems import LinElas as JLinElas  # noqa: E402
from feddlib_tpu.solvers import refinement as jref  # noqa: E402
from feddlib_tpu.utils.config import ParameterList as JPL  # noqa: E402

from benchmark import inputs  # noqa: E402
from benchmark.reference import fem, fem_p2  # noqa: E402
from feddlib_tpu_torch.fe.domain import Domain  # noqa: E402
from feddlib_tpu_torch.la.block import BlockVector  # noqa: E402
from feddlib_tpu_torch.mesh.mesh import Mesh  # noqa: E402
from feddlib_tpu_torch.mesh.partition import MeshPartition  # noqa: E402
from feddlib_tpu_torch.mesh.structured import flag_boxed_boundary  # noqa: E402
from feddlib_tpu_torch.precond.gdsw import (GDSWCoarseOperator,  # noqa: E402
                                            interface_components)
from feddlib_tpu_torch.problems import Laplace, LinElas  # noqa: E402
from feddlib_tpu_torch.utils import timers  # noqa: E402
from feddlib_tpu_torch.utils.config import ParameterList  # noqa: E402

MIXED = {"Use Mixed Precision": True, "TwoLevel": True,
         "Null Space Type": "elasticity", "Coarse Space Variant": "GDSW",
         "Level Combination": "Additive", "Convergence Tolerance": 1e-8,
         "Inner Tolerance": 1e-6, "Maximum Iterations": 100,
         "Num Blocks": 100}
# the f32 device factor against the f64 host inverse of the same blocks
# (1.4e-6 of the max at P2 3^3)
ROUNDOFF_F32 = 1e-4


@pytest.fixture(autouse=True)
def blas1():
    """Host LAPACK single-threaded under the port's factor thread pool."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(1, user_api="blas"):
        yield


def _p2_linelas(cells, params):
    """The port's P2 LinElas on the benchmark's cube mesh, every P2 node
    on x = 0 clamped (flag 2)."""
    points, elements = inputs.cube_mesh(cells)
    mesh = Mesh(3, "P1", points, inputs.point_flags(points, {}), elements,
                np.zeros(len(elements), dtype=np.int32))
    dom = Domain(mesh, device="cpu").p2_domain()
    dom.mesh.point_flags = inputs.point_flags(dom.mesh.points, {"x0": 2})
    prob = LinElas(dom, parameter_list=ParameterList("P", dict(params)),
                   device="cpu")
    prob.assemble()
    prob.add_bc(lambda x, t: 0.0, 2, 0)
    return prob


def _dofs(order):
    return (order[:, None] * 3 + np.arange(3)).ravel()


def test_p2_linelas_matrix_matches_the_reference():
    rng = np.random.default_rng(2**31 + 18)
    E, nu = rng.uniform(0.5, 5.0), rng.uniform(0.05, 0.45)
    prob = _p2_linelas(3, {"E": E, "Poisson Ratio": nu})
    K = prob.system.get_block(0, 0).to_scipy().toarray()
    ref = fem_p2.LinElasP2(3, *fem.lame(E, nu))
    d = _dofs(ref.m.order_of(prob.domains[0].mesh.points))
    Kr = ref.A.to_dense().numpy()[np.ix_(d, d)]
    assert K.shape == Kr.shape == (3 * 7 ** 3, 3 * 7 ** 3)
    assert np.abs(K - Kr).max() <= 1e-12 * np.abs(Kr).max()


def test_p2_mixed_two_level_solve_on_the_reference():
    """Problem.solve at P2 4^3 with 8 clusters, seeded random loads (zero
    on the clamped dofs): relres <= 1e-8 on the reference's matrix and
    within 1e-7 of its direct solve."""
    prob = _p2_linelas(4, dict(MIXED, Clusters=8))
    ref = fem_p2.LinElasP2(4, *fem.lame(1.0, 0.3))
    order = ref.m.order_of(prob.domains[0].mesh.points)
    Ar = ref.A.to_dense().numpy()
    D = ref.D.numpy()
    Ar[D] = 0.0
    Ar[D, D] = 1.0
    rng = np.random.default_rng(2**31 + 19)
    for _ in range(2):
        b = rng.standard_normal(prob.block_sizes()[0])
        b[np.repeat(prob.domains[0].mesh.point_flags == 2, 3)] = 0.0
        prob.rhs = BlockVector([torch.as_tensor(b)])
        prob.solve()
        x = prob.solution[0].numpy()
        assert prob.last_relres <= 1e-8
        assert ref.relres(ref.to_mine(order, b), ref.to_mine(order, x)) \
            <= 1e-8
        direct = np.linalg.solve(Ar, ref.to_mine(order, b))
        xr = ref.to_mine(order, x)
        assert np.abs(xr - direct).max() <= 1e-7 * np.abs(direct).max()
    prec = prob._mixed_cache["prec"]
    assert prec.n_coarse == 105
    assert tuple(prec.level1.inv.shape)[0] == 8


def _laplace_p1(cells):
    prob = Laplace(Domain.structured(3, cells, device="cpu"),
                   parameter_list=ParameterList("P", {}), device="cpu")
    prob.assemble()
    prob.add_bc(lambda x, t: 0.0, 1, 0)
    return prob, "laplace"


def _linelas_p1(cells):
    dom = Domain.structured(3, cells, device="cpu")
    flag_boxed_boundary(dom.mesh, [0.0] * 3, [1.0] * 3, {"x0": 2})
    prob = LinElas(dom, parameter_list=ParameterList("P", {}), device="cpu")
    prob.assemble()
    prob.add_bc(lambda x, t: 0.0, 2, 0)
    return prob, "elasticity"


def _linelas_p2(cells):
    return _p2_linelas(cells, {}), "elasticity"


@pytest.mark.parametrize("case,cells,clusters", [
    (_laplace_p1, 8, 8), (_linelas_p1, 6, 8), (_linelas_p2, 4, 8)])
def test_restricted_extension_equals_the_full_one(case, cells, clusters):
    prob, null_space = case(cells)
    A = prob.bc_system().get_block(0, 0)
    dom = prob.domains[0]
    part = MeshPartition((dom.parent_p1 or dom).mesh, clusters)
    umap = prob.preconditioner._merged_dof_map(part)
    (spec,) = prob.preconditioner._block_specs(part, null_space)
    mask = prob.merged_dirichlet_mask()
    timers.reset_counters("gdsw.extension_columns")
    co = GDSWCoarseOperator(A, umap, blocks=[spec], dirichlet_mask=mask)
    solved = timers.counters().get("gdsw.extension_columns", 0)
    phi = co.phi.to_scipy().toarray()

    # Phi written out: Phi_Gamma on the interface (Phi's own interface
    # rows), and on each subdomain's interior I (owned, non-interface,
    # non-Dirichlet dofs) the harmonic extension spsolve(A_II, -A_I.
    # Phi_Gamma) of every coarse column
    _, iface_node = interface_components(spec["node_part_sets"],
                                         spec["points"].shape[0])
    iface = np.repeat(iface_node, spec["dofs_per_node"]) & ~mask
    interior = ~iface & ~mask
    sp = A.to_scipy().tocsr()
    phi_gamma = np.where(iface[:, None], phi, 0.0)
    want = phi_gamma.copy()
    nonzero_columns = 0
    for owned in umap.partition_indices:
        I = owned[interior[owned]]
        if len(I) == 0:
            continue
        rhs = -(sp[I] @ phi_gamma)
        nonzero_columns += int((rhs != 0).any(axis=0).sum())
        want[I] = spla.spsolve(sps.csc_matrix(sp[I][:, I]), rhs).reshape(
            len(I), -1)
    assert np.abs(phi - want).max() <= 1e-14 * np.abs(want).max()
    assert solved == nonzero_columns
    assert solved < part.n_parts * co.n_coarse


def _p1_mixed(D, L, PL, kind, **kw):
    """The P1 mixed two-level solves of tests/test_torch_elasticity.py
    (LinElas, 8^3, x = 0 clamped, body load, rotations) and
    tests/test_torch_solve.py (Laplace, 10^3), in either package."""
    if kind == "elasticity":
        dom = D.structured(3, 8, **kw)
        flag_boxed_boundary(dom.mesh, [0.0] * 3, [1.0] * 3, {"x0": 2})
        prob = L(dom, parameter_list=PL("P", {
            "Use Mixed Precision": True, "TwoLevel": True,
            "Null Space Type": "Elasticity", "Clusters": 8}), **kw)
        load, flag = (lambda x: [0.0, 0.0, -0.1]), 2
    else:
        prob = L(D.structured(3, 10, **kw), parameter_list=PL("P", {
            "Clusters": 8, "Use Mixed Precision": True, "TwoLevel": True}),
            **kw)
        load, flag = (lambda x: 1.0 + 0 * x[0]), 1
    if not kw:  # the JAX package's loads are jnp arrays
        f = load
        load = (lambda x: jnp.asarray(f(x)))
    prob.assemble()
    prob.assemble_source(load)
    prob.add_bc(lambda x, t: 0.0, flag, 0)
    prob.set_boundaries_rhs()
    return prob


@pytest.mark.parametrize("kind", ["elasticity", "laplace"])
def test_p1_mixed_counts_match_jax(kind, monkeypatch):
    """The P1 mixed two-level solves, whose coarse space the one-field
    path now takes from `Preconditioner._block_specs`, keep the JAX
    package's refinement passes and inner iterations (within 2, f32 sums
    in another order) on the same problem, and its solution within 1e-7.
    For a P1 field the spec is the coarse space of the partition's own
    nodes that the path built before."""
    passes = []
    orig = jref.iterative_refinement

    def spy(*a, **k):
        res = orig(*a, **k)
        passes.append(res.passes)
        return res

    monkeypatch.setattr(jref, "iterative_refinement", spy)
    L = {"elasticity": (JLinElas, LinElas), "laplace": (JLaplace, Laplace)}
    pj = _p1_mixed(JDomain, L[kind][0], JPL, kind)
    pt = _p1_mixed(Domain, L[kind][1], ParameterList, kind, device="cpu")
    it_j, it_t = pj.solve(), pt.solve()
    assert pj.last_relres <= 1e-8 and pt.last_relres <= 1e-8
    assert pt.last_passes == passes[0] and abs(it_t - it_j) <= 2
    assert np.abs(pt.solution[0].numpy()
                  - np.asarray(pj.solution[0])).max() < 1e-7
    mesh = pt.domains[0].mesh
    part = MeshPartition(mesh, 8)
    (spec,) = pt.preconditioner._block_specs(part, kind)
    assert spec["points"] is mesh.points and spec["null_space"] == kind
    assert spec["dofs_per_node"] == pt.block_sizes()[0] // mesh.n_points
    for a, b in zip(spec["node_part_sets"],
                    part.repeated_map.partition_indices, strict=True):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("symmetric_rows", [False, True])
def test_chunked_level1_factor_matches_jax(symmetric_rows, dtype,
                                           monkeypatch):
    """The device factor of the P2 level-1 blocks (forced on the CPU), in
    one chunk and in chunks of 3 clusters under a small
    `FACTOR_CHUNK_BYTES`, against the JAX package's host-LU owned-row
    inverses of the same blocks with the same 1e-6 diagonal guard: the
    chunked inverse equals the one-batch one within 1e-6 of its max, and
    the JAX one within the factor dtype's roundoff.
    `level1.factor_chunks` counts the chunks.  With identity Dirichlet
    rows the blocks are not symmetric (the batched LU); the unconstrained
    operator takes the batched Cholesky."""
    from feddlib_tpu_torch.la import dense_blocks
    from feddlib_tpu_torch.la.dense_blocks import (DenseBlockSchwarz,
                                                   _blocks_symmetric)
    from feddlib_tpu_torch.solvers.linear import point_cluster_operators

    prob = _p2_linelas(3, {})
    A = (prob.system if symmetric_rows else prob.bc_system()).get_block(0, 0)
    assert _blocks_symmetric(A) == symmetric_rows
    points = prob.domains[0].mesh.points
    db, _ = point_cluster_operators(A, points, 8, 3)
    Kj = JCsr.from_scipy(A.to_scipy())
    dbj = jdb.DenseBlockSpMV.from_csr(
        Kj, np.repeat(jpartition_points(points, 8), 3), dtype=jnp.float64)
    assert np.array_equal(db.old_of_pad.numpy(), np.asarray(dbj.old_of_pad))
    want = np.asarray(jdb.DenseBlockSchwarz(
        Kj, dbj, dtype=jnp.float64, device_factor=False, shift=1e-6).inv)
    P, R, W = db.P, db.R, db.blocks.shape[2]
    per = (2 * W * W + 2 * W * R) * torch.finfo(dtype).bits // 8
    timers.reset_counters("level1.factor_chunks")
    # torch's batched CPU LU can stall under several intra-op threads (MKL)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = DenseBlockSchwarz(A, db, dtype=dtype, device_factor=True)
        assert timers.counters()["level1.factor_chunks"] == 1
        monkeypatch.setattr(dense_blocks, "FACTOR_CHUNK_BYTES", 3 * per)
        chunked = DenseBlockSchwarz(A, db, dtype=dtype, device_factor=True)
    finally:
        torch.set_num_threads(threads)
    assert timers.counters()["level1.factor_chunks"] == 1 + -(-P // 3)
    assert chunked.inv.dtype == dtype
    assert chunked.inv.shape == one.inv.shape == want.shape == (P, R, W)
    scale = np.abs(want).max()
    assert float((chunked.inv - one.inv).abs().max()) <= 1e-6 * scale
    err = np.abs(chunked.inv.double().numpy() - want).max() / scale
    assert err <= (ROUNDOFF_F32 if dtype == torch.float32 else 1e-12), err
