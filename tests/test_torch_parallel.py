"""The port's shard-axis linear algebra (feddlib_tpu_torch/parallel:
spmd.py, solve.py, assembly.py) against the JAX package, on the scenarios
of tests/test_parallel.py.  Both packages get the same matrix (the JAX one,
carried over with utils/convert.py) and the same partition (identical
RCB); the port runs its shards stacked on the CPU.  The plans are compared
entry for entry, the applies within 1e-12, the Krylov counts exactly."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from feddlib_tpu.bc import BCBuilder as JBC  # noqa: E402
from feddlib_tpu.fe import ops as jops  # noqa: E402
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.mesh.partition import MeshPartition as JPart  # noqa: E402
from feddlib_tpu.parallel import assembly as jasm  # noqa: E402
from feddlib_tpu.parallel import spmd as jspmd  # noqa: E402
from feddlib_tpu.parallel.solve import DistributedSolver as JSolver  # noqa: E402
from feddlib_tpu.solvers.krylov import cg as jcg  # noqa: E402

from feddlib_tpu_torch.la.map import IndexMap as TMap  # noqa: E402
from feddlib_tpu_torch.mesh.partition import MeshPartition as TPart  # noqa: E402
from feddlib_tpu_torch.parallel import assembly as tasm  # noqa: E402
from feddlib_tpu_torch.parallel import spmd as tspmd  # noqa: E402
from feddlib_tpu_torch.parallel.solve import DistributedSolver as TSolver  # noqa: E402
from feddlib_tpu_torch.precond.gdsw import distributed_two_level  # noqa: E402
from feddlib_tpu_torch.precond.schwarz import distributed_schwarz  # noqa: E402
from feddlib_tpu_torch.solvers import krylov as tk  # noqa: E402
from feddlib_tpu_torch.utils import convert  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def poisson():
    """tests/test_parallel.py's fixture: the Dirichlet Poisson system of
    Domain.structured(2, 12) and its serial CG reference, in both
    packages."""
    dom = JDomain.structured(2, 12)
    K = jops.assemble_laplace(dom)
    bcb = JBC()
    bcb.add_bc(lambda x, t: 0.0, 1, 0, dom, "Dirichlet", 1)
    b = jops.assemble_rhs(dom, lambda x: 1.0 + 0 * x[0])
    Kj, bj = bcb.apply_symmetric(K, b, 0)
    ref = jcg(Kj.matvec, bj, tol=1e-10, maxiter=2000)
    sp = Kj.to_scipy()
    Kt = convert.csr_from_numpy(sp.indptr, sp.indices, sp.data, sp.shape,
                                device="cpu")
    return dom, Kj, bj, ref, Kt, np.array(bj)


def _tmap(jmap):
    return TMap(jmap.n_global, [np.array(ix)
                                for ix in jmap.partition_indices])


def _both(dom, Kj, Kt, n_parts):
    part = JPart(dom.mesh, n_parts)
    umap = _tmap(part.unique_map)
    return (part, jspmd.DistributedCsr(Kj, part.unique_map),
            umap, tspmd.DistributedCsr(Kt, umap))


def _eq(t, j):
    np.testing.assert_array_equal(np.asarray(t.cpu() if torch.is_tensor(t)
                                             else t), np.asarray(j))


@pytest.mark.parametrize("n_parts", [2, 4, 8])
def test_halo_plan_and_ell_equal_jax(poisson, n_parts):
    """Every array of the halo plan (send sets, ghost_src, the export plan,
    each round's perm and index arrays, gidx) and of the ELL layout equals
    the JAX package's, entry for entry."""
    dom, Kj, _, _, Kt, _ = poisson
    _, dj, _, dt = _both(dom, Kj, Kt, n_parts)
    pj, pt = dj.plan, dt.plan
    for a in ("n_dev", "N_o", "G", "B", "R", "_recv_total"):
        assert getattr(pt, a) == getattr(pj, a), a
    for a in ("send_idx", "ghost_src", "recv_src", "recv_dst", "owned_mask"):
        _eq(getattr(pt, a), getattr(pj, a))
    assert pt._round_meta == pj._round_meta
    assert len(pt._round_meta) >= 1
    for ts, js in zip(pt.import_arrays[0], pj.import_arrays[0]):
        _eq(ts, js)
    _eq(pt.import_arrays[1], pj.import_arrays[1])
    for tt, jt in zip(pt.export_arrays, pj.export_arrays):
        assert len(tt) == len(jt)
        for a, b in zip(tt, jt):
            _eq(a, b)
    assert dt.K == dj.K
    _eq(dt.ell_cols, dj.ell_cols)
    _eq(dt.ell_data, dj.ell_data)
    _eq(dt.row_lens, dj.row_lens)
    for a, b in zip(dt.col_gids, dj.col_gids):
        _eq(a, b)
    lt, lj = dt.locator(), dj.locator()
    assert (lt != lj).nnz == 0
    for p in (0, n_parts - 1):
        (ot, rt), (oj, rj) = dt.local_rows(p), dj.local_rows(p)
        _eq(ot, oj)
        assert abs(rt - rj).max() == 0


@pytest.mark.parametrize("n_parts", [2, 4, 8])
def test_distributed_matvec(poisson, n_parts):
    """tests/test_parallel.py:46: the halo import (ppermute rounds) and the
    batched ELL matvec, against the JAX shard_map program on the same
    input and the serial product; the all_gather import
    (`DistributedCsr.matvec_fn`) alike."""
    dom, Kj, _, _, Kt, _ = poisson
    part, dj, umap, dt = _both(dom, Kj, Kt, n_parts)
    xg = np.random.default_rng(0).standard_normal(dom.n_nodes)

    axis = jspmd.DeviceAxis.make(n_parts)
    imp_j = dj.plan.importer()

    def prog(x_own, ed, ec, halo):
        x_own, ed, ec = x_own[0], ed[0], ec[0]
        hi = jax.tree.map(lambda a: a[0], halo)
        return jnp.sum(ed * imp_j(x_own, hi)[ec], axis=0)[None]

    f = jax.jit(axis.shard_map(prog, (P(jspmd.AXIS),) * 4, P(jspmd.AXIS)))
    yj = np.asarray(f(jspmd.distribute_vector(xg, part.unique_map,
                                              dj.plan.N_o),
                      dj.ell_data, dj.ell_cols, dj.plan.import_arrays))

    xt = tspmd.distribute_vector(xg, umap, dt.plan.N_o, device="cpu")
    yt = tspmd.DistributedCsr.local_matvec(
        dt.ell_data, dt.ell_cols,
        dt.plan.importer()(xt, dt.plan.import_arrays))
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=1e-12)
    y_ref = np.asarray(Kj.matvec(jnp.asarray(xg)))
    np.testing.assert_allclose(tspmd.collect_vector(yt, umap), y_ref,
                               atol=1e-12)
    p = dt.plan
    yg = dt.matvec_fn()(xt, dt.ell_data, dt.ell_cols, p.send_idx,
                        p.ghost_src)
    np.testing.assert_allclose(yg.numpy(), yt.numpy(), rtol=0, atol=1e-14)


def test_exchanges_against_host_reference(poisson):
    """The importer, the exporter and the all_gather plans against a plain
    host loop over the column maps: x_col[p] = x[col_gids[p]] (zeros in the
    padded lanes of the rounds' import), and the Export/Add of y_col sums
    every ghost contribution into its owner."""
    dom, Kj, _, _, Kt, _ = poisson
    _, _, umap, dt = _both(dom, Kj, Kt, 8)
    p_ = dt.plan
    N_o, G, n = p_.N_o, p_.G, dt.n_dev
    rng = np.random.default_rng(3)
    xg = rng.standard_normal(dom.n_nodes)
    xt = tspmd.distribute_vector(xg, umap, N_o, device="cpu")
    xc = p_.importer()(xt, p_.import_arrays).numpy()
    xa = tspmd.import_ghosts(xt, p_.send_idx, p_.ghost_src).numpy()
    y_col = rng.standard_normal((n, N_o + G))
    y_ref = np.zeros(dom.n_nodes)
    for p in range(n):
        cg = dt.col_gids[p]
        n_own = len(umap.partition_indices[p])
        ref = np.zeros(N_o + G)
        ref[:n_own] = xg[cg[:n_own]]
        ref[N_o: N_o + len(cg) - n_own] = xg[cg[n_own:]]
        np.testing.assert_array_equal(xc[p], ref)
        # the all_gather plan fills padded ghost lanes from buffer slot 0,
        # as in the JAX package (no ELL column reads them)
        m = N_o + len(cg) - n_own
        np.testing.assert_array_equal(xa[p, :m], ref[:m])
        y_col[p, n_own:N_o] = 0.0  # padded owned lanes
        y_col[p, N_o + len(cg) - n_own:] = 0.0  # padded ghost lanes
        np.add.at(y_ref, cg[:n_own], y_col[p, :n_own])
        np.add.at(y_ref, cg[n_own:], y_col[p, N_o: N_o + len(cg) - n_own])
    yt = torch.as_tensor(y_col)
    ye = p_.exporter()(yt, p_.export_arrays)
    ya = tspmd.export_add(yt, N_o, p_.recv_src, p_.recv_dst)
    np.testing.assert_allclose(tspmd.collect_vector(ye, umap), y_ref,
                               atol=1e-13)
    np.testing.assert_allclose(tspmd.collect_vector(ya, umap), y_ref,
                               atol=1e-13)


def test_device_axis_collectives():
    """ppermute moves each sender's row to its receiver and zeros the
    shards that receive nothing (lax.ppermute's rule); psum and all_gather
    act over axis 0."""
    ax = tspmd.DeviceAxis.make(4, device="cpu")
    buf = torch.arange(12, dtype=torch.float64).view(4, 3) + 1
    out = ax.ppermute(buf, [(0, 2), (2, 0), (3, 1)])
    ref = torch.zeros(4, 3, dtype=torch.float64)
    ref[2], ref[0], ref[1] = buf[0], buf[2], buf[3]
    assert torch.equal(out, ref)
    assert torch.equal(ax.ppermute(buf, ax.perm_source([(0, 2), (2, 0),
                                                        (3, 1)])), ref)
    assert torch.equal(ax.psum(buf), buf.sum(0))
    assert torch.equal(ax.all_gather(buf), buf)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tspmd.DeviceAxis.make(4)


@pytest.mark.parametrize("n_parts", [2, 4])
def test_distributed_cg_matches_serial(poisson, n_parts):
    """tests/test_parallel.py:76: CG over the shard axis in the serial
    count — the JAX distributed run's, and the port's serial CG's."""
    dom, Kj, bj, ref, Kt, b = poisson
    part, dj, umap, dt = _both(dom, Kj, Kt, n_parts)
    xj, it_j, _ = JSolver(dj, jspmd.DeviceAxis.make(n_parts)).solve(
        jspmd.distribute_vector(b, part.unique_map, dj.plan.N_o),
        method="cg", tol=1e-10, maxiter=2000)
    xt, it_t, rel = TSolver(dt).solve(
        tspmd.distribute_vector(b, umap, dt.plan.N_o, device="cpu"),
        method="cg", tol=1e-10, maxiter=2000)
    ser = tk.cg(Kt.matvec, torch.as_tensor(b), tol=1e-10, maxiter=2000)
    assert it_t == it_j == ser.iters == ref.iters
    assert rel <= 1e-10
    np.testing.assert_allclose(tspmd.collect_vector(xt, umap),
                               np.asarray(ref.x), atol=1e-12)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-12)


def test_distributed_gmres(poisson):
    """tests/test_parallel.py:89: GMRES(60) over 4 shards."""
    dom, Kj, bj, ref, Kt, b = poisson
    part, dj, umap, dt = _both(dom, Kj, Kt, 4)
    xj, it_j, _ = JSolver(dj, jspmd.DeviceAxis.make(4)).solve(
        jspmd.distribute_vector(b, part.unique_map, dj.plan.N_o),
        method="gmres", tol=1e-10, maxiter=500, restart=60)
    xt, it_t, rel = TSolver(dt).solve(
        tspmd.distribute_vector(b, umap, dt.plan.N_o, device="cpu"),
        method="gmres", tol=1e-10, maxiter=500, restart=60)
    ser = tk.gmres(Kt.matvec, torch.as_tensor(b), tol=1e-10, maxiter=500,
                   restart=60)
    assert rel <= 1e-10 and it_t == it_j == ser.iters
    np.testing.assert_allclose(tspmd.collect_vector(xt, umap),
                               np.asarray(ref.x), atol=1e-8)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-9)


def test_distributed_cg_jacobi(poisson):
    """tests/test_parallel.py:102: Jacobi-preconditioned CG, the inverse
    diagonal taken from the stacked ELL."""
    dom, Kj, bj, ref, Kt, b = poisson
    part, dj, umap, dt = _both(dom, Kj, Kt, 4)
    xj, it_j, _ = JSolver(dj, jspmd.DeviceAxis.make(4)).solve(
        jspmd.distribute_vector(b, part.unique_map, dj.plan.N_o),
        method="cg", tol=1e-10, maxiter=2000, precond="jacobi")
    xt, it_t, rel = TSolver(dt).solve(
        tspmd.distribute_vector(b, umap, dt.plan.N_o, device="cpu"),
        method="cg", tol=1e-10, maxiter=2000, precond="jacobi")
    d = torch.as_tensor(Kj.to_scipy().diagonal())
    ser = tk.cg(Kt.matvec, torch.as_tensor(b), M=lambda r: r / d, tol=1e-10,
                maxiter=2000)
    assert rel <= 1e-10 and it_t == it_j == ser.iters
    np.testing.assert_allclose(tspmd.collect_vector(xt, umap),
                               np.asarray(ref.x), atol=1e-9)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-9)


def test_distributed_assembly_matches_serial():
    """tests/test_parallel.py:115: per-shard element assembly with the
    ghost-row export reproduces the serial CSR data (atol 1e-12), equal to
    the JAX program's output; the plans equal the JAX package's."""
    from feddlib_tpu_torch.fe.domain import Domain as TDomain

    dom = JDomain.structured(2, 10)
    part = JPart(dom.mesh, 4)
    dj = jasm.DistributedAssembly(part, dofs_per_node=1)
    data_j = np.asarray(dj.assemble_laplace(jspmd.DeviceAxis.make(4)))
    tdom = TDomain.structured(2, 10, device="cpu")
    tpart = TPart(tdom.mesh, 4)
    np.testing.assert_array_equal(tpart.elem_part, part.elem_part)
    dt = tasm.DistributedAssembly(tpart, dofs_per_node=1)
    for a in ("L", "S", "Rx", "E_max"):
        assert getattr(dt, a) == getattr(dj, a), a
    for a in ("seg_ids", "recv_src", "recv_dst", "valid", "vert_coords",
              "local_slot_of_global"):
        _eq(getattr(dt, a), getattr(dj, a))
    data_t = dt.assemble_laplace(tspmd.DeviceAxis.make(4, device="cpu"))
    K = jops.assemble_laplace(dom)
    ref = dj.reference_local_data(np.asarray(K.data))
    np.testing.assert_allclose(data_t.numpy(), ref, atol=1e-12)
    np.testing.assert_allclose(data_t.numpy(), data_j, atol=1e-12)
    np.testing.assert_array_equal(dt.reference_local_data(
        np.asarray(K.data)), ref)


def test_halo_exchange_is_neighbor_wise(poisson):
    """tests/test_parallel.py:144: the ppermute schedule moves O(local
    cut) elements per shard; the port's comm_stats equal the JAX
    package's."""
    dom, Kj, _, _, Kt, _ = poisson
    stats = {}
    for n_parts in (2, 8):
        _, dj, _, dt = _both(dom, Kj, Kt, n_parts)
        stats[n_parts] = dt.plan.comm_stats()
        assert stats[n_parts] == dj.plan.comm_stats()
    assert stats[8]["allgather_elems"] > 2.5 * stats[2]["allgather_elems"]
    assert stats[8]["ppermute_elems"] < 2.0 * stats[2]["ppermute_elems"]
    assert stats[8]["ppermute_elems"] < 0.5 * stats[8]["allgather_elems"]
    assert stats[8]["rounds"] <= 8


def test_padded_lanes_stay_zero():
    """The Krylov loop sums over every stacked lane, so the padded lanes of
    an owned vector must stay exactly zero through A and every M (Jacobi,
    the three one-level combines, both two-level combinations), and in the
    solution."""
    dom = JDomain.structured(2, 13)
    K = jops.assemble_laplace(dom)
    bcb = JBC()
    bcb.add_bc(lambda x, t: 0.0, 1, 0, dom, "Dirichlet", 1)
    Kj, bj = bcb.apply_symmetric(
        K, jops.assemble_rhs(dom, lambda x: 1.0 + 0 * x[0]), 0)
    sp = Kj.to_scipy()
    Kt = convert.csr_from_numpy(sp.indptr, sp.indices, sp.data, sp.shape,
                                device="cpu")
    tpart = TPart(convert.mesh_from_numpy(
        dom.mesh.points, dom.mesh.elements, dom.mesh.point_flags), 6)
    dt = tspmd.DistributedCsr(Kt, tpart.unique_map)
    pad = ~dt.plan.owned_mask
    assert bool(pad.any())  # unequal parts: some lanes are padding
    x = tspmd.distribute_vector(
        np.random.default_rng(5).standard_normal(dom.n_nodes),
        tpart.unique_map, dt.plan.N_o, device="cpu")
    solver = TSolver(dt)
    dmask = bcb.dirichlet_mask(0, dom.n_nodes)
    precs = ["jacobi"] + [distributed_schwarz(dt, combine=c)
                          for c in ("Restricted", "Full", "Averaging")] + [
        distributed_two_level(dt, tpart, dom.mesh.points, 1,
                              dirichlet_mask=dmask, level_combination=lc)
        for lc in ("Additive", "Multiplicative")]
    A, _ = solver.operators()
    assert bool((A(x)[pad] == 0).all())
    for prec in precs:
        _, M = solver.operators(prec)
        assert bool((M(x)[pad] == 0).all())
        assert bool((M(A(x))[pad] == 0).all())
        xs, _, rel = solver.solve(
            tspmd.distribute_vector(np.asarray(bj), tpart.unique_map,
                                    dt.plan.N_o, device="cpu"),
            method="gmres", tol=1e-8, maxiter=500, precond=prec)
        assert rel <= 1e-8 and bool((xs[pad] == 0).all())
