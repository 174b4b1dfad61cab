"""The port's padded-cluster operators (feddlib_tpu_torch) against their
JAX counterparts at Domain.structured(3, 8) with 8 clusters: both packages
build every operator from the same matrix, clusters and partition, and each
apply on the same random vector agrees within 1e-5 relative to max|y| (f32
sums in another order)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.fe.host_assembly import host_poisson_dirichlet  # noqa: E402
from feddlib_tpu.la import dense_blocks as jdb  # noqa: E402
from feddlib_tpu.la.csr import CsrMatrix as JCsr  # noqa: E402
from feddlib_tpu.la.sell import PaddedSplitSpMV as JSplit  # noqa: E402
from feddlib_tpu.mesh.partition import MeshPartition as JPart  # noqa: E402
from feddlib_tpu.mesh.partition import partition_points  # noqa: E402
from feddlib_tpu.precond import cluster_coarse as jcc  # noqa: E402
from feddlib_tpu.precond.gdsw import GDSWCoarseOperator as JGDSW  # noqa: E402

from feddlib_tpu_torch.la import dense_blocks as tdb  # noqa: E402
from feddlib_tpu_torch.la.sell import PaddedSplitSpMV as TSplit  # noqa: E402
from feddlib_tpu_torch.precond import cluster_coarse as tcc  # noqa: E402
from feddlib_tpu_torch.precond.gdsw import GDSWCoarseOperator as TGDSW  # noqa: E402
from feddlib_tpu_torch.utils import convert  # noqa: E402

TOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def setup():
    try:  # keep host LAPACK single-threaded under the factor thread pool
        from threadpoolctl import threadpool_limits
        limit = threadpool_limits(1, user_api="blas")
    except ImportError:
        limit = None
    dom = JDomain.structured(3, 8)
    K, _ = host_poisson_dirichlet(dom)
    mesh = dom.mesh
    Aj = JCsr.from_scipy(K)
    At = convert.csr_from_numpy(K.indptr, K.indices, K.data, K.shape,
                                device="cpu")
    cluster = partition_points(mesh.points, 8)
    partj = JPart(mesh, 8)
    mesh_t = convert.mesh_from_numpy(mesh.points, mesh.elements,
                                     mesh.point_flags, mesh.element_flags)
    partt = convert.partition_from_numpy(mesh_t, partj.elem_part)
    dbj = jdb.DenseBlockSpMV.from_csr(Aj, cluster, dtype=jnp.float32)
    dbt = tdb.DenseBlockSpMV.from_csr(At, cluster, dtype=torch.float32)
    mask = np.asarray(mesh.point_flags) == 1
    rng = np.random.default_rng(0)
    x = rng.standard_normal(K.shape[0]).astype(np.float32)
    xpj = dbj.to_padded(jnp.asarray(x))
    xpt = dbt.to_padded(torch.as_tensor(x))
    yield dict(K=K, Aj=Aj, At=At, partj=partj, partt=partt, dbj=dbj,
               dbt=dbt, mask=mask, xpj=xpj, xpt=xpt, mesh=mesh)
    if limit is not None:
        limit.restore_original_limits()


def test_dense_block_layout_and_matvec(setup):
    s = setup
    dbj, dbt = s["dbj"], s["dbt"]
    assert (dbt.P, dbt.R, dbt.G) == (dbj.P, dbj.R, dbj.G)
    assert np.array_equal(dbt.pad_of_old.numpy(), np.asarray(dbj.pad_of_old))
    assert np.array_equal(dbt.ghost_idx.numpy(), np.asarray(dbj.ghost_idx))
    assert np.array_equal(dbt.blocks.numpy(), np.asarray(dbj.blocks))
    assert np.array_equal(s["xpt"].numpy(), np.asarray(s["xpj"]))
    yj = dbj.matvec_padded(s["xpj"])
    yt = dbt.matvec_padded(s["xpt"])
    assert _rel(yt.numpy(), yj) < TOL
    # original ordering through to_padded/from_padded
    x = np.array(dbj.from_padded(s["xpj"]), copy=True)
    assert _rel(dbt.matvec(torch.as_tensor(x)).numpy(),
                dbj.matvec(jnp.asarray(x))) < TOL


def test_padded_split_spmv(setup):
    s = setup
    Sj = JSplit(s["Aj"], s["dbj"], dtype=jnp.float32)
    St = TSplit(s["At"], s["dbt"], dtype=torch.float32)
    assert (St.Ac.E, St.Ac.K) == (Sj.Ac.E, Sj.Ac.K)
    assert _rel(St.matvec(s["xpt"]).numpy(), Sj.matvec(s["xpj"])) < TOL
    fn, ops = St.operator()
    assert _rel(fn(ops, s["xpt"]).numpy(), Sj.matvec(s["xpj"])) < TOL
    # with_data refresh (reassembly with the same pattern)
    d = np.random.default_rng(1).standard_normal(s["K"].nnz)
    Sj2 = Sj.with_data(jnp.asarray(d))
    St2 = St.with_data(torch.as_tensor(d))
    assert _rel(St2.matvec(s["xpt"]).numpy(), Sj2.matvec(s["xpj"])) < TOL


@pytest.mark.parametrize("store", ["f32", "bf16"])
def test_dense_block_schwarz(setup, store):
    s = setup
    sj = jnp.bfloat16 if store == "bf16" else None
    st = torch.bfloat16 if store == "bf16" else None
    Mj = jdb.DenseBlockSchwarz(s["Aj"], s["dbj"], store_dtype=sj)
    Mt = tdb.DenseBlockSchwarz(s["At"], s["dbt"], store_dtype=st)
    assert tuple(Mt.inv.shape) == tuple(Mj.inv.shape)
    fj, oj = Mj.padded_operator()
    ft, ot = Mt.padded_operator()
    assert ft is tdb.dense_block_schwarz_op
    assert _rel(ft(ot, s["xpt"]).numpy(), fj(oj, s["xpj"])) < TOL


def test_gdsw_and_padded_cluster_coarse(setup):
    s = setup
    pj, pt = s["partj"], s["partt"]
    sets_j = [np.asarray(ix) for ix in pj.repeated_map.partition_indices]
    sets_t = [np.asarray(ix) for ix in pt.repeated_map.partition_indices]
    cj = JGDSW(s["Aj"], pj.unique_map, node_part_sets=sets_j,
               points=s["mesh"].points, dirichlet_mask=s["mask"])
    ct = TGDSW(s["At"], pt.unique_map, node_part_sets=sets_t,
               points=s["mesh"].points, dirichlet_mask=s["mask"])
    assert ct.n_coarse == cj.n_coarse > 0
    phj, pht = cj.phi.to_scipy(), ct.phi.to_scipy()
    assert abs(phj - pht).max() < 1e-12
    assert abs(cj.A0_sparse() - ct.A0_sparse()).max() < 1e-12 * abs(
        cj.A0_sparse()).max()
    Cj = jcc.PaddedClusterCoarse(phj, np.asarray(cj.A0_inv), s["dbj"])
    Ct = tcc.PaddedClusterCoarse(pht, ct.A0_inv.numpy(), s["dbt"])
    assert Ct.c == Cj.c
    fj, oj = Cj.operator()
    ft, ot = Ct.operator()
    assert _rel(ft(ot, s["xpt"]).numpy(), fj(oj, s["xpj"])) < TOL


@pytest.mark.parametrize("combination", ["Additive", "Multiplicative"])
def test_padded_two_level_schwarz(setup, combination):
    s = setup
    Pj = jcc.PaddedTwoLevelSchwarz(s["Aj"], s["partj"], s["dbj"],
                                   dirichlet_mask=s["mask"],
                                   level_combination=combination)
    Pt = tcc.PaddedTwoLevelSchwarz(s["At"], s["partt"], s["dbt"],
                                   dirichlet_mask=s["mask"],
                                   level_combination=combination)
    assert Pt.n_coarse == Pj.n_coarse
    fj, oj = Pj.padded_operator()
    ft, ot = Pt.padded_operator()
    assert _rel(ft(ot, s["xpt"]).numpy(), fj(oj, s["xpj"])) < TOL


def test_padded_two_level_bf16_stores(setup):
    """The bench-chain configuration: additive, bf16 level-1 and coarse
    stores (kernel B4 on the card).  bf16 inverses round differently in the
    last bit after the f64 → f32 → bf16 casts, so 1e-2 relative."""
    s = setup
    kw = dict(dirichlet_mask=s["mask"], level_combination="Additive")
    Pj = jcc.PaddedTwoLevelSchwarz(s["Aj"], s["partj"], s["dbj"],
                                   l1_store_dtype=jnp.bfloat16,
                                   coarse_store_dtype=jnp.bfloat16, **kw)
    Pt = tcc.PaddedTwoLevelSchwarz(s["At"], s["partt"], s["dbt"],
                                   l1_store_dtype=torch.bfloat16,
                                   coarse_store_dtype=torch.bfloat16, **kw)
    assert Pt.level1.inv.dtype == torch.bfloat16
    assert Pt.coarse.phi_blocks.dtype == torch.bfloat16
    fj, oj = Pj.padded_operator()
    ft, ot = Pt.padded_operator()
    assert _rel(ft(ot, s["xpt"]).numpy(), fj(oj, s["xpj"])) < 1e-2


def test_gdsw_device_rap_matches_host(setup):
    s = setup
    pt = s["partt"]
    sets = [np.asarray(ix) for ix in pt.repeated_map.partition_indices]
    kw = dict(node_part_sets=sets, points=s["mesh"].points,
              dirichlet_mask=s["mask"])
    host = TGDSW(s["At"], pt.unique_map, **kw)
    dev = TGDSW(s["At"], pt.unique_map, rap="device", **kw)
    A0h, A0d = host.A0_sparse(), dev.A0_sparse()
    assert abs(A0h - A0d).max() <= 1e-12 * abs(A0h).max()


def test_dense_block_schwarz_device_factor(setup):
    """The card's factorization for symmetric matrices (batched Cholesky and
    two triangular solves), run here on the CPU, matches the host-LU
    owned-row inverses of the JAX package.  (The batched LU branch for
    nonsymmetric matrices is held against the host LU on the card,
    tests/test_torch_gpu.py: this CPU build's batched getrf stalls.)"""
    s = setup
    assert tdb._blocks_symmetric(s["At"])
    Mj = jdb.DenseBlockSchwarz(s["Aj"], s["dbj"], device_factor=False)
    Mt = tdb.DenseBlockSchwarz(s["At"], s["dbt"], device_factor=True)
    # the f32 device factor carries a 1e-6 diagonal guard and f32 roundoff
    assert _rel(Mt.inv.numpy(), np.asarray(Mj.inv)) < 1e-3
    fj, oj = Mj.padded_operator()
    ft, ot = Mt.padded_operator()
    assert _rel(ft(ot, s["xpt"]).numpy(), fj(oj, s["xpj"])) < 1e-3


def test_rebalance_row_clusters_matches(setup):
    s = setup
    owner = s["partj"].unique_map.owner_of()
    rj = jdb.rebalance_row_clusters(s["K"], owner)
    rt = tdb.rebalance_row_clusters(s["K"], owner.copy())
    assert np.array_equal(rj, rt)
    assert np.bincount(rt).max() <= np.bincount(owner).max()
