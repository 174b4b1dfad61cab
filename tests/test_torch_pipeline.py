"""The port's device-resident assembly pipeline
(feddlib_tpu_torch/parallel/pipeline.py) against the JAX package's, on the
assembly scenarios of tests/test_pipeline.py: the plan arrays entry for
entry at 2, 4 and 8 parts, the assembled shards within 1e-12 of max |a|
of the JAX package's (and the serial operators' products at the JAX
test's tolerances), the device RHS program, the exchange volume, moved
coordinates, and the `_dist_mirror` attachment of BlockVector.  The port
stacks its shards on the CPU; the JAX package runs its shard_map programs
on the 8 virtual CPU devices.  Every input comes from numpy with a seed."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from feddlib_tpu.fe import ops as jops  # noqa: E402
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.mesh.partition import MeshPartition as JPart  # noqa: E402
from feddlib_tpu.parallel.pipeline import \
    DistributedPipeline as JPipe  # noqa: E402
from feddlib_tpu.parallel.solve import DistributedSolver as JSolver  # noqa: E402
from feddlib_tpu.parallel.spmd import DeviceAxis as JAxis  # noqa: E402

from feddlib_tpu_torch.fe import ops as tops  # noqa: E402
from feddlib_tpu_torch.fe.domain import Domain as TDomain  # noqa: E402
from feddlib_tpu_torch.la.block import BlockVector  # noqa: E402
from feddlib_tpu_torch.mesh.partition import MeshPartition as TPart  # noqa: E402
from feddlib_tpu_torch.parallel.pipeline import \
    DistributedPipeline as TPipe  # noqa: E402
from feddlib_tpu_torch.parallel.solve import DistributedSolver as TSolver  # noqa: E402
from feddlib_tpu_torch.parallel.spmd import DeviceAxis as TAxis  # noqa: E402
from feddlib_tpu_torch.parallel.spmd import DistributedCsr  # noqa: E402

CPU = "cpu"


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _pair(n_parts, variables, blocks, rhs=(), p2=False, n=6):
    """The same pipeline in both packages on Domain.structured(2, n)
    (its P2 child for the vector variable when p2).  variables: list of
    (kind 'u' | 'p' | 's', dofs); blocks: (i, j, kind, params)."""
    out = []
    for pkg in ("jax", "torch"):
        base = (JDomain.structured(2, n) if pkg == "jax"
                else TDomain.structured(2, n, device=CPU))
        doms = {"p": base, "s": base,
                "u": base.p2_domain() if p2 else base}
        Part, Pipe = (JPart, JPipe) if pkg == "jax" else (TPart, TPipe)
        pipe = Pipe(Part(base.mesh, n_parts),
                    [(doms[k], d) for k, d in variables])
        for i, j, kind, prm in blocks:
            pipe.add_block(i, j, kind, **dict(prm))
        for b, fns, flag in rhs:
            f = fns[0] if pkg == "jax" else fns[1]
            if flag is None:
                pipe.add_rhs(b, f)
            else:
                pipe.add_surface_rhs(b, f, flag)
        pipe.finalize(JAxis.make(n_parts) if pkg == "jax"
                      else TAxis.make(n_parts, CPU))
        out.append((pipe, doms))
    return out


def _same_plans(jp, tp):
    """Every plan array of the two pipelines, entry for entry."""
    assert (jp.L, jp.S, jp.K, jp.N_o, jp.E_max) == \
        (tp.L, tp.S, tp.K, tp.N_o, tp.E_max)
    for a in ("seg_ids", "ell_src", "ell_cols", "const_vals"):
        ja, ta = np.asarray(getattr(jp, a)), _np(getattr(tp, a))
        assert ja.shape == ta.shape and np.array_equal(ja, ta), a
    assert np.array_equal(jp.row_lens, tp.row_lens)
    assert [(p, w) for p, w in jp._xc_meta] == \
        [(p, w) for p, w in tp._xc_meta]
    for a, b in zip(jp._xc_sidx + jp._xc_rdst, tp._xc_sidx + tp._xc_rdst):
        assert np.array_equal(np.asarray(a), _np(b))
    assert sorted(jp.field_plans) == sorted(tp.field_plans)
    for b in jp.field_plans:
        for k in ("pos", "mask", "elem_idx"):
            assert np.array_equal(np.asarray(jp.field_plans[b][k]),
                                  _np(tp.field_plans[b][k])), (b, k)
    for p in range(jp.n_dev):
        assert np.array_equal(jp.col_gids[p], tp.col_gids[p])


def _collect(dmat):
    """Distributed ELL → global scipy CSR (test oracle only)."""
    n = dmat.n_global
    rows_l, cols_l, vals_l = [], [], []
    for p in range(dmat.n_dev):
        owned, R = dmat.local_rows(p)
        if not len(owned):
            continue
        coo = R.tocoo()
        rows_l.append(owned[coo.row])
        cols_l.append(coo.col)
        vals_l.append(coo.data)
    return sps.csr_matrix((np.concatenate(vals_l),
                           (np.concatenate(rows_l), np.concatenate(cols_l))),
                          shape=(n, n))


def _matvec(dmat, pipe, xg):
    """Global x → global A x through the port's distributed operator."""
    imp = dmat.plan.importer()
    xd = pipe.distribute(xg)
    y = DistributedCsr.local_matvec(dmat.ell_data, dmat.ell_cols,
                                    imp(xd, dmat.plan.import_arrays))
    return pipe.collect(y)


def _same_matrix(jd, td, tol=1e-12):
    ja, ta = np.asarray(jd.ell_data), _np(td.ell_data)
    assert ja.shape == ta.shape
    assert np.abs(ja - ta).max() <= tol * np.abs(ja).max()


def _f_jax(x, t):
    return jnp.sin(3.0 * x[0]) * (1.0 + t) + x[1]


def _f_torch(x, t):
    return torch.sin(3.0 * x[0]) * (1.0 + t) + x[1]


def _g_jax(x, t):
    return x[0] * (2.0 - t)


def _g_torch(x, t):
    return x[0] * (2.0 - t)


NS_BLOCKS = [(0, 0, "laplace_vec", {"viscosity": 0.01}),
             (0, 0, "advection", {}), (0, 0, "advection_in_u", {}),
             (0, 1, "divergence_T", {}), (1, 0, "divergence", {})]


@pytest.mark.parametrize("n_parts", [2, 4, 8])
def test_pipeline_plans_equal_jax(n_parts):
    """The host plans of a scalar Laplace pipeline, of a P2/P1
    Navier–Stokes pipeline with its field plans and of the device RHS
    program equal the JAX package's entry for entry; the assembled shards
    agree within 1e-12 of max |a|."""
    (jp, _), (tp, _) = _pair(n_parts, [("s", 1)],
                             [(0, 0, "laplace", {})], n=12)
    _same_plans(jp, tp)
    _same_matrix(jp.assemble(), tp.assemble())

    rhs = [(0, (_f_jax, _f_torch), None), (0, (_g_jax, _g_torch), 1)]
    (jp, _), (tp, _) = _pair(n_parts, [("u", 2), ("p", 1)], NS_BLOCKS,
                             p2=True, n=5)
    _same_plans(jp, tp)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(int(jp.offsets[-1]))
    _same_matrix(jp.assemble(x=jp.distribute(x)),
                 tp.assemble(x=tp.distribute(x)))
    # the device RHS plans of a scalar pipeline (volume + surface)
    (jp, _), (tp, _) = _pair(n_parts, [("s", 1)], [(0, 0, "laplace", {})],
                             rhs=rhs, n=8)
    jm, tm = jp._rhs_plans(), tp._rhs_plans()
    assert np.array_equal(np.asarray(jm["seg"]), _np(tm["seg"]))
    assert jm["S_r"] == tm["S_r"] and jm["xc_meta"] == tm["xc_meta"]
    for a, b in zip(jm["xc_sidx"] + jm["xc_rdst"],
                    tm["xc_sidx"] + tm["xc_rdst"]):
        assert np.array_equal(np.asarray(a), _np(b))


@pytest.mark.parametrize("n_parts", [4, 8])
def test_pipeline_laplace_matches_serial(n_parts):
    (jp, jdoms), (tp, tdoms) = _pair(n_parts, [("s", 1)],
                                     [(0, 0, "laplace", {})], n=12)
    jd, td = jp.assemble(), tp.assemble()
    _same_matrix(jd, td)
    K = tops.assemble_laplace(tdoms["s"])
    rng = np.random.default_rng(3)
    xg = rng.standard_normal(tdoms["s"].n_nodes)
    y_ref = K.matvec(torch.as_tensor(xg)).numpy()
    np.testing.assert_allclose(_matvec(td, tp, xg), y_ref, rtol=1e-12,
                               atol=1e-12)
    # the shards equal the from-global construction's layout
    dref = DistributedCsr(K, tp.dof_map)
    np.testing.assert_allclose(_np(td.ell_data), _np(dref.ell_data),
                               atol=1e-12)


def test_pipeline_dirichlet_and_solve():
    """Host RHS, Dirichlet rows with values and a Jacobi GMRES: the count
    equals the JAX package's and x agrees within 1e-9."""
    import scipy.sparse.linalg as spla

    from feddlib_tpu.bc import BCBuilder as JBC

    (jp, jdoms), (tp, tdoms) = _pair(4, [("s", 1)],
                                     [(0, 0, "laplace", {})], n=12)
    dom = jdoms["s"]
    bcb = JBC()
    bcb.add_bc(lambda x, t: 0.0, 1, 0, dom, "Dirichlet", 1)
    mask = np.asarray(bcb.dirichlet_mask(0, dom.n_nodes))
    g = np.zeros(dom.n_nodes)
    jd = jp.assemble()
    jr = jp.assemble_rhs({0: lambda x: 1.0 + 0 * x[0]})
    jd, jr = jp.apply_dirichlet(jd, jr, mask, g)
    xj, itj, _ = JSolver(jd, jp.axis).solve(jr, method="gmres", tol=1e-10,
                                            precond="jacobi")

    td = tp.assemble()
    tr = tp.assemble_rhs({0: lambda x: 1.0 + 0 * x[0]})
    b = tops.assemble_rhs(tdoms["s"], lambda x: 1.0 + 0 * x[0]).numpy()
    np.testing.assert_allclose(tp.collect(tr), b, atol=1e-12)
    np.testing.assert_allclose(_np(tr), np.asarray(
        jp.assemble_rhs({0: lambda x: 1.0 + 0 * x[0]})), atol=1e-14)
    td, tr = tp.apply_dirichlet(td, tr, mask, g)
    _same_matrix(jd, td)
    xt, itt, rel = TSolver(td, tp.axis).solve(tr, method="gmres", tol=1e-10,
                                              precond="jacobi")
    assert itt == itj and rel < 1e-9
    # against the row-eliminated serial system
    sp = tops.assemble_laplace(tdoms["s"]).to_scipy().tolil()
    for i in np.nonzero(mask)[0]:
        sp.rows[i] = [i]
        sp.data[i] = [1.0]
    x_ref = spla.spsolve(sp.tocsr(), np.where(mask, g, b))
    np.testing.assert_allclose(tp.collect(xt), x_ref, atol=1e-7)
    np.testing.assert_allclose(tp.collect(xt), jp.collect(xj), atol=1e-9)


@pytest.mark.parametrize("p2", [True, False], ids=["P2P1", "P1P1"])
def test_pipeline_stokes_matches_serial(p2):
    from feddlib_tpu_torch.la.block import BlockMatrix

    blocks = [(0, 0, "laplace_vec", {"viscosity": 1.0}),
              (0, 1, "divergence_T", {}), (1, 0, "divergence", {})]
    if not p2:
        blocks.append((1, 1, "bd_stab", {}))
    (jp, _), (tp, tdoms) = _pair(4, [("u", 2), ("p", 1)], blocks, p2=p2)
    jd, td = jp.assemble(), tp.assemble()
    _same_matrix(jd, td)
    dom_u, dom_p = tdoms["u"], tdoms["p"]
    B, BT = tops.assemble_divergence(dom_u, dom_p)
    sizes = [dom_u.n_dofs(2), dom_p.n_dofs(1)]
    sys = BlockMatrix(sizes)
    sys.add_block(0, 0, tops.assemble_laplace_vec(dom_u, 1.0))
    sys.add_block(0, 1, BT)
    sys.add_block(1, 0, B)
    if not p2:
        sys.add_block(1, 1, tops.assemble_bd_stabilization(dom_p))
    rng = np.random.default_rng(5)
    xg = rng.standard_normal(sum(sizes))
    y_ref = sys.merge().matvec(torch.as_tensor(xg)).numpy()
    np.testing.assert_allclose(_matvec(td, tp, xg), y_ref, rtol=1e-11,
                               atol=1e-11)


def test_pipeline_navier_stokes_advection():
    """N(u) and W(u) through the field halo equal the serial reassembly
    and the JAX package's pipeline."""
    from feddlib_tpu_torch.la.block import BlockMatrix

    (jp, _), (tp, tdoms) = _pair(4, [("u", 2), ("p", 1)], NS_BLOCKS,
                                 p2=True, n=5)
    dom_u, dom_p = tdoms["u"], tdoms["p"]
    sizes = [dom_u.n_dofs(2), dom_p.n_dofs(1)]
    rng = np.random.default_rng(7)
    u = rng.standard_normal(sizes[0])
    xfull = np.concatenate([u, np.zeros(sizes[1])])
    jd = jp.assemble(x=jp.distribute(xfull))
    td = tp.assemble(x=tp.distribute(xfull))
    _same_matrix(jd, td)
    ut = torch.as_tensor(u)
    A = tops.assemble_laplace_vec(dom_u, 0.01)
    A = A.add(tops.assemble_advection(dom_u, ut)).add(
        tops.assemble_advection_in_u(dom_u, ut))
    B, BT = tops.assemble_divergence(dom_u, dom_p)
    sys = BlockMatrix(sizes)
    sys.add_block(0, 0, A)
    sys.add_block(0, 1, BT)
    sys.add_block(1, 0, B)
    xg = rng.standard_normal(sum(sizes))
    y_ref = sys.merge().matvec(torch.as_tensor(xg)).numpy()
    np.testing.assert_allclose(_matvec(td, tp, xg), y_ref, rtol=1e-10,
                               atol=1e-10)


def test_device_rhs_volume_and_surface():
    """The device RHS program (volume + Neumann surface loads, time-
    dependent) equals the JAX package's and the serial assemblies at each
    t."""
    rhs = [(0, (_f_jax, _f_torch), None), (0, (_g_jax, _g_torch), 1)]
    (jp, _), (tp, tdoms) = _pair(4, [("s", 1)], [(0, 0, "laplace", {})],
                                 rhs=rhs, n=8)
    dom = tdoms["s"]
    for t in (0.0, 0.7):
        b_dev = tp.collect(tp.assemble_rhs_device(t=t))
        b_ref = (tops.assemble_rhs(dom, lambda x, tt=t: _f_torch(x, tt))
                 + tops.assemble_surface_rhs(
                     dom, lambda x, tt=t: _g_torch(x, tt), flag=1)).numpy()
        scale = max(np.abs(b_ref).max(), 1.0)
        assert np.abs(b_dev - b_ref).max() < 1e-12 * scale
        b_jax = jp.collect(jp.assemble_rhs_device(t=t))
        assert np.abs(b_dev - b_jax).max() < 1e-12 * scale


def test_device_rhs_vector_field():
    """A vector-valued volume source on a P2 velocity space."""
    def fj(x, t):
        return jnp.stack([x[0] + t, x[0] * x[1]])

    def ft(x, t):
        return torch.stack([x[0] + t, x[0] * x[1]])

    (jp, _), (tp, tdoms) = _pair(4, [("u", 2)],
                                 [(0, 0, "laplace_vec", {})],
                                 rhs=[(0, (fj, ft), None)], p2=True)
    b_dev = tp.collect(tp.assemble_rhs_device(t=0.3))
    b_ref = tops.assemble_rhs(tdoms["u"], lambda x: ft(x, 0.3), 2).numpy()
    scale = max(np.abs(b_ref).max(), 1.0)
    assert np.abs(b_dev - b_ref).max() < 1e-12 * scale
    assert np.abs(b_dev - jp.collect(jp.assemble_rhs_device(t=0.3))).max() \
        < 1e-12 * scale


def _problem(pkg, which):
    """The problem of test_pipeline.py:416 in one package, assembled (the
    hyperelastic one at a seeded displacement, reassembled)."""
    if pkg == "jax":
        from feddlib_tpu.problems.geometry import Geometry
        from feddlib_tpu.problems.nonlin_elasticity import NonLinElasticity
        from feddlib_tpu.problems.tpm import TPM
        Domain, kw = JDomain, {}
    else:
        from feddlib_tpu_torch.problems.geometry import Geometry
        from feddlib_tpu_torch.problems.nonlin_elasticity import \
            NonLinElasticity
        from feddlib_tpu_torch.problems.tpm import TPM
        Domain, kw = TDomain, {"device": CPU}
    if which == "tpm":
        base = Domain.structured(2, 4, **kw)
        prob = TPM(base.p2_domain(), base, **kw)
    elif which == "geometry_scaled":
        base = Domain.structured(2, 6, **kw)
        dist = np.random.default_rng(0).random(base.mesh.n_points) + 0.1
        prob = Geometry(base, distances=dist, **kw)
    else:
        base = Domain.structured(2, 4, **kw)
        prob = NonLinElasticity(base, **kw)
    prob.assemble()
    if which == "hyper":
        d = 0.02 * np.random.default_rng(1).standard_normal(
            prob.block_sizes()[0])
        prob.solution[0] = (jnp.asarray(d) if pkg == "jax"
                            else torch.as_tensor(d))
        prob.reassemble("Newton")
    return prob, base


@pytest.mark.parametrize("which", ["tpm", "geometry_scaled", "hyper"])
def test_problem_pipeline_blocks_match_serial(which):
    """TPM Biot, the distance-scaled harmonic extension and the
    hyperelastic tangent through the pipeline equal the serial merged
    matrices and the JAX package's pipeline."""
    dmats = []
    for pkg in ("jax", "torch"):
        prob, base = _problem(pkg, which)
        Part, Pipe = (JPart, JPipe) if pkg == "jax" else (TPart, TPipe)
        pipe = Pipe(Part(base.mesh, 4),
                    [(d, k) for d, k, _ in prob.variables])
        for i, j, kind, prm in prob.pipeline_blocks():
            pipe.add_block(i, j, kind, **prm)
        pipe.finalize(JAxis.make(4) if pkg == "jax" else TAxis.make(4, CPU))
        x = (pipe.distribute(np.asarray(prob.solution.concat()))
             if which == "hyper" else None)
        dmats.append(pipe.assemble(x=x))
    _same_matrix(*dmats)
    S = prob.system.merge().to_scipy().tocsr()
    D = _collect(dmats[1])
    assert abs(S - D).max() < 1e-10 * max(abs(S).max(), 1.0)


def test_pipeline_exchange_volume_is_local_cut():
    """The contribution exchange moves O(local cut) a shard (ppermute
    rounds), well below the all_gather's n_dev · S; its index arrays stay
    inside the send buffer and [0, L]."""
    (jp, _), (tp, _) = _pair(8, [("s", 1)], [(0, 0, "laplace", {})], n=16)
    assert tp._xc_meta == jp._xc_meta and len(tp._xc_meta) >= 1
    pp_total = sum(w for _, w in tp._xc_meta)
    assert pp_total * 3 < 8 * tp.S, (pp_total, 8 * tp.S)
    for si, rd in zip(tp._xc_sidx, tp._xc_rdst):
        assert int(si.max()) < tp.S and int(rd.max()) <= tp.L


def test_vert_coords_override_moved_mesh():
    """assemble(vert_coords={0: ...}) assembles on moved coordinates
    without rebuilding a plan: equal to the serial assembly on the moved
    mesh and to the JAX package's override."""
    (jp, jdoms), (tp, tdoms) = _pair(4, [("s", 1)],
                                     [(0, 0, "laplace", {})], n=8)
    pts = tdoms["s"].mesh.points
    disp = 0.03 * np.stack([np.sin(np.pi * pts[:, 0])
                            * np.sin(np.pi * pts[:, 1])] * 2, axis=1)
    moved = pts + disp
    td = tp.assemble(vert_coords={0: tp.mesh_vert_coords(0, moved)})
    jd = jp.assemble(vert_coords={0: jp.mesh_vert_coords(0, moved)})
    _same_matrix(jd, td)
    from feddlib_tpu_torch.mesh.structured import build_structured_mesh

    mesh2 = build_structured_mesh(2, 8)
    mesh2.points = moved.copy()
    K_ref = tops.assemble_laplace(TDomain(mesh2, device=CPU))
    rng = np.random.default_rng(0)
    xg = rng.standard_normal(len(pts))
    np.testing.assert_allclose(_matvec(td, tp, xg),
                               K_ref.matvec(torch.as_tensor(xg)).numpy(),
                               rtol=1e-11, atol=1e-11)


def test_block_vector_dist_mirror():
    """The shard mirror rides axpy / scale / copy (same pipeline only) and
    a block write drops it."""
    pipe, other = object(), object()
    a = BlockVector([torch.ones(3), torch.zeros(2)])
    b = BlockVector([torch.full((3,), 2.0), torch.ones(2)])
    sa, sb = torch.arange(4.0).view(2, 2), torch.ones(2, 2)
    a._dist_mirror = (pipe, sa)
    b._dist_mirror = (pipe, sb)
    c = a.axpy(0.5, b)
    assert c._dist_mirror[0] is pipe
    assert torch.equal(c._dist_mirror[1], sa + 0.5 * sb)
    s = a.scale(-2.0)
    assert torch.equal(s._dist_mirror[1], -2.0 * sa)
    cp = a.copy()
    assert cp._dist_mirror is a._dist_mirror
    b._dist_mirror = (other, sb)  # another pipeline's shards: dropped
    assert a.axpy(1.0, b)._dist_mirror is None
    assert a.axpy(1.0, BlockVector([torch.ones(3), torch.ones(2)])
                  )._dist_mirror is None
    cp[0] = torch.zeros(3)
    assert cp._dist_mirror is None and a._dist_mirror is not None
    # split results start without one; the solve attaches its shards
    assert BlockVector.split(torch.zeros(5), [3, 2])._dist_mirror is None
