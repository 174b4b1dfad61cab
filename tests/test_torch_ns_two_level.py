"""Steady Navier–Stokes on the port's mixed two-level path (P2/P1
Taylor–Hood, `'Use Mixed Precision'` + `'TwoLevel'`): the Re 100
lid-driven cavity of the benchmark's `cavity3d-p2p1-24` at 4^3 cells on 8
clusters, held against the benchmark's plain reference
(`benchmark/reference/fem_ns.py`) and, for the block coarse basis, against
the port's f64 `TwoLevelSchwarz` and the JAX package's GDSW.  The
single-field layouts keep their sizes."""

import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.mesh.partition import MeshPartition as JPart  # noqa: E402
from feddlib_tpu.precond import gdsw as jgdsw  # noqa: E402
from feddlib_tpu.problems import NavierStokes as JNS  # noqa: E402
from feddlib_tpu.utils.config import ParameterList as JPL  # noqa: E402

from benchmark import plugins  # noqa: E402
from benchmark.reference import fem_ns  # noqa: E402
from feddlib_tpu_torch.fe.domain import Domain as TDomain  # noqa: E402
from feddlib_tpu_torch.la.block import BlockVector  # noqa: E402
from feddlib_tpu_torch.mesh.partition import MeshPartition  # noqa: E402
from feddlib_tpu_torch.precond import gdsw as tgdsw  # noqa: E402
from feddlib_tpu_torch.precond.cluster_coarse import (  # noqa: E402
    PaddedTwoLevelSchwarz)
from feddlib_tpu_torch.problems import NavierStokes as TNS  # noqa: E402
from feddlib_tpu_torch.solvers.nonlinear import NonLinearSolver  # noqa: E402
from feddlib_tpu_torch.utils import timers  # noqa: E402
from feddlib_tpu_torch.utils.config import ParameterList as TPL  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS, CLUSTERS = 4, 8


@pytest.fixture(scope="module", autouse=True)
def blas1():
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(1, user_api="blas"):
        yield


def _config(**params):
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "cavity3d-p2p1-24.json")) as f:
        cfg = json.load(f)
    cfg["mesh"]["cells"] = CELLS
    cfg["parameters"].update(Clusters=CLUSTERS, **params)
    return cfg


def _program(**params):
    """The benchmark's problem kind on the CPU: (system, config)."""
    cfg = _config(**params)
    kind = plugins.load("problems", cfg["problem"])
    return kind.build(cfg, torch.device("cpu")), cfg


def _perm(system, cfg, ref):
    """Each program dof's id in the reference's numbering."""
    kind = plugins.load("problems", cfg["problem"])
    ids_u, ids_p = kind.order(system, cfg, ref)
    return np.concatenate([(ids_u[:, None] * 3 + np.arange(3)).ravel(),
                           ref.n_u + ids_p])


def _mine(perm, v, n):
    out = np.empty(n)
    out[perm] = np.asarray(v, dtype=np.float64)
    return torch.as_tensor(out)


@pytest.fixture(scope="module")
def newton():
    """The program's Newton solve from rest, with the counters it made."""
    system, cfg = _program()
    seen = {}

    def count(rec):
        if not hasattr(rec, "end_ns"):
            seen[rec.name] = seen.get(rec.name, 0) + rec.n

    timers.subscribe(count)
    try:
        solver = NonLinearSolver("Newton")
        its = solver.solve(system.prob)
    finally:
        timers.unsubscribe(count)
    ref = fem_ns.Cavity(CELLS, 0.01)
    perm = _perm(system, cfg, ref)
    state = _mine(perm, system.prob.solution.concat().numpy(), ref.n)
    return dict(system=system, cfg=cfg, its=its, solver=solver, seen=seen,
                ref=ref, perm=perm, state=state)


def _frozen(system, state_prog):
    """Freeze the program's Newton Jacobian at a state (program order)."""
    prob = system.prob
    prob.init_vectors()
    prob.solution = BlockVector.split(state_prog, prob.block_sizes())
    prob.reassemble("Newton")
    frozen = prob.bc_system()
    prob.bc_system = lambda: frozen
    return frozen.merge()


def test_bc_jacobian_equals_the_reference(newton):
    """The merged bc_system() Newton Jacobian at the converged state equals
    fem_ns's entry for entry (identity Dirichlet rows, free pressure)."""
    system, ref, perm = newton["system"], newton["ref"], newton["perm"]
    A = _frozen(system, system.prob.solution.concat().clone())
    J = ref.jacobian(newton["state"]).to_dense().numpy()
    mine = np.zeros_like(J)
    mine[np.ix_(perm, perm)] = A.to_scipy().toarray()
    assert np.abs(mine - J).max() <= 1e-12 * np.abs(J).max()
    assert (np.diag(J)[ref.D.numpy()] == 1.0).all()


def test_newton_counts_one_build_and_refreshes(newton):
    """Newton builds the mixed cache once (one merged pattern for every
    reassembly) and refreshes its operator at every later iteration, on
    the block two-level path."""
    seen, its = newton["seen"], newton["its"]
    assert its >= 3
    assert seen.get("mixed.builds") == 1
    assert seen.get("mixed.refreshes") == its - 1
    prec = newton["system"].prob._mixed_cache["prec"]
    assert isinstance(prec, PaddedTwoLevelSchwarz)
    assert prec.coarse_per_block.shape == (2,)
    assert (prec.coarse_per_block > 0).all()


def test_one_level_newton_rebuilds_at_every_step():
    """The one-level mixed path of a multi-field system keeps its layout
    for one merged matrix alone: a Newton solve builds it at every
    iteration and never refreshes it, though every merge of the same block
    patterns shares one merged pattern."""
    system, _ = _program(TwoLevel=False)
    seen = {}

    def count(rec):
        if not hasattr(rec, "end_ns"):
            seen[rec.name] = seen.get(rec.name, 0) + rec.n

    timers.subscribe(count)
    try:
        its = NonLinearSolver("Newton").solve(system.prob)
    finally:
        timers.unsubscribe(count)
    assert its >= 3
    assert seen.get("mixed.builds") == its
    assert "mixed.refreshes" not in seen
    assert type(system.prob._mixed_cache["prec"]).__name__ == \
        "DenseBlockSchwarz"


def test_newton_state_matches_the_reference_dense_newton(newton):
    """The program's steady state against the reference's own dense Newton:
    velocity to 1e-7, pressure to 1e-7 up to its constant (on the
    pressures that the Jacobian couples; a pressure whose velocities are
    all fixed is free), and the reference's criterion at the program's
    state within the configuration's 1e-6."""
    ref, state = newton["ref"], newton["state"]
    x, _ = ref.dense_newton(tol=1e-12)
    nu = ref.n_u
    assert ref.newton_criterion(state) <= 1e-6
    assert abs(ref.newton_criterion(state)
               - newton["solver"].final_criterion) <= 1e-9
    du = (state[:nu] - x[:nu]).abs().max() / x[:nu].abs().max()
    assert du <= 1e-7
    J = ref.jacobian(x).to_dense()
    coupled = (J[:, nu:] != 0).any(dim=0)
    p, q = state[nu:][coupled], x[nu:][coupled]
    dp = ((p - p.mean()) - (q - q.mean())).abs().max() / q.abs().max()
    assert dp <= 1e-7


def test_two_level_solve_on_the_reference_matrix(newton):
    """One solve against the Jacobian at the converged state: the block
    two-level mixed path reaches relres <= 1e-8 on the reference's matrix
    in under a third of the one-level mixed path's iterations."""
    ref, perm = newton["ref"], newton["perm"]
    state = newton["system"].prob.solution.concat().clone()
    J = ref.jacobian(newton["state"])
    rng = np.random.default_rng(22)
    out = {}
    for two in (True, False):
        system, _ = _program(TwoLevel=two)
        _frozen(system, state)
        prob = system.prob
        nu = prob.block_sizes()[0]
        b = torch.as_tensor(rng.standard_normal(nu) * 1e-3)
        b[torch.as_tensor(system.dirichlet)] = 0.0
        x, its = prob.linear_solver.solve_system(
            prob, BlockVector([b, torch.zeros(prob.block_sizes()[1],
                                              dtype=torch.float64)]))
        bb = _mine(perm, torch.cat([b, torch.zeros(ref.n_p,
                                                   dtype=torch.float64)]),
                   ref.n)
        out[two] = (its, ref.relres(J, bb, _mine(perm, x.concat(), ref.n)),
                    type(prob._mixed_cache["prec"]).__name__)
    its2, rel2, kind2 = out[True]
    its1, _, kind1 = out[False]
    assert kind2 == "PaddedTwoLevelSchwarz" and kind1 == "DenseBlockSchwarz"
    assert rel2 <= 1e-8
    assert 3 * its2 < its1, out


def _jax_ns(params):
    import jax.numpy as jnp

    dom_p = JDomain.structured(3, CELLS)
    prob = JNS(dom_p.p2_domain(), dom_p,
               parameter_list=JPL("P", dict(params)))
    prob.assemble()
    prob.add_bc(lambda x, t: jnp.stack(
        [jnp.where(x[2] > 1 - 1e-9, 1.0, 0.0), 0.0 * x[0], 0.0 * x[0]]),
        1, 0)
    return prob


def _torch_ns(params):
    dom_p = TDomain.structured(3, CELLS, device="cpu")
    prob = TNS(dom_p.p2_domain(), dom_p, parameter_list=TPL(
        "P", dict(params)), device="cpu")
    prob.assemble()
    prob.add_bc(lambda x, t: torch.stack(
        [(x[2] > 1 - 1e-9).double(), 0.0 * x[0], 0.0 * x[0]]), 1, 0)
    return prob


def test_f64_block_basis_matches_jax():
    """The f64 TwoLevelSchwarz's block coarse basis Φ (velocity
    translations and pressure constants on their interface components,
    each field extended through its own diagonal block, the JAX package's
    block-wise construction) equals the JAX package's GDSW basis to 1e-12,
    on one cavity and partition."""
    params = {"Viscosity": 0.01, "Clusters": CLUSTERS}
    prob = _torch_ns(params)
    prob.init_vectors()
    prob.solution = prob.bc_builder.apply_to_rhs(prob.solution, 0.0)
    prob.reassemble("Newton")
    A = prob.bc_system().merge()
    part = MeshPartition(prob.domains[1].mesh, CLUSTERS)
    pc = prob.preconditioner
    mask = prob.merged_dirichlet_mask()
    co64 = tgdsw.TwoLevelSchwarz(A, pc._merged_dof_map(part),
                                 blocks=pc._block_specs(part, "laplace"),
                                 dirichlet_mask=mask).coarse
    phi64 = co64.phi.to_scipy().toarray()
    assert co64.column_block.max() == 1
    pj = _jax_ns(params)
    pj.init_vectors()
    pj.solution = pj.bc_builder.apply_to_rhs(pj.solution, 0.0)
    pj.reassemble("Newton")
    jpart = JPart(pj.domains[1].mesh, CLUSTERS)
    jco = jgdsw.GDSWCoarseOperator(
        pj.bc_system().merge(), pj.preconditioner._merged_dof_map(jpart),
        blocks=pj.preconditioner._block_specs(jpart, "laplace"),
        dirichlet_mask=mask)
    phij = jco.phi.to_scipy().toarray()
    assert phij.shape == phi64.shape
    assert np.abs(phij - phi64).max() <= 1e-12 * np.abs(phi64).max()


def _padded_phi(prec, db, n):
    """The padded coarse level's Φ back in the original dof order."""
    co = prec.coarse
    P, c, R = co.phi_blocks.shape
    old = db.old_of_pad.numpy().reshape(P, R)
    idx = co.coarse_idx.numpy()
    vals = co.phi_blocks.double().numpy()
    out = np.zeros((n, co.nc))
    p, k, r = np.nonzero(vals)
    out[old[p, r], idx[p, k]] = vals[p, k, r]
    return out


def _plain_phi(J, blocks, owned, dirichlet):
    """The monolithic GDSW basis built plainly from a dense matrix J: on
    each field's interface components (nodes grouped by the set of parts
    whose repeated nodes hold them), one function per component of the
    field, the normalised constant on its free dofs; then on each part's
    interior (its owned dofs off the interface and the Dirichlet rows) the
    solve of the merged interior system with those boundary values.  An
    interior dof whose row or column of that system is empty keeps 0.
    Returns (Φ [n, nc], each column's boundary dofs, the interface)."""
    from scipy.linalg import solve

    n = J.shape[0]
    iface = np.zeros(n, bool)
    support = []
    for blk in blocks:
        off, dpn = int(blk["offset"]), int(blk["dofs_per_node"])
        parts_of = [set() for _ in range(blk["points"].shape[0])]
        for p, nodes in enumerate(blk["node_part_sets"]):
            for v in np.asarray(nodes):
                parts_of[v].add(p)
        comps = {}
        for v, ps in enumerate(parts_of):
            if len(ps) > 1:
                comps.setdefault(frozenset(ps), []).append(v)
        for nodes in comps.values():
            for c in range(dpn):
                dofs = off + np.asarray(nodes) * dpn + c
                dofs = dofs[~dirichlet[dofs]]
                if len(dofs):
                    support.append(dofs)
    phi = np.zeros((n, len(support)))
    for j, dofs in enumerate(support):
        iface[dofs] = True
        phi[dofs, j] = 1.0 / np.sqrt(len(dofs))
    for own in owned:
        I = own[~iface[own] & ~dirichlet[own]]
        A_II = J[np.ix_(I, I)]
        live = (A_II != 0).any(axis=1) & (A_II != 0).any(axis=0)
        I = I[live]
        phi[I] = -solve(J[np.ix_(I, I)], J[np.ix_(I, np.flatnonzero(iface))]
                        @ phi[iface])
    return phi, support, iface


def test_padded_block_basis_matches_a_plain_extension(newton):
    """The mixed path's padded block coarse basis Φ, extended through the
    merged interior saddle-point system, equals to 1e-12 a plain
    construction from the reference's Jacobian at the converged state
    (`_plain_phi`, dense solves of each part's interior system), column
    for column up to sign.  The f32 padded coarse apply of a seeded vector
    agrees with the f64 apply to 1e-5 of its largest entry."""
    from feddlib_tpu_torch.solvers.linear import block_cluster_operators

    ref, perm = newton["ref"], newton["perm"]
    system, _ = _program()
    A = _frozen(system, newton["system"].prob.solution.concat().clone())
    prob = system.prob
    n = A.shape[0]
    part = MeshPartition(prob.domains[0].parent_p1.mesh, CLUSTERS)
    pc = prob.preconditioner
    blocks, dof_map = pc._block_specs(part, "laplace"), pc._merged_dof_map(
        part)
    mask = prob.merged_dirichlet_mask()
    out = {}
    for dt in (torch.float64, torch.float32):
        db, _ = block_cluster_operators(A, prob, CLUSTERS)
        out[dt] = (db, PaddedTwoLevelSchwarz(
            A, part, db, blocks=blocks, dirichlet_mask=mask, dof_map=dof_map,
            level_combination="Additive", dtype=dt))
    db, padded = out[torch.float64]
    phi = _padded_phi(padded, db, n)
    J = ref.jacobian(newton["state"]).to_dense().numpy()[np.ix_(perm, perm)]
    dirichlet = ref.D.numpy()[perm]
    plain, support, iface = _plain_phi(J, blocks, dof_map.partition_indices,
                                       dirichlet)
    assert phi.shape == plain.shape and (padded.coarse_per_block > 0).all()
    col_of = {frozenset(np.flatnonzero((phi[:, k] != 0) & iface).tolist()): k
              for k in range(phi.shape[1])}
    assert len(col_of) == phi.shape[1]
    err = 0.0
    for j, dofs in enumerate(support):
        k = col_of[frozenset(dofs.tolist())]
        s = np.sign(phi[dofs[0], k])
        err = max(err, np.abs(s * phi[:, k] - plain[:, j]).max())
    assert err <= 1e-12 * np.abs(plain).max(), err
    r = torch.as_tensor(np.random.default_rng(5).standard_normal(n))
    z64 = padded.coarse.operator()
    z64 = db.from_padded(z64[0](z64[1], db.to_padded(r)))
    db32, p32 = out[torch.float32]
    fn, ops = p32.coarse.operator()
    z32 = db32.from_padded(fn(ops, db32.to_padded(r.float()))).double()
    assert (z32 - z64).abs().max() <= 1e-5 * z64.abs().max()


@pytest.mark.parametrize("name,shape", [
    ("laplace3d-p1-64", (8, 48, 104, [42, 43])),
    ("elasticity3d-p2-24", (8, 280, 1040, [273, 276])),
])
def test_single_field_layouts_keep_their_sizes(name, shape):
    """The one-field cells at their rehearsal sizes keep the point layout
    they had before the block branch: clusters, R, W and cluster sizes."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           name + ".json")) as f:
        cfg = json.load(f)
    cfg["mesh"].update(cfg["rehearsal"]["mesh"])
    cfg["parameters"].update(cfg["rehearsal"]["parameters"])
    system = plugins.load("problems", cfg["problem"]).build(
        cfg, torch.device("cpu"))
    prob = system.prob
    b = torch.ones(prob.block_sizes()[0], dtype=torch.float64)
    b[torch.as_tensor(system.dirichlet)] = 0.0
    prob.linear_solver.solve_system(prob, BlockVector([b]))
    db = prob._mixed_cache["db32"]
    sizes = (db.old_of_pad.numpy() < db.n).reshape(db.P, db.R).sum(1)
    assert (db.P, db.R, db.blocks.shape[2],
            sorted(set(sizes.tolist()))) == shape
