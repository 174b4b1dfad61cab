"""The port's shards on several processes (feddlib_tpu_torch/parallel/
multihost.py) against the same shards stacked in one process and the JAX
package's serial counts.

Ranks are spawned by the port's launcher over gloo on the CPU, 2 ranks x 2
shards.  The spawned ranks import this module, so nothing at its top level
imports jax: the JAX references are computed inside the tests, in the test
process.  The scenarios are those of tests/multihost_worker.py (distributed
CG on Domain.structured(2, 12); the pipeline + two-level GDSW GMRES on
Domain.structured(2, 16)), plus the collectives one by one and a
Problem.solve inside the multi-rank program.  Tolerances: ppermute,
all_gather, the gathered ELL values and world size 1 bitwise; psum 1e-15
relative; x 1e-12 relative to the stacked run; counts equal.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

N_SHARDS = 4
SPAWN_TIMEOUT = 240  # seconds, each launch (tests/test_multihost.py:47)

# ---------------------------------------------------------------------------
# what every rank runs (no jax in here)
# ---------------------------------------------------------------------------

_PERMS = [
    [(0, 1), (1, 0), (2, 3), (3, 2)],   # within each rank
    [(0, 2), (2, 0), (1, 3), (3, 1)],   # every pair crosses the ranks
    [(1, 2), (2, 1)],                   # one crossing pair, two idle
    [(0, 3), (3, 0), (1, 2)],           # mixed, one one-way pair
]


def _collectives(axis):
    """ppermute / psum / all_gather of a seeded [4, 5] buffer: this rank's
    rows of each result (psum: the full sum)."""
    buf = np.random.default_rng(7).standard_normal((N_SHARDS, 5))
    loc = torch.as_tensor(buf[axis.lo:axis.hi], device=axis.device)
    return {"ppermute": [axis.ppermute(loc, p).cpu().numpy()
                         for p in _PERMS],
            "psum": axis.psum(loc).cpu().numpy(),
            "all_gather": axis.all_gather(loc).cpu().numpy(),
            "lo": axis.lo, "hi": axis.hi}


def _cg(axis):
    """Stage 1 of tests/multihost_worker.py: distributed CG to 1e-10."""
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.fe.host_assembly import host_poisson_dirichlet
    from feddlib_tpu_torch.la.csr import CsrMatrix
    from feddlib_tpu_torch.mesh.partition import MeshPartition
    from feddlib_tpu_torch.parallel.solve import DistributedSolver
    from feddlib_tpu_torch.parallel.spmd import (DistributedCsr,
                                                 collect_vector,
                                                 distribute_vector)

    dom = Domain.structured(2, 12, device=axis.device)
    K, b = host_poisson_dirichlet(dom)
    Kb = CsrMatrix.from_scipy(K, device=axis.device)
    part = MeshPartition(dom.mesh, N_SHARDS)
    dmat = DistributedCsr(Kb, part.unique_map, axis=axis)
    b_dist = distribute_vector(b, part.unique_map, dmat.plan.N_o, axis=axis)
    x, it, rel = DistributedSolver(dmat, axis).solve(
        b_dist, method="cg", tol=1e-10, maxiter=2000)
    return {"iters": it, "relres": rel,
            "x": collect_vector(x, part.unique_map, axis),
            "ell": dmat.ell_host()}


def _pipeline(axis, coarse_procs=0):
    """Stage 2 of tests/multihost_worker.py: the pipeline's assembly and
    Dirichlet rows, two-level GDSW GMRES to 1e-8 (the coarse problem
    solved on the ranks of the first `coarse_procs` shards, if given)."""
    from feddlib_tpu_torch.bc import BCBuilder
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.mesh.partition import MeshPartition
    from feddlib_tpu_torch.parallel.pipeline import DistributedPipeline
    from feddlib_tpu_torch.parallel.solve import DistributedSolver
    from feddlib_tpu_torch.precond.gdsw import distributed_two_level

    dom = Domain.structured(2, 16, device=axis.device)
    part = MeshPartition(dom.mesh, N_SHARDS)
    pipe = DistributedPipeline(part, [(dom, 1)], device=axis.device)
    pipe.add_block(0, 0, "laplace")
    pipe.finalize(axis)
    rhs = pipe.assemble_rhs({0: lambda x: 1.0 + 0 * x[0]})
    bcb = BCBuilder()
    bcb.add_bc(lambda x, t: 0.0, 1, 0, dom, "Dirichlet", 1)
    dmask = np.asarray(bcb.dirichlet_mask(0, dom.n_nodes))
    dmat, rhs = pipe.apply_dirichlet(pipe.assemble(), rhs, dmask,
                                     np.zeros(dom.n_nodes))
    build, arrs = distributed_two_level(dmat, part, dom.mesh.points, 1,
                                        dirichlet_mask=dmask,
                                        coarse_procs=coarse_procs)
    x, it, rel = DistributedSolver(dmat, axis).solve(
        rhs, method="gmres", tol=1e-8, maxiter=300, precond=(build, arrs))
    return {"iters": it, "relres": rel, "x": pipe.collect(x),
            "ell": dmat.ell_host(), "rhs": pipe.collect(rhs)}


def _problem_solve(pipeline):
    """Problem.solve with 'Use Distributed Solve' ('Use Device Pipeline')
    and no 'Devices': inside a program of ranks the shards default to one
    a rank."""
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.problems.laplace import Laplace
    from feddlib_tpu_torch.utils.config import ParameterList

    opts = {"Use Distributed Solve": True, "Use Device Pipeline": pipeline,
            "Preconditioner Type": "SchwarzTwoLevel",
            "Convergence Tolerance": 1e-9, "Maximum Iterations": 500}
    prob = Laplace(Domain.structured(2, 16, device="cpu"),
                   parameter_list=ParameterList("P", opts), device="cpu")
    prob.assemble()
    prob.assemble_source(lambda x: 1.0 + 0 * x[0])
    prob.add_bc(lambda x, t: 0.0, 1, 0)
    prob.set_boundaries_rhs()
    its = prob.solve()
    return {"iters": its, "x": prob.solution[0].numpy()}


def rank_main(problem_solve: bool = True):
    """One rank's work: every scenario on this rank's shards."""
    import sys

    from feddlib_tpu_torch.parallel import multihost

    torch.set_num_threads(2)
    axis = multihost.global_device_axis(N_SHARDS, "cpu")
    out = {"rank": axis.rank, "world": axis.world,
           "slice": multihost.process_local_slice(axis),
           "multiprocess": multihost.is_multiprocess(),
           "collectives": _collectives(axis), "cg": _cg(axis),
           "pipeline": _pipeline(axis),
           # shards 0-2: ranks 0 and 1 own them, rank 0 solves, broadcasts
           "coarse_procs": _pipeline(axis, coarse_procs=3),
           "jax_loaded": any(m == "jax" or m.startswith("jax.")
                             for m in sys.modules)}
    if problem_solve:
        out["solve"] = _problem_solve(False)
        out["solve_pipe"] = _problem_solve(True)
    return out


def _stacked():
    from feddlib_tpu_torch.parallel.spmd import DeviceAxis

    axis = DeviceAxis.make(N_SHARDS, "cpu")
    return {"collectives": _collectives(axis), "cg": _cg(axis),
            "pipeline": _pipeline(axis)}


# ---------------------------------------------------------------------------
# the tests (the process that imports jax)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs():
    from feddlib_tpu_torch.parallel import multihost

    env = {"OPENBLAS_NUM_THREADS": "1", "OMP_NUM_THREADS": "2"}
    two = multihost.launch(rank_main, 2, backend="gloo",
                           timeout=SPAWN_TIMEOUT, env=env)
    one = multihost.launch(rank_main, 1, args=(False,), backend="gloo",
                           timeout=SPAWN_TIMEOUT, env=env)
    return {"two": two, "one": one[0], "stacked": _stacked()}


@pytest.fixture(scope="module")
def jax_counts():
    """The JAX package's serial counts of the two stages."""
    import jax.numpy as jnp

    from feddlib_tpu.bc import BCBuilder
    from feddlib_tpu.fe import ops
    from feddlib_tpu.fe.domain import Domain
    from feddlib_tpu.fe.host_assembly import host_poisson_dirichlet
    from feddlib_tpu.la.csr import CsrMatrix
    from feddlib_tpu.mesh.partition import MeshPartition
    from feddlib_tpu.precond.gdsw import TwoLevelSchwarz
    from feddlib_tpu.solvers.krylov import cg, gmres

    dom = Domain.structured(2, 12)
    K, b = host_poisson_dirichlet(dom)
    ref = cg(CsrMatrix.from_scipy(K).matvec, jnp.asarray(b), tol=1e-10,
             maxiter=2000)
    dom2 = Domain.structured(2, 16)
    part2 = MeshPartition(dom2.mesh, N_SHARDS)
    bcb = BCBuilder()
    bcb.add_bc(lambda x, t: 0.0, 1, 0, dom2, "Dirichlet", 1)
    dmask = np.asarray(bcb.dirichlet_mask(0, dom2.n_nodes))
    K2 = bcb.apply_to_matrix(ops.assemble_laplace(dom2), 0)
    b2 = jnp.where(jnp.asarray(dmask), 0.0,
                   ops.assemble_rhs(dom2, lambda x: 1.0 + 0 * x[0]))
    tls = TwoLevelSchwarz(K2, part2.unique_map,
                          part2.repeated_map.partition_indices,
                          dom2.mesh.points, 1, overlap=1,
                          dirichlet_mask=dmask)
    ref2 = gmres(K2.matvec, b2, M=tls.apply, tol=1e-8, maxiter=300)
    return {"cg": ref.iters, "pipeline": ref2.iters}


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_single_process_fallback():
    """Without a process group: the stacked axis of every shard (the JAX
    anchor tests/test_parallel.py:130)."""
    from feddlib_tpu_torch.parallel import multihost

    assert not multihost.is_multiprocess()
    axis = multihost.global_device_axis(N_SHARDS, "cpu")
    assert axis.n_dev == N_SHARDS and axis.group is None
    assert multihost.process_local_slice(axis) == (0, N_SHARDS)
    assert axis.n_local == N_SHARDS


def test_ranks_hold_their_slices(runs):
    two = runs["two"]
    assert [r["rank"] for r in two] == [0, 1]
    assert [r["slice"] for r in two] == [(0, 2), (2, 4)]
    assert all(r["world"] == 2 and r["multiprocess"] for r in two)
    assert runs["one"]["slice"] == (0, N_SHARDS)
    assert not runs["one"]["multiprocess"]
    # the spawned ranks never import jax
    assert not any(r["jax_loaded"] for r in two + [runs["one"]])


@pytest.mark.parametrize("k", range(len(_PERMS)))
def test_ppermute_bitwise(runs, k):
    ref = runs["stacked"]["collectives"]["ppermute"][k]
    got = np.concatenate([r["collectives"]["ppermute"][k]
                          for r in runs["two"]])
    assert np.array_equal(got, ref)


def test_psum_and_all_gather(runs):
    ref = runs["stacked"]["collectives"]
    for r in runs["two"]:
        c = r["collectives"]
        assert _rel(c["psum"], ref["psum"]) <= 1e-15
        assert np.array_equal(c["all_gather"], ref["all_gather"])


@pytest.mark.parametrize("stage", ["cg", "pipeline"])
def test_ell_host_gathered(runs, stage):
    ref = runs["stacked"][stage]["ell"]
    for r in runs["two"]:
        assert np.array_equal(r[stage]["ell"], ref)


@pytest.mark.parametrize("stage", ["cg", "pipeline", "coarse_procs"])
def test_two_ranks_match_stacked_and_jax(runs, jax_counts, stage):
    ref = runs["stacked"][stage if stage != "coarse_procs" else "pipeline"]
    want = jax_counts["cg" if stage == "cg" else "pipeline"]
    tol = 1e-10 if stage == "cg" else 1e-8
    assert ref["iters"] == want
    for r in runs["two"]:
        got = r[stage]
        assert got["iters"] == ref["iters"] == want
        assert got["relres"] <= tol
        assert _rel(got["x"], ref["x"]) <= 1e-12


@pytest.mark.parametrize("stage", ["cg", "pipeline"])
def test_world_size_one_bitwise(runs, stage):
    ref, got = runs["stacked"][stage], runs["one"][stage]
    assert got["iters"] == ref["iters"]
    assert np.array_equal(got["x"], ref["x"])
    assert np.array_equal(got["ell"], ref["ell"])


@pytest.mark.parametrize("key", ["solve", "solve_pipe"])
def test_problem_solve_inside_ranks(runs, key):
    """Laplace.solve() in the two-rank program, shards one a rank, against
    the same solve in one process on 2 shards."""
    from feddlib_tpu_torch.fe.domain import Domain
    from feddlib_tpu_torch.problems.laplace import Laplace
    from feddlib_tpu_torch.utils.config import ParameterList

    opts = {"Use Distributed Solve": True, "Devices": 2,
            "Use Device Pipeline": key == "solve_pipe",
            "Preconditioner Type": "SchwarzTwoLevel",
            "Convergence Tolerance": 1e-9, "Maximum Iterations": 500}
    prob = Laplace(Domain.structured(2, 16, device="cpu"),
                   parameter_list=ParameterList("P", opts), device="cpu")
    prob.assemble()
    prob.assemble_source(lambda x: 1.0 + 0 * x[0])
    prob.add_bc(lambda x, t: 0.0, 1, 0)
    prob.set_boundaries_rhs()
    its = prob.solve()
    x = prob.solution[0].numpy()
    for r in runs["two"]:
        assert r[key]["iters"] == its
        assert _rel(r[key]["x"], x) <= 1e-12


def test_launcher_reports_a_failed_rank():
    from feddlib_tpu_torch.parallel import multihost

    with pytest.raises(RuntimeError, match="rank 1 of 2"):
        multihost.launch(_fail_on_rank_one, 2, backend="gloo", timeout=60)


def _fail_on_rank_one():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one fails")
    return 0


def test_left_gmres_matches_jax():
    """gmres(left=True) on a Jacobi-preconditioned Laplace: the JAX
    package's count, x within 1e-10."""
    import jax.numpy as jnp

    from feddlib_tpu.fe.domain import Domain as JDomain
    from feddlib_tpu.fe.host_assembly import host_poisson_dirichlet
    from feddlib_tpu.la.csr import CsrMatrix as JCsr
    from feddlib_tpu.solvers.krylov import gmres as jgmres
    from feddlib_tpu_torch.la.csr import CsrMatrix
    from feddlib_tpu_torch.solvers.krylov import gmres

    K, b = host_poisson_dirichlet(JDomain.structured(2, 10))
    dinv = 1.0 / K.diagonal()
    Kj = JCsr.from_scipy(K)
    ref = jgmres(Kj.matvec, jnp.asarray(b), M=lambda r: jnp.asarray(dinv) * r,
                 tol=1e-10, restart=20, maxiter=400, left=True)
    Kt = CsrMatrix.from_scipy(K, device="cpu")
    dt = torch.as_tensor(dinv)
    got = gmres(Kt.matvec, torch.as_tensor(b), M=lambda r: dt * r, tol=1e-10,
                restart=20, maxiter=400, left=True)
    right = gmres(Kt.matvec, torch.as_tensor(b), M=lambda r: dt * r,
                  tol=1e-10, restart=20, maxiter=400)
    assert got.converged and got.iters == ref.iters
    assert _rel(got.x.numpy(), np.asarray(ref.x)) <= 1e-10
    assert abs(got.relres - float(ref.relres)) <= 1e-12
    assert _rel(got.x.numpy(), right.x.numpy()) <= 1e-8
