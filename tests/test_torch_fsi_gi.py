"""The port's geometry-implicit FSI loop, its refusals, a 3D mixed GE
step and steps resumed from a JAX state, against the JAX package on the
two-box scenario of tests/test_fsi.py:24 (helpers and tolerances of
test_torch_fsi.py).  GI GMRES counts ±2 of the JAX package's [30, 30];
solutions within 1e-8 of max |x|; the 3D mixed step's GMRES counts within
10 % of the JAX package's (f32 noise over 700 inner iterations)."""

import numpy as np
import pytest

from test_torch_fsi import (FACSI, GI, JACOBI, _jax_run,  # noqa: F401
                            _problem, _rel, _run, _same_solution, _solution,
                            blas1)
from feddlib_tpu_torch.utils import convert


def test_gi_matches_jax_and_ge():
    """GI (five fields, shape-derivative blocks) with 'SchwarzOneLevel' on
    8 subdomains: [30, 30] GMRES iterations as in the JAX package, the same
    solution; and GE against GI as in tests/test_fsi.py:163 (two Jacobi
    steps, relative difference of d below 5 %)."""
    its_j, sol_j, _ = _jax_run("GI", 4, GI, mode="GI", t_end=0.02)
    its_t, sol_t, prob = _run("torch", 4, GI, mode="GI", t_end=0.02)
    assert its_j == [30, 30]
    assert prob.block_sizes() == [162, 25, 162, 18, 162]
    assert all(abs(a - b) <= 2 for a, b in zip(its_t, its_j)) \
        and len(its_t) == 2
    _same_solution(sol_t, sol_j)
    d = {}
    for mode in ("GE", "GI"):
        d[mode] = _run("torch", 3, JACOBI, mode=mode)[1][2]
    assert _rel(d["GI"], d["GE"]) < 0.05


def test_gi_with_facsi_raises():
    """FaCSI has no step for the GI geometry block: a readable ValueError
    instead of the JAX package's broadcasting failure inside GMRES."""
    prob = _problem("torch", 3, FACSI)
    with pytest.raises(ValueError, match="5 blocks"):
        prob.advance_gi(t_end=0.02)


def test_distributed_solve_raises():
    """'Use Distributed Solve' on FSI (the pipeline and distributed FaCSI,
    tests/test_torch_fsi_pipeline.py) refuses what the JAX package
    refuses: a linearisation other than Newton, and a shard count without
    a fluid and a solid shard."""
    prob = _problem("torch", 3, dict(FACSI, **{
        "Use Distributed Solve": True, "Devices": 6, "Solid Devices": 2}))
    with pytest.raises(ValueError, match="newton_method='Newton'"):
        prob.advance(t_end=0.02, newton_method="FixedPoint")
    prob.parameter_list["Devices"] = 2
    for run in (prob.advance, prob.advance_gi):
        with pytest.raises(ValueError, match="one fluid and one solid"):
            run(t_end=0.02)


def test_3d_mixed_step_matches_jax():
    """One 3D GE step on (3, 3, 2) cells a box, mixed precision with
    'SchwarzOneLevel' on 8 dof-map clusters (λ placed by
    extra_block_owner): solutions within 1e-8, GMRES counts within 10 % of
    the JAX package's (its own [643, 713])."""
    params = {"Use Mixed Precision": True,
              "Preconditioner Type": "SchwarzOneLevel", "Clusters": 8,
              "MaxNonLinIts": 12}
    its_j, sol_j, _ = _run("jax", 3, params, t_end=0.02, dim=3)
    its_t, sol_t, prob = _run("torch", 3, params, t_end=0.02, dim=3)
    assert prob.block_sizes() == [735, 48, 735, 111]
    assert len(its_t) == len(its_j) == 2
    assert all(abs(a - b) <= 0.1 * b for a, b in zip(its_t, its_j))
    _same_solution(sol_t, sol_j)
    assert prob.last_relres <= 1e-8


def test_step_resumed_from_jax_state():
    """fsi_state_from_numpy: the JAX package's state after its first
    FaCSI step, carried into the port, gives the JAX second step within
    1e-8 (GE), and likewise for one GI step after a GI step."""
    for mode, params, n in (("GE", FACSI, 4), ("GI", GI, 3)):
        states = []

        def keep(t, sol, box=states):
            p = box[0]
            box.append((t, [np.array(b) for b in sol.blocks],
                        np.array(p.solid_v), np.array(p.solid_a),
                        np.array(p.g_prev),
                        p.variables[0][0].mesh.points.copy(),
                        p.variables[0][0].mesh.ref_points.copy()))

        prob_j = _problem("jax", n, params)
        states.append(prob_j)
        (prob_j.advance if mode == "GE" else prob_j.advance_gi)(
            t_end=0.04, observer=keep)
        _, blocks, v, a, gp, pts, ref = states[1]
        prob_t = _problem("torch", n, params)
        convert.fsi_state_from_numpy(prob_t, blocks, v, a, gp, pts, ref)
        (prob_t.advance if mode == "GE" else prob_t.advance_gi)(t_end=0.02)
        _same_solution(_solution(prob_t), _solution(prob_j))
        assert _rel(prob_t.solid_v.numpy(), np.array(prob_j.solid_v)) < 1e-8
