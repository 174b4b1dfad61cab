"""The port's distributed FSI loops on several processes: the GE and GI
time loops of tests/test_torch_fsi_pipeline.py (`_loop`: the two-box of
tests/test_fsi.py:24 at 3 cells a box, 'Devices' 6, 'Solid Devices' 2,
two time steps) on 2 gloo ranks x 3 shards, against the same loops with
every shard stacked in one process and the JAX package's distributed run.

Rank 1 owns one fluid shard and both solid shards, so its FaCSI solid
factors and interface sums span both meshes.  Counts (Newton a step,
GMRES a Newton step) equal the JAX run's and the stacked run's; every
field within 1e-12 relative (to the field's max) of the stacked run on
every rank; world size 1 bitwise the stacked run; without 'Devices' the
loops take one shard a rank.  Spawned ranks import this module, so jax is
imported only inside the tests.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

IFACE = 9  # drivers/fsi.py IFACE_BOX
SPAWN_TIMEOUT = 240  # seconds, each launch (tests/test_multihost.py:47)
PARAMS = {"dt": 0.02, "Viscosity": 0.5, "Density Fluid": 1.0,
          "Density Solid": 1.0, "E": 5.0, "Convergence Tolerance": 1e-10,
          "relNonLinTol": 1e-9}


def _two_box(device="cpu"):
    """The two-box at 3 cells a box (feddlib_tpu_torch/scenarios.py, the
    geometry of tests/test_torch_fsi.py `_two_box`)."""
    from feddlib_tpu_torch.scenarios import two_box

    return two_box(3, device)[:3]


def torch_loop(mode, device="cpu"):
    """tests/test_torch_fsi_pipeline.py `_loop("torch", True, mode)` on
    `device`: (Newton a step, GMRES a Newton step, solution blocks,
    problem)."""
    from feddlib_tpu_torch.problems.fsi import FSI
    from feddlib_tpu_torch.solvers import linear
    from feddlib_tpu_torch.utils.config import ParameterList

    d = dict(PARAMS, **{"Use Distributed Solve": True, "Devices": 6,
                        "Solid Devices": 2})
    dom_u, dom_p, dom_d = _two_box(device=device)
    prob = FSI(dom_u, dom_p, dom_d, [IFACE],
               parameter_list=ParameterList("P", d), device=device)
    prob.assemble()
    prob.init_vectors()
    prob.add_bc(lambda x, t: [0.0, 0.0], 1, 0)
    prob.add_bc(lambda x, t: [0.0, 0.0], 1, 2)
    log, newton = [], []
    orig = linear.LinearSolver.solve_system

    def counted(self, problem, b):
        x, it = orig(self, problem, b)
        log.append(it)
        return x, it

    linear.LinearSolver.solve_system = counted
    try:
        if mode == "GE":
            prob.advance(0.04, source_f=lambda x, t: torch.stack(
                [-8.0 * (x[1] - 0.75), 8.0 * (x[0] - 0.5)]),
                observer=lambda t, s: newton.append(len(log)))
        else:
            u0 = 0.01 * np.random.default_rng(7).standard_normal(
                prob.block_sizes()[0])
            prob.solution[0] = torch.as_tensor(u0, device=device)
            prob.advance_gi(0.04,
                            observer=lambda t, s: newton.append(len(log)))
    finally:
        linear.LinearSolver.solve_system = orig
    steps = [int(v) for v in np.diff([0] + newton)]
    return steps, log, [b.cpu().numpy() for b in prob.solution.blocks], prob


def rank_main(modes=("GE", "GI")):
    """One rank's work: each loop on this rank's shards, and the loops'
    shard count without 'Devices'."""
    import sys

    from feddlib_tpu_torch.utils import timers

    torch.set_num_threads(2)
    out = {}
    for mode in modes:
        timers.reset_counters("axis.xfer_bytes", "axis.xfer_calls")
        steps, log, sol, prob = torch_loop(mode)
        cache = prob._pipe_ge if mode == "GE" else prob._pipe_gi
        axis = cache["pipe"].axis
        moved = timers.counters()
        out[mode] = {"steps": steps, "log": log, "sol": sol,
                     "slice": (axis.lo, axis.hi), "n_dev": axis.n_dev,
                     "local_rows": int(cache["pipe"].distribute(
                         prob.solution.concat()).shape[0]),
                     "xfer": {k: moved.get("axis.xfer_" + k, 0)
                              for k in ("bytes", "calls")}}
    dom_u, dom_p, dom_d = _two_box()
    from feddlib_tpu_torch.problems.fsi import FSI
    from feddlib_tpu_torch.utils.config import ParameterList

    prob = FSI(dom_u, dom_p, dom_d, [IFACE],
               parameter_list=ParameterList("P", dict(PARAMS)), device="cpu")
    out["default_devices"] = prob._dist_devices()[0]
    out["jax_loaded"] = any(m == "jax" or m.startswith("jax.")
                            for m in sys.modules)
    return out


# ---------------------------------------------------------------------------
# the tests (the process that imports jax)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs():
    from feddlib_tpu_torch.parallel import multihost

    env = {"OPENBLAS_NUM_THREADS": "1", "OMP_NUM_THREADS": "2"}
    two = multihost.launch(rank_main, 2, backend="gloo",
                           timeout=SPAWN_TIMEOUT, env=env)
    one = multihost.launch(rank_main, 1, args=(("GE",),), backend="gloo",
                           timeout=SPAWN_TIMEOUT, env=env)
    stacked = {}
    for mode in ("GE", "GI"):
        steps, log, sol, _ = torch_loop(mode)
        stacked[mode] = {"steps": steps, "log": log, "sol": sol}
    return {"two": two, "one": one[0], "stacked": stacked}


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def test_ranks_hold_their_slices(runs):
    for mode in ("GE", "GI"):
        got = [r[mode] for r in runs["two"]]
        assert [g["slice"] for g in got] == [(0, 3), (3, 6)]
        assert all(g["n_dev"] == 6 and g["local_rows"] == 3 for g in got)
        # the loops exchanged rows across the ranks (the registry's
        # counters of the collectives)
        assert all(g["xfer"]["bytes"] > 0 and g["xfer"]["calls"] > 0
                   for g in got)
    assert runs["one"]["GE"]["slice"] == (0, 6)
    assert not any(r["jax_loaded"] for r in runs["two"] + [runs["one"]])


@pytest.mark.parametrize("mode", ["GE", "GI"])
def test_two_ranks_match_stacked_and_jax(runs, mode):
    from test_torch_fsi_pipeline import _loop

    j_steps, j_log, _, _ = _loop("jax", True, mode)
    ref = runs["stacked"][mode]
    assert ref["log"] == j_log and ref["steps"] == [int(s) for s in j_steps]
    for r in runs["two"]:
        got = r[mode]
        assert got["log"] == j_log and got["steps"] == ref["steps"]
        for b in range(len(ref["sol"])):
            assert _rel(got["sol"][b], ref["sol"][b]) <= 1e-12, (mode, b)


def test_ranks_share_one_solution(runs):
    """Every rank moves the same mesh: the gathered fields are bitwise
    equal on both ranks."""
    a, b = runs["two"]
    for mode in ("GE", "GI"):
        for x, y in zip(a[mode]["sol"], b[mode]["sol"]):
            assert np.array_equal(x, y)


def test_world_size_one_bitwise(runs):
    ref, got = runs["stacked"]["GE"], runs["one"]["GE"]
    assert got["log"] == ref["log"] and got["steps"] == ref["steps"]
    for x, y in zip(got["sol"], ref["sol"]):
        assert np.array_equal(x, y)


def test_default_shards_one_a_rank(runs):
    assert [r["default_devices"] for r in runs["two"]] == [2, 2]
    assert runs["one"]["default_devices"] == torch.cpu.device_count()
