"""The vector cells' side of the harness on the CPU: `correct` comes out
false for each of their faults, for each cell's float32 control and for
the program's answers rounded to float32, each planted underneath a whole
run at the configurations' rehearsal sizes (`faults_vector.py`); the P2 reference's clamped nodes and its lattice-key
map; the vector loads.

Run from the repository root: python -m pytest benchmark/tests -q
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import inputs, plugins
from benchmark.reference import fem_p2
from benchmark.tests.faults_vector import FAULTS

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def _operation(cell):
    w = next(w for w in SPEC["workloads"] if w["name"] == cell)
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           w["traffic"] + ".json")) as f:
        return json.load(f)["operation"]


CASES = [(fault, w["name"]) for fault in sorted(FAULTS)
         for w in SPEC["workloads"] if _operation(w["name"]) in FAULTS[fault]]


def test_every_vector_cell_has_its_faults():
    cells = {c for _, c in CASES}
    assert {"elasticity3d-p2-24.load_cases",
            "neohooke3d-p1-32.tangent_solves"} <= cells
    for fault in ("control_f32", "rounded_f32"):
        assert {(fault, "elasticity3d-p2-24.load_cases"),
                (fault, "neohooke3d-p1-32.tangent_solves")} <= set(CASES)


@pytest.mark.parametrize("fault,cell", CASES)
def test_vector_fault_comes_out_not_correct(fault, cell):
    env = dict(os.environ, OPENBLAS_NUM_THREADS="1", OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.tests.faults_vector", fault,
         "--workload", cell, "--seed", "2147483711", "--seconds", "2",
         "--trace", "0", "--rehearse"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is False and res["failed"] > 0
    relres = float(res["checks"]["relres_max"]["value"])
    assert relres > res["checks"]["relres_max"]["limit"]
    if fault == "control_f32":  # far above the limit, not by rounding
        assert relres > 1e-6


@pytest.mark.parametrize("cells", [2, 4])
def test_p2_reference_clamps_exactly_the_x0_nodes(cells):
    """The Dirichlet mask is the P2 nodes (vertices and midpoints) with
    x = 0, and the lattice-key map from any other numbering of the nodes
    is a bijection."""
    ref = fem_p2.LinElasP2(cells, 1.0, 0.5)
    pts = ref.m.points
    n = (2 * cells + 1) ** 3
    assert pts.shape == (n, 3) and len(np.unique(ref.m.keys())) == n
    assert (ref.clamped_nodes == (pts[:, 0] == 0.0)).all()
    assert ref.clamped_nodes.sum() == (2 * cells + 1) ** 2
    assert (ref.D.numpy() == np.repeat(ref.clamped_nodes, 3)).all()
    perm = np.random.default_rng(cells).permutation(n)
    order = ref.m.order_of(pts[perm])
    assert (order == perm).all()
    with pytest.raises(ValueError):
        ref.m.order_of(np.concatenate([pts[perm][:-1], pts[:1]]))


def test_vector_loads_make_up():
    """Each component gets its own smooth modes and noise; the same seed
    gives the same loads; zero on every clamped dof."""
    pts, _ = inputs.cube_mesh(3)
    clamped = inputs.point_flags(pts, {"x0": 2}) == 2
    spec = {"max_mode": 2, "noise_pool": 3, "noise_share": 0.01}
    cfg = {"mesh": {"cells": 3}}
    Loads = plugins.load("loads", "vector_modes_plus_noise").Loads
    a = Loads(pts, clamped, spec, 2**31 + 5, cfg)
    b = Loads(pts, clamped, spec, 2**31 + 5, cfg)
    c = Loads(pts, clamped, spec, 2**31 + 6, cfg)
    assert a.modes.shape == (3 * len(pts), 3 * 8)
    assert a.noise.shape == (3 * len(pts), 3 * 3)
    assert (a.load(4) == b.load(4)).all()
    assert not (a.load(4) == c.load(4)).all()
    v = a.load(4).reshape(-1, 3)
    assert not v[clamped].any() and (np.abs(v[~clamped]) > 0).all()
    scalar = plugins.load("loads", "modes_plus_noise").Loads(
        pts, clamped, dict(spec, noise_pool=9), 2**31 + 5, cfg)
    for comp in range(3):
        assert np.allclose(a.modes[comp::3, comp * 8:(comp + 1) * 8],
                           scalar.modes)
    am, w = a.coefficients(4)
    smooth = np.linalg.norm(a.modes @ am)
    assert np.linalg.norm(a.noise @ w) == pytest.approx(0.01 * smooth)
