"""`correct` has to come out false for the control (the reference in
float32, planted in the program's place) and for each fault of the timed
path that a cell can have, each planted underneath a whole run of the
harness (`faults.py`), at the configurations' rehearsal sizes on the CPU."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests.faults import FAULTS

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


@pytest.mark.parametrize("fault,cell", CASES)
def test_fault_comes_out_not_correct(fault, cell):
    env = dict(os.environ, OPENBLAS_NUM_THREADS="1", OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.tests.faults", fault,
         "--workload", cell, "--seed", "2147483711", "--seconds", "2",
         "--trace", "0", "--rehearse"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is False and res["failed"] > 0
    # the number that failed is printed beside its limit
    failing = [n for n, c in res["checks"].items()
               if not (float(c["value"]) <= c["limit"] if c["rule"] == "<="
                       else float(c["value"]) >= c["limit"])]
    assert failing, res["checks"]
