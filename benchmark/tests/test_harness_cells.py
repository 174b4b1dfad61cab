"""The harness end to end on the CPU, in its rehearsal mode: each cell at
its configuration's rehearsal size, `--trace 0` and `1`, read from the last
line; discovery by name; the refusals (no card, no program, JAX loaded).

Run from the repository root: python -m pytest benchmark/tests -q
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in SPEC["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(args, cwd=ROOT, timeout=300):
    env = dict(os.environ, OPENBLAS_NUM_THREADS="1", OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def _last(out):
    return json.loads(out.stdout.strip().splitlines()[-1])


def _applies(m, cell):
    return "workloads" not in m or cell in m["workloads"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_rehearsal(cell, trace):
    out = _run(["--workload", cell, "--seed", str(2**31 + 17),
                "--seconds", "2", "--trace", str(trace), "--rehearse"])
    assert out.returncode == 0, out.stderr[-3000:]
    res = _last(out)
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert res["device"]["platform"] == "cpu"
    for name, c in res["checks"].items():
        assert f"check {name}:" in out.stderr
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    host = json.loads(out.stdout.strip().splitlines()[-2][len("host: "):])
    assert host["probe_s_before"] > 0 and host["probe_s_after"] > 0
    if trace == 0:
        want = {m["name"] for m in SPEC["end_to_end"] if _applies(m, cell)}
    else:
        # no device metric from a CPU run
        want = {m["name"] for m in SPEC["per_layer"] if _applies(m, cell)
                and m["source"] != "device_trace"}
        assert "busy_s" not in res["device"] and "breakdown" in res
    assert set(res["metrics"]) == want
    units = {m["name"]: m["unit"] for m in
             SPEC["end_to_end"] + SPEC["per_layer"]}
    for name, v in res["metrics"].items():
        assert v["unit"] == units[name] and v["value"] > 0


def test_same_seed_same_inputs():
    from benchmark import inputs, plugins

    pts, _ = inputs.cube_mesh(3)
    dirichlet = inputs.point_flags(pts, {}) == 1
    spec = {"max_mode": 2, "noise_pool": 3, "noise_share": 0.01}
    cfg = {"mesh": {"cells": 3}}
    Loads = plugins.load("loads", "modes_plus_noise").Loads
    a = Loads(pts, dirichlet, spec, 2**31 + 5, cfg)
    b = Loads(pts, dirichlet, spec, 2**31 + 5, cfg)
    c = Loads(pts, dirichlet, spec, 2**31 + 6, cfg)
    assert (a.load(4) == b.load(4)).all()
    assert not (a.load(4) == c.load(4)).all()
    assert not a.load(4)[dirichlet].any()


def test_no_card_fails_without_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal needs a machine without")
    out = _run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                "--trace", "0"], timeout=120)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_benchmark_alone_fails_without_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    out = _run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                "--trace", "0", "--rehearse"], cwd=tmp_path, timeout=120)
    assert out.returncode != 0
    assert "correct" not in out.stdout


# a new problem kind and a new operation, each in a file of its own
_PROBLEM = """
from benchmark import plugins

_laplace = plugins.load("problems", "laplace")


def build(cfg, device):
    system = _laplace.build(cfg, device)
    system.kind = "poisson_copy"
    return system


relres = _laplace.relres
"""

_OPERATION = """
from benchmark import plugins


class Loop(plugins.load("operations", "solve_stream").Loop):
    def end_to_end(self):
        assert self.sys.kind == "poisson_copy"
        return {"pair_ms": 2 * self.window_s / len(self.run.ops) * 1e3}
"""


def test_new_parts_found_by_name(tmp_path):
    """A throwaway configuration of a new problem kind, a traffic mix of a
    new operation, an end-to-end and a per-layer metric, added as new
    files and new BENCHMARK.json entries; no file edited."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    os.symlink(os.path.join(ROOT, "feddlib_tpu_torch"),
               tmp_path / "feddlib_tpu_torch")
    bench = tmp_path / "benchmark"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.load(open(bench / "configs" / "laplace3d-p1-64.json"))
    cfg.update(name="poisson3d-p1-5", problem="poisson_copy",
               mesh=dict(cfg["mesh"], cells=5),
               rehearsal={"mesh": {"cells": 5},
                          "parameters": {"Clusters": 4}})
    json.dump(cfg, open(bench / "configs" / "poisson3d-p1-5.json", "w"))
    (bench / "problems" / "poisson_copy.py").write_text(_PROBLEM)
    mix = json.load(open(bench / "traffic" / "rhs_stream.json"))
    mix["operation"] = "solve_pairs"
    mix["load"]["max_mode"] = 2
    json.dump(mix, open(bench / "traffic" / "two_modes.json", "w"))
    (bench / "operations" / "solve_pairs.py").write_text(_OPERATION)
    (bench / "metrics" / "ir_passes.solve.py").write_text(
        "from benchmark.readers import mean_of\n\n\n"
        "def read(run):\n    return mean_of(run, 'ir_passes')\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append(dict(spec["configs"][0], name="poisson3d-p1-5",
                                file="benchmark/configs/poisson3d-p1-5.json"))
    cell = "poisson3d-p1-5.two_modes"
    spec["workloads"].append(dict(spec["workloads"][0], name=cell,
                                  config="poisson3d-p1-5",
                                  traffic="two_modes"))
    spec["end_to_end"].append({
        "name": "pair_ms", "unit": "ms", "better": "lower", "bound": 0.25,
        "source": "host_clock", "workloads": [cell]})
    spec["per_layer"].append({
        "name": "ir_passes.solve", "unit": "passes", "better": "lower",
        "source": "program_counter", "layer": "Refinement (f64)",
        "moves": "pair_ms", "workloads": [cell]})
    json.dump(spec, open(tmp_path / "BENCHMARK.json", "w"))
    for trace in (0, 1):
        out = _run(["--workload", cell, "--seed", "9", "--seconds", "1",
                    "--trace", str(trace), "--rehearse"], cwd=tmp_path)
        assert out.returncode == 0, out.stderr[-3000:]
        res = _last(out)
        assert res["correct"] is True
        want = "pair_ms" if trace == 0 else "ir_passes.solve"
        assert res["metrics"][want]["value"] >= 1
    assert {p: p.read_bytes() for p in before} == before


def test_forbidden_modules_compare_whole_names(monkeypatch):
    from benchmark import run

    for name in ("feddlib_tpu_torch.la", "jaxtyping", "flaxen_x"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == [
        m for m in run.FORBIDDEN if m in {k.split(".")[0]
                                          for k in sys.modules}]
    monkeypatch.setitem(sys.modules, "feddlib_tpu.fe", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"feddlib_tpu", "jaxlib"} <= set(run.forbidden_modules())


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_jax_in_the_benchmark_and_no_program_in_the_reference():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        for f in files:
            if not f.endswith(".py") or "tests" in dirpath.split(os.sep):
                continue
            names = set(_imports(os.path.join(dirpath, f)))
            assert not names & {"jax", "jaxlib", "flax", "feddlib_tpu"}, f
            if os.path.basename(dirpath) == "reference":
                assert "feddlib_tpu_torch" not in names, f
    code = ("import sys, benchmark.reference.checks, "
            "benchmark.reference.control; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    loaded = set(ast.literal_eval(out.stdout.strip()))
    assert not loaded & {"jax", "jaxlib", "flax", "feddlib_tpu",
                         "feddlib_tpu_torch"}


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA H100")
    out = _run(["--workload", cell, "--seed", "12345", "--seconds", "5",
                "--trace", "0"], timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = _last(out)
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
