"""Run one cell of the benchmark once:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (mesh, assembly, operator layout,
preconditioner, warm-up) is timed from the process start; then the cell's
closed loop runs whole operations for `--seconds`; then what the window
produced is judged against the plain reference.  The last line of standard
output is one JSON object (`correct`, `attempted`, `failed`, `metrics`,
`device`, with `--trace 1` also `breakdown`, and last `checks`: each number
compared beside its limit, also printed as the last lines of standard
error).  `--trace 0` reports the cell's end-to-end metrics, `--trace 1` its
per-layer metrics from a profiled sub-window.

Everything is found by name: the cell in BENCHMARK.json, its configuration
in `benchmark/configs/<config>.json` and its problem kind in
`benchmark/problems/<problem>.py`, its traffic mix in
`benchmark/traffic/<mix>.json` with its operation in
`benchmark/operations/<operation>.py` and its load kind in
`benchmark/loads/<kind>.py`, each per-layer metric's reader in
`benchmark/metrics/<metric>.py` (`benchmark/plugins.py`).

The host sets the pace of both cells, and its speed swings between
machines and within minutes.  So the window runs with the caller's thread
on one fixed core, and the run prints a host line before its result: a
fixed pure-Python loop timed before and after the window, and the share of
the window's CPU time the hypervisor took (steal).

Without a CUDA device (or with fewer than the cell asks for) the run fails
and prints no result.  `--rehearse` (for the CPU tests only) runs the
configuration's `rehearsal` sizes on the CPU, names the CPU as the device
and writes no device metric.
"""

import os
import time

# the clock of `setup_s` starts with the process
try:
    with open("/proc/self/stat") as _f:
        _ticks = int(_f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as _f:
        _AGE = max(float(_f.read().split()[0])
                   - _ticks / os.sysconf("SC_CLK_TCK"), 0.0)
except (OSError, ValueError, IndexError):
    _AGE = 0.0
T_START = time.perf_counter() - _AGE

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "feddlib_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def host_probe() -> float:
    """Seconds of a fixed pure-Python loop: the host's speed for the
    interpreter-bound parts of the program."""
    t = time.perf_counter()
    acc = 0
    for i in range(1_000_000):
        acc += i * i % 7
    return time.perf_counter() - t


def _cpu_jiffies():
    """(all, steal) jiffies of the machine's CPUs, from /proc/stat."""
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
        return sum(v[:8]), v[7]
    except (OSError, ValueError, IndexError):
        return None


def _pin_caller() -> int:
    """Keep the calling thread on one fixed core (the last it may use);
    threads made before keep theirs.  Returns the core, or -1."""
    try:
        cpu = max(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {cpu})
        return cpu
    except (AttributeError, OSError, ValueError):
        return -1


def forbidden_modules():
    """Top-level names of loaded modules that the run may not hold,
    compared whole (`feddlib_tpu_torch` is not `feddlib_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What one run knows: the cell, its files, the device, the window's
    operations and the trace.  Loops and metric readers read it."""

    def __init__(self, args, spec, cell, config, traffic, device):
        self.args, self.spec, self.cell = args, spec, cell
        self.config, self.traffic, self.device = config, traffic, device
        self.seed = args.seed
        self.rehearse = args.rehearse
        self.ops = []        # one dict per window operation
        self.op_index = -1   # the window operation in progress
        self.trace = None
        self.setup_s = None
        self.spans = {}      # name -> {op_index: seconds}, from readers
        self.cpu, self.jiffies = -1, None

    def window_started(self) -> None:
        self.setup_s = time.perf_counter() - T_START
        self.cpu = _pin_caller()
        self.jiffies = _cpu_jiffies()
        if self.args.trace:
            from benchmark.tracing import Trace

            self.trace = Trace(self.device)
            self.trace.start()

    def after_op(self, elapsed: float) -> None:
        """Called with the window's seconds after each operation is
        recorded: marks it if the profiler saw it, and ends the traced
        sub-window once `trace_seconds` have passed."""
        t = self.trace
        if t is not None and t.active:
            self.ops[-1]["profiled"] = True
            if elapsed >= float(self.traffic["trace_seconds"]):
                t.stop()

    def add_span(self, name: str, seconds: float) -> None:
        per_op = self.spans.setdefault(name, {})
        per_op[self.op_index] = per_op.get(self.op_index, 0.0) + seconds


def _parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="CPU tests only: the configuration's rehearsal "
                        "sizes on the CPU, no device metric")
    return p


def _fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return 1


def _card(torch) -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else torch.cuda.get_device_name(0)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    spec = load_json(ROOT, "BENCHMARK.json")
    cell = find_cell(spec, args.workload)
    config = load_json(HERE, "configs", cell["config"] + ".json")
    traffic = load_json(HERE, "traffic", cell["traffic"] + ".json")
    cache = os.path.join(HERE, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")

    import torch

    if args.rehearse:
        device = torch.device("cpu")
        config = dict(config, **{
            "mesh": dict(config["mesh"], **config["rehearsal"]["mesh"]),
            "parameters": dict(config["parameters"],
                               **config["rehearsal"]["parameters"])})
    else:
        if not torch.cuda.is_available():
            return _fail("no CUDA device: this benchmark measures the card")
        if torch.cuda.device_count() < int(cell["chips"]):
            return _fail(f"{cell['name']} needs {cell['chips']} cards, "
                         f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    try:
        import feddlib_tpu_torch
    except ImportError as e:
        return _fail(f"the program is not in this checkout: {e}")
    if not os.path.abspath(feddlib_tpu_torch.__file__).startswith(
            ROOT + os.sep):
        return _fail(f"feddlib_tpu_torch loaded from outside the checkout: "
                     f"{feddlib_tpu_torch.__file__}")

    from benchmark import plugins

    if device.type == "cuda":
        from feddlib_tpu_torch.la import _cuda

        _cuda.lib()  # the kernels: built in the checkout's first run
        print(_card(torch), flush=True)
    run = Run(args, spec, cell, config, traffic, device)
    readers = {}
    if args.trace:
        readers = {m["name"]: plugins.load("metrics", m["name"])
                   for m in spec["per_layer"] if applies(m, cell["name"])}
    problem = plugins.load("problems", config["problem"])
    op = plugins.load("operations", traffic["operation"])
    probe_before = host_probe()
    t = time.perf_counter()
    system = problem.build(config, device)
    t_built = time.perf_counter()
    loop = op.Loop(run, system, traffic)
    t_ready = time.perf_counter()
    print(f"setup: process start to build {t - T_START:.3f} s, system "
          f"built {t_built - t:.3f} s, loop ready {t_ready - t_built:.3f} s",
          file=sys.stderr, flush=True)
    run.system = system
    for r in readers.values():
        if hasattr(r, "install"):
            r.install(run)
    loop.run_loop(args.seconds)
    j0, j1 = run.jiffies, _cpu_jiffies()
    steal = (100.0 * (j1[1] - j0[1]) / max(j1[0] - j0[0], 1)
             if j0 and j1 else float("nan"))
    host = {"probe_s_before": probe_before, "probe_s_after": host_probe(),
            "steal_pct": steal, "cpu": run.cpu}
    print(f"setup: warm-up {T_START + run.setup_s - t_ready:.3f} s "
          f"(setup_s {run.setup_s:.3f} s)", file=sys.stderr, flush=True)
    thirds = [run.ops[i * len(run.ops) // 3:(i + 1) * len(run.ops) // 3]
              for i in range(3)]
    print("window: %d operations, mean seconds by thirds %s" % (
        len(run.ops), " / ".join(
            "%.4f" % (sum(o["seconds"] for o in t) / max(len(t), 1))
            for t in thirds)), file=sys.stderr, flush=True)
    if run.trace is not None and run.trace.active:
        run.trace.stop()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))

    metrics = {}
    if not args.trace:
        values = dict(loop.end_to_end(), setup_s=run.setup_s)
        for m in spec["end_to_end"]:
            if applies(m, cell["name"]):
                metrics[m["name"]] = {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
    else:
        for m in spec["per_layer"]:
            if m["name"] not in readers:
                continue
            if args.rehearse and m["source"] == "device_trace":
                continue
            v = readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the program's state goes before the reference runs
    loop.release()
    run.system = system = None
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = loop.check(device)
    correct = failed == 0 and all(v <= lim if rule == "<=" else v >= lim
                                  for _, v, lim, rule in checks)

    found = forbidden_modules()
    if found:
        return _fail(f"modules loaded that the run may not hold: {found}")
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": int(cell["chips"]), "memory_peak_bytes": peak}
    else:
        dev = {"platform": "cpu", "kind": "cpu (rehearsal)", "count": 1}
    result = {"correct": bool(correct), "attempted": len(run.ops),
              "failed": failed if failed or correct else len(run.ops),
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        if device.type == "cuda":
            dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown
    # a NaN or an infinity is no JSON number: it is written as a string
    result["checks"] = {n: {"value": v if math.isfinite(v) else repr(v),
                            "limit": lim, "rule": rule}
                        for n, v, lim, rule in checks}
    for n, v, lim, rule in checks:
        print(f"check {n}: {v!r} (limit {rule} {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print("host: " + json.dumps(host), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
