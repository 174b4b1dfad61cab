"""What the operations (`benchmark/operations/<operation>.py`, found by a
traffic mix's `operation`) share.

An operation module has a class `Loop(run, system, traffic)`: a closed
loop of whole operations with one caller, each ended by a synchronise, so
that its latency is the caller's.  It has

- `run_loop(seconds)`: warm-up, then `run.window_started()`, then whole
  operations until `seconds` have passed, recording one dict per
  operation in `run.ops` (its `seconds` and the counts the program
  returns) and calling `run.after_op(elapsed)` after each;
- `end_to_end()`: the end-to-end metrics it measures, by name;
- `release()`: move what the check needs to the host and drop the
  program's state;
- `check(device)`: ([(name, value, limit, "<=" or ">=")], failed
  operations), on the reference's side of the configuration's problem
  kind (`problem(run)`).
"""

from __future__ import annotations

from benchmark import plugins

# warm-up requests draw their loads from indices no window request uses
WARMUP_INDEX = 2**40


def worst(values):
    """The largest value, or NaN where any is NaN."""
    return float("nan") if any(v != v for v in values) else max(values)


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def problem(run):
    """The module of the configuration's problem kind."""
    return plugins.load("problems", run.config["problem"])


def loads(run, system, traffic):
    """The traffic's loads: its load kind's `Loads` on this run's mesh,
    parameters and seed."""
    spec = traffic["load"]
    kind = plugins.load("loads", spec["kind"])
    nodes = system.points.shape[0]
    dirichlet = system.dirichlet.reshape(nodes, -1).all(axis=1)
    return kind.Loads(system.points, dirichlet, spec, run.seed, run.config)
