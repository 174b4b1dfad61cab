"""Find the benchmark's parts by name, each in a file of its own:

    benchmark/problems/<problem>.py      a configuration's `problem` kind
    benchmark/operations/<operation>.py  a traffic mix's `operation`
    benchmark/loads/<kind>.py            a traffic mix's `load` kind
    benchmark/metrics/<metric>.py        a per-layer metric's reader

A later cell adds files and `BENCHMARK.json` entries; no existing file is
edited.  Names may hold dots and dashes, so each file is loaded by its path
and kept under one module name, so that every caller sees the same module.
"""

from __future__ import annotations

import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def load(kind: str, name: str, root: str = HERE):
    """The module `<root>/<kind>/<name>.py`, loaded once per process."""
    path = os.path.join(root, kind, name + ".py")
    if not os.path.isfile(path):
        have = sorted(f[:-3] for f in os.listdir(os.path.join(root, kind))
                      if f.endswith(".py") and not f.startswith("_"))
        raise FileNotFoundError(f"no {kind} part {name!r} ({path}); "
                                f"have {have}")
    mod_name = "benchmark_%s_%s" % (kind, name.replace("_", "__").replace(
        ".", "_d").replace("-", "_h"))
    mod = sys.modules.get(mod_name)
    if mod is None or getattr(mod, "__file__", None) != path:
        sp = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(sp)
        sys.modules[mod_name] = mod
        sp.loader.exec_module(mod)
    return mod
