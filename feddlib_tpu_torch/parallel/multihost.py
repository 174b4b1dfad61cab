"""Shards on several processes — counterpart of
feddlib_tpu/parallel/multihost.py, on `torch.distributed`.

One process (rank) holds a contiguous range [lo, hi) of the shard axis,
stacked on its own device; the collectives of `DeviceAxis` run through
the process group: neighbour pairs of a `ppermute` round that cross ranks
become one point-to-point send / receive per peer rank, `psum` a local sum
plus an all-reduce, `all_gather` an all-gather of the local rows.

Setup-phase host work (the mesh, the partition, every plan) is replicated
on every rank, as in the JAX package: the plans are deterministic, so all
ranks derive identical indices and upload only the rows of their shards.

Transport: NCCL for one card a rank; gloo on the CPU, and wherever several
ranks share a card (NCCL refuses two ranks on one device).  What gloo
cannot send from device memory is staged through pinned host buffers; the
staging is chosen by the backend's name (`DeviceAxis._staged`), never on
an error.

Usage, one process a rank (any launcher that sets the rank and the world
size; `launch` below spawns them on this host):

    from feddlib_tpu_torch.parallel import multihost
    multihost.initialize("nccl", "tcp://host0:29500", world, rank)
    axis = multihost.global_device_axis(n_shards)   # this rank's slice
    lo, hi = multihost.process_local_slice(axis)

A single process needs no `initialize`: `global_device_axis` then returns
the stacked axis, all shards on one device.
"""

from __future__ import annotations

import importlib
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

import torch

from feddlib_tpu_torch.parallel.spmd import DeviceAxis, shard_ranges


def _dist():
    import torch.distributed as dist

    return dist


def initialize(backend: str = "nccl", init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> None:
    """Join the process group (`torch.distributed.init_process_group`).
    Idempotent.  Without `init_method` the `env://` variables are read."""
    dist = _dist()
    if dist.is_initialized():
        return
    kw = {}
    if init_method is not None:
        kw["init_method"] = init_method
    if world_size is not None:
        kw["world_size"] = int(world_size)
    if rank is not None:
        kw["rank"] = int(rank)
    dist.init_process_group(backend, **kw)


def is_multiprocess() -> bool:
    dist = _dist()
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def local_device(device="cuda") -> torch.device:
    """The device of this rank: `cuda:{local rank % cards}` for a CUDA
    device type (LOCAL_RANK, else the rank), the CPU otherwise."""
    dev = torch.device(device)
    dist = _dist()
    if dev.type != "cuda" or not dist.is_initialized():
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def default_shards(device="cuda") -> int:
    """The shard count when none is given: one a rank inside a program of
    ranks, else the device count of the device type (the JAX package's
    len(jax.devices()))."""
    if is_multiprocess():
        return _dist().get_world_size()
    return (torch.cuda.device_count() if torch.device(device).type == "cuda"
            else torch.cpu.device_count())


def global_device_axis(n_dev: Optional[int] = None,
                       device="cuda") -> DeviceAxis:
    """The shard axis over every rank of the process group: this rank owns
    the contiguous range `shard_ranges(n_dev, world)[rank]` on
    `local_device(device)`.  Without a process group it is the stacked
    axis of one process.  n_dev defaults to `default_shards`."""
    if n_dev is None:
        n_dev = default_shards(device)
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        return DeviceAxis.make(n_dev, device)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = int(n_dev)
    if n < world:
        raise ValueError(f"{n} shards over {world} ranks: every rank needs "
                         f"at least one shard")
    lo, hi = shard_ranges(n, world)[rank]
    return DeviceAxis.make(n, local_device(device), group=dist.group.WORLD,
                           rank=rank, world=world, lo=lo, hi=hi,
                           backend=dist.get_backend())


def process_local_slice(axis: DeviceAxis):
    """(lo, hi): the shards whose rows live on this process."""
    return axis.lo, axis.hi


# ---------------------------------------------------------------------------
# launcher: N ranks of one function on this host
# ---------------------------------------------------------------------------


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _target_spec(target) -> str:
    if isinstance(target, str):
        return target
    mod = target.__module__
    if mod == "__main__":  # a script's function: import the script
        main = sys.modules["__main__"].__file__
        mod = os.path.splitext(os.path.basename(main))[0]
    return f"{mod}:{target.__qualname__}"


def launch(target, nprocs: int, args=(), backend: str = "gloo",
           timeout: float = 240.0, env: Optional[dict] = None,
           echo: bool = False):
    """Run `target(*args)` in `nprocs` new processes, the ranks of one
    `backend` process group over localhost, and return their results in
    rank order.

    `target` is a module-level function or its "module:qualname"; each
    rank imports it (the parent's sys.path is its PYTHONPATH), joins the
    group, calls it and pickles the result back.  Every rank must finish
    within `timeout` seconds.  If one fails or time runs out, every rank
    still running is killed and RuntimeError carries the failed rank's
    output.  `echo` prints each rank's output after the run."""
    spec = _target_spec(target)
    tmp = tempfile.mkdtemp(prefix="fedd_ranks_")
    init = f"tcp://127.0.0.1:{free_port()}"
    penv = dict(os.environ)
    penv.update(env or {})
    penv["PYTHONPATH"] = os.pathsep.join(
        [p for p in sys.path if p] + [penv.get("PYTHONPATH", "")])
    with open(os.path.join(tmp, "args.pkl"), "wb") as f:
        pickle.dump(tuple(args), f)
    procs, logs = [], []
    try:
        for r in range(nprocs):
            log = open(os.path.join(tmp, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "feddlib_tpu_torch.parallel.multihost",
                 spec, str(r), str(nprocs), init, backend, tmp],
                stdout=log, stderr=subprocess.STDOUT, env=penv))
        t_end = time.monotonic() + timeout
        failed = None
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = (bad[0], f"exit code {codes[bad[0]]}")
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > t_end:
                late = [r for r, c in enumerate(codes) if c is None]
                failed = (late[0], f"no result within {timeout} s")
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        outs = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                outs.append(f.read())
        if echo:
            for r, out in enumerate(outs):
                for line in out.splitlines():
                    print(f"[rank {r}] {line}", flush=True)
        if failed is not None:
            r, why = failed
            raise RuntimeError(f"rank {r} of {nprocs} ({spec}, {backend}) "
                               f"failed: {why}\n{outs[r][-4000:]}")
        results = []
        for r in range(nprocs):
            with open(os.path.join(tmp, f"rank{r}.out"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _child(argv) -> None:
    spec, rank, world, init, backend, tmp = argv
    rank, world = int(rank), int(world)
    os.environ.setdefault("LOCAL_RANK", str(rank))
    initialize(backend, init, world, rank)
    if backend == "nccl":
        torch.cuda.set_device(local_device("cuda"))
    mod, _, qual = spec.partition(":")
    fn = importlib.import_module(mod)
    for part in qual.split("."):
        fn = getattr(fn, part)
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    res = fn(*args)
    dist = _dist()
    dist.barrier()
    with open(os.path.join(tmp, f"rank{rank}.out"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    # run through the package module, so that the target and this entry
    # share one module state
    from feddlib_tpu_torch.parallel import multihost as _mh

    _mh._child(sys.argv[1:])
