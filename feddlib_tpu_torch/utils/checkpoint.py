"""Checkpoint / resume of solution state — counterpart of
feddlib_tpu/utils/checkpoint.py, in the same format, so a checkpoint
written by either package loads in the other.

Format: a single .npz per checkpoint (written to a temporary file, then
renamed atomically), holding every block of the solution (`block_i`), the
block count (`_n_blocks`), the time (`_time`), named auxiliary arrays
(`aux_*`: velocity/acceleration, BDF history) and scalar metadata
(`meta_*`)."""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Optional

import numpy as np
import torch

from feddlib_tpu_torch.la.block import BlockVector
from feddlib_tpu_torch.utils.device import resolve_device


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, solution: BlockVector, t: float,
                    aux: Optional[Dict[str, np.ndarray]] = None,
                    meta: Optional[Dict[str, float]] = None) -> None:
    data = {f"block_{i}": _host(b) for i, b in enumerate(solution.blocks)}
    data["_n_blocks"] = np.array(len(solution.blocks))
    data["_time"] = np.array(t)
    for k, v in (aux or {}).items():
        data[f"aux_{k}"] = _host(v)
    for k, v in (meta or {}).items():
        data[f"meta_{k}"] = np.array(v)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **data)
        os.replace(tmp, path)  # atomic
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(path: str, device="cuda"):
    """Returns (solution: BlockVector on `device`, t, aux dict of numpy
    arrays, meta dict)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        n = int(z["_n_blocks"])
        sol = BlockVector([torch.as_tensor(z[f"block_{i}"], device=dev)
                           for i in range(n)])
        t = float(z["_time"])
        aux = {k[4:]: z[k] for k in z.files if k.startswith("aux_")}
        meta = {k[5:]: float(z[k]) for k in z.files if k.startswith("meta_")}
    return sol, t, aux, meta
