"""Permutation gather y[i] = x[idx[i]] (idx < 0 gives 0) — kernel B1.

The padded operators move vectors through static index plans (the cluster
ghost fetch of the dense-block level 1 and of the padded SpMV).  The JAX
package (feddlib_tpu/la/permute.py) turns each plan into 128-lane windows
for its TPU kernel; on the card every thread can load any address, so the
plan here is the flat int32 index vector itself and the kernel
(csrc/permute.cu) gives each warp a tile of consecutive outputs, in at most
one wave, launched so that it starts while the kernel ahead of it drains.

`permute_gather` launches the kernel for a CUDA tensor and runs the plain
version for a CPU tensor; the result is bit-identical either way.
"""

from __future__ import annotations

import numpy as np
import torch

from feddlib_tpu_torch.la import _cuda
from feddlib_tpu_torch.utils import timers
from feddlib_tpu_torch.utils.device import resolve_device


def permute_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: y[i] = x[idx[i]] where idx[i] >= 0, else 0."""
    valid = idx >= 0
    y = x[idx.clamp(min=0).long()]
    return torch.where(valid, y, torch.zeros((), dtype=x.dtype,
                                             device=x.device))


def permute_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """y[i] = x[idx[i]] (0 where idx[i] < 0); x f32 [n_in], idx int32."""
    if x.device.type == "cpu":
        return permute_gather_plain(x, idx)
    _cuda.require_hopper(x, idx)
    _cuda.require(x, "x", torch.float32, 1)
    _cuda.require(idx, "idx", torch.int32, 1)
    y = torch.empty(idx.shape[0], dtype=torch.float32, device=x.device)
    rc = _cuda.lib().fedd_permute_gather_f32(
        x.data_ptr(), idx.data_ptr(), y.data_ptr(), idx.shape[0],
        _cuda.stream_of(x))
    _cuda.check(rc, "permute_gather")
    timers.count("kernel.permute_gather")
    return y


def _permute_apply(idx: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Operator body: the kernel for f32 vectors, the plain gather for any
    other dtype (as the JAX package sends only f32 through its kernel)."""
    if x.dtype == torch.float32:
        return permute_gather(x, idx)
    return permute_gather_plain(x, idx)


class PermutationGather:
    """Static plan for y = x[idx] (idx int64 [N_out], -1 -> 0)."""

    def __init__(self, idx: np.ndarray, n_in: int, device="cuda"):
        idx = np.asarray(idx, dtype=np.int64)
        if len(idx) and (idx.max() >= n_in or idx.min() < -1):
            raise ValueError("permutation index out of range")
        if n_in >= 2 ** 31:
            raise ValueError("input longer than int32 indexing allows")
        self.n_out = len(idx)
        self.n_in = n_in
        self.device = resolve_device(device)
        self.idx = torch.as_tensor(idx.astype(np.int32), device=self.device)

    def operands(self):
        """Operands of permute_op(ops, x [n_in]) -> y [n_out]."""
        return (self.idx,)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return permute_op(self.operands(), x)


def permute_op(ops, x):
    (idx,) = ops
    return _permute_apply(idx, x)
