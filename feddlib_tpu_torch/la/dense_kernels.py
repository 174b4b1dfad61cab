"""Batched dense-block GEMV — kernels B3 (f32) and B4 (bf16 store).

Counterpart of feddlib_tpu/la/pallas_kernels.py.  Both compute
y[p, r] = Σ_w blocks[p, r, w] · xs[p, w] for blocks [P, R, W] and
xs [P, W] f32, y [P, R] f32:

- `dense_block_mv`: f32 blocks (the level-1 apply of the mixed-precision
  `Problem.solve`, and `DenseBlockSpMV`).  The JAX package keeps its TPU
  kernel opt-in because of a Mosaic aliasing fault inside while_loop; the
  port takes its kernel by default on the card.
- `dense_block_mv_lowp`: bf16 blocks, x rounded to bf16 first, products
  widened to f32 and accumulated in f32 (the bf16 level 1 of the bench
  chain).

Each launches its CUDA kernel (csrc/dense_gemv.cu) for a CUDA tensor and
runs the plain version for a CPU tensor.
"""

from __future__ import annotations

import torch

from feddlib_tpu_torch.la import _cuda
from feddlib_tpu_torch.utils import timers


def dense_block_mv_plain(blocks: torch.Tensor, xs: torch.Tensor
                         ) -> torch.Tensor:
    """Plain PyTorch version of B3: elementwise products summed over W."""
    return (blocks * xs.unsqueeze(1)).sum(-1)


def dense_block_mv_lowp_plain(blocks: torch.Tensor, xs: torch.Tensor
                              ) -> torch.Tensor:
    """Plain PyTorch version of B4: x rounded to the store dtype, products
    in f32 (exact for bf16 × bf16), f32 sums over W."""
    xr = xs.to(blocks.dtype).to(torch.float32)
    return (blocks.to(torch.float32) * xr.unsqueeze(1)).sum(-1)


def _launch(entry: str, counter: str, blocks, xs, store_dtype):
    _cuda.require_hopper(blocks, xs)
    _cuda.require(blocks, "blocks", store_dtype, 3)
    _cuda.require(xs, "xs", torch.float32, 2)
    P, R, W = blocks.shape
    if tuple(xs.shape) != (P, W):
        raise ValueError(f"xs shape {tuple(xs.shape)} != ({P}, {W})")
    y = torch.empty((P, R), dtype=torch.float32, device=blocks.device)
    rc = getattr(_cuda.lib(), entry)(
        blocks.data_ptr(), xs.data_ptr(), y.data_ptr(), P, R, W,
        _cuda.stream_of(blocks))
    _cuda.check(rc, entry)
    timers.count("kernel." + counter)
    return y


def dense_block_mv(blocks: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """B3: blocks [P, R, W] f32 × xs [P, W] f32 → y [P, R] f32."""
    if blocks.device.type == "cpu":
        return dense_block_mv_plain(blocks, xs)
    return _launch("fedd_dense_gemv_f32", "dense_gemv_f32", blocks, xs,
                   torch.float32)


def dense_block_mv_lowp(blocks: torch.Tensor, xs: torch.Tensor
                        ) -> torch.Tensor:
    """B4: blocks [P, R, W] bf16 × xs [P, W] f32 → y [P, R] f32."""
    if blocks.device.type == "cpu":
        return dense_block_mv_lowp_plain(blocks, xs)
    return _launch("fedd_dense_gemv_bf16", "dense_gemv_bf16", blocks, xs,
                   torch.bfloat16)
