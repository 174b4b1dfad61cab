"""The CUDA kernels of feddlib_tpu_torch against their plain PyTorch
versions on the card (marker `gpu`; skipped without a Hopper card).  This
file imports neither jax nor the JAX package, so it runs on a machine with
PyTorch alone:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: B1 bit-exact (a gather); B2 1e-6 and B3/B4 1e-5 relative to
max|y| (f32 sums in another order)."""

import numpy as np
import pytest
import torch

from feddlib_tpu_torch.fe.domain import Domain
from feddlib_tpu_torch.fe.host_assembly import host_poisson_dirichlet
from feddlib_tpu_torch.la import _cuda
from feddlib_tpu_torch.la import dense_kernels as dk
from feddlib_tpu_torch.la import sell
from feddlib_tpu_torch.la.permute import permute_gather, permute_gather_plain


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0)[0] != 9:
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("n_in,n_out", [(5000, 3000), (128, 1), (1, 0)])
def test_b1_permute_on_card(hopper, n_in, n_out):
    rng = np.random.default_rng(n_in)
    idx = rng.integers(-1, n_in, n_out).astype(np.int32)
    x = torch.randn(n_in, device=hopper)
    it = torch.as_tensor(idx, device=hopper)
    before = _cuda.launch_counts["permute_gather"]
    y = permute_gather(x, it)
    assert _cuda.launch_counts["permute_gather"] == before + 1
    assert torch.equal(y, permute_gather_plain(x, it))


@pytest.mark.gpu
@pytest.mark.parametrize("n,K", [(7, None), (12, 3)])
def test_b2_sell_on_card(hopper, n, K):
    K_sp, _ = host_poisson_dirichlet(Domain.structured(3, n, device="cpu"))
    A = sell.SellMatrix.from_csr(K_sp, dtype=torch.float32, K=K,
                                 device=hopper)
    nx2 = (K_sp.shape[1] + 127) // 128
    x2d = torch.randn(nx2, 128, device=hopper)
    y = sell.sell_spmv(A.vals, A.pidx, A.bids, x2d, A.E)
    y0 = sell.sell_spmv_plain(A.vals, A.pidx, A.bids, x2d, A.E)
    assert _rel(y, y0) < 1e-6
    x = torch.randn(K_sp.shape[1], device=hopper)
    ref = torch.as_tensor(K_sp @ x.cpu().double().numpy(), device=hopper)
    assert _rel(A.matvec(x).double(), ref) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("P,R,W", [(8, 48, 136), (3, 40, 1001), (2, 9, 31)])
def test_b3_b4_gemv_on_card(hopper, P, R, W):
    g = torch.Generator(device=hopper).manual_seed(P + R + W)
    b = torch.randn(P, R, W, generator=g, device=hopper)
    x = torch.randn(P, W, generator=g, device=hopper)
    assert _rel(dk.dense_block_mv(b, x), dk.dense_block_mv_plain(b, x)) < 1e-5
    bb = b.to(torch.bfloat16)
    assert _rel(dk.dense_block_mv_lowp(bb, x),
                dk.dense_block_mv_lowp_plain(bb, x)) < 1e-5
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_wrappers_reject_bad_inputs(hopper):
    x = torch.randn(10, device=hopper)
    with pytest.raises(TypeError):
        permute_gather(x.double(), torch.zeros(3, dtype=torch.int32,
                                               device=hopper))
    with pytest.raises(ValueError):
        dk.dense_block_mv(torch.randn(2, 3, 4, device=hopper),
                          torch.randn(2, 5, device=hopper))


@pytest.mark.gpu
@pytest.mark.parametrize("symmetric", [True, False])
def test_dense_block_schwarz_device_factor_on_card(hopper, symmetric):
    """The card's f32 factorization (Cholesky for symmetric matrices, else
    the batched LU solve, as Problem.solve's row-masked matrices take)
    matches the host f64 LU; 1e-3 relative covers the f32 factor and its
    1e-6 diagonal guard."""
    from feddlib_tpu_torch.la.csr import CsrMatrix
    from feddlib_tpu_torch.la.dense_blocks import (DenseBlockSchwarz,
                                                   DenseBlockSpMV,
                                                   _blocks_symmetric)
    from feddlib_tpu_torch.mesh.partition import partition_points

    dom = Domain.structured(3, 8, device="cpu")
    K, _ = host_poisson_dirichlet(dom)
    if not symmetric:
        K = K.tolil()
        K[0, 1] = -0.25
        K = K.tocsr()
    cl = partition_points(dom.mesh.points, 8)
    out = {}
    for dev in ("cpu", hopper):
        A = CsrMatrix.from_scipy(K, device=dev)
        assert _blocks_symmetric(A) == symmetric
        db = DenseBlockSpMV.from_csr(A, cl, dtype=torch.float32)
        out[str(dev)] = DenseBlockSchwarz(A, db).inv.cpu()
    assert _rel(out[str(hopper)], out["cpu"]) < 1e-3
