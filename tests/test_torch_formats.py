"""The SpMV formats of the PyTorch port (feddlib_tpu_torch.la.dia, the block
part of la.sell) against the JAX package on the same matrices: identical
layout planes and plans (they are built by the same host code), applies
within 1e-12 (f64) / 1e-5 (f32) relative of the scipy product — the sums run
in another order, so they are not bit-equal — and the plain version of the
block-SELL kernel within 1e-6 (f32) / 1e-14 (f64) of the JAX package's XLA
reference of its TPU kernel.  The port applies block-SELL through a sliced
layout of its own (`SlicePlan`), checked entry by entry against the planes
and applied within 1e-12 (f64) / 1e-5 (f32) of the JAX package's apply.
Inputs come from numpy seeds and structured meshes only."""

import inspect

import numpy as np
import pytest
import scipy.sparse as sps
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402
from feddlib_tpu.fe import host_assembly as jha  # noqa: E402
from feddlib_tpu.fe import ops as jops  # noqa: E402
from feddlib_tpu.fe.domain import Domain as JDomain  # noqa: E402
from feddlib_tpu.la import dia as jdia  # noqa: E402
from feddlib_tpu.la import sell as jsell  # noqa: E402

from feddlib_tpu_torch.la import dia as tdia  # noqa: E402
from feddlib_tpu_torch.la import sell as tsell  # noqa: E402
from feddlib_tpu_torch.utils import convert  # noqa: E402

JDT = {"f64": jnp.float64, "f32": jnp.float32}
TDT = {"f64": torch.float64, "f32": torch.float32}
NDT = {"f64": np.float64, "f32": np.float32}
APPLY_TOL = {"f64": 1e-12, "f32": 1e-5}


def _np(a):
    return None if a is None else np.array(a, copy=True)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _same(a, b):
    """Identical arrays (None matches None); index dtypes may differ."""
    if a is None or b is None:
        return a is None and b is None
    a, b = _np(a), (b.numpy() if isinstance(b, torch.Tensor) else _np(b))
    return a.shape == b.shape and np.array_equal(a, b)


def _x(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


def _apply(fmt, x, prec):
    """fmt.matvec on a numpy vector in the format's dtype → numpy."""
    if isinstance(fmt.dtype, torch.dtype):
        return fmt.matvec(torch.as_tensor(x.astype(NDT[prec]))).numpy()
    return np.asarray(fmt.matvec(jnp.asarray(x.astype(NDT[prec]))))


# -- inputs ------------------------------------------------------------------

_cache = {}


def _matrix(kind):
    """scipy CSR (f64, sorted) and its dofs per node."""
    if kind not in _cache:
        if kind == "laplace3d":
            K, _ = jha.host_poisson_dirichlet(JDomain.structured(3, 7))
            d = 1
        elif kind == "elas_p1_3d":
            K, d = jha.host_lin_elasticity_p1(JDomain.structured(3, 7),
                                              1.0, 1.5), 3
        elif kind.startswith("elas_p2_"):  # elas_p2_<dim>_<n>
            dim, n = int(kind[8]), int(kind[10:])
            dom = JDomain.structured(dim, n).p2_domain()
            K, d = jops.assemble_lin_elasticity(dom, 1.0, 1.5).to_scipy(), dim
        elif kind == "random":
            K = (sps.random(400, 400, 0.03, random_state=3, format="csr")
                 + sps.identity(400))
            d = 1
        else:
            raise KeyError(kind)
        K = sps.csr_matrix(K, dtype=np.float64, copy=True)
        K.sort_indices()
        _cache[kind] = (K, d)
    return _cache[kind]


# -- (b) DIA and block-DIA ---------------------------------------------------

def _same_dia(fj, ft):
    assert tuple(fj.offsets) == tuple(ft.offsets)
    assert fj.shape == ft.shape and fj.nnz == ft.nnz
    assert _same(fj.vals, ft.vals) and _same(fj.data_slots, ft.data_slots)
    for name in ("spill_rows", "spill_cols", "spill_vals", "spill_sel"):
        assert _same(getattr(fj, name), getattr(ft, name)), name
    assert fj.hbm_bytes_per_apply() == ft.hbm_bytes_per_apply()


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_dia_matches(prec):
    K, _ = _matrix("laplace3d")
    kw = dict(max_bytes_per_nnz=16.0 if prec == "f64" else 8.0)
    fj = jdia.DiaMatrix.from_csr(K, dtype=JDT[prec], **kw)
    ft = tdia.DiaMatrix.from_csr(K, dtype=TDT[prec], device="cpu", **kw)
    assert fj is not None and ft is not None and ft.spill_rows is None
    _same_dia(fj, ft)
    x = _x(K.shape[0])
    assert _rel(_apply(ft, x, prec), K @ x) < APPLY_TOL[prec]
    assert _rel(_apply(ft, x, prec), _apply(fj, x, prec)) < APPLY_TOL[prec]
    fn, ops = ft.operator()
    assert torch.equal(fn(ops, torch.as_tensor(x.astype(NDT[prec]))),
                       ft.matvec(torch.as_tensor(x.astype(NDT[prec]))))
    new = np.random.default_rng(1).random(K.nnz)
    K2 = sps.csr_matrix((new, K.indices, K.indptr), shape=K.shape)
    f2 = ft.with_data(torch.as_tensor(new))
    assert _same(fj.with_data(jnp.asarray(new)).vals, f2.vals)
    assert _rel(_apply(f2, x, prec), K2 @ x) < APPLY_TOL[prec]


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_block_dia_matches(prec):
    K, d = _matrix("elas_p1_3d")
    kw = dict(max_bytes_per_nnz=16.0 if prec == "f64" else 8.0)
    fj = jdia.BlockDiaMatrix.from_csr(K, d, dtype=JDT[prec], **kw)
    ft = tdia.BlockDiaMatrix.from_csr(K, d, dtype=TDT[prec], device="cpu",
                                      **kw)
    assert fj is not None and ft is not None
    _same_dia(fj, ft)
    x = _x(K.shape[0])
    assert _rel(_apply(ft, x, prec), K @ x) < APPLY_TOL[prec]
    assert _rel(_apply(ft, x, prec), _apply(fj, x, prec)) < APPLY_TOL[prec]
    xt = torch.as_tensor(x.astype(NDT[prec]))
    fn, ops = ft.planar_operator()
    yp = ft.from_planar(fn(ops, ft.to_planar(xt)))
    assert _rel(yp.numpy(), K @ x) < APPLY_TOL[prec]
    f2 = ft.with_data(torch.as_tensor(K.data * 3.0))
    assert _rel(_apply(f2, x, prec), 3.0 * (K @ x)) < APPLY_TOL[prec]


def test_dia_forced_spill_is_exact():
    # banded matrix + a few far off-band entries -> spill path
    n = 300
    rng = np.random.RandomState(2)
    main = sps.diags([rng.rand(n - 1), 2 + rng.rand(n), rng.rand(n - 1)],
                     [-1, 0, 1], format="csr")
    far = sps.csr_matrix(
        (rng.rand(5), (np.arange(5), np.arange(5) * 37 + 100)), (n, n))
    sp = (main + far).tocsr()
    fj = jdia.DiaMatrix.from_csr(sp, dtype=jnp.float64, coverage=0.9,
                                 max_offsets=3)
    ft = tdia.DiaMatrix.from_csr(sp, dtype=torch.float64, coverage=0.9,
                                 max_offsets=3, device="cpu")
    assert ft.spill_rows is not None and ft.spill_rows.numel() == 5
    _same_dia(fj, ft)
    x = _x(n)
    assert _rel(_apply(ft, x, "f64"), sp @ x) < 1e-12
    f2 = ft.with_data(torch.as_tensor(sp.data * 2.0))
    assert _rel(_apply(f2, x, "f64"), 2.0 * (sp @ x)) < 1e-12


def test_block_dia_forced_spill_is_exact():
    K, d = _matrix("elas_p1_3d")
    kw = dict(max_offsets=9, coverage=0.5, max_bytes_per_nnz=1e9)
    fj = jdia.BlockDiaMatrix.from_csr(K, d, dtype=jnp.float64, **kw)
    ft = tdia.BlockDiaMatrix.from_csr(K, d, dtype=torch.float64,
                                      device="cpu", **kw)
    assert ft.spill_rows is not None and len(ft.offsets) == 9
    _same_dia(fj, ft)
    x = _x(K.shape[0])
    assert _rel(_apply(ft, x, "f64"), K @ x) < 1e-12
    f2 = ft.with_data(torch.as_tensor(K.data * 2.0))
    assert _rel(_apply(f2, x, "f64"), 2.0 * (K @ x)) < 1e-12


# -- (c) block-SELL ----------------------------------------------------------

def _sliced_bytes(bt):
    """What one apply of the port's block-SELL moves: the sliced layout,
    x and y, the spill (the JAX package's count is of its planes)."""
    pl, isz = bt.plan, bt.hvals.element_size()
    b = (bt.hvals.numel() * isz + pl.hcols.numel() * 4
         + pl.slice_ptr.numel() * 8 + pl.row_of.numel() * 4
         + 2 * bt.shape[0] * isz)
    if bt.spill_rows is not None:
        b += bt.spill_rows.numel() * (8 + 2 * isz)
    return b


def _same_block_sell(bj, bt):
    assert bj.layout.E == bt.layout.E and bj.layout.K == bt.layout.K
    assert bt.vals.shape[1:] == (bt.d * bt.d, 8, 128)
    assert _same(bj.vals, bt.vals)
    assert _same(bj.layout.pidx, bt.layout.pidx)
    assert _same(bj.layout.bids, bt.layout.bids)
    assert bt.layout.pidx.dtype == torch.int16
    assert bt.layout.bids.dtype == torch.int32
    assert _same(bj.dof_slots, bt.dof_slots)
    for name in ("spill_rows", "spill_cols", "spill_vals", "spill_sel"):
        assert _same(getattr(bj, name), getattr(bt, name)), name
    assert bt.hbm_bytes_per_apply() == _sliced_bytes(bt)


def _x2d(x, nn, d, prec):
    """Interleaved x → the planar padded [d*nx2, 128] array of the kernel."""
    nx2 = max((nn + 127) // 128, 1)
    xpad = np.zeros((d, nx2 * 128), NDT[prec])
    xpad[:, :nn] = x.reshape(nn, d).T
    return xpad.reshape(d * nx2, 128), nx2


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("kind", ["elas_p2_3_3", "elas_p2_3_4",
                                  "elas_p2_2_6"])
def test_block_sell_matches(kind, prec):
    K, d = _matrix(kind)
    bj = jsell.BlockSellMatrix.from_csr(K, d, dtype=JDT[prec])
    bt = tsell.BlockSellMatrix.from_csr(K, d, dtype=TDT[prec], device="cpu")
    assert bj is not None and bt is not None and bt.spill_rows is None
    _same_block_sell(bj, bt)
    nn, E = K.shape[0] // d, bt.layout.E
    x = _x(K.shape[0])
    # the plain version against the XLA reference of the TPU kernel
    x2d, nx2 = _x2d(x, nn, d, prec)
    yj = np.asarray(jsell._block_sell_mv_xla(
        bj.vals, bj.layout.pidx, bj.layout.bids, jnp.asarray(x2d), E, d,
        nx2))
    yt = tsell.block_sell_spmv_plain(bt.vals, bt.layout.pidx, bt.layout.bids,
                                     torch.as_tensor(x2d), E, d)
    assert yt.shape == yj.shape
    assert _rel(yt.numpy(), yj) < (1e-14 if prec == "f64" else 1e-6)
    # the sliced layout gives the same product; its wrapper takes the plain
    # version for a CPU tensor
    pl = bt.plan
    xc = torch.as_tensor(x2d.reshape(d, -1))
    ys = tsell.block_sell_slices_plain(bt.hvals, pl.hcols, pl.slice_ptr,
                                       pl.row_of, xc, nn)
    assert _rel(ys.numpy(), yt[:, :nn].numpy()) < APPLY_TOL[prec]
    assert torch.equal(tsell.block_sell_slices(
        bt.hvals, pl.hcols, pl.slice_ptr, pl.row_of, xc, nn), ys)
    # applies
    assert _rel(_apply(bt, x, prec), K @ x) < APPLY_TOL[prec]
    assert _rel(_apply(bt, x, prec), _apply(bj, x, prec)) < APPLY_TOL[prec]
    xt = torch.as_tensor(x.astype(NDT[prec]))
    fn, ops = bt.planar_operator()
    yp = bt.from_planar(fn(ops, bt.to_planar(xt)))
    assert _rel(yp.numpy(), K @ x) < APPLY_TOL[prec]
    b2 = bt.with_data(torch.as_tensor(K.data * 3.0))
    assert _same(bj.with_data(jnp.asarray(K.data * 3.0)).vals, b2.vals)
    assert _rel(_apply(b2, x, prec), 3.0 * (K @ x)) < APPLY_TOL[prec]


@pytest.mark.parametrize("kind,Kwin", [("elas_p2_3_3", 2), ("elas_p2_2_6", 1)])
def test_block_sell_forced_spill(kind, Kwin):
    K, d = _matrix(kind)
    bj = jsell.BlockSellMatrix.from_csr(K, d, dtype=jnp.float64, K=Kwin)
    bt = tsell.BlockSellMatrix.from_csr(K, d, dtype=torch.float64, K=Kwin,
                                        device="cpu")
    assert bt.spill_rows is not None and bt.spill_rows.numel() > 0
    _same_block_sell(bj, bt)
    x = _x(K.shape[0])
    assert _rel(_apply(bt, x, "f64"), K @ x) < 1e-12
    b2 = bt.with_data(torch.as_tensor(K.data * 2.0))
    assert _rel(_apply(b2, x, "f64"), 2.0 * (K @ x)) < 1e-12


def test_block_sell_refuses_non_blocked_patterns():
    """A pattern that is not d x d node-blocked must be refused rather than
    padded to 9x storage."""
    rng = np.random.RandomState(5)
    sp = sps.random(120, 120, density=0.05, format="csr", random_state=rng)
    assert jsell.BlockSellMatrix.from_csr(sp, 3) is None
    assert tsell.BlockSellMatrix.from_csr(sp, 3, device="cpu") is None
    assert tsell.BlockSellMatrix.from_csr(sp, 1, device="cpu") is None
    assert tsell.BlockSellMatrix.from_csr(sp[:, :60], 3, device="cpu") is None


# -- the sliced layout the card applies (SlicePlan, kernel B5) ---------------

def _check_slices(bt, max_ratio=None):
    """Every occupied slot of the planes appears once, with its value and
    node column; row_of is a permutation, sorted by occupied length within
    each window; padding entries hold column 0 and value 0."""
    pl, lay, d = bt.plan, bt.layout, bt.d
    n, E, C = lay.shape[0], lay.E, tsell.SLICE_ROWS
    src = pl.src.numpy()
    occ = lay.data_slots[lay.data_slots >= 0]
    assert src.shape == (pl.hcols.shape[0], C)
    assert np.array_equal(np.sort(src[src >= 0]), np.sort(occ))
    row_of = pl.row_of.numpy()
    assert pl.row_of.dtype == torch.int32 and pl.hcols.dtype == torch.int32
    assert np.array_equal(np.sort(row_of), np.arange(n))
    lens = np.bincount(occ // E, minlength=n)[row_of]
    # slice s holds sorted rows s*C ..: rows of one window, longest first;
    # it is as wide as its longest row, and the slices go widest first
    widths = np.diff(pl.slice_ptr.numpy())
    assert len(widths) == -(-n // C)
    slen = np.zeros(len(widths) * C, np.int64)
    slen[:n] = lens
    assert np.array_equal(widths, slen.reshape(-1, C).max(1))
    win = np.full(len(widths) * C, -1)
    win[:n] = row_of // tsell.SORT_WINDOW
    for sl_len, sl_win in zip(slen.reshape(-1, C), win.reshape(-1, C)):
        assert (np.diff(sl_len) <= 0).all()
        assert len(set(sl_win[sl_win >= 0])) == 1
    assert (np.diff(widths[: n // C]) <= 0).all()
    slice_of = np.repeat(np.arange(len(widths)), widths)
    j = np.arange(len(src)) - pl.slice_ptr.numpy()[slice_of]
    i = slice_of[:, None] * C + np.arange(C)
    rows = np.full(len(widths) * C, -1)
    rows[:n] = row_of
    live = src >= 0
    assert np.array_equal(live, j[:, None] < slen[i])
    assert np.array_equal(src[live], (rows[i] * E + j[:, None])[live])
    # values and columns are those of the source slot; padding is zero
    hv = bt.hvals.numpy().transpose(0, 2, 1)            # [t, C, d*d]
    planes = bt.vals.numpy().reshape(bt.vals.shape[0], d * d, -1)
    f = src[live]
    assert np.array_equal(hv[live], planes[f // 1024, :, f % 1024])
    assert not hv[~live].any() and not pl.hcols.numpy()[~live].any()
    p = lay.pidx.numpy().reshape(-1)[f].astype(np.int64)
    cols = (lay.bids.numpy()[f // 1024, p >> 7].astype(np.int64) * 128
            + (p & 127))
    assert np.array_equal(pl.hcols.numpy()[live], cols)
    if max_ratio is not None:
        assert pl.slots_per_occupied <= max_ratio


@pytest.mark.parametrize("kind,build", [
    ("elas_p2_3_3", "from_csr"), ("elas_p2_2_6", "from_csr"),
    ("elas_p2_3_8", "from_csr"), ("elas_p2_3_4", "carried"),
    ("elas_p2_2_6", "carried_spill")])
def test_block_sell_hopper_plan(kind, build):
    """The sliced layout of BlockSellMatrix, built from CSR and carried
    from JAX; at >= 4,096 node rows it stores <= 1.25 slots per occupied
    slot (the E-padded planes store 3x)."""
    K, d = _matrix(kind)
    if build == "from_csr":
        bt = tsell.BlockSellMatrix.from_csr(K, d, dtype=torch.float32,
                                            device="cpu")
    else:
        bj = jsell.BlockSellMatrix.from_csr(
            K, d, dtype=jnp.float32, K=1 if build == "carried_spill" else None)
        bt = _carry_block_sell(bj, "f32")
        assert (bt.spill_rows is not None) == (build == "carried_spill")
        x = _x(K.shape[0])
        assert _rel(_apply(bt, x, "f32"), _apply(bj, x, "f32")) < 1e-5
    big = bt.layout.shape[0] >= 4096
    assert big == (kind == "elas_p2_3_8")
    _check_slices(bt, 1.25 if big else None)
    assert tsell.slice_plan(bt.layout) is bt.plan


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("kind,Kwin", [
    ("elas_p2_3_3", None), ("elas_p2_3_4", None), ("elas_p2_2_6", None),
    ("elas_p2_3_3", 2), ("elas_p2_2_6", 1)])
def test_block_sell_slices_plain_matches_jax(kind, Kwin, prec):
    """block_sell_slices_plain plus the spill against the JAX package's
    _block_sell_apply (its XLA reference of the TPU kernel on the CPU)."""
    K, d = _matrix(kind)
    bj = jsell.BlockSellMatrix.from_csr(K, d, dtype=JDT[prec], K=Kwin)
    bt = tsell.BlockSellMatrix.from_csr(K, d, dtype=TDT[prec], K=Kwin,
                                        device="cpu")
    assert (bt.spill_rows is not None) == (Kwin is not None)
    nn = K.shape[0] // d
    xc = np.ascontiguousarray(_x(K.shape[0], 5).astype(NDT[prec])
                              .reshape(nn, d).T)
    yj = np.asarray(jsell._block_sell_apply(
        bj.vals, bj.layout.pidx, bj.layout.bids, bj.spill_rows,
        bj.spill_cols, bj.spill_vals, jnp.asarray(xc), nn, d, bj.layout.E))
    pl, xt = bt.plan, torch.as_tensor(xc)
    y = tsell.block_sell_slices_plain(bt.hvals, pl.hcols, pl.slice_ptr,
                                      pl.row_of, xt, nn)
    if bt.spill_rows is not None:
        y = y.reshape(-1).index_add(
            0, bt.spill_rows, bt.spill_vals * xt.reshape(-1)[bt.spill_cols])
    assert _rel(y.reshape(d, nn).numpy(), yj) < (1e-12 if prec == "f64"
                                                 else 1e-5)
    fn, ops = bt.planar_operator()
    assert _rel(fn(ops, xt).numpy(), yj) < (1e-12 if prec == "f64" else 1e-5)


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("kind,Kwin", [("elas_p2_3_4", None),
                                       ("elas_p2_3_3", 2)])
def test_block_sell_with_data_through_sliced_layout(kind, Kwin, prec):
    """with_data(3 * data) keeps the plan and gathers the new planes."""
    K, d = _matrix(kind)
    bt = tsell.BlockSellMatrix.from_csr(K, d, dtype=TDT[prec], K=Kwin,
                                        device="cpu")
    b3 = bt.with_data(torch.as_tensor(K.data * 3.0))
    assert b3.plan is bt.plan
    assert torch.equal(b3.hvals, bt.plan.gather(b3.vals))
    assert _rel(b3.hvals.numpy(), 3.0 * bt.hvals.numpy()) < (
        1e-15 if prec == "f64" else 1e-7)
    x = _x(K.shape[0], 6)
    assert _rel(_apply(b3, x, prec), 3.0 * (K @ x)) < APPLY_TOL[prec]


# -- SELL additions: RCM order and rectangular matrices ----------------------

def test_sell_rcm_order_matches():
    K, _ = _matrix("random")
    sj = jsell.SellMatrix.from_csr(K, dtype=jnp.float64, order="rcm")
    st = tsell.SellMatrix.from_csr(K, dtype=torch.float64, order="rcm",
                                   device="cpu")
    assert _same(sj.perm, st.perm) and _same(sj.iperm, st.iperm)
    assert _same(sj.csr_order, st.csr_order)
    assert _same(sj.vals, st.vals) and _same(sj.pidx, st.pidx)
    assert _same(sj.bids, st.bids)
    assert sj.hbm_bytes_per_apply() == st.hbm_bytes_per_apply()
    x = _x(K.shape[0])
    assert _rel(_apply(st, x, "f64"), K @ x) < 1e-12
    s2 = st.with_data(torch.as_tensor(K.data * 2.0))
    assert _rel(_apply(s2, x, "f64"), 2.0 * (K @ x)) < 1e-12
    with pytest.raises(ValueError):
        tsell.SellMatrix.from_csr(K[:, :100], order="rcm", device="cpu")


def test_sell_rectangular_matches():
    K = sps.random(130, 333, 0.05, random_state=7, format="csr")
    sj = jsell.SellMatrix.from_csr(K, dtype=jnp.float64)
    st = tsell.SellMatrix.from_csr(K, dtype=torch.float64, device="cpu")
    assert _same(sj.vals, st.vals) and _same(sj.pidx, st.pidx)
    assert _same(sj.bids, st.bids)
    x = _x(333)
    assert _rel(_apply(st, x, "f64"), K @ x) < 1e-12


# -- (d) SplitDiaMatrix and auto_spmv ----------------------------------------

AUTO_CASES = {
    # kind -> (class for f32, class for f64): the f64 planes of the banded
    # formats exceed the 8 B/nnz guard of auto_spmv, so f64 goes on to the
    # RCM split
    "laplace3d": ("DiaMatrix", "SplitDiaMatrix"),
    "elas_p1_3d": ("BlockDiaMatrix", "SplitDiaMatrix"),
    "elas_p2_3_3": ("SplitDiaMatrix", "SplitDiaMatrix"),
    "random": ("SellMatrix", "SellMatrix"),
}


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("kind", list(AUTO_CASES))
def test_auto_spmv_dispatch_matches(kind, prec):
    K, d = _matrix(kind)
    fj = jdia.auto_spmv(K, dtype=JDT[prec], dofs_per_node=d)
    ft = tdia.auto_spmv(K, dtype=TDT[prec], dofs_per_node=d, device="cpu")
    assert type(ft).__name__ == type(fj).__name__
    assert type(ft).__name__ == AUTO_CASES[kind][prec == "f64"]
    # the same bytes, but a block-SELL residue's are those of the port's
    # sliced layout
    bytes_j = fj.hbm_bytes_per_apply()
    if isinstance(getattr(ft, "sell", None), tsell.BlockSellMatrix):
        bytes_j += _sliced_bytes(ft.sell) - fj.sell.hbm_bytes_per_apply()
    assert bytes_j == ft.hbm_bytes_per_apply()
    x = _x(K.shape[0])
    assert _rel(_apply(ft, x, prec), K @ x) < APPLY_TOL[prec]
    assert _rel(_apply(ft, x, prec), _apply(fj, x, prec)) < APPLY_TOL[prec]
    fn, ops = ft.operator()
    xt = torch.as_tensor(x.astype(NDT[prec]))
    assert torch.equal(fn(ops, xt), ft.matvec(xt))
    f2 = ft.with_data(torch.as_tensor(K.data * 2.0))
    assert _rel(_apply(f2, x, prec), 2.0 * (K @ x)) < APPLY_TOL[prec]
    if isinstance(ft, tdia.SplitDiaMatrix):
        assert np.array_equal(fj.node_perm, ft.node_perm)
        assert fj.dia_share == ft.dia_share and 0.25 <= ft.dia_share < 1.0
        assert np.array_equal(fj.sel_dia, ft.sel_dia)
        assert np.array_equal(fj.sel_res, ft.sel_res)
        assert tuple(fj.dia.offsets) == tuple(ft.dia.offsets)
        assert _same(fj.dia.vals, ft.dia.vals)
        assert type(ft.sell).__name__ == type(fj.sell).__name__
        if d > 1:
            assert isinstance(ft.sell, tsell.BlockSellMatrix)
            _same_block_sell(fj.sell, ft.sell)
        # the permuted (planar) operator between the two gathers
        pf, pops = ft.permuted_operator()
        y = ft.from_permuted(pf(pops, ft.to_permuted(xt)))
        assert _rel(y.numpy(), K @ x) < APPLY_TOL[prec]


def test_split_residue_falls_back_to_planar_scalar_sell():
    """A vector operator whose residue is not node-blocked (here: full 3x3
    blocks on a node band plus single entries beside it) keeps its
    block-DIA part and sends the residue through a planar-indexed scalar
    SELL (kernel B2, not B5), as the JAX package does."""
    rng = np.random.default_rng(11)
    nn, d = 400, 3
    n = nn * d
    band = sps.diags([np.ones(nn - 1), 2 * np.ones(nn), np.ones(nn - 1)],
                     [-1, 0, 1])
    blocks = sps.kron(band, rng.random((d, d)) + 1).tocsr()
    i = rng.integers(0, nn - 6, 60)
    j = i + rng.integers(2, 6, 60)
    far = sps.csr_matrix((rng.random(60), (i * d, j * d)), (n, n))
    A = (blocks + far + far.T).tocsr()
    A.sort_indices()
    fj = jdia.SplitDiaMatrix.from_csr(A, dtype=jnp.float64, dofs_per_node=d)
    ft = tdia.SplitDiaMatrix.from_csr(A, dtype=torch.float64,
                                      dofs_per_node=d, device="cpu")
    assert isinstance(fj.sell, jsell.SellMatrix)
    assert isinstance(ft.sell, tsell.SellMatrix)
    assert np.array_equal(fj.sel_res, ft.sel_res)
    x = _x(n)
    assert _rel(_apply(ft, x, "f64"), A @ x) < 1e-12
    f2 = ft.with_data(torch.as_tensor(A.data * 2.0))
    assert _rel(_apply(f2, x, "f64"), 2.0 * (A @ x)) < 1e-12


# -- the converters: build once in JAX, apply in both ------------------------

def _carry_sell(sj, prec):
    return convert.sell_from_numpy(
        sj.shape, _np(sj.vals), _np(sj.pidx), _np(sj.bids), sj.E, sj.K,
        sj.nnz, sj.data_slots, sj.data_spill, _np(sj.spill_rows),
        _np(sj.spill_cols), _np(sj.spill_vals), _np(sj.perm), _np(sj.iperm),
        sj.csr_order, dtype=TDT[prec], device="cpu")


def _carry_block_sell(bj, prec):
    return convert.block_sell_from_numpy(
        bj.shape[0], bj.d, _carry_sell(bj.layout, "f32"), _np(bj.vals),
        _np(bj.dof_slots), bj.nnz, _np(bj.spill_rows), _np(bj.spill_cols),
        _np(bj.spill_vals), _np(bj.spill_sel), dtype=TDT[prec])


def _carry_dia(fj, prec):
    if isinstance(fj, jdia.BlockDiaMatrix):
        return convert.block_dia_from_numpy(
            fj.shape[0], fj.d, fj.offsets, _np(fj.vals), _np(fj.data_slots),
            fj.nnz, _np(fj.spill_rows), _np(fj.spill_cols),
            _np(fj.spill_vals), _np(fj.spill_sel), dtype=TDT[prec],
            device="cpu")
    return convert.dia_from_numpy(
        fj.shape, fj.offsets, _np(fj.vals), _np(fj.data_slots), fj.nnz,
        _np(fj.spill_rows), _np(fj.spill_cols), _np(fj.spill_vals),
        _np(fj.spill_sel), dtype=TDT[prec], device="cpu")


def _carry(fj, prec):
    if isinstance(fj, jdia.SplitDiaMatrix):
        sell = fj.sell
        if isinstance(sell, jsell.BlockSellMatrix):
            sell = _carry_block_sell(sell, prec)
        elif sell is not None:
            sell = _carry_sell(sell, prec)
        return convert.split_dia_from_numpy(
            _carry_dia(fj.dia, prec), sell, fj.d, fj.node_perm, fj.sel_dia,
            fj.sel_res, fj.nnz, dtype=TDT[prec])
    if isinstance(fj, jsell.BlockSellMatrix):
        return _carry_block_sell(fj, prec)
    if isinstance(fj, jsell.SellMatrix):
        return _carry_sell(fj, prec)
    return _carry_dia(fj, prec)


@pytest.mark.parametrize("kind,build", [
    ("laplace3d", "auto"), ("elas_p1_3d", "auto"), ("elas_p2_3_3", "auto"),
    ("elas_p2_2_6", "block_sell_spill"), ("random", "sell_rcm"),
    ("laplace3d", "split")])
def test_format_carried_over_applies_alike(kind, build):
    """A format built once by the JAX package and carried over as numpy
    arrays applies in the port as it does there, and takes new values."""
    K, d = _matrix(kind)
    prec = "f32"
    if build == "auto":
        fj = jdia.auto_spmv(K, dtype=jnp.float32, dofs_per_node=d)
    elif build == "split":
        fj = jdia.SplitDiaMatrix.from_csr(K, dtype=jnp.float32)
    elif build == "sell_rcm":
        fj = jsell.SellMatrix.from_csr(K, dtype=jnp.float32, order="rcm")
    else:
        fj = jsell.BlockSellMatrix.from_csr(K, d, dtype=jnp.float32, K=1)
        assert fj.spill_rows is not None
    ft = _carry(fj, prec)
    assert type(ft).__name__ == type(fj).__name__
    x = _x(K.shape[0])
    assert _rel(_apply(ft, x, prec), _apply(fj, x, prec)) < 1e-6
    assert _rel(_apply(ft, x, prec), K @ x) < 1e-5
    f2 = ft.with_data(torch.as_tensor(K.data * 2.0))
    assert _rel(_apply(f2, x, prec), 2.0 * (K @ x)) < 1e-5


def test_format_entry_points_default_to_cuda():
    for fn in (tdia.auto_spmv, tdia.DiaMatrix.from_csr,
               tdia.BlockDiaMatrix.from_csr, tdia.SplitDiaMatrix.from_csr,
               tsell.BlockSellMatrix.from_csr, tsell.SellMatrix.from_csr,
               convert.sell_from_numpy, convert.dia_from_numpy,
               convert.block_dia_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        K, d = _matrix("random")
        with pytest.raises(RuntimeError, match="cuda"):
            tdia.auto_spmv(K)
