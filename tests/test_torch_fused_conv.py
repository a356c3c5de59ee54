"""The port's padded-2D int8 convolutions (``yolo_v3_tpu_torch/ops/fused_conv.py``)
against the JAX Pallas kernels run in interpret mode, on the shapes and cases
of ``tests/test_fused_conv.py``.  On the CPU the port's wrappers run their
plain versions; the CUDA kernels are held to those on the card
(``tests/test_torch_cuda_kernels.py``).

Tolerances are the JAX suite's: int8 output bit-equal (int32 accumulation is
exact and both epilogues round at the same points); bf16 output rtol/atol
1e-2 (1x1) and 2e-2 (3x3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_v3_tpu.models import quantized as JQ
from yolo_v3_tpu.ops import fused_conv as JF
from yolo_v3_tpu_torch.ops import fused_conv as TF

_JDT = {torch.int8: jnp.int8, torch.bfloat16: jnp.bfloat16}


def _rand_int8(rng, shape):
    return rng.integers(-20, 20, shape, dtype=np.int8)


def _np(x):
    return np.asarray(x.float() if x.dtype == torch.bfloat16 else x)


def _inputs(rng, b, h, w, c, n, taps):
    x = _rand_int8(rng, (b, h, w, c))
    wt = _rand_int8(rng, (c, n) if taps == 1 else (3, 3, c, n))
    scale = rng.uniform(0.001, 0.01, n).astype(np.float32)
    bias = (rng.normal(size=n) * 0.1).astype(np.float32)
    return x, wt, scale, bias


def _both(taps, x, wt, scale, bias, hp, wp, tile, **kw):
    """(port, JAX) outputs of the same conv on the same packed input."""
    jfn, tfn = ((JF.conv1x1_p2d, TF.conv1x1_p2d) if taps == 1
                else (JF.conv3x3_p2d, TF.conv3x3_p2d))
    x2d = JF.pack_p2d(jnp.asarray(x))
    jkw = dict(kw, out_dtype=_JDT[kw.get("out_dtype", torch.int8)])
    if "residual" in kw:
        jkw["residual"] = jnp.asarray(kw["residual"])
        kw = dict(kw, residual=torch.from_numpy(kw["residual"]))
    want = jfn(x2d, jnp.asarray(wt), jnp.asarray(scale), jnp.asarray(bias), hp, wp,
               tile_m=JF.pick_tile_m(x2d.shape[0], tile), tile_n=wt.shape[-1],
               interpret=True, **jkw)
    got = tfn(torch.from_numpy(np.array(x2d)), torch.from_numpy(wt),
              torch.from_numpy(scale), torch.from_numpy(bias), hp, wp, **kw)
    return got, np.asarray(want, np.float32)


def test_pack_unpack_match_jax(rng):
    x = rng.standard_normal((2, 5, 7, 3), dtype=np.float32)
    x2d = TF.pack_p2d(torch.from_numpy(x))
    np.testing.assert_array_equal(x2d.numpy(), np.asarray(JF.pack_p2d(jnp.asarray(x))))
    np.testing.assert_array_equal(TF.unpack_p2d(x2d, 2, 5, 7).numpy(), x)
    assert TF.p2d_geometry(2, 5, 7) == JF.p2d_geometry(2, 5, 7)


@pytest.mark.parametrize("out_dtype", [torch.int8, torch.bfloat16], ids=["i8", "bf16"])
def test_conv1x1_matches_jax(rng, out_dtype):
    b, h, w, c, n = 2, 6, 6, 16, 24
    x, wt, scale, bias = _inputs(rng, b, h, w, c, n, 1)
    _, hp, wp = TF.p2d_geometry(b, h, w)
    got, want = _both(1, x, wt, scale, bias, hp, wp, 64, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    if out_dtype == torch.int8:
        np.testing.assert_array_equal(_np(got), want)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=1e-2, atol=1e-2)


def test_conv1x1_borders_stay_zero(rng):
    b, h, w, c, n = 1, 4, 4, 8, 8
    x, wt, _, _ = _inputs(rng, b, h, w, c, n, 1)
    scale, bias = np.full(n, 0.01, np.float32), np.full(n, 5.0, np.float32)
    _, hp, wp = TF.p2d_geometry(b, h, w)
    got, want = _both(1, x, wt, scale, bias, hp, wp, 64)
    got = _np(got).reshape(hp, wp, n)
    assert (got[0] == 0).all() and (got[-1] == 0).all()
    assert (got[:, 0] == 0).all() and (got[:, -1] == 0).all()
    assert (got[1:-1, 1:-1] != 0).any()
    np.testing.assert_array_equal(got.reshape(-1, n), want)


@pytest.mark.parametrize("out_dtype", [torch.int8, torch.bfloat16], ids=["i8", "bf16"])
def test_conv3x3_matches_jax(rng, out_dtype):
    b, h, w, c, n = 2, 8, 10, 16, 24
    x, wt, scale, bias = _inputs(rng, b, h, w, c, n, 9)
    _, hp, wp = TF.p2d_geometry(b, h, w)
    got, want = _both(9, x, wt, scale, bias, hp, wp, 80, out_dtype=out_dtype)
    if out_dtype == torch.int8:
        np.testing.assert_array_equal(_np(got), want)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=2e-2, atol=2e-2)


def test_conv3x3_tap_geometry_identity_kernel(rng):
    """Only tap (0, 0) nonzero: the image shifts down-right by one pixel."""
    b, h, w, c = 1, 6, 6, 4
    x = _rand_int8(rng, (b, h, w, c))
    wt = np.zeros((3, 3, c, c), np.int8)
    wt[0, 0] = np.eye(c, dtype=np.int8)
    _, hp, wp = TF.p2d_geometry(b, h, w)
    ones, zeros = np.ones(c, np.float32), np.zeros(c, np.float32)
    got, want = _both(9, x, wt, ones, zeros, hp, wp, 48, leaky=False)
    shifted = np.zeros_like(x)
    shifted[:, 1:, 1:] = x[:, :-1, :-1]
    np.testing.assert_array_equal(TF.unpack_p2d(got, b, h, w).numpy(), shifted)
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("taps", [1, 9], ids=["1x1", "3x3"])
def test_ragged_rows_with_residual_match_jax(rng, taps):
    """R = 63 rows, which no 8- or 32-row tile divides, with the residual
    fused: the 3x3's taps reach past both ends of the array."""
    b, h, w, c, n = 1, 5, 7, 16, 8
    x, wt, scale, bias = _inputs(rng, b, h, w, c, n, taps)
    r, hp, wp = TF.p2d_geometry(b, h, w)
    assert r == 63
    res = rng.integers(-127, 128, (r, n), dtype=np.int8)
    got, want = _both(taps, x, wt, scale, bias, hp, wp, 64, residual=res,
                      res_scale=0.7)
    np.testing.assert_array_equal(_np(got), want)


def test_res_block_matches_jax(rng):
    b, h, w, c = 2, 8, 8, 16
    cm = c // 2
    x = _rand_int8(rng, (b, h, w, c))
    w1, w2 = _rand_int8(rng, (c, cm)), _rand_int8(rng, (3, 3, cm, c))
    s1 = rng.uniform(0.01, 0.05, cm).astype(np.float32)
    b1 = rng.normal(size=cm).astype(np.float32)
    s2 = rng.uniform(0.001, 0.01, c).astype(np.float32)
    b2 = (rng.normal(size=c) * 0.1).astype(np.float32)
    r, hp, wp = TF.p2d_geometry(b, h, w)
    x2d = JF.pack_p2d(jnp.asarray(x))
    want = JF.res_block_p2d(x2d, *map(jnp.asarray, (w1, s1, b1, w2, s2, b2)), hp, wp,
                            res_scale=0.7, tile_m=JF.pick_tile_m(r, 80), interpret=True)
    t = torch.from_numpy
    got = TF.res_block_p2d(t(np.array(x2d)), t(w1), t(s1), t(b1), t(w2), t(s2), t(b2),
                           hp, wp, res_scale=0.7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("stride,padding,residual", [
    (2, None, False),                  # the stride-2 downs of stages 2-4
    (1, ((1, 0), (1, 0)), False),      # down1's 2x2 window
    (1, None, True),                   # res0_2's residual
    (2, ((1, 1), (1, 1)), False),      # down0's explicit padding
])
def test_conv_i8_nhwc_matches_jax(rng, stride, padding, residual):
    k = 2 if padding == ((1, 0), (1, 0)) else 3
    x = _rand_int8(rng, (2, 10, 12, 16))
    wt = _rand_int8(rng, (k, k, 16, 24))
    qp = {"w": wt, "m": rng.uniform(0.001, 0.01, 24).astype(np.float32),
          "b": (rng.normal(size=24) * 0.1).astype(np.float32)}
    ho, wo = (10 // stride, 12 // stride)
    res = rng.integers(-127, 128, (2, ho, wo, 24), dtype=np.int8) if residual else None
    want = JQ._conv_i8({k_: jnp.asarray(v) for k_, v in qp.items()}, jnp.asarray(x),
                       stride=stride, padding=padding,
                       residual=None if res is None else jnp.asarray(res), res_scale=0.6)
    t = torch.from_numpy
    got = TF.conv_i8_nhwc(t(x), t(wt), t(qp["m"]), t(qp["b"]), stride=stride,
                          padding=padding, residual=None if res is None else t(res),
                          res_scale=0.6)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int_mm_is_exact(rng):
    a = rng.integers(-128, 128, (37, 50), dtype=np.int8)
    b = rng.integers(-128, 128, (50, 13), dtype=np.int8)
    got = TF.int_mm(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))


def test_cpu_wrappers_do_not_count_launches(rng):
    x, wt, scale, bias = _inputs(rng, 1, 4, 4, 8, 8, 1)
    before = (TF.conv1x1_p2d.launches, TF.conv3x3_p2d.launches)
    t = torch.from_numpy
    TF.conv1x1_p2d(TF.pack_p2d(t(x)), t(wt), t(scale), t(bias), 6, 6)
    assert (TF.conv1x1_p2d.launches, TF.conv3x3_p2d.launches) == before


# ---------------------------------------------------------------------------
# bf16 input (float32 accumulation).  The JAX suite holds this mode at rtol =
# atol = 2e-2 (tests/test_fused_conv.py:115).  Here the scale is 1, as the
# float model's heads use it, and the weights are scaled by 1/sqrt(K), so
# that outputs are of order 1 and the tolerance is not met by small values.
# ---------------------------------------------------------------------------

def _bf16_inputs(rng, b, h, w, c, n, taps):
    """(x2d, w, scale, bias) as bf16-valued float32 numpy arrays (x2d packed
    by the JAX package) and float32 scale and bias."""
    def bf(a):
        return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))

    x2d = bf(JF.pack_p2d(jnp.asarray(rng.standard_normal((b, h, w, c), np.float32))))
    shape = (c, n) if taps == 1 else (3, 3, c, n)
    wt = bf(rng.standard_normal(shape, np.float32) / np.sqrt(taps * c))
    bias = (rng.normal(size=n) * 0.1).astype(np.float32)
    return x2d, wt, np.ones(n, np.float32), bias


def _both_bf16(taps, x2d, wt, scale, bias, hp, wp, tile, residual=None, **kw):
    """(port, JAX) bf16 outputs, both as float32 numpy, of one conv."""
    jfn, tfn = ((JF.conv1x1_p2d, TF.conv1x1_p2d) if taps == 1
                else (JF.conv3x3_p2d, TF.conv3x3_p2d))
    j16 = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731 (exact: bf16 values)
    t16 = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    want = jfn(j16(x2d), j16(wt), jnp.asarray(scale), jnp.asarray(bias), hp, wp,
               out_dtype=jnp.bfloat16,
               residual=None if residual is None else j16(residual),
               tile_m=JF.pick_tile_m(x2d.shape[0], tile), tile_n=wt.shape[-1],
               interpret=True, **kw)
    got = tfn(t16(x2d), t16(wt), torch.from_numpy(scale), torch.from_numpy(bias), hp, wp,
              out_dtype=torch.bfloat16,
              residual=None if residual is None else t16(residual), **kw)
    assert got.dtype == torch.bfloat16
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("taps", [1, 9], ids=["1x1", "3x3"])
@pytest.mark.parametrize("b,h,w,c,n,residual,leaky", [
    (2, 6, 6, 16, 24, False, True),
    (2, 8, 10, 32, 24, True, True),
    (1, 5, 7, 16, 21, True, True),     # R = 63 (ragged), N % 8 != 0, residual
    (1, 5, 7, 24, 21, False, False),   # a detection conv: no leaky
])
def test_bf16_conv_matches_jax(rng, taps, b, h, w, c, n, residual, leaky):
    """bf16-input conv1x1_p2d / conv3x3_p2d against the Pallas kernels in
    interpret mode at rtol = atol = 2e-2.  Measured max abs error over these
    cases 3.0e-8, on outputs up to 5.8 (0 in 7 of the 8: on the CPU both
    accumulate the bf16 products in float32 and round once)."""
    x2d, wt, scale, bias = _bf16_inputs(rng, b, h, w, c, n, taps)
    r, hp, wp = TF.p2d_geometry(b, h, w)
    res = None
    if residual:
        res = np.array(jnp.asarray(rng.standard_normal((r, n), np.float32),
                                   jnp.bfloat16).astype(jnp.float32))
    got, want = _both_bf16(taps, x2d, wt, scale, bias, hp, wp, 64, residual=res,
                           leaky=leaky)
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    full = got.reshape(b, hp, wp, n)
    assert (full[:, 0] == 0).all() and (full[:, :, -1] == 0).all()


def test_bf16_res_block_matches_jax(rng):
    """bf16 res_block_p2d (the two bf16 kernels, the residual fused into the
    3x3's epilogue) against the Pallas composition in interpret mode at rtol
    = atol = 2e-2.  Measured max abs error 2.4e-7, on outputs up to 4.4."""
    b, h, w, c = 2, 8, 8, 32
    cm = c // 2
    x2d, w1, s1, b1 = _bf16_inputs(rng, b, h, w, c, cm, 1)
    _, w2, s2, b2 = _bf16_inputs(rng, b, h, w, cm, c, 9)
    r, hp, wp = TF.p2d_geometry(b, h, w)
    j16 = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    t16 = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731
    t = torch.from_numpy
    want = JF.res_block_p2d(j16(x2d), j16(w1), jnp.asarray(s1), jnp.asarray(b1),
                            j16(w2), jnp.asarray(s2), jnp.asarray(b2), hp, wp,
                            out_dtype=jnp.bfloat16, tile_m=JF.pick_tile_m(r, 80),
                            interpret=True)
    got = TF.res_block_p2d(t16(x2d), t16(w1), t(s1), t(b1), t16(w2), t(s2), t(b2),
                           hp, wp, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("inference", [False, True], ids=["normal", "inference"])
def test_k_major_follows_in_place_writes(inference):
    """The K-major copy is never stale: after ``w.mul_(2)`` under
    ``torch.inference_mode()`` the next call returns the new layout, also
    for an inference tensor, which has no version counter."""
    with torch.inference_mode(inference):
        w = torch.arange(-6, 6, dtype=torch.int8).reshape(3, 4)
    first = TF.k_major(w, w).clone()
    np.testing.assert_array_equal(first.numpy(), w.t().numpy())
    with torch.inference_mode():
        w.mul_(2)
    np.testing.assert_array_equal(TF.k_major(w, w).numpy(), 2 * first.numpy())


# ---------------------------------------------------------------------------
# The kernel's decomposition (csrc/conv_p2d.cu, conv_p2d_kernel), in both
# input types: the planner's tile shape, a persistent grid of blocks walking
# tiles, and per tile a sum over ring slots of one 128-byte row of channels
# (64 bf16, 128 int8), each of TMA boxes: BM rows of x2d (the 3x3: BM + 2
# rows at kernel row dy's offset, which its three taps read shifted by 0, 1,
# 2 rows), zero outside [0, R) and past C; and per tap BN rows of the
# K-major weight seen as [N][taps][C], zero past N and C.  int8 channels
# that do not make 16-byte rows are first zero-padded to 16 (pad_channels).
# Emulated with the kernel's accumulator (float32 for bf16; int8 exactly,
# in float64).  The bf16 mode is held here to the plain version and to the
# Pallas kernels in interpret mode at the JAX suite's rtol = atol = 2e-2;
# the int8 mode, bit-equal, in tests/test_torch_conv_p2d_int8.py.
# ---------------------------------------------------------------------------

# every (taps, H = W, C, N, leaky) of the bf16 forward's heads and up convs at
# YOLOv3-416 (chip_smoke.py's BF16_CONVS)
BF16_HEAD_SHAPES = [
    (1, 13, 1024, 512, True), (9, 13, 512, 1024, True), (1, 13, 1024, 255, False),
    (1, 13, 512, 256, True),
    (1, 26, 768, 256, True), (1, 26, 512, 256, True), (9, 26, 256, 512, True),
    (1, 26, 512, 255, False), (1, 26, 256, 128, True),
    (1, 52, 384, 128, True), (1, 52, 256, 128, True), (9, 52, 128, 256, True),
    (1, 52, 256, 255, False),
]


def _tile_schedule(r, n, variant, sms=132):
    """Per block of the persistent grid, the (m0, n0) of the tiles it
    computes, in order: block b takes tiles b, b + grid, ...; tile t is rows
    (t % m_tiles) * BM and channels (t // m_tiles) * BN."""
    wgs, bn, bps = TF.P2D_TILES[variant]
    bm = 64 * wgs
    m_tiles = -(-r // bm)
    tiles = m_tiles * -(-n // bn)
    grid = min(tiles, sms * bps)
    return [[((t % m_tiles) * bm, (t // m_tiles) * bn) for t in range(b, tiles, grid)]
            for b in range(grid)]


def _kernel_acc(x2d, w, wp, taps, variant):
    """The kernel's accumulator [R, N]: its sum slot by slot in its type
    (int32 for int8, exact; float32 for bf16), over the TMA boxes of every
    tile (all tiles at once, one product a slot: which block of the
    persistent grid runs a tile does not change its sum)."""
    r, c = x2d.shape
    wt = TF.k_major(w, TF._w2d(w, c, taps))           # [N, taps * C]
    n = wt.shape[0]
    x2d, wt = TF.pad_channels(x2d, wt, taps)
    c = x2d.shape[1]
    int8 = x2d.dtype == torch.int8
    acc_dtype = torch.float64 if int8 else torch.float32
    wgs, bn, _ = TF.P2D_TILES[variant]
    bm, kslot, tps = 64 * wgs, TF.K_SLOT[x2d.dtype], TF.taps_per_slot(taps)
    kpt, m_tiles, n_tiles = -(-c // kslot), -(-r // bm), -(-n // bn)
    # TMA's zero fill: x2d rows outside [0, R) and channels past C; weight
    # rows past N and channels past C
    lo = wp + 1
    xz = torch.zeros(lo + m_tiles * bm + wp + 2, kpt * kslot, dtype=acc_dtype)
    xz[lo:lo + r, :c] = x2d.to(acc_dtype)
    wz = torch.zeros(n_tiles * bn, taps, kpt * kslot, dtype=acc_dtype)
    wz[:n, :, :c] = wt.view(n, taps, c).to(acc_dtype)
    m0 = torch.arange(m_tiles) * bm
    acc = torch.zeros(m_tiles, bm, n_tiles * bn, dtype=acc_dtype)
    for s in range(taps // tps * kpt):
        dy, k0 = s // kpt, (s % kpt) * kslot
        # each tile's A box: BM + tps - 1 rows from the tile's first row at
        # kernel row dy (the 3x3: one pixel left of the tap (dy, 1)); tap j
        # reads it from its row j, against the tap's B box
        a0 = m0 + ((dy - 1) * wp - 1 if taps == 9 else 0)
        box = xz[lo + a0[:, None] + torch.arange(bm + tps - 1), k0:k0 + kslot]
        a = torch.cat([box[:, j:j + bm] for j in range(tps)], dim=2)
        b = wz[:, dy * tps:(dy + 1) * tps, k0:k0 + kslot].reshape(-1, tps * kslot)
        acc += a @ b.t()
    acc = acc.reshape(m_tiles * bm, n_tiles * bn)[:r, :n]
    if int8:
        assert acc.abs().max() < 2 ** 31
        acc = acc.to(torch.int32)                     # exact: integers below 2^53
    return acc


def _emulate_kernel(x2d, w, scale, bias, hp, wp, taps, variant, **epilogue):
    """The kernel's output: its accumulator through the plain epilogue."""
    valid = TF.border_mask(x2d.shape[0], hp, wp, x2d.device)[:, None]
    return TF.epilogue_ref(_kernel_acc(x2d, w, wp, taps, variant), scale, bias, valid=valid,
                           **epilogue)


def _check_bf16_emulation(rng, b, h, w, c, n, taps, variant, residual, leaky):
    x2d, wt, scale, bias = _bf16_inputs(rng, b, h, w, c, n, taps)
    r, hp, wp = TF.p2d_geometry(b, h, w)
    res = None
    if residual:
        res = np.array(jnp.asarray(rng.standard_normal((r, n), np.float32),
                                   jnp.bfloat16).astype(jnp.float32))
    kw = dict(leaky=leaky, residual=None if res is None else torch.from_numpy(res).bfloat16(),
              res_scale=0.7 if residual else 1.0)
    t16 = lambda a: torch.from_numpy(a).bfloat16()  # noqa: E731 (exact: bf16 values)
    with torch.inference_mode(False):
        got = _emulate_kernel(t16(x2d), t16(wt), torch.from_numpy(scale),
                              torch.from_numpy(bias), hp, wp, taps, variant,
                              out_dtype=torch.bfloat16, **kw)
    ref = (TF.conv3x3_p2d_ref if taps == 9 else TF.conv1x1_p2d_ref)(
        t16(x2d), t16(wt), torch.from_numpy(scale), torch.from_numpy(bias), hp, wp,
        out_dtype=torch.bfloat16, **kw)
    np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(), rtol=2e-2, atol=2e-2)
    _, want = _both_bf16(taps, x2d, wt, scale, bias, hp, wp, 256, residual=res, leaky=leaky,
                         **({"res_scale": 0.7} if residual else {}))
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("taps,hw,c,n,leaky", BF16_HEAD_SHAPES,
                         ids=[f"{'3x3' if t == 9 else '1x1'}-{h}-{c}-{n}"
                              for t, h, c, n, _ in BF16_HEAD_SHAPES])
def test_bf16_kernel_emulation_at_head_shapes(rng, taps, hw, c, n, leaky):
    """Every head and up conv of the bf16 forward at batch 1, with the tile
    shape the planner picks for that geometry."""
    r, _, _ = TF.p2d_geometry(1, hw, hw)
    _check_bf16_emulation(rng, 1, hw, hw, c, n, taps,
                          TF.plan_tiles(r, c, n, taps, torch.bfloat16),
                          residual=False, leaky=leaky)


@pytest.mark.parametrize("variant", range(len(TF.P2D_TILES)))
@pytest.mark.parametrize("b,h,w,c,n,taps,residual", [
    (3, 11, 9, 40, 36, 9, True),    # C % 64 != 0 (zero channel tail), N = 36 (72-byte rows)
    (2, 8, 8, 72, 255, 9, True),    # C = 72 (a second, mostly empty K slot), N = 255
    (4, 1, 1, 16, 24, 9, False),    # hp = wp = 3: 9 rows an image, taps reach rows -4 .. 39
    (1, 5, 7, 72, 36, 1, True),
])
def test_bf16_kernel_emulation_edges(rng, variant, b, h, w, c, n, taps, residual):
    """The channel tail, the N edge and taps outside [0, R), with every
    tile shape of P2D_TILES."""
    _check_bf16_emulation(rng, b, h, w, c, n, taps, variant, residual=residual, leaky=True)


def _check_planner_coverage(shapes, dtype, batch):
    for taps, hw, c, n in shapes:
        r, _, _ = TF.p2d_geometry(batch, hw, hw)
        v = TF.plan_tiles(r, c, n, taps, dtype)
        wgs, bn, bps = TF.P2D_TILES[v]
        cover = np.zeros((r + 64 * wgs, n + bn), np.int32)
        schedule = _tile_schedule(r, n, v)
        assert len(schedule) <= 132 * bps
        for block in schedule:
            for m0, n0 in block:
                cover[m0:m0 + 64 * wgs, n0:n0 + bn] += 1
        assert (cover[:r, :n] == 1).all(), (taps, hw, c, n)
        assert TF.ring_slots(v, taps) >= 2
        assert TF.smem_bytes(v, taps) <= TF.SMEM_PER_BLOCK
        assert bps * (TF.smem_bytes(v, taps) + 1024) <= TF.SMEM_PER_SM


@pytest.mark.parametrize("batch", [1, 8])
def test_bf16_planner_covers_output_and_fits_shared_memory(batch):
    """For every head and up shape: the persistent grid's tiles cover [R, N]
    exactly once, the grid stays within the blocks the card holds at once,
    and the ring (at least two slots) and staging fit the shared memory
    (227 KB a block, 228 KB an SM for all its blocks)."""
    _check_planner_coverage([s[:4] for s in BF16_HEAD_SHAPES], torch.bfloat16, batch)


def test_bf16_planner_picks_the_cheapest_tiles():
    """plan_tiles is the argmin of tiles_cost.  At batch 8 it takes the
    large tile (128 x 128, one block an SM) where its grid fills the card
    (the 13^2 3x3: 120 tiles; the 26^2 1x1s to N = 256) and the small one
    (64 x 64, two blocks an SM) where a large tile would leave SMs idle (the
    13^2 1x1s: 30 to 60 tiles) or short a second wave (the 52^2 N = 128
    1x1s: 183 tiles)."""
    bf16 = torch.bfloat16
    for taps, hw, c, n, _ in BF16_HEAD_SHAPES:
        r, _, _ = TF.p2d_geometry(8, hw, hw)
        costs = [TF.tiles_cost(v, r, c, n, taps, 132, bf16) for v in range(len(TF.P2D_TILES))]
        assert TF.plan_tiles(r, c, n, taps, bf16) == costs.index(min(costs))
    big, small = 0, 1
    assert TF.P2D_TILES[big][:2] == (2, 128) and TF.P2D_TILES[small][:2] == (1, 64)
    for (taps, hw, c, n), want in (((9, 13, 512, 1024), big), ((1, 26, 512, 256), big),
                                   ((1, 13, 1024, 512), small), ((1, 52, 256, 128), small)):
        assert TF.plan_tiles(TF.p2d_geometry(8, hw, hw)[0], c, n, taps, bf16) == want
