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
