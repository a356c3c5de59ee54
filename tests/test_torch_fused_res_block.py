"""The port's residual block (plain version, and the wrapper on CPU tensors)
against the JAX Pallas kernel in interpret mode and the JAX XLA chain; the
fp32 kernel's 3xTF32 scheme (host weight split, operand layout, and a numpy
emulation of its arithmetic) against the plain fp32 block; the bf16 kernel's
weight layout and an emulation of its decomposition (tiles, halo window,
conv1 sliced over a cluster, tap GEMMs) against the plain block and the
Pallas kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_v3_tpu.models import darknet as JD
from yolo_v3_tpu.ops.pallas_kernels import fused_res_block as jax_fused_res_block
from yolo_v3_tpu_torch.ops.fused_res_block import (
    bf16_weights,
    fused_res_block,
    fused_res_block_ref,
    split_tf32,
    tf32_weights,
)


def _inputs(shape, cmid, seed=0):
    b, h, w, c = shape
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) * 0.5,
            rng.normal(size=(1, 1, c, cmid)).astype(np.float32) * 0.2,
            rng.normal(size=(cmid,)).astype(np.float32) * 0.1,
            rng.normal(size=(3, 3, cmid, c)).astype(np.float32) * 0.2,
            rng.normal(size=(c,)).astype(np.float32) * 0.1]


def _xla_chain(y, w1, b1, w2, b2):
    r = JD._conv_bias_leaky({"w": w1, "b": b1}, y)
    return y + JD._conv_bias_leaky({"w": w2, "b": b2}, r)


def _torch(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


@pytest.mark.parametrize("shape,cmid", [((2, 32, 16, 8), 4), ((1, 48, 24, 16), 8)])
def test_plain_matches_pallas_interpret(shape, cmid):
    arrs = _inputs(shape, cmid)
    want = jax_fused_res_block(*[jnp.asarray(a) for a in arrs], tile_h=16,
                               interpret=True)
    got = fused_res_block_ref(*_torch(arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_plain_matches_xla_chain_ragged_fp32():
    """H=13, W=11: not a multiple of any tile (the 416 stage-4 height)."""
    arrs = _inputs((2, 13, 11, 16), 8, seed=1)
    want = _xla_chain(*[jnp.asarray(a) for a in arrs])
    got = fused_res_block_ref(*_torch(arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_plain_matches_xla_chain_bf16():
    """bf16 storage, fp32 accumulation, the same two rounding points.  The
    tolerance is 2 bf16 ulps (2 * 2^-8 relative): a rounding-point flip of
    mid or of conv2's result between two fp32 summation orders."""
    arrs = _inputs((2, 13, 13, 32), 16, seed=2)
    want = _xla_chain(*[jnp.asarray(a, jnp.bfloat16) for a in arrs])
    got = fused_res_block_ref(*_torch(arrs, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1.6e-2, atol=1.6e-2)


def test_halo_is_zero_not_leaky_bias():
    """Out-of-image mid is 0, not leaky(b1): with a large b1 the edge rows
    and columns would differ (reference pallas_kernels.py:69-77)."""
    arrs = _inputs((1, 8, 8, 8), 4, seed=3)
    arrs[2] = np.full((4,), 3.0, np.float32)
    want = np.asarray(_xla_chain(*[jnp.asarray(a) for a in arrs]))
    got = fused_res_block_ref(*_torch(arrs)).numpy()
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_allclose(got[edge], want[edge], rtol=1e-4, atol=1e-5)


def test_wrapper_on_cpu_runs_plain_version():
    args = _torch(_inputs((1, 9, 7, 16), 8, seed=4))
    before = fused_res_block.launches
    got = fused_res_block(*args)
    assert fused_res_block.launches == before  # no kernel on the CPU
    torch.testing.assert_close(got, fused_res_block_ref(*args), rtol=0, atol=0)


def test_wrapper_rejects_bad_shapes():
    y, w1, b1, w2, b2 = _torch(_inputs((1, 8, 8, 16), 8))
    with pytest.raises(ValueError):
        fused_res_block(y, w1, b1, w2[:, :, :4], b2)
    with pytest.raises(ValueError):
        fused_res_block(y, w1, b1[:4], w2, b2)


# ---------------------------------------------------------------------------
# The fp32 kernel's 3xTF32 scheme
# ---------------------------------------------------------------------------

def _weights_to_split():
    rng = np.random.default_rng(5)
    w = rng.normal(size=4096).astype(np.float32) * np.float32(0.03)
    edge = np.array([0.0, -0.0, 1.0, -1.0, 3.0e-30, -7.5e20, 1.0 + 2.0 ** -11,
                     -(1.0 + 3 * 2.0 ** -11), 0.1, 1.0 / 3.0], np.float32)
    return torch.from_numpy(np.concatenate([w, edge]))


def test_split_tf32_parts_are_tf32():
    """hi and lo keep 10 mantissa bits: the low 13 of fp32's 23 are zero."""
    hi, lo = split_tf32(_weights_to_split())
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0


def test_split_tf32_recovers_fp32():
    """|hi + lo - w| <= 2^-22 |w|: the pair carries fp32's precision."""
    w = _weights_to_split()
    hi, lo = split_tf32(w)
    err = (hi.double() + lo.double() - w.double()).abs()
    assert bool((err <= 2.0 ** -22 * w.double().abs()).all()), err.max()


def test_split_tf32_rounds_to_nearest_ties_away():
    """cvt.rna: 1 + 2^-11 (a tie) rounds up to 1 + 2^-10, -(1 + 2^-11) down
    to -(1 + 2^-10); 1 + 2^-12 rounds to 1."""
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12])
    hi, lo = split_tf32(x)
    assert hi.tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]
    assert lo.tolist() == [-(2.0 ** -11), 2.0 ** -11, 2.0 ** -12]


def test_tf32_weights_layout_and_cache():
    """K-major, zero-padded (Cmid to 32, C to 32), hi/lo interleaved per
    group of 8 K as hi(q), lo(q), hi(q+4), lo(q+4); cached on w1 until a
    weight is written in place."""
    c, cmid = 40, 12
    rng = np.random.default_rng(6)
    w1 = torch.from_numpy(rng.normal(size=(c, cmid)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(size=(3, 3, cmid, c)).astype(np.float32))
    w1s, w2s = tf32_weights(w1, w2)
    assert tuple(w1s.shape) == (32, 2 * 64) and tuple(w2s.shape) == (c * 9, 2 * 32)

    def entry(ws, n, k):                      # (hi, lo) of K-major element [n, k]
        at = (k // 8) * 16 + (k % 4) * 4 + 2 * ((k % 8) // 4)
        return ws[n, at].item(), ws[n, at + 1].item()

    h, l = split_tf32(w1)
    for m, k in ((0, 0), (5, 7), (11, 39), (3, 12)):
        assert entry(w1s, m, k) == (h[k, m].item(), l[k, m].item())
    assert entry(w1s, 12, 3) == (0.0, 0.0) and entry(w1s, 2, 45) == (0.0, 0.0)
    h2, l2 = split_tf32(w2)
    for co, t, m in ((0, 0, 0), (39, 8, 11), (7, 4, 5)):
        assert entry(w2s, co * 9 + t, m) == (h2[t // 3, t % 3, m, co].item(),
                                             l2[t // 3, t % 3, m, co].item())
    assert entry(w2s, 5, 20) == (0.0, 0.0)
    assert tf32_weights(w1, w2)[0] is w1s     # cached
    w2.mul_(2.0)
    assert tf32_weights(w1, w2)[1] is not w2s  # rebuilt after an in-place write


def _mm_tf32(a, b, passes=3):
    """a @ b as the kernel takes it: both operands split by split_tf32, the
    three products lo*hi + hi*lo + hi*hi, each summed in fp32 (passes=1:
    hi*hi alone, a plain TF32 product)."""
    (ah, al), (bh, bl) = [[t.numpy() for t in split_tf32(torch.from_numpy(x))]
                          for x in (a, b)]
    return al @ bh + ah @ bl + ah @ bh if passes == 3 else ah @ bh


def test_3xtf32_emulation_holds_fp32_tolerance():
    """The scheme at a YOLO width, [1, 13, 13, 512] with Cmid 256 (conv2's
    K = 9 * 256 = 2304), against the plain fp32 block at the kernel's fp32
    tolerance, rtol = atol = 1e-4.  One TF32 product would not hold it."""
    b, h, w, c, cmid = 1, 13, 13, 512, 256
    rng = np.random.default_rng(7)
    y = rng.normal(size=(b, h, w, c)).astype(np.float32) * np.float32(0.5)
    w1 = (rng.normal(size=(c, cmid)) / np.sqrt(c)).astype(np.float32)
    b1 = (rng.normal(size=cmid) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(3, 3, cmid, c)) / np.sqrt(9 * cmid)).astype(np.float32)
    b2 = (rng.normal(size=c) * 0.1).astype(np.float32)

    def leaky(v):
        return np.where(v > 0, v, np.float32(0.1) * v)

    def block(passes):
        mid = leaky(_mm_tf32(y.reshape(-1, c), w1, passes) + b1).reshape(b, h, w, cmid)
        halo = np.pad(mid, ((0, 0), (1, 1), (1, 1), (0, 0)))   # out-of-image mid is 0
        cols = np.concatenate([halo[:, dy:dy + h, dx:dx + w] for dy in range(3)
                               for dx in range(3)], axis=-1).reshape(-1, 9 * cmid)
        r = leaky(_mm_tf32(cols, w2.reshape(9 * cmid, c), passes) + b2)
        return y + r.reshape(y.shape)

    want = fused_res_block_ref(*(torch.from_numpy(a) for a in (y, w1, b1, w2, b2)))
    np.testing.assert_allclose(block(3), want.numpy(), rtol=1e-4, atol=1e-4)
    one_pass = np.abs(block(1) - want.numpy())
    assert (one_pass > 1e-4 + 1e-4 * np.abs(want.numpy())).any()


# ---------------------------------------------------------------------------
# The bf16 kernel's decomposition
# ---------------------------------------------------------------------------

def test_bf16_weights_layout_and_cache():
    """K-major and zero-padded: w1k [Mpad, Cp] (Mpad = Cmid to 16, Cp = C to
    64), w2k [C, K2p] with column t * Mpad + m (K2p = 9 * Mpad to 64); HWIO
    comes back from both; cached on w1 until a weight is written in place."""
    c, cmid = 40, 12
    rng = np.random.default_rng(8)
    w1 = torch.from_numpy(rng.normal(size=(c, cmid)).astype(np.float32)).bfloat16()
    w2 = torch.from_numpy(rng.normal(size=(3, 3, cmid, c)).astype(np.float32)).bfloat16()
    w1k, w2k = bf16_weights(w1, w2)
    assert w1k.dtype == w2k.dtype == torch.bfloat16
    assert tuple(w1k.shape) == (16, 64) and tuple(w2k.shape) == (c, 192)
    assert torch.equal(w1k[:cmid, :c].t(), w1)
    taps = w2k[:, :9 * 16].reshape(c, 9, 16)
    assert torch.equal(taps[:, :, :cmid].permute(1, 2, 0).reshape(3, 3, cmid, c), w2)
    assert not w1k[cmid:].any() and not w1k[:, c:].any()
    assert not taps[:, :, cmid:].any() and not w2k[:, 9 * 16:].any()
    assert bf16_weights(w1, w2)[0] is w1k     # cached
    w1.mul_(2.0)
    assert bf16_weights(w1, w2)[0] is not w1k  # rebuilt after an in-place write


TH = TW = 8          # the kernel's output tile
HALO = TW + 2        # halo window width (10 x 10 pixels)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _leaky(v):
    return torch.where(v > 0, v, 0.1 * v)


def _emulate_bf16_kernel(y, w1, b1, w2, b2, cs):
    """The bf16 kernel's decomposition on the CPU, in fp32 with its rounding
    points.  Per 8x8 output tile: the 10x10 halo window of y; conv1 sliced
    over a cluster of ``cs`` blocks (rank j computes mid channels
    [j*MS, (j+1)*MS) from the K-major w1k), mid 0 outside the image and in
    padded channels, rounded to bf16; conv2 as 9 tap GEMMs whose A rows are
    the halo rows shifted by the tap, against w2k's tap-major K; conv2's
    result rounded to bf16, then added to y and rounded again."""
    b, h, w, c = y.shape
    cmid = w1.shape[-1]
    w1k, w2k = (t.float() for t in bf16_weights(w1, w2))
    mpad = w1k.shape[0]
    ms = -(-mpad // 16 // cs) * 16
    yf, b1f, b2f = y.float(), b1.float(), b2.float()
    b1p = torch.zeros(mpad)
    b1p[:cmid] = b1f
    out = torch.empty_like(yf)
    p = torch.arange(HALO * HALO)
    pix = torch.arange(TH * TW)
    hrow = (pix // TW) * HALO + pix % TW
    for bi in range(b):
        for ty0 in range(0, h, TH):
            for tx0 in range(0, w, TW):
                gy, gx = ty0 - 1 + p // HALO, tx0 - 1 + p % HALO
                inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
                yh = torch.zeros(HALO * HALO, w1k.shape[1])
                yh[inside, :c] = yf[bi, gy[inside], gx[inside]]
                mid = torch.zeros(HALO * HALO, mpad)
                for rank in range(cs):
                    lo = rank * ms
                    hi = min(lo + ms, mpad)
                    if hi <= lo:
                        continue
                    v = _leaky(yh @ w1k[lo:hi].t() + b1p[lo:hi])
                    keep = inside[:, None] & (torch.arange(lo, hi) < cmid)[None]
                    mid[:, lo:hi] = _bf16(torch.where(keep, v, torch.zeros(())))
                cols = torch.cat([mid[hrow + (t // 3) * HALO + t % 3] for t in range(9)], 1)
                r = _bf16(_leaky(cols @ w2k[:, :9 * mpad].t() + b2f))
                oy, ox = ty0 + pix // TW, tx0 + pix % TW
                ok = (oy < h) & (ox < w)
                out[bi, oy[ok], ox[ok]] = _bf16(yf[bi, oy[ok], ox[ok]] + r[ok])
    return out


_PALLAS_BF16 = {}


def _pallas_bf16(shape, cmid, arrs):
    """The JAX Pallas kernel on bf16 inputs, interpret mode, one tile of the
    whole height (computed once per shape)."""
    if (shape, cmid) not in _PALLAS_BF16:
        got = jax_fused_res_block(*[jnp.asarray(a, jnp.bfloat16) for a in arrs],
                                  tile_h=shape[1], interpret=True)
        _PALLAS_BF16[(shape, cmid)] = np.asarray(got.astype(jnp.float32))
    return _PALLAS_BF16[(shape, cmid)]


@pytest.mark.parametrize("cs", [1, 2, 4])
@pytest.mark.parametrize("shape,cmid", [((2, 13, 13, 128), 64),   # ragged tiles
                                        ((1, 19, 21, 80), 40)])   # Cmid padded to 48
def test_bf16_kernel_emulation_holds_bf16_tolerance(shape, cmid, cs):
    """The decomposition against the plain block and the Pallas kernel at
    the bf16 tolerance (2 bf16 ulps: a rounding-point flip of mid or of
    conv2's result between two fp32 summation orders)."""
    b, h, w, c = shape
    rng = np.random.default_rng(9)
    arrs = [rng.normal(size=shape) * 0.5, rng.normal(size=(c, cmid)) / np.sqrt(c),
            rng.normal(size=cmid) * 0.1, rng.normal(size=(3, 3, cmid, c)) / np.sqrt(9 * cmid),
            rng.normal(size=c) * 0.1]
    arrs = [np.asarray(a, np.float32) for a in arrs]
    args = _torch(arrs, torch.bfloat16)
    got = _emulate_bf16_kernel(*args, cs=cs)
    want = fused_res_block_ref(*args).float()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1.6e-2, atol=1.6e-2)
    np.testing.assert_allclose(got.numpy(), _pallas_bf16(shape, cmid, arrs),
                               rtol=1.6e-2, atol=1.6e-2)


@pytest.mark.parametrize("layout", [tf32_weights, bf16_weights], ids=["tf32", "bf16"])
@pytest.mark.parametrize("inference", [False, True], ids=["normal", "inference"])
def test_weight_layouts_follow_in_place_writes(layout, inference):
    """A cached kernel layout is never stale: after ``w1.mul_(2)`` and
    ``w2.mul_(2)`` under ``torch.inference_mode()`` the next call returns the
    layout of the new weights, also for inference tensors, which have no
    version counter."""
    dtype = torch.float32 if layout is tf32_weights else torch.bfloat16
    _, w1, _, w2, _ = _inputs((1, 4, 4, 16), 8)
    with torch.inference_mode(inference):
        w1 = torch.from_numpy(w1.reshape(16, 8)).to(dtype)
        w2 = torch.from_numpy(w2).to(dtype)
    first = [t.clone() for t in layout(w1, w2)]
    with torch.inference_mode():
        w1.mul_(2)
        w2.mul_(2)
    with torch.inference_mode(inference):
        want = layout(w1.clone(), w2.clone())           # fresh tensors: no cache
    for got, old, new in zip(layout(w1, w2), first, want):
        assert not torch.equal(got, old)
        torch.testing.assert_close(got, new, rtol=0, atol=0)
