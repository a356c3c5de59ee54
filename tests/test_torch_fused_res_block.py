"""The port's residual block (plain version, and the wrapper on CPU tensors)
against the JAX Pallas kernel in interpret mode and the JAX XLA chain; the
fp32 kernel's 3xTF32 scheme (host weight split, hi / lo planes, a numpy
emulation of its arithmetic with and without the tensor cores' truncating
partial sums) and its decomposition (8x8 and flat tiles, conv1 sliced over
a cluster, chunk-major tap GEMMs) against the plain fp32 block; the bf16
kernel's weight layout and an emulation of its decomposition (tiles, halo
window, conv1 sliced over a cluster, tap GEMMs) against the plain block and
the Pallas kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_v3_tpu.models import darknet as JD
from yolo_v3_tpu.ops.pallas_kernels import fused_res_block as jax_fused_res_block
from yolo_v3_tpu_torch.ops.fused_res_block import (
    F32_KPART,
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
    """Two planes, hi and lo, each K-major and zero-padded (Cmid to 32, C to
    32): w1p [2, Mpad, Cp] holds w1[k, m] at [., m, k]; w2p [2, C, 9 * Mpad]
    holds w2[t // 3, t % 3, m, co] at [., co, (m // 32 * 9 + t) * 32 + m %
    32] (K chunk-major, as conv2 steps through it).  Each plane is TF32 and
    hi + lo recovers fp32 within 2^-22; cached on w1 until a weight is
    written in place."""
    c, cmid = 40, 44
    rng = np.random.default_rng(6)
    w1 = torch.from_numpy(rng.normal(size=(c, cmid)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(size=(3, 3, cmid, c)).astype(np.float32))
    w1p, w2p = tf32_weights(w1, w2)
    assert tuple(w1p.shape) == (2, 64, 64) and tuple(w2p.shape) == (2, c, 9 * 64)
    for plane in (w1p, w2p):
        assert plane.is_contiguous()
        assert int((plane.view(torch.int32) & 0x1FFF).abs().max()) == 0   # TF32
    h, l = split_tf32(w1)
    for m, k in ((0, 0), (5, 7), (43, 39), (3, 12), (33, 1)):
        assert (w1p[0, m, k].item(), w1p[1, m, k].item()) == (h[k, m].item(), l[k, m].item())
    assert not w1p[:, cmid:].any() and not w1p[:, :, c:].any()

    def col(t, m):
        return (m // 32 * 9 + t) * 32 + m % 32

    h2, l2 = split_tf32(w2)
    for co, t, m in ((0, 0, 0), (39, 8, 43), (7, 4, 5), (12, 2, 32), (1, 6, 31)):
        assert (w2p[0, co, col(t, m)].item(), w2p[1, co, col(t, m)].item()) == (
            h2[t // 3, t % 3, m, co].item(), l2[t // 3, t % 3, m, co].item())
    taps = torch.stack([w2p[:, :, [col(t, m) for m in range(64)]] for t in range(9)], 2)
    assert not taps[:, :, :, cmid:].any()                      # padded mid channels
    for w, (hi, lo) in ((w1, w1p[:, :cmid, :c].transpose(1, 2)),
                        (w2, taps[:, :, :, :cmid].permute(0, 2, 3, 1).reshape(2, 3, 3, cmid, c))):
        err = (hi.double() + lo.double() - w.double()).abs()
        assert bool((err <= 2.0 ** -22 * w.double().abs()).all()), err.max()
    assert tf32_weights(w1, w2)[0] is w1p     # cached
    w2.mul_(2.0)
    assert tf32_weights(w1, w2)[1] is not w2p  # rebuilt after an in-place write


def _rz32(x):
    """float64 -> float32 rounded toward zero: the tensor cores' fp32
    accumulation, which truncates."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _mm_tf32(a, b, passes=3, k_part=None):
    """a @ b as the kernel takes it: both operands split by split_tf32, the
    three products lo*hi + hi*lo + hi*hi, each summed in fp32 (passes=1:
    hi*hi alone, a plain TF32 product).  With ``k_part``, the kernel's
    accumulation: each k8 product added into a partial sum of k_part K
    rounded toward zero (the tensor cores' accumulator, fresh at every
    partial), the partials added in fp32 to nearest."""
    (ah, al), (bh, bl) = [[t.numpy() for t in split_tf32(torch.from_numpy(x))]
                          for x in (a, b)]
    if k_part is None:
        return al @ bh + ah @ bl + ah @ bh if passes == 3 else ah @ bh
    terms = [(x.astype(np.float64), y.astype(np.float64)) for x, y in ((al, bh), (ah, bl), (ah, bh))]
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], k_part):
        part = None
        for k in range(k0, min(k0 + k_part, a.shape[1]), 8):
            for x, y in terms:
                s = x[:, k:k + 8] @ y[k:k + 8]
                part = _rz32(s if part is None else part.astype(np.float64) + s)
        total = total + part
    return total


@pytest.mark.parametrize("k_part", [None, 32 * F32_KPART], ids=["fp32-sums", "kernel-partials"])
def test_3xtf32_emulation_holds_fp32_tolerance(k_part):
    """The scheme at a YOLO width, [1, 13, 13, 512] with Cmid 256 (conv2's
    K = 9 * 256 = 2304), against the plain fp32 block at the kernel's fp32
    tolerance, rtol = atol = 1e-4: with fp32 sums, and with the kernel's
    partial sums of 32 * F32_KPART K, each accumulated by truncation.  One
    TF32 product would not hold it."""
    b, h, w, c, cmid = 1, 13, 13, 512, 256
    rng = np.random.default_rng(7)
    y = rng.normal(size=(b, h, w, c)).astype(np.float32) * np.float32(0.5)
    w1 = (rng.normal(size=(c, cmid)) / np.sqrt(c)).astype(np.float32)
    b1 = (rng.normal(size=cmid) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(3, 3, cmid, c)) / np.sqrt(9 * cmid)).astype(np.float32)
    b2 = (rng.normal(size=c) * 0.1).astype(np.float32)

    def leaky(v):
        return np.where(v > 0, v, np.float32(0.1) * v)

    def block(passes, k_part=None):
        mid = leaky(_mm_tf32(y.reshape(-1, c), w1, passes, k_part) + b1).reshape(b, h, w, cmid)
        halo = np.pad(mid, ((0, 0), (1, 1), (1, 1), (0, 0)))   # out-of-image mid is 0
        cols = np.concatenate([halo[:, dy:dy + h, dx:dx + w] for dy in range(3)
                               for dx in range(3)], axis=-1).reshape(-1, 9 * cmid)
        r = leaky(_mm_tf32(cols, w2.reshape(9 * cmid, c), passes, k_part) + b2)
        return y + r.reshape(y.shape)

    want = fused_res_block_ref(*(torch.from_numpy(a) for a in (y, w1, b1, w2, b2)))
    np.testing.assert_allclose(block(3, k_part), want.numpy(), rtol=1e-4, atol=1e-4)
    one_pass = np.abs(block(1) - want.numpy())
    assert (one_pass > 1e-4 + 1e-4 * np.abs(want.numpy())).any()


TP = 64              # the fp32 kernel's tile: 64 output pixels (one m64)
FBM1 = 128           # conv1 rows a tile computes
FLAT_MAX_W = 31      # flat tiles need 64 + 2W + 2 <= FBM1 mid rows


def _emulate_f32_kernel(y, w1, b1, w2, b2, flat, cs):
    """The fp32 kernel's decomposition on the CPU, in float64 on the weights'
    hi + lo planes.  Per tile of 64 output pixels, an 8x8 square (mid rows:
    the 10 x 10 window, row stride 10) or 64 pixels in raster order (flat;
    mid rows: the raster run from p0 - W - 1, row stride W): conv1 on the
    tile's 128 y rows (zeros outside the image), sliced over a cluster of
    ``cs`` blocks in chunks of 32 mid channels; mid 0 outside the image and in
    padded channels; conv2 as 9 * Mpad / 32 steps, chunk-major, each a tap's
    shifted mid rows (flat: 0 where the tap wraps past the left or right
    edge) against that step's 32 columns of w2p."""
    b, h, w, c = y.shape
    cmid = w1.shape[-1]
    w1p, w2p = (t.double() for t in tf32_weights(w1, w2))
    w1k, w2k = w1p[0] + w1p[1], w2p[0] + w2p[1]
    mpad, cp = w1k.shape
    ms = -(-mpad // 32 // cs) * 32
    yd = y.double()
    out = torch.empty_like(yd)
    if flat:
        tiles, mrows, rs = -(-h * w // TP), TP + 2 * w + 2, w
    else:
        tiles_w = -(-w // TW)
        tiles, mrows, rs = -(-h // TH) * tiles_w, HALO * HALO, HALO
    p, i = torch.arange(FBM1), torch.arange(TP)
    b1p = torch.zeros(mpad, dtype=torch.float64)
    b1p[:cmid] = b1.double()
    for bi in range(b):
        yflat = torch.zeros(h * w, cp, dtype=torch.float64)
        yflat[:, :c] = yd[bi].reshape(h * w, c)
        for tile in range(tiles):
            if flat:
                p0 = tile * TP
                f = p0 - w - 1 + p
                inside = (f >= 0) & (f < h * w)
                arow, x = i, (p0 + i) % w
                left, right = x == 0, x == w - 1
                opix = p0 + i
                ok = opix < h * w
            else:
                ty0, tx0 = (tile // tiles_w) * TH, (tile % tiles_w) * TW
                gy, gx = ty0 - 1 + p // HALO, tx0 - 1 + p % HALO
                inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w) & (p < HALO * HALO)
                f = gy * w + gx
                arow = (i // TW) * HALO + i % TW
                left = right = torch.zeros(TP, dtype=torch.bool)
                oy, ox = ty0 + i // TW, tx0 + i % TW
                ok, opix = (oy < h) & (ox < w), oy * w + ox
            yrows = torch.where(inside[:, None], yflat[torch.where(inside, f, 0)], 0.0)
            mid = torch.zeros(mrows, mpad, dtype=torch.float64)
            for rank in range(cs):
                lo, hi = rank * ms, min(rank * ms + ms, mpad)
                if hi <= lo:
                    continue
                v = _leaky(yrows @ w1k[lo:hi].t() + b1p[lo:hi])
                keep = inside[:, None] & (torch.arange(lo, hi) < cmid)[None]
                mid[:, lo:hi] = torch.where(keep, v, 0.0)[:mrows]
            acc = torch.zeros(TP, c, dtype=torch.float64)
            for s in range(9 * mpad // 32):
                kc, t = divmod(s, 9)
                rows = arow + (t // 3) * rs + t % 3
                assert int(rows.max()) < mrows <= FBM1
                wrap = left if t % 3 == 0 else right if t % 3 == 2 else torch.zeros_like(left)
                a = torch.where(wrap[:, None], 0.0, mid[rows, kc * 32:(kc + 1) * 32])
                acc += a @ w2k[:, s * 32:(s + 1) * 32].t()
            r = _leaky(acc + b2.double())
            o = out[bi].view(h * w, c)
            o[opix[ok]] = yd[bi].reshape(h * w, c)[opix[ok]] + r[ok]
    return out.float()


@pytest.mark.parametrize("cs", [1, 2, 3])
@pytest.mark.parametrize("flat", [False, True], ids=["8x8", "flat"])
@pytest.mark.parametrize("shape,cmid", [((2, 13, 13, 64), 32),     # 13 wide: flat tiles
                                        ((1, 19, 21, 128), 48),    # ragged, Cmid padded to 64
                                        ((1, 9, FLAT_MAX_W, 16), 8)])  # the widest flat tile
def test_f32_kernel_emulation_matches_plain(shape, cmid, flat, cs):
    """The decomposition against the plain fp32 block, at 1e-5: what the
    kernel adds to it is the 3xTF32 arithmetic held above."""
    b, h, w, c = shape
    rng = np.random.default_rng(10)
    arrs = [rng.normal(size=shape) * 0.5, rng.normal(size=(c, cmid)) / np.sqrt(c),
            rng.normal(size=cmid) * 0.1, rng.normal(size=(3, 3, cmid, c)) / np.sqrt(9 * cmid),
            rng.normal(size=c) * 0.1]
    args = _torch([np.asarray(a, np.float32) for a in arrs])
    got = _emulate_f32_kernel(*args, flat=flat, cs=cs)
    want = fused_res_block_ref(*args)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


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
