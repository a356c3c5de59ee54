"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; without them it skips.  The
global TF32 flags stay at PyTorch's defaults: the plain versions turn TF32
off themselves.  The file imports no JAX, so it also runs on a host without
it:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from yolo_v3_tpu_torch.models import darknet as D
from yolo_v3_tpu_torch.ops import activations as A
from yolo_v3_tpu_torch.ops import conv_down as CD
from yolo_v3_tpu_torch.ops import entry_kernel as EK
from yolo_v3_tpu_torch.ops import fused_conv as FC
from yolo_v3_tpu_torch.ops import letterbox as L
from yolo_v3_tpu_torch.ops.fused_res_block import (
    cluster_size,
    fused_res_block,
    fused_res_block_ref,
    plan,
)
from yolo_v3_tpu_torch.utils.precision import full_fp32

pytestmark = pytest.mark.cuda

# fp32: summation order only.  bf16: 2 bf16 ulps, for rounding-point flips
# of mid or of conv2's result between two fp32 summation orders.
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1.6e-2)}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _block_inputs(shape, cmid, dtype, dev, seed=0):
    b, h, w, c = shape
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)

    return (t(rng.normal(size=shape) * 0.5),
            t(rng.normal(size=(c, cmid)) / np.sqrt(c)),
            t(rng.normal(size=(cmid,)) * 0.1),
            t(rng.normal(size=(3, 3, cmid, c)) / np.sqrt(9 * cmid)),
            t(rng.normal(size=(c,)) * 0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,cmid", [
    ((2, 32, 16, 8), 4),          # the Pallas suite's shapes
    ((1, 48, 24, 16), 8),
    ((2, 13, 13, 64), 32),        # ragged tiles
    ((1, 19, 21, 128), 64),
    ((2, 26, 26, 512), 256),      # YOLOv3 stage 3 / 4 widths
    ((1, 13, 13, 1024), 512),
    ((8, 26, 26, 512), 256),      # batch 8: the fp32 split runs in clusters
    ((8, 13, 13, 1024), 512),
    ((8, 19, 19, 1024), 512),     # ragged and clustered
    ((8, 208, 208, 64), 32),      # the other residual-block shapes of
    ((8, 104, 104, 128), 64),     # YOLOv3-416 at the serving batch
    ((8, 52, 52, 256), 128),
    ((8, 76, 76, 256), 128),      # YOLOv3-608
    ((4, 26, 26, 512), 256),      # phase 10: batch 4 under the data axis,
    ((4, 13, 13, 1024), 512),
    ((8, 8, 13, 1024), 512),      # and a 13-wide stripe of rank 0 under space
])
def test_kernel_matches_plain(dev, shape, cmid, dtype):
    args = _block_inputs(shape, cmid, dtype, dev)
    before = fused_res_block.launches
    got = fused_res_block(*args)
    torch.cuda.synchronize()
    assert fused_res_block.launches == before + 1
    want = fused_res_block_ref(*args)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_f32_split_runs_in_clusters_on_small_grids(dev):
    """At batch 8 the 26x26 and 13x13 blocks split each tile over a cluster
    (conv1 shared through distributed shared memory) and take flat tiles (64
    pixels in raster order: 11 and 3 an image, against 16 and 4 of 8x8);
    19x19 (ragged) splits too; 208x208 fills the card unsplit, in 8x8
    tiles.  The other batch-8 shapes of test_kernel_matches_plain run
    whichever split and geometry the host picks."""
    assert cluster_size(8, 208, 208, 64, 32) == 1
    assert plan(8, 208, 208, 64, 32)["geometry"] == "8x8"
    for hw, c, tiles in ((26, 512, 11), (13, 1024, 3)):
        got = plan(8, hw, hw, c, c // 2)
        assert got["cluster"] > 1
        assert got["geometry"] == "flat" and got["tiles"] == tiles
        assert got["mid_rows"] == 64 + 2 * hw + 2
    assert cluster_size(8, 19, 19, 1024, 512) > 1


def test_bf16_split_runs_in_clusters_on_small_grids(dev):
    """The bf16 kernel shares the planner: at batch 8, 208x208 fills the card
    unsplit, and the 13x13 and 19x19 tiles (ragged) split over a cluster
    with conv1 sliced across it."""
    bf16 = torch.bfloat16
    assert cluster_size(8, 208, 208, 64, 32, bf16) == 1
    assert cluster_size(8, 13, 13, 1024, 512, bf16) > 1
    assert cluster_size(8, 19, 19, 1024, 512, bf16) > 1


def test_kernel_rejects_bad_operands(dev):
    y, w1, b1, w2, b2 = _block_inputs((1, 8, 8, 16), 8, torch.float32, dev)
    with pytest.raises(TypeError):
        fused_res_block(y.half(), w1, b1, w2, b2)
    with pytest.raises(ValueError):
        fused_res_block(y, w1, b1, w2[:, :, :4], b2)
    with pytest.raises(ValueError):
        fused_res_block(y.transpose(1, 2), w1, b1, w2, b2)



def test_bf16_kernel_rejects_unaligned_channels(dev):
    """The bf16 kernel stages y in 16-byte rows: C % 8 != 0 raises."""
    args = _block_inputs((1, 8, 8, 12), 6, torch.bfloat16, dev)
    before = fused_res_block.launches
    with pytest.raises(ValueError):
        fused_res_block(*args)
    assert fused_res_block.launches == before


# ---------------------------------------------------------------------------
# int8 kernels: conv1x1_p2d, conv3x3_p2d (res_block_p2d), fused_entry.
# Kernel and plain version share the int32 accumulation and an epilogue with
# the same rounding points, so the outputs are bit-equal, bf16 included.
# ---------------------------------------------------------------------------

def _i8(rng, shape, lo=-20, hi=20):
    return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int8))


def _scale_bias(rng, n, k):
    """Multipliers that put leaky(acc*m+b) mostly inside +-127 for K=k."""
    m = rng.uniform(0.5, 1.5, n) * 40.0 / (np.sqrt(k) * 133.0)
    return (torch.from_numpy(m.astype(np.float32)),
            torch.from_numpy(rng.normal(0, 3.0, n).astype(np.float32)))


def _conv_inputs(b, h, w, c, n, taps, residual, dev, seed=0):
    rng = np.random.default_rng(seed)
    x2d = FC.pack_p2d(_i8(rng, (b, h, w, c)))
    wt = _i8(rng, (3, 3, c, n) if taps == 9 else (c, n))
    s, bias = _scale_bias(rng, n, taps * c)
    res = _i8(rng, (x2d.shape[0], n), -127, 128) if residual else None
    move = (lambda t: None if t is None else t.to(dev))
    return [move(t) for t in (x2d, wt, s, bias, res)]


@pytest.mark.parametrize("taps", [1, 9], ids=["1x1", "3x3"])
@pytest.mark.parametrize("shape,residual,out_dtype", [
    ((2, 6, 6, 16, 24), False, torch.int8),        # the Pallas suite's shapes
    ((2, 8, 10, 16, 24), True, torch.bfloat16),
    ((1, 5, 7, 4, 8), False, torch.int8),          # C % 16 != 0, ragged R
    ((1, 6, 6, 40, 36), True, torch.int8),         # C, N off the tile sizes
    ((2, 13, 13, 1024, 512), False, torch.int8),   # 13^2 head / res conv1
    ((2, 13, 13, 512, 1024), True, torch.int8),    # 13^2 res conv2 / head 3x3
    ((2, 13, 13, 1024, 255), False, torch.bfloat16),   # det, N = 255
    ((2, 52, 52, 128, 256), True, torch.int8),
    ((8, 26, 26, 512, 256), False, torch.int8),
])
def test_int8_conv_kernel_matches_plain(dev, taps, shape, residual, out_dtype):
    b, h, w, c, n = shape
    x2d, wt, s, bias, res = _conv_inputs(b, h, w, c, n, taps, residual, dev)
    _, hp, wp = FC.p2d_geometry(b, h, w)
    fn, ref = ((FC.conv1x1_p2d, FC.conv1x1_p2d_ref) if taps == 1
               else (FC.conv3x3_p2d, FC.conv3x3_p2d_ref))
    leaky = out_dtype == torch.int8
    kw = dict(leaky=leaky, out_dtype=out_dtype, residual=res, res_scale=0.7)
    before = fn.launches
    got = fn(x2d, wt, s, bias, hp, wp, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = ref(x2d, wt, s, bias, hp, wp, **kw)
    assert got.dtype == want.dtype == out_dtype
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()
    # borders are zero
    full = got.reshape(b, h + 2, w + 2, n).float()
    assert full[:, 0].abs().sum() == 0 and full[:, :, -1].abs().sum() == 0


def test_int8_res_block_kernel_matches_plain(dev):
    rng = np.random.default_rng(1)
    b, h, w, c = 2, 26, 26, 512
    x2d = FC.pack_p2d(_i8(rng, (b, h, w, c))).to(dev)
    w1, w2 = _i8(rng, (c, c // 2)).to(dev), _i8(rng, (3, 3, c // 2, c)).to(dev)
    s1, b1 = (t.to(dev) for t in _scale_bias(rng, c // 2, c))
    s2, b2 = (t.to(dev) for t in _scale_bias(rng, c, 9 * c // 2))
    _, hp, wp = FC.p2d_geometry(b, h, w)
    counts = (FC.conv1x1_p2d.launches, FC.conv3x3_p2d.launches, FC.res_block_p2d.launches)
    got = FC.res_block_p2d(x2d, w1, s1, b1, w2, s2, b2, hp, wp, res_scale=0.8)
    torch.cuda.synchronize()
    assert (FC.conv1x1_p2d.launches, FC.conv3x3_p2d.launches,
            FC.res_block_p2d.launches) == tuple(n + 1 for n in counts)
    want = FC.res_block_p2d_ref(x2d, w1, s1, b1, w2, s2, b2, hp, wp, res_scale=0.8)
    assert torch.equal(got, want)


def test_int8_conv_kernel_rejects_bad_operands(dev):
    x2d, wt, s, bias, _ = _conv_inputs(1, 4, 4, 16, 8, 1, False, dev)
    with pytest.raises(TypeError):                 # bf16 input with an int8 weight
        FC.conv1x1_p2d(x2d.bfloat16(), wt, s, bias, 6, 6)
    with pytest.raises(ValueError):
        FC.conv3x3_p2d(x2d, wt, s, bias, 6, 6)     # a 1x1 weight for the 3x3
    with pytest.raises(ValueError):
        FC.conv1x1_p2d(x2d, wt, s[:4], bias, 6, 6)
    with pytest.raises(ValueError):
        FC.conv1x1_p2d(x2d.t().contiguous().t(), wt, s, bias, 6, 6)


# every (taps, H = W, C, N) of the int8 forward's padded-2D convs at
# YOLOv3-416: the 15 of chip_smoke.py's 18 INT8_CONVS once the residual and
# the output type, which the planner does not read, are left out
INT8_FORWARD_SHAPES = [
    (1, 104, 128, 64), (1, 52, 256, 128), (1, 26, 512, 256), (1, 13, 1024, 512),
    (9, 104, 64, 128), (9, 52, 128, 256), (9, 26, 256, 512), (9, 13, 512, 1024),
    (1, 26, 768, 256), (1, 52, 384, 128), (1, 13, 1024, 255), (1, 26, 512, 255),
    (1, 52, 256, 255), (1, 13, 512, 256), (1, 26, 256, 128),
    # stage 0's block in a tree without space-to-depth
    (1, 208, 64, 32), (9, 208, 32, 64),
]


@pytest.mark.parametrize("tiles", range(len(FC.P2D_TILES)))
@pytest.mark.parametrize("taps,b,h,w,c,n,out_dtype", [
    (1, 1, 5, 7, 4, 8, torch.int8),                # C = 4: padded to 16
    (9, 3, 11, 9, 40, 36, torch.int8),             # C = 40: padded to 48; N = 36
    (9, 2, 8, 8, 144, 255, torch.bfloat16),        # a second, mostly empty K slot; N = 255
    (9, 1, 3, 3, 16, 24, torch.int8),              # R = 25, below one tile
    (9, 8, 104, 104, 64, 128, torch.int8),         # stage 1's 3x3: half a K slot
    (1, 8, 104, 104, 128, 64, torch.int8),         # stage 1's 1x1: N = 64
    (9, 8, 13, 13, 512, 1024, torch.int8),
    (1, 8, 52, 52, 256, 255, torch.bfloat16),      # a det
    (1, 8, 26, 26, 768, 256, torch.int8),
])
def test_int8_conv_kernel_every_tile_shape(dev, tiles, taps, b, h, w, c, n, out_dtype):
    """Each tile shape of P2D_TILES with int8 input, whichever the planner
    picks, bit-equal to the plain version, with a residual."""
    x2d, wt, s, bias, res = _conv_inputs(b, h, w, c, n, taps, True, dev)
    _, hp, wp = FC.p2d_geometry(b, h, w)
    name, ref = (("conv3x3_p2d", FC.conv3x3_p2d_ref) if taps == 9
                 else ("conv1x1_p2d", FC.conv1x1_p2d_ref))
    leaky = out_dtype == torch.int8
    got = FC._launch(name, taps, x2d, wt, s, bias, hp, wp, leaky, out_dtype, res, 0.7,
                     tiles=tiles)
    torch.cuda.synchronize()
    want = ref(x2d, wt, s, bias, hp, wp, leaky=leaky, out_dtype=out_dtype, residual=res,
               res_scale=0.7)
    assert got.dtype == want.dtype == out_dtype
    assert torch.equal(got, want), (got.float() - want.float()).abs().max()


def test_int8_planner_on_the_card_matches_plan_tiles(dev):
    """The C launcher's tile choice for int8 input is
    ops/fused_conv.py::plan_tiles with the card's SM count, at every shape
    of the int8 forward at batch 8 and 1."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for taps, hw, c, n in INT8_FORWARD_SHAPES:
        for b in (8, 1):
            r, _, _ = FC.p2d_geometry(b, hw, hw)
            assert (FC.plan_on_device(r, c, n, taps, torch.int8)
                    == FC.plan_tiles(r, c, n, taps, torch.int8, sms))


@pytest.mark.parametrize("taps", [1, 9], ids=["1x1", "3x3"])
@pytest.mark.parametrize("c", [4, 40])
def test_int8_conv_kernel_pads_unaligned_channels(dev, taps, c):
    """C % 16 != 0 runs the one kernel on channels zero-padded to 16 (the C
    launcher itself refuses rows that are not 16 bytes), bit-equal to the
    plain version."""
    x2d, wt, s, bias, res = _conv_inputs(2, 7, 9, c, 24, taps, True, dev)
    _, hp, wp = FC.p2d_geometry(2, 7, 9)
    fn, ref = ((FC.conv1x1_p2d, FC.conv1x1_p2d_ref) if taps == 1
               else (FC.conv3x3_p2d, FC.conv3x3_p2d_ref))
    before = fn.launches
    got = fn(x2d, wt, s, bias, hp, wp, residual=res, res_scale=0.7)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, ref(x2d, wt, s, bias, hp, wp, residual=res, res_scale=0.7))
    wk = FC.k_major(wt, wt.reshape(taps * c, 24))
    out = torch.empty_like(got)
    entry = getattr(FC._lib(), f"yolo_{fn.__name__}_i8")
    rc = entry(x2d.data_ptr(), wk.data_ptr(), s.data_ptr(), bias.data_ptr(), 0, 1.0,
               out.data_ptr(), 0, x2d.shape[0], c, 24, hp, wp, 1,
               torch.cuda.current_stream().cuda_stream)
    assert rc != 0                                 # cudaErrorInvalidValue: C % 16 != 0


def _entry_inputs(b, h, w, dev, seed=0):
    rng = np.random.default_rng(seed)
    xb = _i8(rng, (b, 2 * h + 2, 2 * w + 2, 12), -127, 128).to(dev)
    qs2d = {}
    for name, (kh, kw, cin, cout) in EK.SHAPES.items():
        shape = (cin, cout) if kh == 1 else (kh, kw, cin, cout)
        m, bias = _scale_bias(rng, cout, kh * kw * cin)
        qs2d[name] = {"w": _i8(rng, shape).to(dev), "m": m.to(dev), "b": bias.to(dev)}
    return xb, qs2d


# the first three since the kernel was ported; then batch 1, 8 and 16 at the
# forward's h = w = 104, its half, the DIM-96 fixture's 24, and ragged shapes
# (13 x 21: one strip narrower than the strip width; 7 x 40: a second strip
# of 14 columns)
ENTRY_SHAPES = [(2, 24, 24), (1, 13, 21), (8, 104, 104)] + [
    (b, h, w) for b in (1, 8, 16)
    for h, w in ((24, 24), (13, 21), (104, 104), (52, 52), (7, 40))
    if (b, h, w) != (8, 104, 104)]


def _check_entry(xb, qs2d, got):
    torch.cuda.synchronize(xb.device)
    want = EK.fused_entry_ref(xb, qs2d, 0.6)
    b, hb, wb, _ = xb.shape
    assert got.shape == (b, (hb - 2) // 2, (wb - 2) // 2, 128)
    assert torch.equal(got, want), (got.int() - want.int()).abs().max()


@pytest.mark.parametrize("b,h,w", ENTRY_SHAPES)
def test_fused_entry_kernel_matches_plain(dev, b, h, w):
    """The planner's geometry, one launch, bit-equal to the plain version."""
    xb, qs2d = _entry_inputs(b, h, w, dev)
    before = EK.fused_entry.launches
    got = EK.fused_entry(xb, qs2d, 0.6)
    _check_entry(xb, qs2d, got)
    assert EK.fused_entry.launches == before + 1


@pytest.mark.parametrize("b,h,w", [(2, 24, 24), (8, 104, 104)])
@pytest.mark.parametrize("band", [1, 2, 3, 5, 13, 26, 0])
def test_fused_entry_kernel_every_geometry(dev, b, h, w, band):
    """Bands of 1, 2, 3, 5, 13, 26 rows and the whole height (0: h),
    forced through the wrapper's launcher, whatever the planner picks."""
    xb, qs2d = _entry_inputs(b, h, w, dev, seed=1)
    _check_entry(xb, qs2d, EK._launch(xb, qs2d, 0.6, band=min(band or h, h)))


def test_fused_entry_kernel_on_every_device(dev):
    """A launch on each card in turn (the kernel's shared-memory limit holds
    only for the device it was raised on), bit-equal to the plain version."""
    for i in range(torch.cuda.device_count()):
        xb, qs2d = _entry_inputs(1, 13, 21, torch.device("cuda", i))
        _check_entry(xb, qs2d, EK.fused_entry(xb, qs2d, 0.6))


def test_fused_entry_planner_on_the_card_matches_plan_entry(dev):
    """The C launcher's geometry is ops/entry_kernel.py::plan_entry with the
    card's SM count, at the int8 forward's shape and others."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, h, w in [(8, 104, 104), (1, 104, 104), (16, 104, 104), (8, 52, 52), (2, 24, 24),
                    (1, 13, 21), (3, 7, 40)]:
        geo, mirror = EK.plan_on_device(b, h, w), EK.plan_entry(b, h, w, sms)
        assert {k: geo[k] for k in ("strip", "step", "band")} == {
            k: mirror[k] for k in ("strip", "step", "band")}
        assert geo["smem"] == EK.SMEM_BYTES


def test_fused_entry_kernel_rejects_bad_operands(dev):
    xb, qs2d = _entry_inputs(1, 8, 8, dev)
    with pytest.raises(TypeError):
        EK.fused_entry(xb.float(), qs2d, 0.6)
    with pytest.raises(ValueError):
        EK.fused_entry(xb[..., :8].contiguous(), qs2d, 0.6)
    bad = dict(qs2d, stem=dict(qs2d["stem"], w=qs2d["stem"]["w"].float()))
    with pytest.raises(ValueError):
        EK.fused_entry(xb, bad, 0.6)
    with pytest.raises(ValueError):                # a band taller than h = 8
        EK._launch(xb, qs2d, 0.6, band=9)
    with pytest.raises(ValueError):
        EK._launch(xb, qs2d, 0.6, band=0)


def _entry_u8_inputs(b, h, w, dev, seed=0):
    """The uint8 feed's entry operands: a uint8 image (black and white bands
    at the two ends of the codes) as ``u8 ^ 0x80`` int8 codes padded with
    -128 (the real 0 of the scheme) in the 2x2 space-to-depth layout, and a
    stem whose multipliers and biases are the first 128 of a ``stem4_u8``
    quantized from random float weights (zero point folded into the bias)."""
    from yolo_v3_tpu_torch.models import quantized as Q

    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (b, 4 * h, 4 * w, 3), dtype=np.uint8)
    u8[:, :3] = 0
    u8[:, -3:] = 255
    x_q = (torch.from_numpy(u8) ^ 0x80).view(torch.int8)
    xb = D._space_to_depth2(torch.nn.functional.pad(x_q, (0, 0, 1, 3, 1, 3), value=-128))
    _, qs2d = _entry_inputs(b, h, w, dev, seed)
    stem_w = rng.normal(0, 0.3, (3, 3, 3, 32)).astype(np.float32)
    stem_b = rng.normal(0, 0.1, 32).astype(np.float32)
    s_out = 6.0 / 127
    w4, b4 = D._stem4_weights(stem_w, stem_b)
    w4q, s4w = Q._quant_w(w4)
    m_u8 = (1.0 / 255.0) * s4w / s_out
    zp = 128.0 * m_u8 * w4q.numpy().astype(np.int32).sum((0, 1, 2))
    w2q, _ = Q._quant_w(D._s2d_stem_weights(stem_w))
    stem = Q._stem_u8({"stem": {"w": w2q},
                       "stem4_u8": {"w": w4q, "m": Q._t(m_u8), "b": Q._t(b4 / s_out + zp)}})
    qs2d["stem"] = {k: v.to(dev) for k, v in stem.items()}
    return xb.contiguous().to(dev), qs2d


@pytest.mark.parametrize("b,h,w", [(1, 13, 21), (2, 24, 24), (8, 104, 104), (1, 104, 104),
                                   (8, 7, 40), (16, 52, 52)])
@pytest.mark.parametrize("band", [None, 1, 3, 0])
def test_fused_entry_kernel_u8_operands(dev, b, h, w, band):
    """The uint8 feed's operands (-128 pad, stem4_u8's multipliers and
    biases) at batch 1, 2, 8 and 16 and the ragged shapes, with the
    planner's band (None) and bands of 1, 3 and h (0): bit-equal to the
    plain version.  Where the kernel makes zeros itself (the stem's im2col
    outside the image, the rows above a band) they reach only stem outputs
    that down0's padding masks, so the caller's pad is all the feed needs."""
    xb, qs2d = _entry_u8_inputs(b, h, w, dev)
    if band is None:
        got = EK.fused_entry(xb, qs2d, 0.6)
    else:
        got = EK._launch(xb, qs2d, 0.6, band=min(band or h, h))
    _check_entry(xb, qs2d, got)


@pytest.mark.parametrize("b,h,w,c", [(8, 208, 208, 64), (2, 1, 1, 64), (3, 1, 1, 1024)])
def test_int8_res_block_kernel_at_stage0_and_the_smallest_grid(dev, b, h, w, c):
    """A tree without space-to-depth runs stage 0's block on the p2d
    kernels: 208^2 at batch 8, C 64 -> N 32 (1x1) and C 32 -> N 64 (3x3),
    widths below one tile (N = 32 under a 64- or 128-wide tile, 32-byte
    rows of C = 32); and hp = wp = 3 (h = w = 1).  Bit-equal to the plain
    version, one launch of each kernel."""
    rng = np.random.default_rng(2)
    x2d = FC.pack_p2d(_i8(rng, (b, h, w, c))).to(dev)
    w1, w2 = _i8(rng, (c, c // 2)).to(dev), _i8(rng, (3, 3, c // 2, c)).to(dev)
    s1, b1 = (t.to(dev) for t in _scale_bias(rng, c // 2, c))
    s2, b2 = (t.to(dev) for t in _scale_bias(rng, c, 9 * c // 2))
    _, hp, wp = FC.p2d_geometry(b, h, w)
    counts = (FC.conv1x1_p2d.launches, FC.conv3x3_p2d.launches)
    got = FC.res_block_p2d(x2d, w1, s1, b1, w2, s2, b2, hp, wp, res_scale=0.8)
    torch.cuda.synchronize()
    assert (FC.conv1x1_p2d.launches, FC.conv3x3_p2d.launches) == tuple(n + 1 for n in counts)
    want = FC.res_block_p2d_ref(x2d, w1, s1, b1, w2, s2, b2, hp, wp, res_scale=0.8)
    assert torch.equal(got, want), (got.int() - want.int()).abs().max()


@pytest.mark.parametrize("s2d", [True, False], ids=["s2d", "no_s2d"])
def test_int8_forwards_of_every_feed_match_plain(dev, s2d):
    """A small int8 net (blocks (1,1,1,1,1), 96 px): the float feed and, for
    an s2d tree, the uint8 feed, kernel path bit-equal to the plain path;
    the entry kernel launches once on an s2d tree and never without s2d,
    where the stage-0 block runs on the p2d kernels."""
    from yolo_v3_tpu_torch.models import quantized as Q

    gen = torch.Generator().manual_seed(0)
    params, state = D.init_yolonet(gen, 2, blocks=(1, 1, 1, 1, 1))
    x = torch.rand(2, 96, 96, 3, generator=gen).to(dev)
    model = Q.YoloNetQuantized(Q.build_quantized(params, state, x, space_to_depth=s2d)).to(dev)
    feeds = [x] + ([(x * 255).round().to(torch.uint8)] if s2d else [])
    for feed in feeds:
        counters = (EK.fused_entry, FC.res_block_p2d)
        before = [f.launches for f in counters]
        with torch.inference_mode():
            heads = model(feed)
            torch.cuda.synchronize()
            assert [f.launches - n for f, n in zip(counters, before)] == (
                [1, 4] if s2d else [0, 5])
            plain = model(feed, plain=True)
        for h, p in zip(heads, plain):
            assert h.dtype == torch.bfloat16 and torch.equal(h, p)


# ---------------------------------------------------------------------------
# bf16 kernels: conv1x1_p2d, conv3x3_p2d (res_block_p2d) with bf16 input and
# float32 accumulation, held to the plain version (a float32 product of the
# bf16 values) at the JAX suite's bf16 tolerance: the two sum in another
# order, so a rounding point may flip by one bf16 ulp.
# ---------------------------------------------------------------------------

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# every (taps, H = W, C, N, leaky) of the bf16 forward's heads and up convs at
# YOLOv3-416 (13 shapes for its 23 convs; the dets have N = 255, no leaky)
BF16_HEAD_SHAPES = [
    (1, 13, 1024, 512, True), (9, 13, 512, 1024, True), (1, 13, 1024, 255, False),
    (1, 13, 512, 256, True),
    (1, 26, 768, 256, True), (1, 26, 512, 256, True), (9, 26, 256, 512, True),
    (1, 26, 512, 255, False), (1, 26, 256, 128, True),
    (1, 52, 384, 128, True), (1, 52, 256, 128, True), (9, 52, 128, 256, True),
    (1, 52, 256, 255, False),
]


def _bf16_conv_inputs(b, h, w, c, n, taps, residual, dev, seed=0):
    rng = np.random.default_rng(seed)

    def t(a, dtype=torch.bfloat16):
        return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)

    x2d = FC.pack_p2d(t(rng.normal(size=(b, h, w, c)) * 0.5))
    wt = t(rng.normal(size=(3, 3, c, n) if taps == 9 else (c, n)) / np.sqrt(taps * c))
    scale = t(np.ones(n), torch.float32)
    bias = t(rng.normal(size=n) * 0.1, torch.float32)
    res = t(rng.normal(size=(x2d.shape[0], n))) if residual else None
    return x2d, wt, scale, bias, res


def _bf16_conv_case(dev, taps, b, h, w, c, n, leaky, residual, res_scale=1.0):
    x2d, wt, s, bias, res = _bf16_conv_inputs(b, h, w, c, n, taps, residual, dev)
    _, hp, wp = FC.p2d_geometry(b, h, w)
    fn, ref = ((FC.conv1x1_p2d, FC.conv1x1_p2d_ref) if taps == 1
               else (FC.conv3x3_p2d, FC.conv3x3_p2d_ref))
    kw = dict(leaky=leaky, out_dtype=torch.bfloat16, residual=res, res_scale=res_scale)
    before = fn.launches
    got = fn(x2d, wt, s, bias, hp, wp, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = ref(x2d, wt, s, bias, hp, wp, **kw)
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    full = got.reshape(b, h + 2, w + 2, n).float()
    assert full[:, 0].abs().sum() == 0 and full[:, :, -1].abs().sum() == 0


@pytest.mark.parametrize("taps,hw,c,n,leaky", BF16_HEAD_SHAPES,
                         ids=[f"{'3x3' if t == 9 else '1x1'}-{h}-{c}-{n}"
                              for t, h, c, n, _ in BF16_HEAD_SHAPES])
def test_bf16_conv_kernel_matches_plain_at_head_shapes(dev, taps, hw, c, n, leaky):
    _bf16_conv_case(dev, taps, 8, hw, hw, c, n, leaky, residual=False)


@pytest.mark.parametrize("taps", [1, 9], ids=["1x1", "3x3"])
def test_bf16_conv_kernel_matches_plain_ragged(dev, taps):
    """R = 3 * 13 * 11 rows (no tile divides it), C = 40 and N = 36 off the
    tile sizes, a residual with res_scale 0.7."""
    _bf16_conv_case(dev, taps, 3, 11, 9, 40, 36, True, residual=True, res_scale=0.7)


@pytest.mark.parametrize("taps", [1, 9], ids=["1x1", "3x3"])
def test_bf16_conv_kernel_matches_plain_c72_n255_residual(dev, taps):
    """C = 72 (a second K slot of 8 channels, the rest zero-filled by TMA)
    and N = 255 (510-byte rows of out: element stores), with a residual."""
    _bf16_conv_case(dev, taps, 2, 10, 12, 72, 255, False, residual=True, res_scale=0.7)


@pytest.mark.parametrize("taps", [1, 9], ids=["1x1", "3x3"])
def test_bf16_conv_kernel_matches_plain_below_one_tile(dev, taps):
    """R = 25 rows, fewer than one tile: the 3x3's first taps read rows from
    -6 on, which TMA fills with zeros, as it does the rows past R."""
    _bf16_conv_case(dev, taps, 1, 3, 3, 16, 24, True, residual=True, res_scale=0.7)


@pytest.mark.parametrize("tiles", range(len(FC.P2D_TILES)))
@pytest.mark.parametrize("taps,b,h,w,c,n", [
    (1, 3, 11, 9, 40, 36), (9, 3, 11, 9, 40, 36), (9, 2, 8, 8, 72, 255),
    (9, 8, 13, 13, 512, 1024), (1, 8, 52, 52, 256, 255), (9, 8, 26, 26, 256, 512),
])
def test_bf16_conv_kernel_every_tile_shape(dev, tiles, taps, b, h, w, c, n):
    """Each tile shape of P2D_TILES, whichever the planner picks, against
    the plain version."""
    x2d, wt, s, bias, res = _bf16_conv_inputs(b, h, w, c, n, taps, True, dev)
    _, hp, wp = FC.p2d_geometry(b, h, w)
    name, ref = (("conv3x3_p2d", FC.conv3x3_p2d_ref) if taps == 9
                 else ("conv1x1_p2d", FC.conv1x1_p2d_ref))
    got = FC._launch(name, taps, x2d, wt, s, bias, hp, wp, True, torch.bfloat16, res, 0.7,
                     tiles=tiles)
    torch.cuda.synchronize()
    want = ref(x2d, wt, s, bias, hp, wp, out_dtype=torch.bfloat16, residual=res,
               res_scale=0.7)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


def test_bf16_planner_on_the_card_matches_plan_bf16(dev):
    """The C launcher's tile choice for bf16 input is
    ops/fused_conv.py::plan_tiles with the card's SM count, at every head
    and up shape at batch 8 and 1."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf16 = torch.bfloat16
    for taps, hw, c, n, _ in BF16_HEAD_SHAPES:
        for b in (8, 1):
            r, _, _ = FC.p2d_geometry(b, hw, hw)
            assert (FC.plan_on_device(r, c, n, taps, bf16)
                    == FC.plan_tiles(r, c, n, taps, bf16, sms))


def test_bf16_res_block_matches_plain_and_fused_block(dev):
    """bf16 res_block_p2d at 26^2, C = 512, batch 8: against its plain
    version, and against the fused residual-block kernel (B4) on the same
    block, which rounds conv2's activation before the residual add where
    the composition rounds once after it."""
    y, w1, b1, w2, b2 = _block_inputs((8, 26, 26, 512), 256, torch.bfloat16, dev)
    _, hp, wp = FC.p2d_geometry(8, 26, 26)
    ones = torch.ones(512, device=dev)
    args = (FC.pack_p2d(y), w1, ones[:256], b1.float(), w2, ones, b2.float(), hp, wp)
    counts = (FC.conv1x1_p2d.launches, FC.conv3x3_p2d.launches, FC.res_block_p2d.launches)
    got = FC.res_block_p2d(*args, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert (FC.conv1x1_p2d.launches, FC.conv3x3_p2d.launches,
            FC.res_block_p2d.launches) == tuple(k + 1 for k in counts)
    want = FC.res_block_p2d_ref(*args, out_dtype=torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    b4 = fused_res_block(y, w1, b1, w2, b2)
    torch.testing.assert_close(FC.unpack_p2d(got, 8, 26, 26).float(), b4.float(),
                               **BF16_TOL)


def test_bf16_conv_kernel_rejects_bad_operands(dev):
    x2d, wt, s, bias, res = _bf16_conv_inputs(1, 4, 4, 16, 8, 1, True, dev)
    before = FC.conv1x1_p2d.launches
    with pytest.raises(TypeError):                 # bf16 input, int8 weight
        FC.conv1x1_p2d(x2d, wt.to(torch.int8), s, bias, 6, 6)
    with pytest.raises(TypeError):                 # int8 input, bf16 residual
        FC.conv1x1_p2d(x2d.to(torch.int8), wt.to(torch.int8), s, bias, 6, 6,
                       residual=res)
    with pytest.raises(TypeError):                 # bf16 input, int8 residual
        FC.conv1x1_p2d(x2d, wt, s, bias, 6, 6, residual=res.to(torch.int8))
    with pytest.raises(ValueError):                # C % 8 != 0
        FC.conv1x1_p2d(x2d[:, :12].contiguous(), wt[:12].contiguous(), s, bias, 6, 6)
    with pytest.raises(TypeError):                 # bf16 scale
        FC.conv1x1_p2d(x2d, wt, s.bfloat16(), bias, 6, 6)
    with pytest.raises(ValueError):                # no such tile shape
        FC._launch("conv1x1_p2d", 1, x2d, wt, s, bias, 6, 6, True, torch.bfloat16, None,
                   1.0, tiles=len(FC.P2D_TILES))
    assert FC.conv1x1_p2d.launches == before


def _small_net(dtype, dev):
    params, state = D.init_yolonet(torch.Generator().manual_seed(0), 2,
                                   blocks=(1, 1, 1, 1, 1))
    folded = D.fold_batchnorm(params, state)
    return D.YoloNetFolded(D.cast_params(folded, dtype, dev)).eval()


def test_bf16_forward_runs_heads_on_the_p2d_kernels(dev):
    """A bf16 forward launches one fused residual block per block, 14
    conv1x1_p2d (per head three 1x1s and the det, plus the two ups), 9
    conv3x3_p2d and 6 conv_down (the stem and the 5 downs); its heads are
    within 5e-2 * max|head| of the plain path."""
    model = _small_net(torch.bfloat16, dev)
    x = torch.rand(2, 96, 96, 3, generator=torch.Generator().manual_seed(1)).to(
        dev, torch.bfloat16)
    counters = (fused_res_block, FC.conv1x1_p2d, FC.conv3x3_p2d, CD.conv_down)
    before = [f.launches for f in counters]
    with torch.inference_mode():
        heads = model(x)
        torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip(counters, before)] == [5, 14, 9, 6]
        plain = model(x, plain=True)
    for h, p in zip(heads, plain):
        assert h.dtype == torch.bfloat16 and h.shape == p.shape
        scale = p.float().abs().max().item()
        assert (h.float() - p.float()).abs().max().item() <= 5e-2 * scale


def test_fp32_heads_do_not_depend_on_global_tf32(dev):
    """The fp32 forward turns TF32 off for its cuDNN convs and restores the
    caller's flags: heads the same with the global TF32 switches on and off."""
    model = _small_net(torch.float32, dev)
    x = torch.rand(2, 96, 96, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    heads = {}
    try:
        for tf32 in (True, False):
            cudnn.allow_tf32 = matmul.allow_tf32 = tf32
            with torch.inference_mode():
                heads[tf32] = model(x)
            assert (cudnn.allow_tf32, matmul.allow_tf32) == (tf32, tf32)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    for on, off in zip(heads[True], heads[False]):
        scale = off.abs().max().item()
        torch.testing.assert_close(on, off, rtol=1e-5, atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# The bf16 stem and stride-2 downs round once (the single-rounding conv of
# the folded forward, tests/test_torch_bf16_single_rounding.py on the CPU)
# ---------------------------------------------------------------------------

# (cin, cout, stride, H = W, activation, batch) of the stem and the 5 downs
# of YOLOv3-416; of YOLOv4-608's stem and 5 Mish downs and PANet's 2 leaky
# stride-2 convs; and of down0 at the cells' batch of 32
C1_CONVS = [(3, 32, 1, 416, "leaky", 2), (32, 64, 2, 416, "leaky", 2),
            (64, 128, 2, 208, "leaky", 2), (128, 256, 2, 104, "leaky", 2),
            (256, 512, 2, 52, "leaky", 2), (512, 1024, 2, 26, "leaky", 2),
            (3, 32, 1, 608, "mish", 2), (32, 64, 2, 608, "mish", 2),
            (64, 128, 2, 304, "mish", 2), (128, 256, 2, 152, "mish", 2),
            (256, 512, 2, 76, "mish", 2), (512, 1024, 2, 38, "mish", 2),
            (128, 256, 2, 76, "leaky", 2), (256, 512, 2, 38, "leaky", 2),
            (32, 64, 2, 416, "leaky", 32)]
C1_IDS = ["stem", "down0", "down1", "down2", "down3", "down4",
          "v4-stem", "v4-down0", "v4-down1", "v4-down2", "v4-down3", "v4-down4",
          "pan-down0", "pan-down1", "down0-b32"]


def _ordered_bf16(a):
    bits = (a.float().view(torch.int32) >> 16).to(torch.int64) & 0xFFFF
    return torch.where(bits >= 0x8000, -(bits & 0x7FFF), bits)


def _c1_conv(cin, cout, stride, act, dev):
    gen = torch.Generator().manual_seed(cin)
    w = (torch.randn(3, 3, cin, cout, generator=gen) / np.sqrt(9 * cin)).to(torch.bfloat16)
    b = (torch.randn(cout, generator=gen) * 0.3).to(torch.bfloat16)
    return D._ConvBias({"w": w, "b": b}, stride=stride, act=act).to(dev), gen


def _c1_input(gen, b, cin, h, w, dev):
    x = torch.randn(b, cin, h, w, generator=gen).to(torch.bfloat16)
    return x.to(dev).contiguous(memory_format=torch.channels_last)


def _single_rounding(conv, x, pad):
    """An fp32 conv with TF32 off, bias and the activation in fp32
    (``activations.mish`` for Mish), one rounding."""
    with full_fp32():
        ref = torch.nn.functional.conv2d(x.float(), conv.weight.float(), None, conv.stride, pad)
    ref = ref + conv.bias.float()[:, None, None]
    if conv.act == "mish":
        ref = A.mish(ref)
    elif conv.act == "leaky":
        ref = torch.nn.functional.leaky_relu(ref, 0.1)
    return ref.to(torch.bfloat16)


def _assert_rounds_once(got, ref):
    """Any difference on under 0.1% of outputs, and none beyond one bf16
    step plus 2^-12 (fp32 summation order near zero)."""
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    step = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp(min=2.0 ** -126))) - 7)
    assert ((got.float() - ref.float()).abs() <= step + 2.0 ** -12).all()
    assert (_ordered_bf16(got) != _ordered_bf16(ref)).float().mean().item() < 1e-3


@pytest.mark.parametrize("cin,cout,stride,hw,act,batch", C1_CONVS, ids=C1_IDS)
def test_bf16_stem_and_downs_round_once_on_the_card(dev, cin, cout, stride, hw, act, batch):
    """The conv kernel against an fp32 conv with TF32 off, bias and the
    activation in fp32, one rounding: any difference on under 0.1% of
    outputs, and none beyond one bf16 step plus 2^-12."""
    conv, gen = _c1_conv(cin, cout, stride, act, dev)
    x = _c1_input(gen, batch, cin, hw, hw, dev)
    before = CD.conv_down.launches
    with torch.no_grad():
        got = conv(x)
        ref = _single_rounding(conv, x, 1)
    assert CD.conv_down.launches == before + 1
    _assert_rounds_once(got, ref)
    with torch.no_grad():          # the plain version: the chunked TF32 convs
        _assert_rounds_once(conv(x, plain=True), ref)


@pytest.mark.parametrize("cin,cout,stride", [(3, 32, 1), (32, 64, 2), (256, 512, 2)],
                         ids=["stem", "down0", "down3"])
def test_conv_down_kernel_on_a_stripe_with_its_halo(dev, cin, cout, stride):
    """``pad = (0, 1)``, the space-sharded stripe that carries its halo rows
    (an odd number of rows at stride 2): the kernel and the plain version
    both round once against the fp32 reference with the same padding."""
    conv, gen = _c1_conv(cin, cout, stride, "leaky", dev)
    rows = 2 * 13 + 1 if stride == 2 else 26 + 2
    x = _c1_input(gen, 2, cin, rows, 56, dev)
    with torch.no_grad():
        got = CD.conv_down(x, conv.weight, conv.bias, stride, (0, 1), "leaky")
        plain = CD.conv_down_ref(x, conv.weight, conv.bias, stride, (0, 1), "leaky")
        ref = _single_rounding(conv, x, (0, 1))
    assert got.shape == plain.shape == ref.shape
    _assert_rounds_once(got, ref)
    _assert_rounds_once(plain, ref)


# (cin, cout, H, W) of downs at every tile shape and width: a ragged grid, and
# the 13^2 / 19^2 outputs of the last downs
TILE_CASES = [(64, 128, 26, 38), (512, 1024, 26, 26), (256, 512, 38, 38)]


@pytest.mark.parametrize("variant", range(len(CD.DOWN_TILES)))
@pytest.mark.parametrize("wt", CD.TILE_WIDTHS)
@pytest.mark.parametrize("cin,cout,h,w", TILE_CASES)
def test_conv_down_kernel_every_tile_shape(dev, variant, wt, cin, cout, h, w):
    if wt > 64 * CD.DOWN_TILES[variant][0]:
        pytest.skip("the tile is narrower than this width")
    conv, gen = _c1_conv(cin, cout, 2, "leaky", dev)
    x = _c1_input(gen, 2, cin, h, w, dev)
    wk, bias32 = CD.k_major(conv.weight, conv.bias)
    with torch.no_grad():
        got = CD._launch(x, wk, bias32, 2, 1, "leaky", tiles=(variant, wt))
        ref = _single_rounding(conv, x, 1)
    _assert_rounds_once(got, ref)


def test_conv_down_planner_on_the_card_matches_plan_tiles(dev):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for c, n, hw in [(32, 64, 416), (64, 128, 208), (128, 256, 104), (256, 512, 52),
                     (512, 1024, 26), (32, 64, 608), (256, 512, 76), (512, 1024, 38)]:
        for b in (1, 8, 32):
            assert CD.plan_on_device(b, hw, hw, c, n) == CD.plan_tiles(b, hw, hw, c, n, sms=sms)


def test_conv_down_kernel_rejects_bad_operands(dev):
    conv, gen = _c1_conv(64, 128, 2, "leaky", dev)
    x = _c1_input(gen, 1, 64, 16, 16, dev)
    wk, bias32 = CD.k_major(conv.weight, conv.bias)
    before = CD.conv_down.launches
    with pytest.raises(TypeError):                 # fp32 input
        CD._launch(x.float(), wk, bias32, 2, 1, "leaky")
    with pytest.raises(ValueError, match="NHWC"):  # NCHW-contiguous, not NHWC
        CD._launch(x.contiguous(), wk, bias32, 2, 1, "leaky")
    with pytest.raises(ValueError):                # odd W
        CD._launch(x[..., :15].contiguous(memory_format=torch.channels_last), wk, bias32,
                   2, 1, "leaky")
    with pytest.raises(ValueError):                # C % 8 != 0
        conv12, _ = _c1_conv(12, 16, 2, "leaky", dev)
        CD.conv_down(_c1_input(gen, 1, 12, 16, 16, dev), conv12.weight, conv12.bias, 2, 1)
    with pytest.raises(ValueError):                # a down at stride 1
        CD._launch(x, wk, bias32, 1, 1, "leaky")
    stem, _ = _c1_conv(3, 32, 1, "leaky", dev)     # a stem of odd W
    with pytest.raises(ValueError, match="even W"):
        CD.conv_down(_c1_input(gen, 1, 3, 12, 13, dev), stem.weight, stem.bias, 1, 1)
    with pytest.raises(ValueError):                # padding 2
        CD._launch(x, wk, bias32, 2, 2, "leaky")
    with pytest.raises(ValueError):                # the stem's layout for a down
        CD._launch(x, wk.reshape(128, -1)[:, :32].contiguous(), bias32, 2, 1, "leaky")
    with pytest.raises(ValueError):                # no such activation
        CD._launch(x, wk, bias32, 2, 1, "relu")
    # the model sends every bf16 conv of a CUDA batch to the kernel, which
    # raises for one it does not take: no plain version runs in its place
    with pytest.raises(ValueError, match="even W"):
        conv(x[..., :15].contiguous(memory_format=torch.channels_last))
    s1, _ = _c1_conv(64, 128, 1, "leaky", dev)     # a stride-1 3x3 of 64 channels
    with pytest.raises(ValueError, match="stride 2"):
        s1(x)
    assert CD.conv_down.launches == before


@pytest.mark.parametrize("inference", [False, True], ids=["no_grad", "inference_mode"])
def test_conv_down_weight_layout_follows_in_place_writes(dev, inference):
    """The kernel's weight layout and float32 bias are made once, and a write
    to the weight or the bias in place shows in the next call's output, also
    under ``torch.inference_mode()``."""
    with torch.inference_mode(inference):
        conv, gen = _c1_conv(64, 128, 2, "leaky", dev)
        x = _c1_input(gen, 2, 64, 32, 32, dev)
        with torch.no_grad():
            before = conv(x)
            assert torch.equal(conv(x), before)
            conv.weight.mul_(-1)
            conv.bias.mul_(2)
            after = conv(x)
            fresh = D._ConvBias({"w": conv.weight.permute(2, 3, 1, 0).cpu(),
                                 "b": conv.bias.cpu()}, stride=2).to(dev)
            assert torch.equal(after, fresh(x))
            assert not torch.equal(after, before)


# ---------------------------------------------------------------------------
# The eval pipeline (yolo_v3_tpu_torch/eval/pipeline.py) on the card
# ---------------------------------------------------------------------------

def _results_rows(path):
    """{image_id: [n, 6] (category, x, y, w, h, score)} of a results json."""
    import json

    out = {}
    for e in json.load(open(path)):
        out.setdefault(e["image_id"], []).append([e["category_id"], *e["bbox"], e["score"]])
    return {k: np.array(v) for k, v in out.items()}


def _same_result_rows(a, b, box_atol=1e-2, score_atol=1e-4):
    """Every image's rows match one to one (same class, boxes within
    ``box_atol`` px, scores within ``score_atol``; order may differ where
    two scores tie)."""
    ra, rb = _results_rows(a), _results_rows(b)
    if sorted(ra) != sorted(rb):
        return False
    for k, want in rb.items():
        got = ra[k]
        if got.shape != want.shape:
            return False
        used = np.zeros(len(got), bool)
        for row in want:
            ok = ((got[:, 0] == row[0]) & ~used
                  & (np.abs(got[:, 1:5] - row[1:5]).max(1) <= box_atol)
                  & (np.abs(got[:, 5] - row[5]) <= score_atol))
            if not ok.any():
                return False
            used[np.argmax(ok)] = True
    return True


@pytest.mark.parametrize("precision", ["int8", "fp32"])
def test_eval_results_on_the_card_match_plain(dev, tmp_path, precision):
    """generate_results_file on the committed scenes (tests/data/torch_scenes,
    a small net: blocks (1,1,1,1,1), 80 classes, 96 px, batch 3 over 7
    images, so the last chunk is ragged), eval mode, letterboxed, images
    decoded by OpenCV (the card's host has no libjpeg for the native pool).
    On the kernels against the plain path on the card: int8 (uint8 feed)
    gives an identical results.json, fp32 the same rows.  Against the CPU's
    plain run: the same rows (int8 heads are bit-equal across the devices,
    but the decode's float math differs in the last bits: boxes up to 6e-5
    px apart at this size)."""
    import os
    import os.path as osp

    from yolo_v3_tpu_torch.detector import Detector
    from yolo_v3_tpu_torch.eval.pipeline import generate_results_file
    from yolo_v3_tpu_torch.utils.config import YoloConfig

    scenes = osp.join(osp.dirname(osp.abspath(__file__)), "data", "torch_scenes")
    img_dir = osp.join(scenes, "images")
    paths = sorted(osp.join(img_dir, n) for n in os.listdir(img_dir) if n.endswith(".jpg"))
    lst = tmp_path / "scenes.txt"
    lst.write_text("\n".join(paths[:7]) + "\n")
    names = [f"c{i}" for i in range(80)]
    cfg = YoloConfig(num_classes=80, img_dim=96, max_detections=24)
    gen = torch.Generator().manual_seed(0)
    params, state = D.init_yolonet(gen, 80, blocks=(1, 1, 1, 1, 1))
    kw = dict(precision=precision, resize_on_device=precision != "int8")
    cpu = Detector(params, state, cfg, device="cpu", **kw)
    card = (Detector(None, None, cfg, quantized_tree=cpu.qtree, device="cuda",
                     resize_on_device=False) if precision == "int8"
            else Detector(params, state, cfg, device="cuda", **kw))
    out = {}
    for name, det, plain in (("card", card, False), ("card_plain", card, True),
                             ("cpu", cpu, False)):
        out[name] = str(tmp_path / f"{name}.json")
        generate_results_file(det, str(lst), names, out[name], batch_size=3,
                              is_letterbox=True, progress=False, use_native_loader=False,
                              plain=plain)
    assert sum(len(v) for v in _results_rows(out["cpu"]).values()) > 0
    if precision == "int8":
        assert open(out["card"]).read() == open(out["card_plain"]).read()
    else:
        assert _same_result_rows(out["card"], out["card_plain"])
    assert _same_result_rows(out["card"], out["cpu"])


def test_step_timer_times_the_card_with_cuda_events(dev):
    """``utils/profiling.py::StepTimer`` on the card: CUDA events on the
    current stream, read after one synchronize; a step of 20 1024^3 matmuls
    takes device time, and a step that launches nothing next to none."""
    from yolo_v3_tpu_torch.utils.profiling import StepTimer

    a = torch.randn(1024, 1024, device=dev)
    timer = StepTimer(warmup=1)
    for _ in range(4):
        with timer.step(n_items=20):
            for _ in range(20):
                a = a @ a / 32
            timer.mark(a)
    with timer.step():
        pass
    times = timer.times
    assert len(times) == 5 and all(t > 0 for t in times[:4])
    assert times[4] < min(times[1:4])
    s = timer.summary()
    assert s["steps"] == 4 and s["items_per_sec"] > 0


# -- the batched letterbox (csrc/letterbox.cu) --------------------------------

LB_COCO_WH = ((640, 480), (480, 640), (640, 427), (500, 375), (640, 360), (427, 640))
LB_ODD_WH = ((37, 53), (1, 300), (300, 1), (2000, 20), (20, 2000), (80, 60), (417, 415),
             (7, 3), (1281, 721))


def _lb_images(sizes_wh, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for w, h in (sizes_wh[i % len(sizes_wh)] for i in range(n))]


def _lb_plain(images, dim, letterbox):
    return L.letterbox_batch_ref(*L.stage_batch(images, dim, letterbox, "cpu")[:2], dim)


@pytest.mark.parametrize("letterbox", [True, False], ids=["letterbox", "resize"])
@pytest.mark.parametrize("dim", [320, 416, 608])
@pytest.mark.parametrize("sizes,n", [(LB_COCO_WH, 32), (LB_ODD_WH, 9)], ids=["coco32", "odd"])
def test_letterbox_kernel_matches_plain(dev, sizes, n, dim, letterbox):
    """The kernel against the plain version on the CPU: max abs <= 2e-6 (a
    float32 summation order), the table and the sizes equal."""
    images = _lb_images(sizes, n, seed=dim)
    src, desc, org = L.stage_batch(images, dim, letterbox, dev)
    before = L.letterbox_batch.launches
    got = L.letterbox_batch(src, desc, dim)
    assert L.letterbox_batch.launches == before + 1
    csrc, cdesc, corg = L.stage_batch(images, dim, letterbox, "cpu")
    want = L.letterbox_batch_ref(csrc, cdesc, dim)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert got.shape == want.shape
    assert (got.cpu() - want).abs().max().item() <= 2e-6
    assert torch.equal(desc.cpu(), cdesc) and torch.equal(org.cpu(), corg)


def test_letterbox_kernel_rejects_bad_operands(dev):
    src, desc, _ = L.stage_batch(_lb_images(LB_COCO_WH, 2), 64, True, dev)
    before = L.letterbox_batch.launches
    with pytest.raises(TypeError, match="src"):
        L.letterbox_batch(src.float(), desc, 64)
    with pytest.raises(TypeError, match="desc"):
        L.letterbox_batch(src, desc.int(), 64)
    with pytest.raises(TypeError, match="desc"):
        L.letterbox_batch(src, desc[:, :6].contiguous(), 64)
    with pytest.raises(ValueError, match="one device"):
        L.letterbox_batch(src, desc.cpu(), 64)
    with pytest.raises(ValueError, match="contiguous"):
        L.letterbox_batch(src[::2], desc, 64)
    with pytest.raises(ValueError, match="dim"):
        L.letterbox_batch(src, desc, 0)
    with pytest.raises(ValueError, match="dim"):
        L.letterbox_batch(src, desc, L.MAX_DIM + 1)
    assert L.letterbox_batch.launches == before


def test_letterbox_kernel_bad_descriptor_rows_give_nan(dev):
    """A table row that does not fit the buffer or the output is not read:
    that image comes out NaN, the others as the plain version."""
    images = _lb_images(LB_COCO_WH, 3)
    src, desc, _ = L.stage_batch(images, 96, True, dev)
    bad = desc.clone()
    bad[1, 0] = src.numel()          # past the end of the packed images
    bad[2, 3] = 97                   # wider than the output
    got = L.letterbox_batch(src, bad, 96).cpu()
    assert torch.isnan(got[1]).all() and torch.isnan(got[2]).all()
    assert (got[0] - _lb_plain(images[:1], 96, True)[0]).abs().max().item() <= 2e-6


@pytest.fixture(scope="module")
def lb_det(dev):
    from yolo_v3_tpu_torch.detector import Detector
    from yolo_v3_tpu_torch.utils.config import YoloConfig

    params, state = D.init_yolonet(torch.Generator().manual_seed(0), 2, blocks=(1, 1, 1, 1, 1))
    return {lb: Detector(params, state, YoloConfig(num_classes=2, img_dim=96), device="cuda",
                         letterbox=lb) for lb in (True, False)}


@pytest.mark.parametrize("letterbox", [True, False], ids=["letterbox", "resize"])
def test_detect_launches_the_letterbox_once(lb_det, letterbox):
    """One launch a detect call, and a CUDA batch never takes the plain path."""
    det, images = lb_det[letterbox], _lb_images(LB_COCO_WH, 5)
    det.detect(images)
    before = L.letterbox_batch.launches
    for _ in range(3):
        det.detect(images)
    assert L.letterbox_batch.launches == before + 3
    x, org = det.preprocess(images)
    assert x.device.type == "cuda" and x.dtype == torch.float32 and x.shape == (5, 96, 96, 3)
    assert org.device.type == "cuda" and org.dtype == torch.float32
    assert org.cpu().tolist() == [[im.shape[1], im.shape[0]] for im in images]
    assert (x.cpu() - _lb_plain(images, 96, letterbox)).abs().max().item() <= 2e-6


def test_preprocess_makes_no_synchronising_call(dev, lb_det):
    det, images = lb_det[True], _lb_images(LB_COCO_WH, 6)
    det.preprocess(images)           # the kernel built, a pinned block cached
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):          # the mode sees a pageable upload
            torch.from_numpy(images[0]).to(dev)
        x, org = det.preprocess(images)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (x.cpu() - _lb_plain(images, 96, True)).abs().max().item() <= 2e-6


def test_back_to_back_preprocess_calls_keep_their_batches(dev, lb_det):
    """The second batch is staged while the first one's upload still waits
    behind a busy card: each call returns its own letterbox."""
    det = lb_det[True]
    first, second = _lb_images(LB_COCO_WH, 8, seed=5), _lb_images(LB_COCO_WH, 8, seed=6)
    det.preprocess(first)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)           # ~0.1 s of a spinning kernel ahead of the uploads
    xa, oa = det.preprocess(first)
    xb, ob = det.preprocess(second)
    assert (xa.cpu() - _lb_plain(first, 96, True)).abs().max().item() <= 2e-6
    assert (xb.cpu() - _lb_plain(second, 96, True)).abs().max().item() <= 2e-6


# ---------------------------------------------------------------------------
# The Mish epilogues (YOLOv4): the residual block at its CSP shapes, Cmid = C
# included, and the padded-2D kernel with each activation code
# ---------------------------------------------------------------------------

# (shape, Cmid): stage 0 (64 -> 32 -> 64 at 304^2) and stages 1-4 (Cmid = C)
# of YOLOv4-608, at batch 2 and, for the smallest grid, at the cell's 32
CSP_BLOCK_SHAPES = [
    ((2, 304, 304, 64), 32),
    ((2, 152, 152, 64), 64),
    ((2, 76, 76, 128), 128),
    ((2, 38, 38, 256), 256),
    ((2, 19, 19, 512), 512),
    ((32, 19, 19, 512), 512),
]


@pytest.mark.parametrize("shape,cmid", CSP_BLOCK_SHAPES,
                         ids=[f"{s[0]}x{s[1]}-{s[3]}-{m}" for s, m in CSP_BLOCK_SHAPES])
def test_bf16_mish_block_matches_plain(dev, shape, cmid):
    args = _block_inputs(shape, cmid, torch.bfloat16, dev)
    before = fused_res_block.launches
    got = fused_res_block(*args, act="mish")
    torch.cuda.synchronize()
    assert fused_res_block.launches == before + 1
    want = fused_res_block_ref(*args, act="mish")
    torch.testing.assert_close(got.float(), want.float(), **TOL[torch.bfloat16])
    # Mish, not leaky: the two differ by far more than the tolerance
    leaky = fused_res_block_ref(*args)
    assert (leaky.float() - want.float()).abs().max() > 0.1
    assert plan(*shape, cmid, torch.bfloat16, act="mish")["cluster"] >= 1


def test_mish_block_rejects_fp32(dev):
    args = _block_inputs((1, 16, 16, 64), 32, torch.float32, dev)
    with pytest.raises(ValueError, match="mish"):
        fused_res_block(*args, act="mish")


# (taps, H = W, C, N): YOLOv4-608's CSP split pair (one launch), transition
# and fuse at 152^2 and 19^2, and neck / head shapes
MISH_P2D_SHAPES = [
    (1, 304, 64, 128), (1, 152, 128, 128), (1, 152, 64, 64),
    (1, 19, 1024, 1024), (1, 19, 512, 512),
    (9, 38, 256, 512), (1, 76, 256, 255),
]


@pytest.mark.parametrize("act", ["mish", "leaky", "linear"])
@pytest.mark.parametrize("taps,hw,c,n", MISH_P2D_SHAPES,
                         ids=[f"{'3x3' if t == 9 else '1x1'}-{h}-{c}-{n}"
                              for t, h, c, n in MISH_P2D_SHAPES])
def test_bf16_conv_kernel_each_activation(dev, taps, hw, c, n, act):
    b = 2
    x2d, wt, s, bias, _ = _bf16_conv_inputs(b, hw, hw, c, n, taps, False, dev)
    _, hp, wp = FC.p2d_geometry(b, hw, hw)
    fn, ref = ((FC.conv1x1_p2d, FC.conv1x1_p2d_ref) if taps == 1
               else (FC.conv3x3_p2d, FC.conv3x3_p2d_ref))
    got = fn(x2d, wt, s, bias, hp, wp, act=act, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    want = ref(x2d, wt, s, bias, hp, wp, act=act, out_dtype=torch.bfloat16)
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)
    full = got.reshape(b, hw + 2, hw + 2, n).float()
    assert full[:, 0].abs().sum() == 0 and full[:, :, -1].abs().sum() == 0
    if act != "leaky":       # the code is the activation: none and Mish are not leaky
        other = ref(x2d, wt, s, bias, hp, wp, leaky=True, out_dtype=torch.bfloat16)
        assert (other.float() - want.float()).abs().max() > 0.05


def test_mish_conv_kernel_rejects_int8(dev):
    x2d, wt, s, bias, _ = _conv_inputs(1, 8, 8, 16, 16, 1, False, dev)
    _, hp, wp = FC.p2d_geometry(1, 8, 8)
    with pytest.raises(ValueError, match="mish"):
        FC.conv1x1_p2d(x2d, wt, s, bias, hp, wp, act="mish")


def test_yolov4_forward_runs_on_the_kernels(dev):
    """A bf16 YOLOv4 forward launches one Mish block per CSP block (23) and
    51 padded-2D convs (38 1x1: the split pairs, transitions and fuses, the
    neck's 1x1s and the dets; 13 3x3) and 8 conv_down (the stem, the 5 Mish
    downs and PANet's 2 stride-2 convs); its heads are within 5e-2 *
    max|head| of the plain path."""
    from yolo_v3_tpu_torch.models import yolov4 as Y4

    params, state = Y4.init_yolov4(torch.Generator().manual_seed(0), 2)
    model = Y4.YoloV4Folded(D.cast_params(D.fold_batchnorm(params, state),
                                          torch.bfloat16, dev)).eval()
    x = torch.rand(2, 128, 128, 3, generator=torch.Generator().manual_seed(1)).to(
        dev, torch.bfloat16)
    counters = (fused_res_block, FC.conv1x1_p2d, FC.conv3x3_p2d, CD.conv_down)
    before = [f.launches for f in counters]
    with torch.inference_mode():
        heads = model(x)
        torch.cuda.synchronize()
        assert [f.launches - b for f, b in zip(counters, before)] == [23, 38, 13, 8]
        plain = model(x, plain=True)
    for h, p in zip(heads, plain):
        assert h.dtype == torch.bfloat16 and h.shape == p.shape
        scale = p.float().abs().max().item()
        assert (h.float() - p.float()).abs().max().item() <= 5e-2 * scale
