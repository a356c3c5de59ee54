"""The bf16 stem and stride-2 conv kernel's CPU side (``ops/conv_down.py``):
which convs the model sends to the kernel, to its plain version or to the
float32 branch; the plain version as the chunked TF32 path it was; the
kernel's weight layouts and their cache; the tile planner; and an emulation
of the kernel's decomposition (pixel pairs, K slots per kernel row,
float32 promotions, tiles) against the conv.  The kernel itself runs in
``tests/test_torch_cuda_kernels.py`` on the card."""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolo_v3_tpu_torch.models import darknet as D
from yolo_v3_tpu_torch.ops import activations as A
from yolo_v3_tpu_torch.ops import conv_down as CD
from yolo_v3_tpu_torch.utils.precision import full_fp32, tf32_conv


def _conv(cin, cout, stride, act, seed=0, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin))
                         .astype(np.float32)).to(dtype)
    b = torch.from_numpy((rng.normal(size=cout) * 0.3).astype(np.float32)).to(dtype)
    return D._ConvBias({"w": w, "b": b}, stride=stride, act=act)


def _x(b, c, h, w, seed=1, dtype=torch.bfloat16):
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=(b, c, h, w))
                         .astype(np.float32)).to(dtype)
    return x.contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

class _FakeLib:
    """The C library's launcher, recording its arguments."""

    def __init__(self):
        self.calls = []

    def yolo_conv_down_bf16(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("x_shape,w_shape,stride,pad,want", [
    ((2, 3, 416, 416), (32, 3, 3, 3), 1, 1, True),         # the stem
    ((2, 3, 28, 51), (32, 3, 3, 3), 1, 1, False),          # a stem of odd W
    ((2, 32, 416, 416), (64, 32, 3, 3), 2, 1, True),       # down0
    ((2, 512, 27, 26), (1024, 512, 3, 3), 2, 1, True),     # odd H: any
    ((2, 128, 10, 38), (256, 128, 3, 3), 2, (0, 1), True),  # a stripe with its halo rows
    ((2, 64, 26, 27), (128, 64, 3, 3), 2, 1, False),       # odd W: no pixel pairs
    ((2, 12, 16, 16), (16, 12, 3, 3), 2, 1, False),        # C % 8 != 0
    ((2, 3, 32, 32), (32, 3, 3, 3), 2, 1, False),          # a 3-channel down
    ((2, 64, 32, 32), (128, 64, 3, 3), 1, 1, False),       # a stride-1 3x3 of 64 channels
    ((2, 64, 32, 32), (255, 64, 3, 3), 2, 1, False),       # N % 8 != 0
    ((2, 64, 32, 32), (128, 64, 3, 3), 2, 2, False),       # padding 2
], ids=["stem", "stem-odd-w", "down0", "odd-h", "stripe", "odd-w", "c12", "stem-s2", "s1",
        "n255", "pad2"])
def test_launcher_takes_the_stem_and_stride2_shapes(monkeypatch, x_shape, w_shape, stride,
                                                    pad, want):
    """The launcher's operand checks, which run before anything reaches the
    card: the stem and stride-2 downs it takes reach the C launcher with
    their geometry, every other conv raises and launches nothing."""
    lib = _FakeLib()
    monkeypatch.setattr(CD, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7})())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    b, c, h, w = x_shape
    n = w_shape[0]
    x = torch.zeros(x_shape, dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wk = torch.zeros((n, CD.STEM_K) if c == CD.STEM_CHANNELS else (n, 3, 3 * c),
                     dtype=torch.bfloat16)
    bias32 = torch.zeros(n)
    if not want:
        with pytest.raises(ValueError):
            CD._launch(x, wk, bias32, stride, pad, "leaky")
        assert not lib.calls
        return
    out = CD._launch(x, wk, bias32, stride, pad, "mish")
    pad_h = pad if isinstance(pad, int) else pad[0]
    ref = F.conv2d(torch.zeros(1, c, h, w), torch.zeros(w_shape), None, stride,
                   (pad_h, 1))
    assert out.shape == (b, n) + ref.shape[2:] and out.dtype == torch.bfloat16
    assert out.permute(0, 2, 3, 1).is_contiguous()
    (args,) = lib.calls
    assert args[4:] == (b, h, w, c, n, pad_h, A.CODES["mish"], 7)
    assert args[0] == x.data_ptr() and args[3] == out.data_ptr()


def test_cpu_tensors_run_the_plain_version_at_any_shape():
    """A CPU batch never reaches the kernel, whatever its shape: a stem of
    odd W, a down of 12 channels to 255 run the plain version."""
    for cin, cout, stride, shape in ((3, 32, 1, (1, 3, 6, 7)), (12, 255, 2, (1, 12, 8, 8))):
        conv = _conv(cin, cout, stride, "leaky")
        x = _x(*shape)
        want = CD.conv_down_ref(x, conv.weight, conv.bias, stride, 1, "leaky")
        assert torch.equal(conv(x), want)
        assert torch.equal(CD.conv_down(x, conv.weight, conv.bias, stride, 1), want)


def _spy(monkeypatch, name):
    calls = []
    real = getattr(CD, name)

    def spy(*args):
        calls.append(args)
        return real(*args) if name == "conv_down_ref" else torch.zeros(())

    monkeypatch.setattr(CD, name, spy)
    return calls


def test_dispatch_kernel_plain_and_float32(monkeypatch):
    """bf16 on a card: the kernel, with a channels_last input; ``plain=True``
    or a CPU tensor: the plain version; float32: neither."""
    ref_calls, kernel_calls = _spy(monkeypatch, "conv_down_ref"), _spy(monkeypatch, "conv_down")
    conv = _conv(64, 128, 2, "mish")
    x = _x(1, 64, 8, 8)
    conv(x)                                            # CPU: the plain version
    assert len(ref_calls) == 1 and not kernel_calls
    assert ref_calls[0][3:] == (2, 1, "mish")
    conv(x.contiguous().to("meta"))                    # off the CPU, NCHW-contiguous
    assert len(kernel_calls) == 1 and len(ref_calls) == 1
    xk = kernel_calls[0][0]
    assert xk.device.type == "meta" and xk.shape == x.shape
    assert xk.permute(0, 2, 3, 1).is_contiguous()
    assert kernel_calls[0][1] is conv.weight and kernel_calls[0][3:] == (2, 1, "mish")
    conv(x, plain=True)
    assert len(ref_calls) == 2 and len(kernel_calls) == 1
    f32 = _conv(64, 128, 2, "mish", dtype=torch.float32)
    y = f32(x.float())
    assert len(ref_calls) == 2 and len(kernel_calls) == 1
    want = F.mish(F.conv2d(x.float(), f32.weight, f32.bias, 2, 1))
    torch.testing.assert_close(y, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The plain version: the chunked TF32 path as it was
# ---------------------------------------------------------------------------

def _chunked(x, weight, bias, stride, pad, act):
    """The folded forward's bf16 stem / down before the kernel."""
    y = None
    with tf32_conv():
        for c in range(0, x.shape[1], 64):
            part = F.conv2d(x[:, c:c + 64].float(), weight[:, c:c + 64].float(), None,
                            stride, pad)
            y = part if y is None else y + part
    y = y + bias.float()[:, None, None]
    if act == "leaky":
        y = F.leaky_relu(y, 0.1)
    elif act == "mish":
        y = F.mish(y, inplace=True)
    return y.to(torch.bfloat16)


@pytest.mark.parametrize("act", ["leaky", "mish", "linear"])
@pytest.mark.parametrize("cin,cout,stride,pad", [(3, 32, 1, 1), (96, 16, 2, 1),
                                                 (160, 32, 2, (0, 1))],
                         ids=["stem", "down", "stripe"])
def test_plain_version_is_the_chunked_path(cin, cout, stride, pad, act):
    conv = _conv(cin, cout, stride, act)
    x = _x(2, cin, 13, 12)
    want = _chunked(x, conv.weight, conv.bias, stride, pad, act)
    got = CD.conv_down_ref(x, conv.weight, conv.bias, stride, pad, act)
    assert torch.equal(got, want)
    if pad == 1:
        assert torch.equal(conv(x), want) and torch.equal(conv(x, plain=True), want)
        assert torch.equal(CD.conv_down(x, conv.weight, conv.bias, stride, pad, act), want)


# ---------------------------------------------------------------------------
# Weight layouts
# ---------------------------------------------------------------------------

def test_kernel_weight_layouts():
    conv = _conv(3, 32, 1, "leaky")
    w = conv.weight                                    # OIHW
    stem = CD.kernel_weight(w)
    assert stem.shape == (32, CD.STEM_K) and (stem[:, 27:] == 0).all()
    for dy in range(3):
        for dx in range(3):
            for c in range(3):
                assert torch.equal(stem[:, (3 * dy + dx) * 3 + c], w[:, c, dy, dx])
    conv = _conv(40, 16, 2, "leaky")
    down = CD.kernel_weight(conv.weight)
    assert down.shape == (16, 3, 120) and down.is_contiguous()
    for dy in range(3):
        for j, dx in enumerate((1, 2, 0)):
            assert torch.equal(down[:, dy, 40 * j:40 * (j + 1)], conv.weight[:, :, dy, dx])


@pytest.mark.parametrize("inference", [False, True], ids=["no_grad", "inference_mode"])
def test_kernel_layout_follows_in_place_writes(inference):
    with torch.inference_mode(inference):
        conv = _conv(64, 16, 2, "leaky")
        first = CD.k_major(conv.weight, conv.bias)
        again = CD.k_major(conv.weight, conv.bias)
        assert all(a is b for a, b in zip(first, again)) != inference   # cached unless inference
        old = [t.clone() for t in first]
        with torch.no_grad():
            conv.weight.mul_(-1)
            conv.bias.add_(1)
        wk, b32 = CD.k_major(conv.weight, conv.bias)
    assert torch.equal(wk, -old[0]) and torch.equal(b32, conv.bias.float())
    assert b32.dtype == torch.float32 and not torch.equal(b32, old[1])


# ---------------------------------------------------------------------------
# The planner (csrc/conv_down.cu: tile_width, plan)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bm", [64, 128])
def test_tile_width_covers_with_the_fewest_pixels(bm):
    for ho in (1, 7, 13, 19, 26, 38, 52, 76, 104, 152, 208, 304):
        for wo in (ho, 1, 12, 13, 100):
            areas = {wt: -(-ho // (bm // wt)) * (bm // wt) * -(-wo // wt) * wt
                     for wt in (8, 16, 32, 64) if wt <= bm}
            best = min(areas.values())
            assert CD.tile_width(bm, ho, wo) == max(wt for wt, a in areas.items() if a == best)


# (batch, input H = W, C, N) -> (variant, tile width) as the card's planner
# picked them (chip_smoke.py phase 3b, batch 8; scripts/conv_down_sweep.py,
# batch 1, where the one-warpgroup shape 2 is planned)
PLANS = {(8, 416, 32, 64): (1, 16), (8, 208, 64, 128): (0, 16), (8, 104, 128, 256): (0, 64),
         (8, 52, 256, 512): (0, 32), (8, 26, 512, 1024): (0, 16), (8, 608, 32, 64): (1, 16),
         (8, 304, 64, 128): (0, 32), (8, 152, 128, 256): (0, 16), (8, 76, 256, 512): (0, 16),
         (8, 38, 512, 1024): (0, 32), (8, 76, 128, 256): (0, 16), (8, 38, 256, 512): (0, 32),
         (1, 416, 32, 64): (1, 16), (1, 208, 64, 128): (0, 16), (1, 104, 128, 256): (1, 64),
         (1, 52, 256, 512): (2, 32), (1, 26, 512, 1024): (2, 16), (1, 608, 32, 64): (1, 16),
         (1, 304, 64, 128): (1, 32), (1, 152, 128, 256): (0, 16), (1, 76, 256, 512): (1, 16),
         (1, 38, 512, 1024): (1, 32), (1, 76, 128, 256): (2, 8), (1, 38, 256, 512): (2, 8)}


@pytest.mark.parametrize("b,hw,c,n", list(PLANS),
                         ids=[f"{k[1]}-{k[2]}" if k[0] == 8 else f"b{k[0]}-{k[1]}-{k[2]}"
                              for k in PLANS])
def test_plan_tiles_is_the_cheapest(b, hw, c, n):
    assert CD.plan_tiles(b, hw, hw, c, n) == PLANS[(b, hw, c, n)]


@pytest.mark.parametrize("variant", range(len(CD.DOWN_TILES)))
@pytest.mark.parametrize("b,ho,wo", [(2, 13, 13), (1, 19, 7), (3, 8, 64), (1, 1, 1)])
def test_tiles_cover_every_output_pixel_once(variant, b, ho, wo):
    """The kernel's tile walk (origin, pix): every output pixel of every
    image is one tile row of one tile."""
    bm = 64 * CD.DOWN_TILES[variant][0]
    for wt in [w for w in CD.TILE_WIDTHS if w <= bm]:
        ht, shift = bm // wt, wt.bit_length() - 1
        th, tw = -(-ho // ht), -(-wo // wt)
        seen = []
        for mt in range(b * th * tw):
            img, r = mt // (th * tw), mt % (th * tw)
            oy0, ox0 = r // tw * ht, (r % tw) << shift
            for row in range(bm):
                oy, ox = oy0 + (row >> shift), ox0 + (row & (wt - 1))
                if oy < ho and ox < wo:
                    seen.append((img * ho + oy) * wo + ox)
        assert sorted(seen) == list(range(b * ho * wo))


# ---------------------------------------------------------------------------
# The kernel's decomposition, emulated
# ---------------------------------------------------------------------------

def _emulate_down(x, wk, pad_h, promote):
    """The down kernel's float32 sum of NHWC ``x`` [B, H, W, C] by the K-major
    ``wk`` [N, 3, 3C]: x as pixel pairs [B, H, W/2, 2C]; per kernel row dy the
    64-channel slots of pair ox (taps dx = 1, 2), then of the second pixel of
    pair ox - 1 (tap dx = 0), zeros outside (TMA's fill); the slot products
    summed in one accumulator, added into the sum every ``promote`` slots."""
    b, h, w, c = x.shape
    n = wk.shape[0]
    ho, wo = CD.output_hw(h, w, c, pad_h)
    pairs = F.pad(x.reshape(b, h, w // 2, 2 * c), (0, 64, 1, 0, 1, 1))   # [B, H+2, W/2+1, 2C+64]
    wkp = F.pad(wk, (0, 64))
    p1, kpd = -(-2 * c // 64), -(-2 * c // 64) + -(-c // 64)
    oy, ox = torch.arange(ho), torch.arange(wo)
    acc = torch.zeros(b, ho, wo, n)
    total = torch.zeros(b, ho, wo, n)
    run = 0
    for dy in range(3):
        iy = (2 * oy - pad_h + dy).clamp(-1, h) + 1                       # padded row
        for j in range(kpd):
            left = j >= p1
            xc, wc = (c + (j - p1) * 64, 2 * c + (j - p1) * 64) if left else (64 * j, 64 * j)
            px = ox - 1 + 1 if left else ox + 1                           # padded pair
            a = pairs[:, iy][:, :, px, xc:xc + 64]
            a = torch.where(torch.arange(64) + xc < 2 * c, a, torch.zeros(()))
            wslot = torch.where(torch.arange(64) + wc < 3 * c, wkp[:, dy, wc:wc + 64],
                                torch.zeros(()))
            acc = acc + a @ wslot.t()
            run += 1
            if run == promote or (dy == 2 and j == kpd - 1):
                total, acc, run = total + acc, torch.zeros_like(acc), 0
    return total


def _emulate_stem(x, wk, pad_h):
    """The stem's gathered A tile [pixels, 32] (K = (3 dy + dx) * 3 + c, zeros
    from 27) times the K-major weight."""
    b, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, pad_h, pad_h))
    ho = h + 2 * pad_h - 2
    cols = [xp[:, dy:dy + ho, dx:dx + w, c] for dy in range(3) for dx in range(3) for c in range(3)]
    a = torch.stack(cols + [torch.zeros(b, ho, w)] * (CD.STEM_K - 27), dim=-1)
    return a @ wk.t()


@pytest.mark.parametrize("cin,cout,h,w,pad_h", [
    (32, 64, 16, 16, 1), (64, 128, 13, 10, 1), (96, 16, 12, 12, 1), (40, 24, 9, 14, 0),
    (128, 32, 8, 8, 1)], ids=["c32", "c64-odd-h", "c96", "c40-stripe", "c128"])
@pytest.mark.parametrize("promote", [0, 1, CD.PROMOTE])
def test_down_decomposition_is_the_conv(cin, cout, h, w, pad_h, promote):
    conv = _conv(cin, cout, 2, "leaky")
    x = _x(2, cin, h, w).float()
    wk = CD.kernel_weight(conv.weight).float()
    got = _emulate_down(x.permute(0, 2, 3, 1).contiguous(), wk, pad_h, promote)
    with full_fp32():
        want = F.conv2d(x, conv.weight.float(), None, 2, (pad_h, 1)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pad_h", [1, 0])
def test_stem_decomposition_is_the_conv(pad_h):
    conv = _conv(3, 32, 1, "mish")
    x = _x(2, 3, 11, 14).float()
    got = _emulate_stem(x.permute(0, 2, 3, 1), CD.kernel_weight(conv.weight).float(), pad_h)
    with full_fp32():
        want = F.conv2d(x, conv.weight.float(), None, 1, (pad_h, 1)).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_output_geometry_matches_the_conv():
    for c, stride in ((3, 1), (32, 2)):
        for h, w, pad_h in ((416, 416, 1), (27, 52, 0), (28, 52, 0), (13, 26, 1)):
            y = F.conv2d(torch.zeros(1, c, h, w), torch.zeros(8, c, 3, 3), None, stride,
                         (pad_h, 1))
            assert CD.output_hw(h, w, c, pad_h) == tuple(y.shape[2:])


def test_mish_of_the_plain_version_is_the_activations_mish():
    y = torch.linspace(-25, 25, 4001)
    torch.testing.assert_close(CD.activate_(y.clone(), "mish"), A.mish(y), rtol=2e-6,
                               atol=1e-6)
    with pytest.raises(ValueError):
        CD.activate_(y, "relu")
