"""The int8 mode of the padded-2D conv kernel (``csrc/conv_p2d.cu``,
``conv_p2d_kernel`` with ``I8In``) emulated on the CPU, with the
emulation of ``tests/test_torch_fused_conv.py``: per tile of the planner's
shape, ring slots of 128 int8 channels, the 3x3's BM + 2-row A box shared by
the three taps of a kernel row, the 3-D weight boxes, TMA's zero fill, and
the channel padding to 16 (``pad_channels``).  Held to the plain version
and to the Pallas kernels in interpret mode, at every padded-2D conv shape
of the int8 forward (batch 1) and at the edges; and the int8 planner's
tests beside the bf16 ones.  On the card the kernel itself is held to the
plain version (``tests/test_torch_cuda_kernels.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_conv import _check_planner_coverage, _inputs, _kernel_acc, _np
from yolo_v3_tpu.ops import fused_conv as JF
from yolo_v3_tpu_torch.ops import fused_conv as TF

# every (taps, H = W, C, N, residual, out) of the int8 forward's padded-2D
# convs at YOLOv3-416 (chip_smoke.py's INT8_CONVS): residual-block conv1 and
# conv2, head 1x1s and 3x3s, the dets (bf16 out, no leaky) and the ups
INT8_FORWARD_SHAPES = [
    (1, 104, 128, 64, False, "i8"), (1, 52, 256, 128, False, "i8"),
    (1, 26, 512, 256, False, "i8"), (1, 13, 1024, 512, False, "i8"),
    (9, 104, 64, 128, True, "i8"), (9, 52, 128, 256, True, "i8"),
    (9, 26, 256, 512, True, "i8"), (9, 13, 512, 1024, True, "i8"),
    (9, 13, 512, 1024, False, "i8"), (9, 26, 256, 512, False, "i8"),
    (9, 52, 128, 256, False, "i8"),
    (1, 26, 768, 256, False, "i8"), (1, 52, 384, 128, False, "i8"),
    (1, 13, 1024, 255, False, "bf16"), (1, 26, 512, 255, False, "bf16"),
    (1, 52, 256, 255, False, "bf16"),
    (1, 13, 512, 256, False, "i8"), (1, 26, 256, 128, False, "i8"),
]


def _pallas(taps, x, wt, scale, bias, hp, wp, **kw):
    """The Pallas kernel in interpret mode on the packed ``x``, as float32."""
    jfn = JF.conv1x1_p2d if taps == 1 else JF.conv3x3_p2d
    x2d = JF.pack_p2d(jnp.asarray(x))
    if kw.get("residual") is not None:
        kw["residual"] = jnp.asarray(kw["residual"])
    out = jfn(x2d, jnp.asarray(wt), jnp.asarray(scale), jnp.asarray(bias), hp, wp,
              tile_m=JF.pick_tile_m(x2d.shape[0], 256), tile_n=wt.shape[-1], interpret=True,
              **kw)
    return np.asarray(out, np.float32)


def _check_int8_emulation(rng, b, h, w, c, n, taps, variant, residual, out):
    """The int8 emulation at the JAX int8 suite's inputs (x, w in [-20, 20),
    the residual over the whole int8 range): its int32 accumulator
    bit-equal to the Pallas kernel's in interpret mode (scale 1, bias 0, no
    leaky, float32 out: exact, the sums stay below 2^24), and its output
    bit-equal to the plain version's.  The epilogue itself is held to
    Pallas's bit for bit at the JAX suite's shapes
    (``tests/test_torch_fused_conv.py``); at these larger ones XLA's FMA
    contraction in the jitted interpret can move a rounding tie (ROADMAP C,
    "The jitted JAX int8 forward is not the op-by-op one")."""
    x, wt, scale, bias = _inputs(rng, b, h, w, c, n, taps)
    r, hp, wp = TF.p2d_geometry(b, h, w)
    t = torch.from_numpy
    x2d = TF.pack_p2d(t(x))
    out_dtype = torch.int8 if out == "i8" else torch.bfloat16
    res = rng.integers(-127, 128, (r, n), dtype=np.int8) if residual else None
    kw = dict(leaky=out == "i8", residual=None if res is None else t(res),
              res_scale=0.7 if residual else 1.0)

    ones, zeros = np.ones(n, np.float32), np.zeros(n, np.float32)
    with torch.inference_mode(False):
        acc = _kernel_acc(x2d, t(wt), wp, taps, variant)
    valid = TF.border_mask(r, hp, wp, x2d.device)[:, None]
    np.testing.assert_array_equal(
        torch.where(valid, acc, 0).float().numpy(),
        _pallas(taps, x, wt, ones, zeros, hp, wp, leaky=False, out_dtype=jnp.float32))
    got = TF.epilogue_ref(acc, t(scale), t(bias), valid=valid, out_dtype=out_dtype, **kw)
    ref = TF.conv3x3_p2d_ref if taps == 9 else TF.conv1x1_p2d_ref
    assert got.dtype == out_dtype
    assert torch.equal(got, ref(x2d, t(wt), t(scale), t(bias), hp, wp, out_dtype=out_dtype,
                                **kw))
    assert (_np(got) != 0).any()


@pytest.mark.parametrize("taps,hw,c,n,residual,out", INT8_FORWARD_SHAPES,
                         ids=[f"{'3x3' if t == 9 else '1x1'}-{h}-{c}-{n}{'-res' if r else ''}"
                              f"-{o}" for t, h, c, n, r, o in INT8_FORWARD_SHAPES])
def test_int8_kernel_emulation_at_forward_shapes(rng, taps, hw, c, n, residual, out):
    """Every padded-2D conv of the int8 forward at batch 1, with the tile
    shape the planner picks for that geometry."""
    r, _, _ = TF.p2d_geometry(1, hw, hw)
    _check_int8_emulation(rng, 1, hw, hw, c, n, taps,
                          TF.plan_tiles(r, c, n, taps, torch.int8), residual, out)


# stage 0's residual block in a quantized tree without space-to-depth:
# 208^2, conv1 C 64 -> N 32, conv2 C 32 -> N 64 (32-byte rows, N = 32 below
# either tile's width)
STAGE0_SHAPES = [(1, 208, 64, 32, False, "i8"), (9, 208, 32, 64, True, "i8")]


@pytest.mark.parametrize("taps,hw,c,n,residual,out", STAGE0_SHAPES,
                         ids=["1x1-208-64-32", "3x3-208-32-64-res"])
def test_int8_kernel_emulation_at_stage0_of_a_tree_without_s2d(rng, taps, hw, c, n,
                                                               residual, out):
    """The stage-0 convs at batch 1 with the planner's tile: C = 32 needs
    no channel padding (16-byte rows) and fills a quarter of a 128-channel
    slot, N = 32 half of a 64-wide tile (the weight box zero-fills the rest
    and the epilogue stores N columns); the planner covers them at batch 1
    and 8 within the shared memory."""
    r, _, _ = TF.p2d_geometry(1, hw, hw)
    x2d = torch.zeros((r, c), dtype=torch.int8)
    wt = torch.zeros((n, taps * c), dtype=torch.int8)
    assert TF.pad_channels(x2d, wt, taps)[0] is x2d
    _check_int8_emulation(rng, 1, hw, hw, c, n, taps,
                          TF.plan_tiles(r, c, n, taps, torch.int8), residual, out)
    for batch in (1, 8):
        _check_planner_coverage([(taps, hw, c, n)], torch.int8, batch)


@pytest.mark.parametrize("variant", range(len(TF.P2D_TILES)))
@pytest.mark.parametrize("b,h,w,c,n,taps,residual,out", [
    (3, 11, 9, 40, 36, 9, True, "i8"),     # C = 40: padded to 48; N = 36 (36-byte rows)
    (1, 5, 7, 4, 8, 9, False, "i8"),       # C = 4: padded to 16; R = 63 ragged
    (2, 8, 8, 144, 255, 9, True, "bf16"),  # C = 144: a second, mostly empty K slot; N = 255
    (1, 3, 3, 16, 24, 9, True, "i8"),      # R = 25, below one tile: taps from row -6 on
    (4, 1, 1, 16, 24, 9, False, "bf16"),   # hp = wp = 3: 9 rows an image
    (1, 5, 7, 40, 255, 1, True, "bf16"),   # the 1x1 through the padding, N = 255
    (2, 6, 6, 4, 36, 1, False, "i8"),
])
def test_int8_kernel_emulation_edges(rng, variant, b, h, w, c, n, taps, residual, out):
    """The channel padding (C % 16 != 0), the channel tail of a 128-channel
    slot, the N edge, R below one tile and taps outside [0, R), with and
    without residual, int8 and bf16 out, with every tile shape of
    P2D_TILES."""
    _check_int8_emulation(rng, b, h, w, c, n, taps, variant, residual, out)


def test_pad_channels_pads_int8_to_16_only():
    """int8 channels to the next multiple of 16 (x2d and each tap of the
    K-major weight, zeros after the channels); bf16 and C % 16 == 0 as they
    are."""
    x2d = torch.arange(5 * 40, dtype=torch.int8).reshape(5, 40)
    wt = torch.arange(3 * 9 * 40, dtype=torch.int8).reshape(3, 9 * 40)
    xp, wp = TF.pad_channels(x2d, wt, 9)
    assert xp.shape == (5, 48) and wp.shape == (3, 9 * 48)
    assert torch.equal(xp[:, :40], x2d) and not xp[:, 40:].any()
    wp3 = wp.view(3, 9, 48)
    assert torch.equal(wp3[..., :40], wt.view(3, 9, 40)) and not wp3[..., 40:].any()
    for a, b in ((x2d[:, :32].contiguous(), wt.view(3, 9, 40)[..., :32].reshape(3, -1)),
                 (x2d.bfloat16(), wt.bfloat16())):
        got = TF.pad_channels(a, b, 9)
        assert got[0] is a and got[1] is b


@pytest.mark.parametrize("batch", [1, 8])
def test_int8_planner_covers_output_and_fits_shared_memory(batch):
    """The same for every padded-2D conv of the int8 forward."""
    _check_planner_coverage([s[:4] for s in INT8_FORWARD_SHAPES], torch.int8, batch)


def test_int8_planner_picks_the_cheapest_tiles():
    """plan_tiles is the argmin of tiles_cost for int8 input too (the same
    slot bytes as bf16, twice the MACs a slot at twice the tensor cores'
    rate).  At batch 8 it takes the large tile (128 x 128, one block an SM)
    for the 13^2 and 52^2 3x3s and the 26^2 1x1 to N = 256, and the small
    one (64 x 64, two blocks an SM) for the 13^2, 52^2 and 104^2 1x1s and
    the 26^2 and 104^2 3x3s: at each, the faster of the two in
    scripts/p2d_tile_sweep.py on an H100 (PERF.md)."""
    i8 = torch.int8
    for taps, hw, c, n, _, _ in INT8_FORWARD_SHAPES:
        r, _, _ = TF.p2d_geometry(8, hw, hw)
        costs = [TF.tiles_cost(v, r, c, n, taps, 132, i8) for v in range(len(TF.P2D_TILES))]
        assert TF.plan_tiles(r, c, n, taps, i8) == costs.index(min(costs))
    big, small = 0, 1
    for (taps, hw, c, n), want in (((9, 13, 512, 1024), big), ((9, 52, 128, 256), big),
                                   ((1, 26, 512, 256), big), ((1, 13, 1024, 512), small),
                                   ((1, 104, 128, 64), small), ((1, 52, 256, 128), small),
                                   ((9, 26, 256, 512), small), ((9, 104, 64, 128), small)):
        assert TF.plan_tiles(TF.p2d_geometry(8, hw, hw)[0], c, n, taps, i8) == want
