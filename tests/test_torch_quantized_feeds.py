"""The port's int8 feeds beyond the float image of an s2d tree
(``yolo_v3_tpu_torch/models/quantized.py``): the uint8 feed, trees without
space-to-depth, the per-layer int8 helpers, and the int8 ``Detector``'s
preprocess options, against the JAX package on the small net of
``tests/test_torch_quantized.py`` (blocks (1,1,1,1,1), 8 classes, 96 px).

Tolerances and why:
* forwards and helpers: bit-equal to the JAX functions run op by op (the
  port rounds every epilogue step, as the op-by-op JAX forward does; see
  ``tests/test_torch_quantized.py``);
* calibration statistics of a tree without s2d: rtol 1e-4 (float
  convolutions sum in another order);
* Detector rows, the JAX artifact served by both packages: the same rows and
  classes, boxes within 1e-2 px, probabilities within 1e-4 (the resize's
  float sums run in another order, and the frameworks' sigmoid and exp
  differ in the last bits).  The JAX side runs its ``detect_fn`` op by op on
  its Detector's preprocessed batch: jitted, it contracts the epilogues into
  FMAs, which moves int8 codes at rounding ties (on the plain-resize batch
  here by up to 0.27 of a head's logits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_v3_tpu.detector import Detector as JDetector
from yolo_v3_tpu.models import darknet as JD
from yolo_v3_tpu.models import quantized as JQ
from yolo_v3_tpu.ops import postprocess as JP
from yolo_v3_tpu.utils.config import YoloConfig as JConfig
from yolo_v3_tpu_torch.detector import Detector
from yolo_v3_tpu_torch.models import darknet as TD
from yolo_v3_tpu_torch.models import quantized as TQ
from yolo_v3_tpu_torch.models import weights as TW
from yolo_v3_tpu_torch.ops import fused_conv as FC
from yolo_v3_tpu_torch.ops.letterbox import letterbox_host
from yolo_v3_tpu_torch.utils.config import YoloConfig

NUM_CLASSES = 8
DIM = 96


@pytest.fixture(scope="module")
def setup():
    """tests/test_torch_quantized.py's net, quantized by JAX with and without
    the s2d entry."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.uniform(0, 1, (2, DIM, DIM, 3)).astype(np.float32))
    params, state = JD.init_yolonet(jax.random.PRNGKey(5), NUM_CLASSES,
                                    blocks=(1, 1, 1, 1, 1))
    _, ns = JD.apply_yolonet(params, state, x, training=True)

    def fix(old, new):
        if set(old.keys()) == {"mean", "var"}:
            mean = (np.asarray(new["mean"]) - 0.9 * np.asarray(old["mean"])) / 0.1
            var = (np.asarray(new["var"]) - 0.9 * np.asarray(old["var"])) / 0.1
            return {"mean": jnp.asarray(mean), "var": jnp.asarray(np.maximum(var, 1e-3))}
        return {k: fix(old[k], new[k]) for k in old}

    state = fix(state, ns)
    trees = {}
    for s2d in (True, False):
        folded = JD.fold_batchnorm(params, state)
        if s2d:
            folded = JD.fold_space_to_depth(folded)
        folded = jax.device_get(folded)
        stats = {k: np.asarray(v) for k, v in jax.jit(JQ.calibrate_yolonet)(folded, x).items()}
        trees[s2d] = JQ.quantize_yolonet(folded, stats)
    return dict(params=params, state=state, x=x, q=trees[True], q_plain=trees[False])


def _port(q):
    return TQ.qtree_from_numpy(jax.device_get(q))


def _assert_heads_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


def _u8(seed, b=2):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, DIM, DIM, 3), dtype=np.uint8)
    img[0, :8] = 0                                   # black and white bands,
    img[-1, -8:] = 255                               # the codes' two ends
    return img


# ---------------------------------------------------------------------------
# the uint8 feed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,b", [(0, 2), (1, 1)])
def test_u8_forward_matches_jax(setup, seed, b):
    """``u8 ^ 0x80`` as int8, the -128 pad, the 2x2 stem with stem4_u8's
    multipliers: bit-equal to ``apply_yolonet_quantized_u8`` (stem4_u8 over
    4x4 blocks, then down0_4)."""
    u8 = _u8(seed, b)
    want = JQ.apply_yolonet_quantized_u8(setup["q"], jnp.asarray(u8))
    model = TQ.YoloNetQuantized(_port(setup["q"]))
    with torch.no_grad():
        got = model(torch.from_numpy(u8))
        plain = model(torch.from_numpy(u8), plain=True)
    _assert_heads_equal(got, want)
    for a, p in zip(got, plain):
        assert torch.equal(a, p)


def test_stem4_u8_is_the_tile_the_entry_uses(setup):
    """stem4_u8's multiplier and bias are one 32-vector tiled over the 16
    positions of a 4x4 block; the entry's u8 stem takes its first 128 (the
    2x2 stem's channel order) with the 2x2 stem's weight codes, and gives
    the stem output of JAX's stem4_u8 conv after its repack, bit for bit,
    pad included."""
    tree = _port(setup["q"])
    s2d = tree["s2d"]
    m4, b4 = s2d["stem4_u8"]["m"], s2d["stem4_u8"]["b"]
    for v in (m4, b4):
        assert tuple(v.shape) == (512,)
        assert torch.equal(v.reshape(16, 32), v[:32].expand(16, 32))
    model = TQ.YoloNetQuantized(tree)
    assert torch.equal(model.stem_u8.m, m4[:128]) and torch.equal(model.stem_u8.b, b4[:128])
    assert torch.equal(model.stem_u8.w, s2d["stem"]["w"])
    # the same per-filter codes: the tile of the 2x2 stem's per-channel sums
    assert torch.equal(s2d["stem"]["w"].int().sum((0, 1, 2)).reshape(4, 32)[0],
                       s2d["stem4_u8"]["w"].int().sum((0, 1, 2))[:32])

    u8 = _u8(2)
    x_q = (torch.from_numpy(u8) ^ 0x80).view(torch.int8)
    xp = torch.nn.functional.pad(x_q, (0, 0, 1, 3, 1, 3), value=-128)
    got = FC.conv_i8_nhwc(TD._space_to_depth2(xp), s2d["stem"]["w"], m4[:128], b4[:128],
                          padding=((0, 0), (0, 0)))
    jxp = jnp.asarray(xp.numpy())
    y4 = JQ._conv_i8(setup["q"]["s2d"]["stem4_u8"], JD._space_to_depth4(jxp),
                     padding=((0, 0), (0, 0)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(JQ._repack_s2d4_to_s2d2(y4)))


# ---------------------------------------------------------------------------
# trees without s2d
# ---------------------------------------------------------------------------

def test_plain_tree_forward_matches_jax(setup):
    """Stem and stage 0's down as plain int8 convs, stage 0's block on the
    p2d path: bit-equal to ``apply_yolonet_quantized`` on the same tree."""
    x = setup["x"]
    want = JQ.apply_yolonet_quantized(setup["q_plain"], x)
    model = TQ.YoloNetQuantized(_port(setup["q_plain"]))
    assert model.num_res_blocks == 5 and not model.has_s2d
    with torch.no_grad():
        got = model(torch.from_numpy(np.array(x)))
        plain = model(torch.from_numpy(np.array(x)), plain=True)
    _assert_heads_equal(got, want)
    for a, p in zip(got, plain):
        assert torch.equal(a, p)
    with pytest.raises(ValueError, match="uint8 feed"):
        model(torch.zeros((1, DIM, DIM, 3), dtype=torch.uint8))


def test_build_quantized_without_s2d_matches_jax(setup):
    """The port's calibration of a tree without s2d: JAX's leaves, scales
    within rtol 1e-4, no "s2d" entry and a stage 0."""
    got = TQ.build_quantized(TW.params_from_numpy(jax.device_get(setup["params"])),
                             TW.params_from_numpy(jax.device_get(setup["state"])),
                             torch.from_numpy(np.array(setup["x"])), space_to_depth=False)
    names = []
    TQ._flatten_q(got, [], names, [], [])
    want = []
    TQ._flatten_q(setup["q_plain"], [], want, [], [])
    assert names == want and "s2d" not in got and "stage0" in got["backbone"]
    for k, v in setup["q_plain"]["scales"].items():
        assert got["scales"][k] == pytest.approx(v, rel=1e-4), k


# ---------------------------------------------------------------------------
# per-layer helpers
# ---------------------------------------------------------------------------

def test_weight_and_activation_quantizers_match_jax():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
    w[..., 3] = 0.0                                  # an all-zero filter: scale 1e-12
    wq, ws = TQ.quantize_weights_per_channel(torch.from_numpy(w))
    jwq, jws = JQ.quantize_weights_per_channel(jnp.asarray(w))
    assert wq.dtype == torch.int8 and ws.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))
    for amax in (3.7, 0.0):
        np.testing.assert_array_equal(TQ.activation_scale(amax).numpy(),
                                      np.asarray(JQ.activation_scale(amax)))
    x = rng.normal(0, 2, (2, 6, 6, 8)).astype(np.float32)
    s = TQ.activation_scale(2.5)
    np.testing.assert_array_equal(
        TQ.quantize_activation(torch.from_numpy(x), s).numpy(),
        np.asarray(JQ.quantize_activation(jnp.asarray(x), JQ.activation_scale(2.5))))
    np.testing.assert_array_equal(TQ.calibrate_absmax(torch.from_numpy(x)).numpy(),
                                  np.asarray(JQ.calibrate_absmax(jnp.asarray(x))))


@pytest.mark.parametrize("ks,stride,leaky,out", [
    (3, 1, True, "bf16"), (3, 2, True, "bf16"), (1, 1, False, "f32"), (3, 1, False, "f32")])
def test_conv_int8_bias_leaky_matches_jax(ks, stride, leaky, out):
    rng = np.random.default_rng(5)
    x_q = rng.integers(-127, 128, (2, 10, 12, 16), dtype=np.int8)
    w_q = rng.integers(-127, 128, (ks, ks, 16, 24), dtype=np.int8)
    w_s = rng.uniform(1e-3, 1e-2, 24).astype(np.float32)
    b = rng.normal(0, 1, 24).astype(np.float32)
    dtypes = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}
    td, jd = dtypes[out]
    got = TQ.conv_int8_bias_leaky(torch.from_numpy(x_q), torch.from_numpy(w_q),
                                  TQ.activation_scale(1.3), torch.from_numpy(w_s),
                                  torch.from_numpy(b), stride, leaky, out_dtype=td)
    want = JQ.conv_int8_bias_leaky(jnp.asarray(x_q), jnp.asarray(w_q), JQ.activation_scale(1.3),
                                   jnp.asarray(w_s), jnp.asarray(b), stride, leaky, out_dtype=jd)
    assert got.dtype == td and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantized_block_matches_jax(dtype):
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (2, 8, 8, 16)).astype(np.float32)
    p = {"w": rng.normal(0, 0.2, (3, 3, 16, 32)).astype(np.float32),
         "b": rng.normal(0, 0.1, 32).astype(np.float32)}
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    if dtype == "bf16":
        tx, jx = tx.bfloat16(), jx.astype(jnp.bfloat16)
    got = TQ.quantized_block(tx, {k: torch.from_numpy(v) for k, v in p.items()}, 3.1, stride=2)
    want = JQ.quantized_block(jx, {k: jnp.asarray(v) for k, v in p.items()}, 3.1, stride=2)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# the int8 Detector's preprocess options
# ---------------------------------------------------------------------------

def _images():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 255, (100, 140, 3), dtype=np.uint8),
            rng.integers(0, 255, (120, 90, 3), dtype=np.uint8)]


def _assert_rows_match(got, want, n_min=5):
    for g, w in zip(got, want):
        assert g.shape == w.shape and len(w) >= n_min
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g[:, 1:5], w[:, 1:5], rtol=0, atol=1e-2)
        np.testing.assert_allclose(g[:, 5:], w[:, 5:], rtol=0, atol=1e-4)


@pytest.mark.parametrize("letterbox,resize_on_device,is_eval", [
    (True, False, False), (False, False, False), (False, True, False),
    (True, False, True)])
def test_int8_detector_options_match_jax(setup, tmp_path, letterbox, resize_on_device,
                                         is_eval):
    """The JAX artifact served by both packages' Detectors.
    ``resize_on_device=False`` is the uint8 feed (OpenCV on the host), in
    both; ``letterbox=False`` resizes to the square input.  JAX's rows come
    from its ``detect_fn`` op by op (module doc)."""
    from yolo_v3_tpu.detector import detect_fn as jdetect_fn

    path = str(tmp_path / "q.npz")
    JQ.save_quantized(setup["q"], path)
    cfg = dict(num_classes=NUM_CLASSES, img_dim=DIM, max_detections=32)
    kw = dict(letterbox=letterbox, resize_on_device=resize_on_device)
    jdet = JDetector.from_quantized(path, JConfig(**cfg), **kw)
    det = Detector.from_quantized(path, YoloConfig(**cfg), device="cpu", **kw)
    assert det._u8_feed == jdet._u8_feed == (not resize_on_device)
    x, _ = det.preprocess(_images())
    assert x.dtype == (torch.uint8 if det._u8_feed else torch.float32)
    conf_thr, nms_thr = (0.1, 0.45) if is_eval else (0.3, 0.4)
    jx, org = jdet.preprocess(_images())
    res = jdetect_fn(jdet.params, jx, org, jdet.config, conf_thr, nms_thr, is_eval=is_eval,
                     is_letterbox=letterbox, compute_dtype=jnp.float32,
                     apply_fn=jdet._apply_fn)
    want = [r[:, [6, 0, 1, 2, 3, 5, 4]] for r in JP.detections_to_lists(res)]
    got = det.detect(_images(), conf_thr=conf_thr, is_eval=is_eval)
    _assert_rows_match(got, want)


def test_int8_calibrates_on_float_images_before_the_u8_feed(setup):
    """The JAX Detector preprocesses its calibration images before it turns
    the uint8 feed on, so an int8 Detector with ``resize_on_device=False``
    calibrates on the float host letterbox.  The port keeps that order: its
    tree is the one ``build_quantized`` makes from the float batch, its
    image scale that of [0, 1] images, and its scales JAX's within rtol
    1e-4; then it serves uint8."""
    params = TW.params_from_numpy(jax.device_get(setup["params"]))
    state = TW.params_from_numpy(jax.device_get(setup["state"]))
    cfg = dict(num_classes=NUM_CLASSES, img_dim=DIM)
    det = Detector(params, state, YoloConfig(**cfg), precision="int8", device="cpu",
                   resize_on_device=False, calib_images=_images())
    assert det._u8_feed
    calib = torch.from_numpy(np.stack([letterbox_host(im, (DIM, DIM)) for im in _images()]))
    want = TQ.build_quantized(params, state, calib)
    names, kinds, got_leaves, want_leaves = [], [], [], []
    TQ._flatten_q(det.qtree, [], names, kinds, got_leaves)
    TQ._flatten_q(want, [], [], [], want_leaves)
    for name, g, w in zip(names, got_leaves, want_leaves):
        np.testing.assert_array_equal(g, w, err_msg=str(name))
    assert det.qtree["scales"]["image"] < 1.0 / 100     # [0, 1] images, not 0..255
    jdet = JDetector(setup["params"], setup["state"], JConfig(**cfg), precision="int8",
                     resize_on_device=False, calib_images=_images())
    for k, v in jdet.params["scales"].items():
        assert det.qtree["scales"][k] == pytest.approx(v, rel=1e-4), k
    x, _ = det.preprocess(_images())
    assert x.dtype == torch.uint8
