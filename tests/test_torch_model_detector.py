"""The port's folded YOLOv3 forward and its Detector against the JAX package
on the same params (JAX ``init_yolonet``, bridged through numpy) and the same
uint8 images."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_v3_tpu.detector import Detector as JDetector
from yolo_v3_tpu.models import darknet as JD
from yolo_v3_tpu.utils.config import YoloConfig as JConfig
from yolo_v3_tpu_torch.detector import Detector
from yolo_v3_tpu_torch.models import darknet as TD
from yolo_v3_tpu_torch.models import quantized as Q
from yolo_v3_tpu_torch.models import weights as TW
from yolo_v3_tpu_torch.utils.config import YoloConfig

BLOCKS = (1, 1, 1, 1, 1)
CFG = dict(num_classes=2, img_dim=128, max_detections=32)


@pytest.fixture(scope="module")
def trees():
    """Small YOLOv3 params from the JAX init, with BN statistics and scales
    spread out and the detection convs scaled up, so activations keep their
    size through the net and detection scores spread well apart (random
    init with identity BN gives every candidate a score near 0.25)."""
    jp, js = JD.init_yolonet(jax.random.PRNGKey(0), num_classes=2, blocks=BLOCKS)
    p, s = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    rng = np.random.default_rng(0)

    def walk(pp, ss):
        if "bn" in pp:
            c = pp["bn"]["scale"].shape[0]
            pp["bn"]["scale"] = rng.uniform(1.5, 2.5, c).astype(np.float32)
            pp["bn"]["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
            ss["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            ss["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        elif "b" in pp:
            pp["w"] = pp["w"] * 8.0
        else:
            for k in pp:
                walk(pp[k], ss.get(k, {}))

    walk(p, s)
    return p, s


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 255, (100, 140, 3), dtype=np.uint8),
            rng.integers(0, 255, (120, 90, 3), dtype=np.uint8)]


def test_folded_forward_matches_jax(trees):
    p, s = trees
    x = np.random.default_rng(2).uniform(0, 1, (2, 96, 96, 3)).astype(np.float32)
    jf = JD.fold_batchnorm(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s))
    want = JD.apply_yolonet_folded(jf, jnp.asarray(x))
    model = TD.YoloNetFolded(TD.fold_batchnorm(TW.params_from_numpy(p),
                                               TW.params_from_numpy(s)))
    assert model.num_res_blocks == sum(BLOCKS)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def _bf16_heads_vs_jax(p, s, plain):
    """max |port - JAX| / max |JAX| per head, bf16 forward on both sides (the
    params folded in float32, then cast)."""
    x = np.random.default_rng(2).uniform(0, 1, (2, 96, 96, 3)).astype(np.float32)
    jf = JD.cast_params(JD.fold_batchnorm(jax.tree.map(jnp.asarray, p),
                                          jax.tree.map(jnp.asarray, s)), jnp.bfloat16)
    want = JD.apply_yolonet_folded(jf, jnp.asarray(x, jnp.bfloat16))
    model = TD.YoloNetFolded(TD.cast_params(
        TD.fold_batchnorm(TW.params_from_numpy(p), TW.params_from_numpy(s)), torch.bfloat16))
    with torch.no_grad():
        got = model(torch.from_numpy(x).bfloat16(), plain=plain)
    ratios = []
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        ratios.append(float(np.abs(g.float().numpy() - w).max() / np.abs(w).max()))
    return ratios


@pytest.mark.parametrize("plain", [True, False], ids=["plain", "wrappers"])
def test_bf16_heads_match_jax(trees, plain):
    """The port's bf16 forward against JAX ``apply_yolonet_folded`` in bf16:
    every head within 5e-2 * max|head| (the bf16 heads gate of
    chip_smoke.py).  On the CPU the wrappers run the plain versions, so both
    ids compute the same.  Measured (coarse head first): 6.2e-3, 1.08e-2,
    1.14e-2 with the head and up convs on the padded-2D kernels' single
    rounding point; 6.2e-3, 8.1e-3, 1.14e-2 with all 29 non-block convs on
    F.conv2d, which rounds conv + bias and then leaky again."""
    ratios = _bf16_heads_vs_jax(*trees, plain)
    print("bf16 heads, max|port - jax| / max|jax|:", ratios)
    assert max(ratios) <= 5e-2


@pytest.mark.parametrize("tf32", [True, False], ids=["tf32_on", "tf32_off"])
def test_fp32_forward_runs_without_tf32_and_restores_flags(trees, tf32):
    """An fp32 forward runs every cuDNN convolution with TF32 off, whatever
    the caller set, and gives the caller's flags back afterwards, also when
    the forward raises."""
    p, s = trees
    model = TD.YoloNetFolded(TD.fold_batchnorm(TW.params_from_numpy(p),
                                               TW.params_from_numpy(s)))
    cudnn = torch.backends.cudnn

    def flags():
        return (cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                torch.get_float32_matmul_precision())

    seen = []
    model.stem.register_forward_pre_hook(lambda m, a: seen.append(flags()))
    model.head2.det.register_forward_pre_hook(lambda m, a: seen.append(flags()))
    saved = flags()
    try:
        cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        before = flags()
        with torch.no_grad():
            model(torch.zeros(1, 64, 64, 3))
        assert seen == [(False, False, "highest")] * 2
        assert flags() == before
        with pytest.raises(RuntimeError):
            model(torch.zeros(1, 64, 64, 5))                 # 5 channels: conv raises
        assert flags() == before
    finally:
        cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[2])


def test_upsample_matches_jax():
    x = np.random.default_rng(3).normal(size=(2, 3, 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        TD.upsample2x_nearest(torch.from_numpy(x)).numpy(),
        np.asarray(JD.upsample2x_nearest(jnp.asarray(x))))


def test_detect_matches_jax_detector(trees, images):
    """Same rows and classes; boxes within 1e-2 px, probabilities within
    1e-4.  The JAX detector runs its s2d entry, an exact re-expression of
    the same convolutions, so only summation order differs."""
    p, s = trees
    jdet = JDetector(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s),
                     JConfig(**CFG), precision="fp32")
    tdet = Detector(TW.params_from_numpy(p), TW.params_from_numpy(s),
                    YoloConfig(**CFG), precision="fp32", device="cpu")
    want = jdet.detect(images, conf_thr=0.7)
    got = tdet.detect(images, conf_thr=0.7)
    for g, w in zip(got, want):
        assert g.shape == w.shape and len(w) >= 10
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g[:, 1:5], w[:, 1:5], rtol=0, atol=1e-2)
        np.testing.assert_allclose(g[:, 5:], w[:, 5:], rtol=0, atol=1e-4)


def test_detector_from_checkpoint_and_bf16(trees, images, tmp_path):
    p, s = trees
    path = str(tmp_path / "ckpt.npz")
    TW.save_pytree({"params": TW.params_from_numpy(p),
                    "state": TW.params_from_numpy(s)}, path)
    det = Detector.from_checkpoint(path, YoloConfig(**CFG), precision="fp32",
                                   device="cpu")
    ref = Detector(TW.params_from_numpy(p), TW.params_from_numpy(s),
                   YoloConfig(**CFG), precision="fp32", device="cpu")
    for a, b in zip(det.detect(images, conf_thr=0.7), ref.detect(images, conf_thr=0.7)):
        np.testing.assert_array_equal(a, b)
    bf = Detector.from_checkpoint(path, YoloConfig(**CFG), precision="bf16",
                                  device="cpu")
    assert bf.model.stem.weight.dtype == torch.bfloat16
    for rows, im in zip(bf.detect(images, conf_thr=0.7), images):
        assert rows.ndim == 2 and rows.shape[1] == 7 and np.isfinite(rows).all()
        assert np.all(rows[:, 1] >= -1e-3) and np.all(rows[:, 2] >= -1e-3)
        assert np.all(rows[:, 1] + rows[:, 3] <= im.shape[1] + 1e-2)
        assert np.all(rows[:, 2] + rows[:, 4] <= im.shape[0] + 1e-2)


def test_int8_precision_raises(trees):
    """int8 is served now (tests/test_torch_quantized.py), trees without s2d
    too (tests/test_torch_quantized_feeds.py); an unknown precision, or an
    int8 tree whose backbone skips a stage, still raises."""
    p, s = trees
    with pytest.raises(ValueError, match="precision"):
        Detector(TW.params_from_numpy(p), TW.params_from_numpy(s),
                 YoloConfig(**CFG), precision="int4", device="cpu")
    cfg = YoloConfig(**CFG)
    tree = Q.build_quantized(TW.params_from_numpy(p), TW.params_from_numpy(s),
                             torch.zeros((1, 64, 64, 3)), space_to_depth=False)
    del tree["backbone"]["stage1"]
    with pytest.raises(ValueError, match="stages"):
        Detector(None, None, cfg, quantized_tree=tree, device="cpu")


def test_detector_defaults_to_the_card(trees):
    """A Detector built without ``device`` serves on the card where there is
    one; without one it fails with PyTorch's own error and never falls back
    to the CPU.  Decided here, not at import."""
    p, s = trees

    def build():
        return Detector(TW.params_from_numpy(p), TW.params_from_numpy(s),
                        YoloConfig(**CFG), precision="fp32")

    if torch.cuda.is_available():
        det = build()
        assert det.device.type == "cuda"
        assert det.model.stem.weight.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            build()
