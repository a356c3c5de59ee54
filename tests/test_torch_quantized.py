"""The port's int8 serving module (``yolo_v3_tpu_torch/models/quantized.py``)
and the space-to-depth folds of its ``models/darknet.py`` against the JAX
package, on the small realistic net of ``tests/test_quantized_net.py``
(blocks (1,1,1,1,1), 8 classes, 96 px, BN statistics set to batch
statistics).

Tolerances and why:
* folds, quantization and the artifact: bit-equal (the same numpy math);
* calibration statistics: rtol 1e-4 (float convolutions sum in another
  order in the two frameworks);
* the int8 forward: bit-equal to ``apply_yolonet_quantized`` run op by op.
  Under ``jax.jit`` XLA on the CPU contracts each epilogue's ``acc * m + b``
  into a fused multiply-add, which flips rounding ties of the requantized
  activations; on this net that moves about half of the head values of the
  jitted JAX forward (by up to ~0.11 of max |head|).  The port rounds every
  step, as the op-by-op forward and the CUDA kernels do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_v3_tpu.models import darknet as JD
from yolo_v3_tpu.models import quantized as JQ
from yolo_v3_tpu_torch.models import darknet as TD
from yolo_v3_tpu_torch.models import quantized as TQ
from yolo_v3_tpu_torch.models import weights as TW

NUM_CLASSES = 8
DIM = 96


@pytest.fixture(scope="module")
def setup():
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
    folded = jax.device_get(JD.fold_space_to_depth(JD.fold_batchnorm(params, state)))
    stats = {k: np.asarray(v) for k, v in jax.jit(JQ.calibrate_yolonet)(folded, x).items()}
    q = JQ.quantize_yolonet(folded, stats)
    return dict(params=params, state=state, x=x, folded=folded, stats=stats, q=q)


def _leaves(q):
    names, kinds, arrays = [], [], []
    TQ._flatten_q(q, [], names, kinds, arrays)
    return names, kinds, arrays


def _assert_same_tree(a, b):
    na, ka, aa = _leaves(a)
    nb, kb, ab = _leaves(b)
    assert na == nb and ka == kb
    for name, x, y in zip(na, aa, ab):
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=str(name))


# ---------------------------------------------------------------------------
# space-to-depth folds (models/darknet.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fold,shape", [
    ("_s2d_1x1_weights", (1, 1, 8, 16)),
    ("_s2d_3x3_s1_weights", (3, 3, 8, 16)),
    ("_s2d_3x3_s2_weights", (3, 3, 8, 16)),
    ("_s2d_3x3_s2_exit_weights", (3, 3, 8, 16)),
    ("_s2d_stem_weights", (3, 3, 3, 32)),
    ("_down0_4_weights", (3, 3, 32, 64)),
    ("_stem4_weights", (3, 3, 3, 32)),
])
def test_s2d_weight_folds_match_jax(rng, fold, shape):
    w = rng.normal(size=shape).astype(np.float32)
    args = (w,)
    if fold == "_stem4_weights":
        args = (w, rng.normal(size=shape[-1]).astype(np.float32))
    want = getattr(JD, fold)(*args)
    got = getattr(TD, fold)(*(torch.from_numpy(a) for a in args))
    for g, wv in zip(got if isinstance(got, tuple) else (got,),
                     want if isinstance(want, tuple) else (want,)):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, np.asarray(wv))


@pytest.mark.parametrize("k", [2, 4])
def test_space_to_depth_matches_jax(rng, k):
    x = rng.normal(size=(2, 4 * k, 2 * k, 3)).astype(np.float32)
    jfn, tfn = ((JD._space_to_depth2, TD._space_to_depth2) if k == 2
                else (JD._space_to_depth4, TD._space_to_depth4))
    np.testing.assert_array_equal(tfn(torch.from_numpy(x)).numpy(),
                                  np.asarray(jfn(jnp.asarray(x))))


def test_fold_space_to_depth_matches_jax(setup):
    folded = JD.fold_batchnorm(setup["params"], setup["state"])
    want = jax.device_get(JD.fold_space_to_depth(folded))["s2d"]
    got = TD.fold_space_to_depth(TW.params_from_numpy(jax.device_get(folded)))["s2d"]
    assert set(got) == set(want)
    for name in want:
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(got[name][leaf].numpy(),
                                          np.asarray(want[name][leaf]), err_msg=name)


# ---------------------------------------------------------------------------
# calibration and quantization
# ---------------------------------------------------------------------------

def test_quantize_yolonet_matches_jax(setup):
    """Same folded params and statistics: the same tree, leaf for leaf."""
    got = TQ.quantize_yolonet(TW.params_from_numpy(setup["folded"]), setup["stats"])
    _assert_same_tree(got, setup["q"])
    assert isinstance(got["route_scales"], tuple)
    assert isinstance(got["backbone"]["stage2"]["res0"]["res_scale"], float)
    assert all(isinstance(v, float) for v in got["scales"].values())


def test_calibrate_matches_jax(setup):
    folded = TD.fold_space_to_depth(TD.fold_batchnorm(
        TW.params_from_numpy(jax.device_get(setup["params"])),
        TW.params_from_numpy(jax.device_get(setup["state"]))))
    with torch.no_grad():
        got = TQ.calibrate_yolonet(folded, torch.from_numpy(np.array(setup["x"])))
    want = setup["stats"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=k)


def test_build_quantized_tree_matches_jax_structure(setup):
    got = TQ.build_quantized(TW.params_from_numpy(jax.device_get(setup["params"])),
                             TW.params_from_numpy(jax.device_get(setup["state"])),
                             torch.from_numpy(np.array(setup["x"])))
    n_got, k_got, _ = _leaves(got)
    n_want, k_want, _ = _leaves(setup["q"])
    assert n_got == n_want and k_got == k_want
    for k, v in setup["q"]["scales"].items():
        assert got["scales"][k] == pytest.approx(v, rel=1e-4), k
    assert got["backbone"]["stage1"]["res0"]["conv1"]["w"].dtype == torch.int8


def test_quantize_image_and_requant_match_jax(rng):
    x = rng.uniform(-0.2, 1.2, (2, 8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        TQ.quantize_image(torch.from_numpy(x), 0.0071).numpy(),
        np.asarray(JQ.quantize_image(jnp.asarray(x), 0.0071)))
    q = rng.integers(-127, 128, (64, 9), dtype=np.int8)
    np.testing.assert_array_equal(
        TQ._requant(torch.from_numpy(q), 0.031, 0.047).numpy(),
        np.asarray(JQ._requant(jnp.asarray(q), 0.031, 0.047)))


# ---------------------------------------------------------------------------
# the serving artifact
# ---------------------------------------------------------------------------

def test_jax_artifact_loads_in_port(setup, tmp_path):
    path = str(tmp_path / "jax_q.npz")
    JQ.save_quantized(setup["q"], path, meta={"num_classes": NUM_CLASSES})
    assert TQ.is_quantized_file(path)
    got = TQ.load_quantized(path)
    _assert_same_tree(got, setup["q"])
    assert isinstance(got["route_scales"], tuple)
    assert isinstance(got["scales"]["image"], float)
    assert got["scales"] == setup["q"]["scales"]
    assert isinstance(got["s2d"]["stem"]["w"], torch.Tensor)


def test_port_artifact_loads_in_jax(setup, tmp_path):
    tree = TQ.qtree_from_numpy(jax.device_get(setup["q"]))
    path = str(tmp_path / "port_q.npz")
    TQ.save_quantized(tree, path, meta={"num_classes": NUM_CLASSES})
    assert JQ.is_quantized_file(path)
    back = JQ.load_quantized(path)
    _assert_same_tree(jax.device_get(back), setup["q"])
    assert isinstance(back["route_scales"], tuple)
    assert back["scales"] == setup["q"]["scales"]


def test_load_rejects_plain_npz(setup, tmp_path):
    path = str(tmp_path / "plain.npz")
    TW.save_pytree({"params": TW.params_from_numpy(jax.device_get(setup["params"]))}, path)
    assert not TQ.is_quantized_file(path)
    with pytest.raises(ValueError, match="not a quantized"):
        TQ.load_quantized(path)


def test_qtree_from_numpy_keeps_leaf_kinds(setup):
    tree = TQ.qtree_from_numpy(jax.device_get(setup["q"]))
    _assert_same_tree(tree, setup["q"])
    assert tree["s2d"]["down0"]["m"].dtype == torch.float32
    assert isinstance(tree["backbone"]["stage3"]["res0"]["res_scale"], float)
    assert isinstance(tree["route_scales"], tuple) and len(tree["route_scales"]) == 3


# ---------------------------------------------------------------------------
# the quantized forward
# ---------------------------------------------------------------------------

def test_quantized_forward_matches_jax(setup):
    q, x = setup["q"], setup["x"]
    want = JQ.apply_yolonet_quantized(q, x)           # op by op, see module doc
    model = TQ.YoloNetQuantized(TQ.qtree_from_numpy(jax.device_get(q)))
    assert model.num_res_blocks == 4                  # stages 1-4; stage 0 is the entry
    with torch.no_grad():
        got = model(torch.from_numpy(np.array(x)))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


def test_quantized_forward_plain_switch(setup):
    """On the CPU both implementations are the plain versions: same heads."""
    model = TQ.YoloNetQuantized(TQ.qtree_from_numpy(jax.device_get(setup["q"])))
    x = torch.from_numpy(np.array(setup["x"]))
    with torch.no_grad():
        for a, b in zip(model(x), model(x, plain=True)):
            assert torch.equal(a, b)


def test_quantized_forward_refuses_unported_feeds(setup):
    """The uint8 feed and trees without s2d are served now
    (tests/test_torch_quantized_feeds.py).  What the port still refuses:
    the uint8 feed on a tree without ``stem4_u8`` (as JAX needs it too), and
    a ``stem4_u8`` that is not the stem tiled over the 4x4 block, which the
    entry's 2x2 stem could not stand in for."""
    tree = TQ.qtree_from_numpy(jax.device_get(setup["q"]))
    model = TQ.YoloNetQuantized(tree)
    with torch.no_grad():
        heads = model(torch.zeros((1, DIM, DIM, 3), dtype=torch.uint8))
    assert [tuple(h.shape) for h in heads] == [(1, DIM // s, DIM // s, 39) for s in (32, 16, 8)]
    no_u8 = dict(tree, s2d={k: v for k, v in tree["s2d"].items() if k != "stem4_u8"})
    with pytest.raises(ValueError, match="uint8 feed"):
        TQ.YoloNetQuantized(no_u8)(torch.zeros((1, DIM, DIM, 3), dtype=torch.uint8))
    bad = dict(tree["s2d"]["stem4_u8"])
    bad["m"] = bad["m"].clone()
    bad["m"][200] *= 2
    with pytest.raises(ValueError, match="tile"):
        TQ.YoloNetQuantized(dict(tree, s2d=dict(tree["s2d"], stem4_u8=bad)))


# ---------------------------------------------------------------------------
# the int8 Detector
# ---------------------------------------------------------------------------

def _images():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 255, (100, 140, 3), dtype=np.uint8),
            rng.integers(0, 255, (120, 90, 3), dtype=np.uint8)]


def test_int8_detector_from_quantized_matches_jax(setup, tmp_path):
    """The JAX artifact served by both packages' Detectors: same rows and
    classes; boxes within 1e-2 px and probabilities within 1e-4 (measured:
    1.5e-5 px and 6e-8; only the letterbox's float32 summation order
    differs, and no int8 code moved on these images)."""
    from yolo_v3_tpu.detector import Detector as JDetector
    from yolo_v3_tpu.utils.config import YoloConfig as JConfig
    from yolo_v3_tpu_torch.detector import Detector
    from yolo_v3_tpu_torch.utils.config import YoloConfig

    path = str(tmp_path / "q.npz")
    JQ.save_quantized(setup["q"], path)
    cfg = dict(num_classes=NUM_CLASSES, img_dim=DIM, max_detections=32)
    want = JDetector.from_quantized(path, JConfig(**cfg)).detect(_images(), conf_thr=0.3)
    det = Detector.from_quantized(path, YoloConfig(**cfg), device="cpu")
    assert det.precision == "int8"
    got = det.detect(_images(), conf_thr=0.3)
    for g, w in zip(got, want):
        assert g.shape == w.shape and len(w) >= 10
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g[:, 1:5], w[:, 1:5], rtol=0, atol=1e-2)
        np.testing.assert_allclose(g[:, 5:], w[:, 5:], rtol=0, atol=1e-4)


def test_int8_detector_calibrates_like_jax_and_round_trips(setup, tmp_path):
    """No calibration images: both calibrate on np.random.default_rng(0)'s
    uniform batch of 8; scales within rtol 1e-4 (float conv summation
    order).  The port's artifact serves the same rows after a reload."""
    from yolo_v3_tpu.detector import Detector as JDetector
    from yolo_v3_tpu.utils.config import YoloConfig as JConfig
    from yolo_v3_tpu_torch.detector import Detector
    from yolo_v3_tpu_torch.utils.config import YoloConfig

    cfg = dict(num_classes=NUM_CLASSES, img_dim=64)
    jdet = JDetector(setup["params"], setup["state"], JConfig(**cfg), precision="int8")
    det = Detector(TW.params_from_numpy(jax.device_get(setup["params"])),
                   TW.params_from_numpy(jax.device_get(setup["state"])),
                   YoloConfig(**cfg), precision="int8", device="cpu")
    for k, v in jdet.params["scales"].items():
        assert det.qtree["scales"][k] == pytest.approx(v, rel=1e-4), k
    path = str(tmp_path / "port_q.npz")
    det.save_quantized(path)
    again = Detector.from_quantized(path, YoloConfig(**cfg), device="cpu")
    for a, b in zip(det.detect(_images(), conf_thr=0.3), again.detect(_images(), conf_thr=0.3)):
        np.testing.assert_array_equal(a, b)
    fp32 = Detector(TW.params_from_numpy(jax.device_get(setup["params"])),
                    TW.params_from_numpy(jax.device_get(setup["state"])),
                    YoloConfig(**cfg), precision="fp32", device="cpu")
    with pytest.raises(ValueError, match="int8"):
        fp32.save_quantized(str(tmp_path / "x.npz"))
