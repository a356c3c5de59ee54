"""The port's eval pipeline (``yolo_v3_tpu_torch/eval/``: ``coco_json.py``,
``cocoeval.py``, ``cocoeval_np.py``, ``pipeline.py``) against the JAX
package's, on the committed scenes of ``tests/data/torch_scenes`` and the
small float net of ``tests/test_torch_detector_options.py`` (blocks
(1,1,1,1,1), BN spread out, detection convs scaled up) with 80 classes at
96 px, and its int8 artifact on the uint8 feed.

Tolerances and why:
* ground truth, writer output and scores on the same inputs: equal (the
  same numpy arithmetic; JSON compared as parsed);
* fp32 results: the same rows per image (same class, boxes within 1e-2 px,
  scores within 1e-4; ``tests/test_torch_detector_options.py:128-129``):
  the JAX Detector runs the s2d entry and jitted convs, which sum in
  another order;
* int8 results (one artifact served by both, on the uint8 feed): the
  same rows at the same tolerances against the JAX pipeline run under
  ``jax.disable_jit()`` (jitted, XLA contracts the int8 epilogues into FMAs
  and moves rounding ties; ROADMAP §C fact 3);
* mAP: int8 within 1e-6, fp32 within 1e-3.
"""

import json
import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_v3_tpu.detector import Detector as JDetector
from yolo_v3_tpu.eval import coco_json as JCJ
from yolo_v3_tpu.eval import cocoeval as JCE
from yolo_v3_tpu.eval import cocoeval_np as JCN
from yolo_v3_tpu.eval import pipeline as JPL
from yolo_v3_tpu.utils.config import YoloConfig as JConfig
from yolo_v3_tpu_torch.detector import Detector
from yolo_v3_tpu_torch.eval import coco_json as CJ
from yolo_v3_tpu_torch.eval import cocoeval as CE
from yolo_v3_tpu_torch.eval import cocoeval_np as CN
from yolo_v3_tpu_torch.eval import pipeline as PL
from yolo_v3_tpu_torch.models import darknet as TD
from yolo_v3_tpu_torch.models import weights as TW
from yolo_v3_tpu_torch.utils.config import YoloConfig

SCENES = osp.join(osp.dirname(osp.abspath(__file__)), "data", "torch_scenes")
N_IMAGES = 7          # at batch 3: chunks of 3, 3 and a ragged 1
DIM = 96
CFG = dict(num_classes=80, img_dim=DIM, max_detections=24)


def class_names():
    with open(osp.join(SCENES, "scenes.names")) as f:
        return [ln.strip() for ln in f if ln.strip()]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """A list file of the first N_IMAGES committed scenes, and one of all."""
    img_dir = osp.join(SCENES, "images")
    paths = [osp.join(img_dir, n) for n in sorted(os.listdir(img_dir)) if n.endswith(".jpg")]
    root = tmp_path_factory.mktemp("scenes")
    (root / "some.txt").write_text("\n".join(paths[:N_IMAGES]) + "\n")
    (root / "all.txt").write_text("\n".join(paths) + "\n")
    return str(root / "some.txt"), str(root / "all.txt")


# ---------------------------------------------------------------------------
# ground truth and the writer
# ---------------------------------------------------------------------------

def test_annotations_dict_matches_jax_on_both_size_routes(scenes, monkeypatch):
    _, lst = scenes
    want = json.loads(json.dumps(JCJ.create_annotations_dict(lst, class_names())))
    got = json.loads(json.dumps(CJ.create_annotations_dict(lst, class_names())))
    assert got == want and len(got["images"]) == 24 and len(got["annotations"]) > 24
    # without OpenCV the sizes come from the native decode
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    native = json.loads(json.dumps(CJ.create_annotations_dict(lst, class_names())))
    assert native == want


def test_annotations_without_opencv_or_native_raise(scenes, monkeypatch):
    from yolo_v3_tpu_torch.data import native_loader as NL
    from yolo_v3_tpu_torch.ops import _build

    _, lst = scenes
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    monkeypatch.setattr(_build, "HOST_LIBS", ("-lno_such_jpeg", "-lpthread"))
    monkeypatch.setattr(_build, "_LIBS", {})
    NL.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="OpenCV or the native loader"):
            CJ.create_annotations_dict(lst, class_names())
    finally:
        NL.load_library.cache_clear()


def test_annotation_file_and_ids_match_jax(scenes, tmp_path):
    some, _ = scenes
    CJ.generate_annotations_file(some, class_names(), str(tmp_path / "port.json"))
    JCJ.generate_annotations_file(some, class_names(), str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    for p in ("/x/COCO_val2014_000000397133.jpg", "val_000005.jpg"):
        assert CJ.get_image_id_from_path(p) == JCJ.get_image_id_from_path(p)
    with pytest.raises(ValueError):
        CJ.get_image_id_from_path("/x/no_digits.jpg")
    assert CJ.create_categories(["a", "b"]) == JCJ.create_categories(["a", "b"])


def test_writer_round_trip_matches_jax(tmp_path):
    rows = np.array([[0, 10, 20, 30, 40, 0.9, 0.8], [3, 1.5, 2.5, 3.5, 4.5, 0.25, 0.5]],
                    np.float32)
    for mod, name in ((CJ, "port.json"), (JCJ, "jax.json")):
        with mod.JsonPredictionWriter(str(tmp_path / name), ["a"]) as w:
            w.add(42, rows)
            w.add(43, np.zeros((0, 7)))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    data = json.load(open(tmp_path / "port.json"))
    assert data[0] == {"image_id": 42, "category_id": 0, "bbox": [10.0, 20.0, 30.0, 40.0],
                       "score": pytest.approx(0.9)}
    assert len(data) == 2
    with CJ.JsonPredictionWriter(str(tmp_path / "empty.json"), ["a"]):
        pass
    assert json.load(open(tmp_path / "empty.json")) == []


def test_ground_truth_as_detections_scores_one(scenes, tmp_path):
    _, lst = scenes
    gt_path = str(tmp_path / "gt.json")
    CJ.generate_annotations_file(lst, class_names(), gt_path)
    gt = json.load(open(gt_path))
    res_path = str(tmp_path / "res.json")
    with CJ.JsonPredictionWriter(res_path, class_names()) as w:
        for img in gt["images"]:
            anns = [a for a in gt["annotations"] if a["image_id"] == img["id"]]
            w.add(img["id"], np.array([[a["category_id"], *a["bbox"], 0.99, 1.0]
                                       for a in anns]).reshape(-1, 7))
    assert CE.evaluate_map(gt_path, res_path) == pytest.approx(1.0, abs=1e-12)
    assert CN.coco_ap(gt, json.load(open(res_path)))[0] == pytest.approx(1.0, abs=1e-12)


# ---------------------------------------------------------------------------
# the scorers
# ---------------------------------------------------------------------------

def _ann(img, cat, bbox, crowd=0, ignore=0):
    a = {"image_id": img, "category_id": cat, "bbox": list(bbox), "iscrowd": crowd,
         "area": bbox[2] * bbox[3]}
    if ignore:
        a["ignore"] = 1
    return a


def _det(img, cat, bbox, score):
    return {"image_id": img, "category_id": cat, "bbox": list(bbox), "score": score}


G1, G2 = [10, 10, 50, 50], [200, 200, 50, 50]
# the hand-computed cases of tests/test_cocoeval_np.py and tests/test_eval.py:
# (annotations, detections, max_dets, the AP they compute)
HAND = {
    "perfect": ([_ann(1, 1, G1)], [_det(1, 1, G1, 0.9)], 100, 1.0),
    "missed_gt": ([_ann(1, 1, G1), _ann(1, 1, G2)], [_det(1, 1, G1, 0.9)], 100, 51 / 101),
    "fp_above_tp": ([_ann(1, 1, G1)], [_det(1, 1, [300, 300, 50, 50], 0.9),
                                       _det(1, 1, G1, 0.8)], 100, 0.5),
    "duplicate": ([_ann(1, 1, G1)], [_det(1, 1, G1, 0.9), _det(1, 1, G1, 0.5)], 100, 1.0),
    "tie_first": ([_ann(1, 1, G1)], [_det(1, 1, G1, 0.7),
                                     _det(1, 1, [300, 300, 50, 50], 0.7)], 100, 1.0),
    "tie_second": ([_ann(1, 1, G1)], [_det(1, 1, [300, 300, 50, 50], 0.7),
                                      _det(1, 1, G1, 0.7)], 100, 0.5),
    "crowd": ([_ann(1, 1, G1), _ann(1, 1, [100, 100, 200, 200], crowd=1)],
              [_det(1, 1, [100 + 10 * i, 100 + 10 * i, 40, 40], 0.9 - 0.1 * i)
               for i in range(3)] + [_det(1, 1, G1, 0.95)], 100, 1.0),
    "crowd_only_category": ([_ann(1, 1, G1), _ann(1, 2, [0, 0, 400, 400], crowd=1)],
                            [_det(1, 1, G1, 0.9), _det(1, 2, [0, 0, 400, 400], 0.9)],
                            100, 1.0),
    "ignore": ([_ann(1, 1, G1, ignore=1), _ann(1, 1, G2)],
               [_det(1, 1, G1, 0.9), _det(1, 1, G2, 0.8)], 100, 1.0),
    "maxdets_1": ([_ann(1, 1, G1), _ann(1, 1, G2)],
                  [_det(1, 1, G1, 0.9), _det(1, 1, G2, 0.8)], 1, 51 / 101),
    "half_matched": ([_ann(1, 0, G1), _ann(2, 0, [30, 30, 40, 40]),
                      _ann(2, 1, [100, 100, 30, 30])],
                     [_det(1, 0, G1, 0.9), _det(2, 1, [100, 100, 30, 30], 0.9)],
                     100, (51 / 101 + 1.0) / 2),
    "none": ([_ann(1, 0, G1)], [], 100, 0.0),
}


@pytest.mark.parametrize("case", sorted(HAND))
def test_scorers_match_jax_on_the_hand_computed_cases(case, tmp_path):
    anns, dets, max_dets, ap = HAND[case]
    gt = {"annotations": anns}
    got, got_cat = CN.coco_ap(gt, dets, max_dets=max_dets)
    want, want_cat = JCN.coco_ap(gt, dets, max_dets=max_dets)
    assert got == want == pytest.approx(ap) and got_cat == want_cat
    assert CE.average_precision_at_iou(gt, dets, max_dets=max_dets) == \
        JCE.average_precision_at_iou(gt, dets, max_dets=max_dets)
    gt_path, res_path = tmp_path / "gt.json", tmp_path / "res.json"
    gt_path.write_text(json.dumps({"categories": [], "images": [], "annotations": anns}))
    res_path.write_text(json.dumps(dets))
    if max_dets == 100:
        assert CE.evaluate_map(str(gt_path), str(res_path)) == \
            JCE.evaluate_map(str(gt_path), str(res_path)) == got
        assert CN.evaluate_map_np(str(gt_path), str(res_path)) == got


@pytest.mark.parametrize("crowd_frac", [0.0, 0.3])
def test_scorers_match_jax_on_seeded_random_scenes(crowd_frac):
    for seed in range(6):
        rng = np.random.default_rng(seed)
        anns, dets = [], []
        for img in range(8):
            for _ in range(rng.integers(2, 9)):
                cat = int(rng.integers(1, 6))
                x, y, w, h = *rng.uniform(0, 300, 2), *rng.uniform(20, 100, 2)
                anns.append(_ann(img, cat, [x, y, w, h], crowd=int(rng.uniform() < crowd_frac)))
                if rng.uniform() < 0.8:
                    jx, jy = rng.normal(0, 6, 2)
                    dets.append(_det(img, cat, [x + jx, y + jy, w * rng.uniform(0.8, 1.2),
                                                h * rng.uniform(0.8, 1.2)],
                                     float(rng.uniform(0.3, 1.0))))
            for _ in range(rng.integers(0, 4)):
                dets.append(_det(img, int(rng.integers(1, 6)),
                                 [*rng.uniform(0, 300, 2), *rng.uniform(20, 100, 2)],
                                 float(rng.uniform(0.05, 0.6))))
        gt = {"annotations": anns}
        assert CN.coco_ap(gt, dets) == JCN.coco_ap(gt, dets)
        assert CE.average_precision_at_iou(gt, dets) == JCE.average_precision_at_iou(gt, dets)


# ---------------------------------------------------------------------------
# generate_results_file / evaluate_detector, port against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """The JAX and the port Detector in fp32 (tests/test_torch_detector_options.py's
    params with 80 classes) and int8 on the uint8 feed (the port's artifact,
    calibrated on its synthetic batch, served by both), each built once so
    the JAX jit and op caches carry over between tests."""
    tp, ts = TD.init_yolonet(torch.Generator().manual_seed(0), 80, blocks=(1, 1, 1, 1, 1))
    p, s = TD.map_tree(lambda t: t.numpy().copy(), tp), TD.map_tree(lambda t: t.numpy().copy(), ts)
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
    port = {"fp32": Detector(TW.params_from_numpy(p), TW.params_from_numpy(s),
                             YoloConfig(**CFG), precision="fp32", device="cpu")}
    jax_ = {"fp32": JDetector(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s),
                              JConfig(**CFG), precision="fp32")}
    path = str(tmp_path_factory.mktemp("q") / "q.npz")
    Detector(TW.params_from_numpy(p), TW.params_from_numpy(s), YoloConfig(**CFG),
             precision="int8", device="cpu").save_quantized(path)
    port["int8"] = Detector.from_quantized(path, YoloConfig(**CFG), device="cpu",
                                           resize_on_device=False)
    jax_["int8"] = JDetector.from_quantized(path, JConfig(**CFG), resize_on_device=False)
    return port, jax_


def _json_rows(path):
    """{image_id: [n, 6] (category, x, y, w, h, score)} of a results json."""
    out = {}
    for e in json.load(open(path)):
        out.setdefault(e["image_id"], []).append([e["category_id"], *e["bbox"], e["score"]])
    return {k: np.array(v) for k, v in out.items()}


def _assert_same_rows(got_path, want_path):
    """Every image's rows match one to one: same class, boxes within 1e-2
    px, scores within 1e-4 (order may differ where scores tie)."""
    got, want = _json_rows(got_path), _json_rows(want_path)
    assert sorted(got) == sorted(want) and sum(len(v) for v in want.values()) >= 20
    for image_id, w in want.items():
        g = got[image_id]
        assert g.shape == w.shape, image_id
        used = np.zeros(len(g), bool)
        for row in w:
            ok = ((g[:, 0] == row[0]) & ~used & (np.abs(g[:, 1:5] - row[1:5]).max(1) <= 1e-2)
                  & (np.abs(g[:, 5] - row[5]) <= 1e-4))
            assert ok.any(), (image_id, row)
            used[np.argmax(ok)] = True


@pytest.mark.parametrize("native", [True, False])
def test_fp32_results_and_map_match_jax(models, scenes, tmp_path, native):
    some, _ = scenes
    det, jdet = models[0]["fp32"], models[1]["fp32"]
    names = class_names()
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    timings = {}
    PL.generate_results_file(det, some, names, str(tmp_path / "port" / "results.json"),
                             batch_size=3, is_letterbox=True, progress=False,
                             use_native_loader=native, timings=timings)
    JPL.generate_results_file(jdet, some, names, str(tmp_path / "jax" / "results.json"),
                              batch_size=3, is_letterbox=True, progress=False,
                              use_native_loader=native)
    _assert_same_rows(tmp_path / "port" / "results.json", tmp_path / "jax" / "results.json")
    assert timings["batches"] == 3 and set(timings) == {*PL.STAGES, "batches"}
    got = PL.evaluate_detector(det, some, names, str(tmp_path / "port"), batch_size=3,
                               is_letterbox=True, use_native_loader=native)
    want = JPL.evaluate_detector(jdet, some, names, str(tmp_path / "jax"), batch_size=3,
                                 is_letterbox=True)
    assert 0.0 <= got <= 1.0 and abs(got - want) <= 1e-3


def test_fp32_plain_resize_results_match_jax(models, scenes, tmp_path):
    """is_letterbox=False: no native route; OpenCV decode, the device resize."""
    some, _ = scenes
    det, jdet = models[0]["fp32"], models[1]["fp32"]
    PL.generate_results_file(det, some, class_names(), str(tmp_path / "port.json"),
                             batch_size=3, progress=False)
    JPL.generate_results_file(jdet, some, class_names(), str(tmp_path / "jax.json"),
                              batch_size=3, progress=False)
    assert det.letterbox is False
    _assert_same_rows(tmp_path / "port.json", tmp_path / "jax.json")


@pytest.mark.parametrize("native", [True, False])
def test_int8_results_and_map_match_jax_op_by_op(models, scenes, tmp_path, native):
    """An int8 artifact on the uint8 feed, served by both packages."""
    some, _ = scenes
    det, jdet = models[0]["int8"], models[1]["int8"]
    assert det._u8_feed and jdet._u8_feed
    names = class_names()
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = PL.evaluate_detector(det, some, names, str(tmp_path / "port"), batch_size=3,
                               is_letterbox=True, use_native_loader=native)
    with jax.disable_jit():
        JPL.generate_results_file(jdet, some, names, str(tmp_path / "jax" / "results.json"),
                                  batch_size=3, is_letterbox=True, progress=False,
                                  use_native_loader=native)
    _assert_same_rows(tmp_path / "port" / "results.json", tmp_path / "jax" / "results.json")
    want = JCE.evaluate_map(str(tmp_path / "port" / "annotations.json"),
                            str(tmp_path / "jax" / "results.json"))
    assert 0.0 <= got <= 1.0 and abs(got - want) <= 1e-6


def test_failed_native_image_takes_opencv_alone(models, scenes, tmp_path):
    """A PNG among the JPEGs: the native pool refuses it, OpenCV letterboxes
    it, and its rows equal the all-OpenCV run's for that image."""
    import cv2

    some, _ = scenes
    paths = open(some).read().split()[:3]
    (tmp_path / "images").mkdir()
    png = str(tmp_path / "images" / "scene_000099.png")
    cv2.imwrite(png, cv2.imread(paths[0]))
    lst = tmp_path / "mixed.txt"
    lst.write_text("\n".join(paths[1:] + [png]) + "\n")
    det = models[0]["int8"]              # the host letterbox in uint8
    out = {}
    for native in (True, False):
        out[native] = str(tmp_path / f"res_{native}.json")
        PL.generate_results_file(det, str(lst), class_names(), out[native], batch_size=3,
                                 is_letterbox=True, progress=False, use_native_loader=native)
    got, want = _json_rows(out[True])[99], _json_rows(out[False])[99]
    np.testing.assert_array_equal(got, want)
