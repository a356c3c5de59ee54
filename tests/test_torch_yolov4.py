"""YOLOv4 (``models/yolov4.py``) on the CPU against the plain reference
``portbench/reference/yolov4.py``, at its published widths on a small input
(64 x 64, batch 2), with seeded weights whose BN statistics are measured on
seeded scenes (``portbench/weights_yolov4.py``); and the heads' ``scale_x_y``
on every decode path of ``ops/decode.py`` and ``ops/postprocess.py``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import scenes, weights_yolov4
from portbench.reference import letterbox as RL
from portbench.reference import postprocess as RP
from portbench.reference import yolov4 as RY4
from yolo_v3_tpu_torch.detector import Detector
from yolo_v3_tpu_torch.models import darknet as D
from yolo_v3_tpu_torch.models import yolov4 as Y4
from yolo_v3_tpu_torch.ops import decode as TDec
from yolo_v3_tpu_torch.ops import postprocess as TP
from yolo_v3_tpu_torch.utils.config import YoloConfig

DIM = 64
SIZES = [[80, 60], [60, 80], [96, 64]]
CFG = {"blocks": [1, 2, 8, 8, 4], "classes": 80, "input_size": DIM,
       "anchors": [list(a) for a in Y4.ANCHORS], "masks": [list(m) for m in Y4.ANCHOR_MASKS],
       "scale_x_y": list(Y4.SCALE_X_Y)}
CONF, NMS, TOPK, MAXDET = 0.5, 0.4, 128, 128
BF16_REL = 0.1


@pytest.fixture(scope="module")
def model():
    pool = scenes.make_pool(6, SIZES, 11, "cpu")
    params, state = weights_yolov4.make(CFG, 5, "cpu", pool[:4])
    x = RL.letterbox_batch(pool[4:], DIM, "cpu").float()
    return params, state, pool, x, RY4.heads_float(params, state, x)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_conv_specs_follow_the_cfg():
    specs = Y4.conv_specs()
    assert len(specs) == 110
    assert sum(k * k * cin * cout for _, k, cin, cout, _, _ in specs) == 64296032
    assert sum(act == "mish" for *_, act in specs) == 72
    assert [p for p, *_ in specs if p.endswith("det")] == ["head2/det", "head1/det", "head0/det"]


@pytest.mark.parametrize("form", ["unfolded", "folded_fp32", "folded_bf16"])
def test_forward_matches_the_reference(model, form):
    params, state, _, x, want = model
    with torch.no_grad():
        if form == "unfolded":
            got = Y4.apply_yolov4(params, state, x)
        else:
            dtype = torch.float32 if form == "folded_fp32" else torch.bfloat16
            net = Y4.YoloV4Folded(D.cast_params(D.fold_batchnorm(params, state), dtype)).eval()
            got = net(x.to(dtype))
    assert [tuple(g.shape) for g in got] == [(2, 2, 2, 255), (2, 4, 4, 255), (2, 8, 8, 255)]
    # bf16: the seeded network at this size moves by about 5% under bf16
    # rounding (4.3-6.0% a head); Mish for SiLU moves it by ~90%
    tol = BF16_REL if form == "folded_bf16" else 1e-4
    for g, w in zip(got, want):
        assert _rel(g, w) < tol


@pytest.mark.parametrize("shape", [(2, 5, 19, 19), (1, 3, 7, 5), (1, 4, 2, 2)])
def test_spp_cascaded_pools_equal_the_wide_pools(shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(3)) * 4 - 1
    m13, m9, m5 = Y4._max_pools(x)
    for got, k in ((m13, 13), (m9, 9), (m5, 5)):
        assert torch.equal(got, F.max_pool2d(x, k, 1, k // 2))


def _raws(seed=4, classes=6, shapes=(4, 8, 16)):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 2, (2, s, s, 3 * (5 + classes))).astype(np.float32))
            for s in shapes]


def test_decode_head_takes_scale_x_y():
    raw = _raws()[1]
    anchors = [(10.0, 13.0), (16.0, 30.0), (33.0, 23.0)]
    got = TDec.decode_head(raw, anchors, 16.0, flatten=False, scale_x_y=1.1)
    t = torch.sigmoid(raw.reshape(2, 8, 8, 3, 11)[..., 0])
    cx = torch.arange(8.0)[None, None, :, None]
    torch.testing.assert_close(got[..., 0], (t * 1.1 - 0.05 + cx) * 16.0)


@pytest.mark.parametrize("path", ["display_fast", "display_global", "eval"])
def test_scale_x_y_on_every_postprocess_path(path):
    """Each fused path against decode_all (with scale_x_y) + the decoded-rows
    postprocess, which decodes every row."""
    raws = _raws()
    cfg = YoloConfig(num_classes=6, display_per_scale_topk=0 if path == "display_global" else 128)
    sxy = (1.05, 1.1, 1.2)
    is_eval = path == "eval"
    thr = 0.2 if is_eval else 0.5
    fused = TP.postprocess_from_raws(raws, cfg, 128, thr, 0.45, is_eval=is_eval, scale_x_y=sxy)
    pre_k = cfg.eval_pre_nms_topk if is_eval else cfg.pre_nms_topk
    legacy = TP.postprocess(TDec.decode_all(raws, cfg, 128, scale_x_y=sxy), cfg.num_classes, thr,
                            0.45, is_eval=is_eval, pre_nms_topk=pre_k,
                            max_detections=cfg.max_detections, grid_nms=is_eval)
    assert int(fused[..., 7].sum()) > 0
    torch.testing.assert_close(fused, legacy, rtol=0, atol=1e-4)
    plain = TP.postprocess_from_raws(raws, cfg, 128, thr, 0.45, is_eval=is_eval)
    assert not torch.allclose(fused, plain, rtol=0, atol=1e-3)


@pytest.mark.parametrize("path", ["display_fast", "display_global", "eval"])
def test_yolov3_decode_unchanged_when_every_scale_x_y_is_one(path):
    raws = _raws(seed=9)
    cfg = YoloConfig(num_classes=6, display_per_scale_topk=0 if path == "display_global" else 128)
    is_eval = path == "eval"
    thr = 0.2 if is_eval else 0.5
    ones = TP.postprocess_from_raws(raws, cfg, 128, thr, 0.45, is_eval=is_eval,
                                    scale_x_y=(1.0, 1.0, 1.0))
    assert torch.equal(ones, TP.postprocess_from_raws(raws, cfg, 128, thr, 0.45, is_eval=is_eval))
    assert torch.equal(TDec.decode_all(raws, cfg, 128, scale_x_y=(1.0, 1.0, 1.0)),
                       TDec.decode_all(raws, cfg, 128))


def test_detector_serves_yolov4_end_to_end(model):
    """``Detector(arch="yolov4").detect`` on the CPU: its rows are the
    reference postprocess of its own heads (scale_x_y included), and its
    heads are the reference's within bf16 rounding."""
    params, state, pool, _, _ = model
    config = YoloConfig(num_classes=80, img_dim=DIM, anchors=Y4.ANCHORS,
                        anchor_masks=Y4.ANCHOR_MASKS, conf_thr=CONF, nms_thr=NMS,
                        display_per_scale_topk=TOPK, max_detections=MAXDET)
    det = Detector(params, state, config, precision="bf16", device="cpu", arch="yolov4")
    assert det.scale_x_y == Y4.SCALE_X_Y
    images = pool[:4]
    rows = det.detect(images)
    x, _ = det.preprocess(images)
    with torch.inference_mode():
        heads = det.model(x.to(torch.bfloat16))
    want = RY4.rows(heads, [(im.shape[1], im.shape[0]) for im in images], CFG["anchors"],
                    CFG["masks"], CFG["scale_x_y"], DIM, CONF, NMS, TOPK, MAXDET)
    assert sum(len(r) for r in rows) > 0
    for a, b in zip(rows, want):
        assert RP.unmatched(a, b, 1e-2, 1e-4) == 0 and RP.unmatched(b, a, 1e-2, 1e-4) == 0
    ref = RY4.heads_float(params, state, x.float())
    for h, r in zip(heads, ref):
        assert _rel(h, r) < BF16_REL


def test_detector_refuses_yolov4_int8():
    with pytest.raises(ValueError, match="YOLOv4"):
        Detector(None, None, precision="int8", device="cpu", arch="yolov4")


def test_detector_refuses_yolov4_fp32():
    """The Mish kernels are bf16 only: an fp32 YOLOv4 would run the plain
    versions on the card, so the Detector refuses it."""
    with pytest.raises(ValueError, match="bf16"):
        Detector(None, None, precision="fp32", device="cpu", arch="yolov4")
