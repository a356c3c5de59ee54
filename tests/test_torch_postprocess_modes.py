"""The port's decode (``yolo_v3_tpu_torch/ops/decode.py``) and the
postprocess modes beyond the per-scale display path
(``ops/postprocess.py``: the decoded-rows ``postprocess``, the global-top-k
display path, eval mode on ``nms_pairs_grid``) against the JAX package, on
the fixtures of ``tests/test_postprocess.py`` and
``tests/test_postprocess_fast.py``.

Tolerances: rows must be the same rows (valid flags and classes equal);
their floats agree within rtol 1e-5, atol 1e-4 (the two frameworks' sigmoid
and exp differ in the last bits), as ``tests/test_torch_ops.py`` holds the
per-scale path; decoded rows within rtol 1e-5, atol 1e-4 the same way.
Within the port, ``decode_all`` + ``postprocess`` and
``postprocess_from_raws`` give the same rows, floats within 1e-4 px.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_v3_tpu.ops import decode as JDec
from yolo_v3_tpu.ops import postprocess as JP
from yolo_v3_tpu.utils.config import YoloConfig as JConfig
from yolo_v3_tpu_torch.ops import decode as TDec
from yolo_v3_tpu_torch.ops import postprocess as TP
from yolo_v3_tpu_torch.utils.config import YoloConfig

# TestFusedPostprocess's config and heads (6 classes, grids 4/8/16 at 128)
FUSED = dict(num_classes=6, pre_nms_topk=128, max_detections=32, eval_pre_nms_topk=128)


def _raws(seed, b=2, grids=(4, 8, 16), attrib=11, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(b, g, g, 3 * attrib)) * scale).astype(np.float32)
            for g in grids]


def _make_dets(rng, n=40, num_classes=4):
    """tests/test_postprocess.py::make_dets (sharp class scores)."""
    det = np.zeros((n, 5 + num_classes), np.float32)
    det[:, 0:2] = rng.uniform(50, 350, (n, 2))
    det[:, 2:4] = rng.uniform(20, 120, (n, 2))
    det[:, 4] = rng.uniform(0, 1, n)
    det[:, 5:] = rng.uniform(0, 1, (n, num_classes)) ** 3
    return det


def _assert_same_rows(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., 7], want[..., 7])
    np.testing.assert_array_equal(got[..., 6], want[..., 6])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def _both(raws, kw, *args, **kwargs):
    want = JP.postprocess_from_raws([jnp.asarray(r) for r in raws], JConfig(**kw),
                                    *args, **kwargs)
    got = TP.postprocess_from_raws([torch.from_numpy(r) for r in raws], YoloConfig(**kw),
                                   *args, **kwargs)
    return got, want


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flatten", [True, False])
def test_decode_head_matches_jax(flatten):
    raw = _raws(0, grids=(8,))[0]
    anchors = [(10, 13), (16, 30), (33, 23)]
    want = np.asarray(JDec.decode_head(jnp.asarray(raw), anchors, 16.0, flatten=flatten))
    got = TDec.decode_head(torch.from_numpy(raw), anchors, 16.0, flatten=flatten)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_decode_all_matches_jax():
    raws = _raws(1)
    want = np.asarray(JDec.decode_all([jnp.asarray(r) for r in raws], JConfig(num_classes=6), 128))
    got = TDec.decode_all([torch.from_numpy(r) for r in raws], YoloConfig(num_classes=6), 128)
    assert tuple(got.shape) == want.shape == (2, 3 * (16 + 64 + 256), 11)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(
        TDec.raw_to_predictions(torch.from_numpy(raws[0]), 3, 11).numpy(),
        np.asarray(JDec.raw_to_predictions(jnp.asarray(raws[0]), 3, 11)))


# ---------------------------------------------------------------------------
# the decoded-rows path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("is_eval,conf,nms,grid", [
    (False, 0.5, 0.4, False), (True, 0.1, 0.45, False), (True, 0.1, 0.45, True)])
def test_postprocess_decoded_rows_match_jax(is_eval, conf, nms, grid):
    """TestNMSParity's scene: three images of 40 rows, 4 classes."""
    rng = np.random.default_rng(0)
    dets = np.stack([_make_dets(rng) for _ in range(3)])
    kw = dict(pre_nms_topk=256, max_detections=192, grid_nms=grid)
    want = JP.postprocess(jnp.asarray(dets), 4, conf, nms, is_eval, True, **kw)
    got = TP.postprocess(torch.from_numpy(dets), 4, conf, nms, is_eval, True, **kw)
    assert (np.asarray(want)[..., 7] > 0).sum() >= 10
    _assert_same_rows(got, want)


@pytest.mark.parametrize("is_eval", [False, True])
def test_postprocess_without_nms_and_with_a_cap_matches_jax(is_eval):
    rng = np.random.default_rng(1)
    dets = np.stack([_make_dets(rng, n=300, num_classes=6) for _ in range(2)])
    for kw in (dict(use_nms=False, pre_nms_topk=64, max_detections=32),
               dict(use_nms=True, pre_nms_topk=512, max_detections=8)):
        want = JP.postprocess(jnp.asarray(dets), 6, 0.05, 0.45, is_eval, **kw)
        got = TP.postprocess(torch.from_numpy(dets), 6, 0.05, 0.45, is_eval, **kw)
        _assert_same_rows(got, want)


def test_topk_pairs_eval_two_stages_match_jax():
    """Above the flat cutoff (N*C > 16384, k <= N) the selection runs in two
    stages: the same (score, box, class) triples as JAX."""
    rng = np.random.default_rng(2)
    probs = rng.uniform(0, 1, (2, 3000, 8)).astype(np.float32) ** 4
    probs[probs < 0.05] = 0.0
    ws, wb, wc = JP._topk_pairs_eval(jnp.asarray(probs), 700)
    gs, gb, gc = TP._topk_pairs_eval(torch.from_numpy(probs), 700)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


# ---------------------------------------------------------------------------
# the fused path: global-top-k display and eval mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_nms", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_global_topk_display_matches_jax(seed, use_nms):
    """TestFusedPostprocess's heads with display_per_scale_topk=0."""
    kw = dict(FUSED, display_per_scale_topk=0)
    got, want = _both(_raws(seed), kw, 128, 0.2, 0.45, use_nms=use_nms)
    assert (np.asarray(want)[..., 7] > 0).sum() >= 20
    _assert_same_rows(got, want)


def test_global_topk_display_equals_fast_path_within_quota():
    """tests/test_postprocess_fast.py's dense scene (logit scale 4, 4
    classes, 128 px): below the per-scale quota both display paths give the
    same rows, in the port as in JAX."""
    cfg = YoloConfig(num_classes=4, img_dim=128)
    raws = [torch.from_numpy(r) for r in
            _raws(3, b=3, grids=(4, 8, 16), attrib=9, scale=4.0)]
    fast = TP.postprocess_from_raws(raws, cfg, 128, 0.5, 0.45)
    exact = TP.postprocess_from_raws(
        raws, dataclasses.replace(cfg, display_per_scale_topk=0), 128, 0.5, 0.45)
    assert (exact[..., 7] > 0).sum() >= 20
    torch.testing.assert_close(fast, exact, rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed,thr", [(0, 0.05), (1, 0.05), (2, 0.45)])
def test_eval_grid_matches_jax(seed, thr):
    """Eval mode, the JAX default (eval_grid_nms): stage 1 keeps the top
    eval_pre_nms_topk = 128 boxes of 1008, then exact greedy NMS over their
    pair grid."""
    got, want = _both(_raws(seed), FUSED, 128, thr, 0.45, is_eval=True)
    assert (np.asarray(want)[..., 7] > 0).sum() >= 10
    _assert_same_rows(got, want)


def test_eval_grid_matches_jax_when_every_box_is_kept():
    """tests/test_postprocess.py's dense scene: eval_pre_nms_topk above the
    box count (no stage-1 cut), up to 512 picks."""
    kw = dict(num_classes=6, pre_nms_topk=128, max_detections=512,
              eval_pre_nms_topk=256, anchor_masks=((6, 7, 8), (3, 4, 5)))
    got, want = _both(_raws(4, grids=(4, 8)), kw, 128, 0.3, 0.45, is_eval=True)
    assert (np.asarray(want)[..., 7] > 0).sum() >= 100
    _assert_same_rows(got, want)


@pytest.mark.parametrize("is_eval,kw", [
    (False, dict(FUSED, display_per_scale_topk=0)),
    (True, FUSED),
    (True, dict(num_classes=6, max_detections=64)),       # eval_pre_nms_topk 4096
])
def test_fused_equals_decode_all_plus_postprocess(is_eval, kw):
    """Within the port: the fused path and the decoded-rows path give the
    same rows (JAX states the same of its own pair)."""
    cfg = YoloConfig(**kw)
    raws = [torch.from_numpy(r) for r in _raws(5)]
    thr = 0.05 if is_eval else 0.2
    fused = TP.postprocess_from_raws(raws, cfg, 128, thr, 0.45, is_eval=is_eval)
    pre_k = cfg.eval_pre_nms_topk if is_eval else cfg.pre_nms_topk
    legacy = TP.postprocess(TDec.decode_all(raws, cfg, 128), cfg.num_classes, thr, 0.45,
                            is_eval=is_eval, pre_nms_topk=pre_k,
                            max_detections=cfg.max_detections, grid_nms=is_eval)
    assert (fused[..., 7] > 0).sum() >= 20
    torch.testing.assert_close(fused[..., 6:], legacy[..., 6:], rtol=0, atol=0)
    torch.testing.assert_close(fused, legacy, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# nms_pairs_grid and the decode constants
# ---------------------------------------------------------------------------

def _grid_scene(seed, k=64, c=5):
    """TestGridNMS's clustered scene."""
    rng = np.random.default_rng(seed)
    boxes_cxy = np.zeros((k, 4), np.float32)
    centers = rng.uniform(60, 340, (6, 2))
    owner = rng.integers(0, 6, k)
    boxes_cxy[:, :2] = centers[owner] + rng.normal(0, 10, (k, 2))
    boxes_cxy[:, 2:] = rng.uniform(25, 90, (k, 2))
    boxes = np.concatenate([boxes_cxy[:, :2] - boxes_cxy[:, 2:] / 2,
                            boxes_cxy[:, :2] + boxes_cxy[:, 2:] / 2], -1)
    scores = rng.uniform(0, 1, (k, c)).astype(np.float32)
    scores[scores < 0.3] = 0.0
    return boxes.astype(np.float32), scores


@pytest.mark.parametrize("seed,m,block", [(0, 16, 8), (1, 24, 128), (2, 12, 1), (3, 48, 16)])
def test_nms_pairs_grid_matches_jax(seed, m, block):
    boxes, scores = _grid_scene(seed)
    want = JP.nms_pairs_grid(jnp.asarray(scores)[None], jnp.asarray(boxes)[None], 0.45, m,
                             block=block)
    got = TP.nms_pairs_grid(torch.from_numpy(scores)[None], torch.from_numpy(boxes)[None],
                            0.45, m, block=block)
    v = np.asarray(want[3])
    np.testing.assert_array_equal(got[3].numpy(), v)
    assert v.sum() >= min(m, 8)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy()[v], np.asarray(w)[v])


def test_nms_pairs_grid_batched_images_converge_independently():
    """A dense image, an empty one and a one-pair one in one batch: each
    image's picks are those it gets alone."""
    (b0, s0), (b1, s1), (b2, s2) = (_grid_scene(s) for s in (11, 12, 13))
    s1[:] = 0.0
    s2[:] = 0.0
    s2[5, 2] = 0.9
    boxes = torch.from_numpy(np.stack([b0, b1, b2]))
    scores = torch.from_numpy(np.stack([s0, s1, s2]))
    gb, gc, gs, gv = TP.nms_pairs_grid(scores, boxes, 0.45, 16, block=8)
    for i in range(3):
        sb, sc, ss, sv = TP.nms_pairs_grid(scores[i:i + 1], boxes[i:i + 1], 0.45, 16,
                                           block=8)
        assert torch.equal(gv[i], sv[0])
        n = int(sv[0].sum())
        assert torch.equal(gb[i, :n], sb[0, :n]) and torch.equal(gc[i, :n], sc[0, :n])
        n_valid = int(gv[i].sum())
        assert bool(gv[i, :n_valid].all()) and not bool(gv[i, n_valid:].any())
        assert bool((gs[i, 1:n_valid] <= gs[i, :max(n_valid - 1, 0)]).all())
    assert int(gv[1].sum()) == 0 and int(gv[2].sum()) == 1


def test_constants_from_index_match_the_table():
    """The arithmetic constants equal the tabulated ones (and JAX's)."""
    shapes = ((4, 4), (8, 8), (16, 16))
    cfg = YoloConfig()
    n = 3 * (16 + 64 + 256)
    gi = torch.from_numpy(np.random.default_rng(6).integers(0, n, (2, 50)))
    table = TP._scale_constants(shapes, cfg.anchor_masks, cfg.anchors, 128)
    arith = TP._constants_from_index(gi, shapes, cfg.anchor_masks, cfg.anchors, 128, 3)
    jtable = JP._scale_constants(shapes, cfg.anchor_masks, cfg.anchors, 128)
    for t, a, j in zip(table, arith, jtable):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        np.testing.assert_array_equal(a.numpy(), t[gi].numpy())
