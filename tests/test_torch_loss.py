"""The port's YOLO loss against the JAX package's ``yolo_layer_loss`` /
``yolo_loss`` on the fixtures of ``tests/test_loss.py``: loss rtol 1e-5,
the stats equal (counts) or within rtol 1e-5 (losses), d loss / d raws
rtol 1e-4, finite gradients where the sigmoids saturate to 0 and 1."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_v3_tpu.models import loss as JL
from yolo_v3_tpu.utils.config import YoloConfig as JConfig
from yolo_v3_tpu_torch.models import loss as TL
from yolo_v3_tpu_torch.utils.config import YoloConfig

JCFG = JConfig(num_classes=4)
CFG = YoloConfig(num_classes=4)
COUNTS = ("nCorrect", "nGT")


def make_labels(rng, nB, T=20, n_real=(3, 8), C=4):
    """``tests/test_loss.py``'s label fixture."""
    labels = np.zeros((nB, T, 5), np.float32)
    for b in range(nB):
        n = rng.integers(*n_real)
        labels[b, :n, 0] = rng.integers(0, C, n)
        labels[b, :n, 1:3] = rng.uniform(0.05, 0.95, (n, 2))
        labels[b, :n, 3:5] = rng.uniform(0.02, 0.5, (n, 2))
    return labels


def _check_stats(got, want):
    assert set(got) == set(want)
    for k in got:
        if k in COUNTS:
            assert float(got[k].detach()) == float(want[k]), k
        else:
            np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)


@functools.lru_cache(maxsize=None)
def _jax_layer_grad(mask, img_dim):
    def f(r, labels):
        return JL.yolo_layer_loss(r, labels, JCFG, mask, img_dim)

    return jax.jit(jax.value_and_grad(f, has_aux=True))


def _layer_both(raw, labels, mask, img_dim):
    """(port loss, stats, d loss / d raw) and the JAX ones."""
    rt = torch.from_numpy(raw).requires_grad_(True)
    loss, stats = TL.yolo_layer_loss(rt, torch.from_numpy(labels), CFG, mask, img_dim)
    loss.backward()

    (jloss, jstats), jgrad = _jax_layer_grad(mask, img_dim)(jnp.asarray(raw),
                                                             jnp.asarray(labels))
    return (loss, stats, rt.grad.numpy()), (jloss, jstats, np.asarray(jgrad))


def _check_layer(raw, labels, mask, img_dim):
    (loss, stats, grad), (jloss, jstats, jgrad) = _layer_both(raw, labels, mask, img_dim)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    _check_stats(stats, jstats)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-4, atol=1e-4 * np.abs(jgrad).max())
    return stats


@pytest.mark.parametrize("mask,grid", [((6, 7, 8), 5), ((3, 4, 5), 10), ((0, 1, 2), 20)])
def test_layer_loss_matches_jax(mask, grid):
    rng = np.random.default_rng(0)
    img_dim = grid * {(6, 7, 8): 32, (3, 4, 5): 16, (0, 1, 2): 8}[mask]
    raw = rng.normal(size=(2, grid, grid, 3 * 9)).astype(np.float32) * 0.5
    stats = _check_layer(raw, make_labels(rng, 2), mask, img_dim)
    assert float(stats["nGT"]) >= 0


def test_zero_row_prefix_semantics():
    """A GT after an all-zero row is ignored (the reference's break)."""
    rng = np.random.default_rng(0)
    raw = rng.normal(size=(1, 5, 5, 27)).astype(np.float32)
    labels = np.zeros((1, 4, 5), np.float32)
    labels[0, 0] = [1, 0.5, 0.5, 0.3, 0.3]
    labels[0, 2] = [2, 0.2, 0.2, 0.2, 0.2]
    stats = _check_layer(raw, labels, (6, 7, 8), 160)
    labels[0, 2] = 0
    _, only_first = TL.yolo_layer_loss(torch.from_numpy(raw), torch.from_numpy(labels),
                                       CFG, (6, 7, 8), 160)
    assert float(stats["nGT"]) == float(only_first["nGT"])


def test_later_gt_overwrites_same_cell():
    """Two GTs on the same cell and anchor: the later one's targets win,
    nGT counts both."""
    rng = np.random.default_rng(0)
    raw = rng.normal(size=(1, 5, 5, 27)).astype(np.float32)
    labels = np.zeros((1, 3, 5), np.float32)
    labels[0, 0] = [1, 0.5, 0.5, 0.8, 0.8]
    labels[0, 1] = [2, 0.52, 0.52, 0.9, 0.9]
    stats = _check_layer(raw, labels, (6, 7, 8), 160)
    assert float(stats["nGT"]) == 2
    # a second GT of the same size trains the same anchor on the same cell:
    # one assigned cell, with the later GT's class target (2, not 1)
    labels[0, 1] = [2, 0.52, 0.52, 0.8, 0.8]
    stats = _check_layer(raw, labels, (6, 7, 8), 160)
    assert float(stats["nGT"]) == 2
    rt = torch.from_numpy(raw)
    p = rt.reshape(1, 5, 5, 3, 9).permute(0, 3, 1, 2, 4)
    anchors = torch.tensor(CFG.anchors, dtype=torch.float32) / 32
    with torch.no_grad():
        boxes = torch.stack([torch.sigmoid(p[..., 0]) + torch.arange(5.0),
                             torch.sigmoid(p[..., 1]) + torch.arange(5.0)[:, None],
                             torch.exp(p[..., 2]) * anchors[6:, 0, None, None],
                             torch.exp(p[..., 3]) * anchors[6:, 1, None, None]], -1)
    tgt, *_ = TL.build_targets(boxes, torch.from_numpy(labels), anchors, (6, 7, 8), 4, 0.5)
    cls = tgt["tcls"][tgt["obj"] > 0]
    assert cls.shape[0] == 1 and int(cls[0].argmax()) == 2


def test_three_scale_sum_and_recall():
    rng = np.random.default_rng(0)
    raws = [rng.normal(size=(2, g, g, 27)).astype(np.float32) for g in (5, 10, 20)]
    labels = make_labels(rng, 2)
    total, stats = TL.yolo_loss([torch.from_numpy(r) for r in raws],
                                torch.from_numpy(labels), CFG, 160)
    jtotal, jstats = jax.jit(lambda rs, lb: JL.yolo_loss(rs, lb, JCFG, 160))(
        [jnp.asarray(r) for r in raws], jnp.asarray(labels))
    assert set(TL.STAT_KEYS) == set(stats)
    np.testing.assert_allclose(float(total), float(jtotal), rtol=1e-5)
    _check_stats(stats, jstats)
    per_layer = sum(float(TL.yolo_layer_loss(torch.from_numpy(r), torch.from_numpy(labels),
                                             CFG, m, 160)[0])
                    for r, m in zip(raws, CFG.anchor_masks))
    np.testing.assert_allclose(float(total), per_layer, rtol=1e-5)


def test_every_gt_assigned_exactly_once():
    rng = np.random.default_rng(1)
    raws = [rng.normal(size=(3, g, g, 27)).astype(np.float32) for g in (5, 10, 20)]
    labels = make_labels(rng, 3, n_real=(5, 9))
    _, stats = TL.yolo_loss([torch.from_numpy(r) for r in raws], torch.from_numpy(labels),
                            CFG, 160)
    assert float(stats["nGT"]) == int((labels.sum(-1) != 0).sum())


@pytest.mark.parametrize("saturate", [-60.0, 60.0], ids=["p0", "p1"])
def test_gradients_finite_where_sigmoids_saturate(saturate):
    """Logits far enough out that sigmoid is exactly 0 or 1 in float32: the
    clamped logs take their constant branch, and every gradient stays
    finite, as in JAX."""
    rng = np.random.default_rng(2)
    raw = rng.normal(size=(2, 5, 5, 27)).astype(np.float32)
    raw[..., 4::9] = saturate          # objectness
    raw[..., 5::9] = saturate          # first class
    labels = make_labels(rng, 2)
    (loss, stats, grad), (jloss, jstats, jgrad) = _layer_both(raw, labels, (6, 7, 8), 160)
    loss = float(loss.detach())
    assert np.isfinite(loss) and np.all(np.isfinite(grad))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    np.testing.assert_allclose(grad, jgrad, rtol=1e-4, atol=1e-4 * np.abs(jgrad).max())
