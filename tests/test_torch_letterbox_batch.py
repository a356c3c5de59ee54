"""The batched letterbox on the CPU (``ops/letterbox.py``): a batch staged as
one packed block (``stage_batch``) and letterboxed by the plain version of
the card's kernel (``letterbox_batch``), against the JAX package's
per-image letterbox; and ``Detector.preprocess`` on the CPU against that
per-image path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_v3_tpu.ops import letterbox as JL
from yolo_v3_tpu_torch.detector import Detector
from yolo_v3_tpu_torch.models import darknet as D
from yolo_v3_tpu_torch.ops import letterbox as L
from yolo_v3_tpu_torch.ops.boxes import letterbox_params
from yolo_v3_tpu_torch.utils.config import YoloConfig

# (w, h) of COCO val's common sizes: the benchmark's scenes
COCO_WH = ((640, 480), (480, 640), (640, 427), (500, 375), (640, 360), (427, 640))
CASES = {
    "coco": COCO_WH,
    "ragged": ((37, 53), (416, 416), (1000, 30), (3, 5), (640, 480), (211, 97)),
    "upscale": ((80, 60),),
    "one_pixel_wide": ((1, 300), (300, 1)),
    "extreme_aspect": ((2000, 20), (20, 2000)),
}


def _images(sizes_wh, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for w, h in sizes_wh]


def _per_image(images, dim, letterbox):
    """The JAX package's per-image letterbox (or plain resize), stacked: what
    ``Detector.preprocess`` computed on the device before the batch was
    staged, one image at a time."""
    if letterbox:
        x = [JL.letterbox_device(jnp.asarray(im), (dim, dim)) for im in images]
    else:
        x = [JL.resize_cubic_device(jnp.asarray(im, jnp.float32) / 255.0, dim, dim)
             .clip(0.0, 1.0) for im in images]
    org = torch.tensor([[im.shape[1], im.shape[0]] for im in images], dtype=torch.float32)
    return torch.from_numpy(np.stack([np.asarray(v) for v in x])), org


@pytest.mark.parametrize("letterbox", [True, False], ids=["letterbox", "resize"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_matches_per_image(case, letterbox):
    images = _images(CASES[case])
    dim = 96 if case == "ragged" else 416
    want, want_org = _per_image(images, dim, letterbox)
    src, desc, org = L.stage_batch(images, dim, letterbox, "cpu")
    before = L.letterbox_batch.launches
    got = L.letterbox_batch(src, desc, dim)
    assert L.letterbox_batch.launches == before        # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(org.numpy(), want_org.numpy())


@pytest.mark.parametrize("letterbox", [True, False], ids=["letterbox", "resize"])
def test_stage_batch_layout(letterbox):
    """One block: the table, the sizes and the images' bytes back to back."""
    images = _images(CASES["ragged"], seed=1)
    images[1] = images[1][:, ::-1]          # a view with a negative stride
    src, desc, org = L.stage_batch(images, 64, letterbox, "cpu")
    assert src.dtype == torch.uint8 and desc.dtype == torch.int64 and org.dtype == torch.float32
    assert desc.shape == (len(images), L.DESC_COLS) and org.shape == (len(images), 2)
    assert src.untyped_storage().data_ptr() == desc.untyped_storage().data_ptr()
    assert src.numel() == sum(im.size for im in images)
    for im, row, wh in zip(images, desc.tolist(), org.tolist()):
        off, w, h, rw, rh, xp, yp = row
        assert (w, h) == (im.shape[1], im.shape[0]) == tuple(wh)
        want = letterbox_params(w, h, 64, 64)[:4] if letterbox else (64, 64, 0, 0)
        assert (rw, rh, xp, yp) == want
        np.testing.assert_array_equal(src[off:off + im.size].numpy(), im.reshape(-1))


@pytest.mark.parametrize("images,error", [
    ([], "no images"),
    ([np.zeros((8, 8, 3), np.float32)], "uint8"),
    ([np.zeros((8, 8), np.uint8)], "uint8"),
    ([np.zeros((8, 8, 4), np.uint8)], "uint8"),
    ([np.zeros((10000, 1, 3), np.uint8)], "letterboxes to 0x416"),
], ids=["empty", "float", "gray", "rgba", "too_thin"])
def test_stage_batch_rejects(images, error):
    with pytest.raises(ValueError, match=error):
        L.stage_batch(images, 416, True, "cpu")


def test_batch_on_another_device_raises():
    src, desc, _ = L.stage_batch(_images(((8, 6),)), 16, True, "meta")
    with pytest.raises(ValueError, match="unsupported device"):
        L.letterbox_batch(src, desc, 16)


@pytest.fixture(scope="module")
def trees():
    return D.init_yolonet(torch.Generator().manual_seed(0), 2, blocks=(1, 1, 1, 1, 1))


@pytest.mark.parametrize("letterbox", [True, False], ids=["letterbox", "resize"])
@pytest.mark.parametrize("precision", ["bf16", "int8"])
def test_detector_preprocess_on_the_cpu(trees, precision, letterbox):
    """The same x, org, dtypes and shapes as the per-image path."""
    images = _images(COCO_WH[:3] + ((80, 60),), seed=2)
    det = Detector(*trees, YoloConfig(num_classes=2, img_dim=96), precision=precision,
                   device="cpu", letterbox=letterbox, calib_images=images[:2])
    for dim in (None, 64):
        want, want_org = _per_image(images, dim or 96, letterbox)
        x, org = det.preprocess(images, dim)
        assert x.dtype == want.dtype and x.shape == want.shape
        assert org.dtype == want_org.dtype and org.shape == want_org.shape
        np.testing.assert_allclose(x.numpy(), want.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(org.numpy(), want_org.numpy())
