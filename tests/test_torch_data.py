"""The port's datasets and transforms (``yolo_v3_tpu_torch/data/datasets.py``,
``data/transforms.py``) and its ``DataHelper`` on the Python path, against
the JAX package's, on the committed scenes of ``tests/data/torch_scenes``
(``scripts/make_torch_scenes.py``) and seeded random images.

Tolerance: none.  Both packages run the same numpy and OpenCV operations
in the same order on the same draws, so every image, label and reverter is
bit-identical for the same seed; the committed labels of the phase-8
training schedule (made by the JAX Python path) are held bit-equal too.
"""

import functools
import os
import os.path as osp

import numpy as np
import pytest

from yolo_v3_tpu.data import datasets as JDS
from yolo_v3_tpu.data import transforms as JT
from yolo_v3_tpu.data.loader import DataHelper as JDataHelper
from yolo_v3_tpu.data.sampler import CyclicSampler as JSampler
from yolo_v3_tpu_torch.data import datasets as DS
from yolo_v3_tpu_torch.data import transforms as T
from yolo_v3_tpu_torch.data.loader import DataHelper
from yolo_v3_tpu_torch.data.sampler import CyclicSampler

SCENES = osp.join(osp.dirname(osp.abspath(__file__)), "data", "torch_scenes")
LABEL = np.array(
    [[1, 0.5, 0.5, 0.4, 0.3], [7, 0.2, 0.3, 0.15, 0.2],
     [3, 0.9, 0.85, 0.3, 0.4], [0, 0.05, 0.95, 0.08, 0.09]], np.float32)


def scenes_list(out_path):
    """The committed scenes' list file (absolute paths, sorted)."""
    img_dir = osp.join(SCENES, "images")
    names = sorted(n for n in os.listdir(img_dir) if n.endswith(".jpg"))
    with open(out_path, "w") as f:
        f.write("\n".join(osp.join(img_dir, n) for n in names) + "\n")
    return str(out_path)


def _assert_samples_equal(a, b, keys=("img", "label", "lb_reverter")):
    for k in keys:
        if a.get(k) is None:
            assert b.get(k) is None, k
            continue
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _sample(img, label, seed):
    return {"img": img.copy(), "label": None if label is None else label.copy(),
            "rng": np.random.default_rng(seed)}


@pytest.mark.parametrize("feed_u8", [False, True])
@pytest.mark.parametrize("dim", [(416, 416), (320, 320)])
def test_training_transform_matches_jax(dim, feed_u8):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    for seed in range(12):
        label = None if seed == 3 else LABEL
        want = JT.training_transform(dim, feed_u8=feed_u8)(_sample(img, label, seed))
        got = T.training_transform(dim, feed_u8=feed_u8)(_sample(img, label, seed))
        _assert_samples_equal(got, want)
        assert got["img"].dtype == (np.uint8 if feed_u8 else np.float32)


@pytest.mark.parametrize("feed_u8", [False, True])
@pytest.mark.parametrize("letterbox", [True, False])
def test_eval_transform_matches_jax(letterbox, feed_u8):
    img = np.random.default_rng(2).integers(0, 256, (97, 215, 3), dtype=np.uint8)
    want = JT.eval_transform((128, 96), letterbox, feed_u8=feed_u8)(_sample(img, LABEL, 0))
    got = T.eval_transform((128, 96), letterbox, feed_u8=feed_u8)(_sample(img, LABEL, 0))
    _assert_samples_equal(got, want)


def test_extra_augmentations_match_jax():
    img = np.random.default_rng(4).integers(0, 256, (64, 80, 3), dtype=np.uint8)
    for seed in range(8):
        want = JT.ExtraAugmentations()(_sample(img, LABEL, seed))
        got = T.ExtraAugmentations()(_sample(img, LABEL, seed))
        _assert_samples_equal(got, want, ("img", "label"))
        chain = functools.partial(T.training_transform, extra_aug=True)
        jchain = functools.partial(JT.training_transform, extra_aug=True)
        _assert_samples_equal(chain((96, 96))(_sample(img, LABEL, seed)),
                              jchain((96, 96))(_sample(img, LABEL, seed)))


def test_jitter_crop_degenerate_draws_match_jax():
    """jitter 0.6 on a 10 x 10 image: some draws leave no pixel and skip the
    crop, labels and all, in both packages."""
    img = np.random.default_rng(1).integers(0, 256, (10, 10, 3), dtype=np.uint8)
    for seed in range(60):
        want = JT.RandomJitterCrop(0.6)(_sample(img, LABEL, seed))
        got = T.RandomJitterCrop(0.6)(_sample(img, LABEL, seed))
        _assert_samples_equal(got, want, ("img", "label"))


@pytest.mark.parametrize("path", [
    "/data/coco/images/val2014/COCO_val2014_000000000042.jpg",
    "/x/images_v2/images/a.png",
    "/data/images/sub/img.jpeg",
    "rel/images/b.JPG",
    "/no/such/layout/c.jpg",
])
def test_label_path_contract_matches_jax(path):
    assert DS.image_path_to_label_path(path) == JDS.image_path_to_label_path(path)


def test_list_dataset_matches_jax(tmp_path):
    lst = scenes_list(tmp_path / "scenes.txt")
    ds, jds = DS.ListDataset(lst), JDS.ListDataset(lst)
    assert len(ds) == len(jds) == 24
    for i in (0, 5, 23):
        a, b = ds.load_raw(i), jds.load_raw(i)
        _assert_samples_equal(a, b, ("img", "org_img", "label"))
        assert a["img_path"] == b["img_path"]
        pa, la = ds.raw_entry(i)
        pb, lb = jds.raw_entry(i)
        assert pa == pb
        np.testing.assert_array_equal(la, lb)
    trans = functools.partial(T.training_transform, feed_u8=True)
    jtrans = functools.partial(JT.training_transform, feed_u8=True)
    got = DS.ListDataset(lst, trans_fn=trans).get(3, (352, 352), 99)
    want = JDS.ListDataset(lst, trans_fn=jtrans).get(3, (352, 352), 99)
    _assert_samples_equal(got, want)


def test_list_dataset_without_labels_warns_or_raises(tmp_path):
    (tmp_path / "images").mkdir()
    lst = tmp_path / "l.txt"
    lst.write_text(str(tmp_path / "images" / "x_000001.jpg") + "\n")
    with pytest.raises(FileNotFoundError):
        DS.ListDataset(str(lst), require_labels=True)
    assert len(DS.ListDataset(str(lst))) == 1


def test_image_folder_dataset_matches_jax():
    img_dir = osp.join(SCENES, "images")
    ds = DS.ImageFolderDataset(img_dir, transform=T.eval_transform((128, 128)))
    jds = JDS.ImageFolderDataset(img_dir, transform=JT.eval_transform((128, 128)))
    assert len(ds) == len(jds) == 24
    _assert_samples_equal(ds[7], jds[7], ("img", "label", "lb_reverter"))


def _cvat_xml(tmp_path):
    """A CVAT-for-images XML over two committed scenes."""
    import cv2

    rows = []
    for name in ("scene_000001.jpg", "scene_000002.jpg"):
        h, w = cv2.imread(osp.join(SCENES, "images", name)).shape[:2]
        rows.append(
            f'<image id="0" name="{name}">'
            f'<box label="x_wing" xtl="{w * 0.25}" ytl="{h * 0.25}" '
            f'xbr="{w * 0.75}" ybr="{h * 0.5}" occluded="0"/>'
            f'<box label="tie" xtl="1" ytl="2" xbr="31" ybr="42" occluded="0"/></image>')
    xml = tmp_path / "tiny.xml"
    xml.write_text("<annotations>" + "".join(rows) + "</annotations>")
    return str(xml)


def test_cvat_dataset_and_export_match_jax(tmp_path):
    xml = _cvat_xml(tmp_path)
    img_dir = osp.join(SCENES, "images")
    assert DS.get_xml_labels(xml) == JDS.get_xml_labels(xml)
    cvat, jcvat = DS.CVATDataset(img_dir, xml), JDS.CVATDataset(img_dir, xml)
    assert len(cvat) == len(jcvat) == 2
    for i in range(2):
        a = cvat.load_raw(i)
        _assert_samples_equal(a, jcvat.load_raw(i), ("img", "label"))
        # box (0.25w, 0.25h, 0.75w, 0.5h) -> cxcywh (.5, .375, .5, .25)
        np.testing.assert_allclose(a["label"][0], [0, 0.5, 0.375, 0.5, 0.25], atol=1e-5)
    lst = DS.export_cvat_to_list(img_dir, xml, str(tmp_path / "port"))
    jlst = JDS.export_cvat_to_list(img_dir, xml, str(tmp_path / "jax"))
    for sub in ("scene_000001.txt", "scene_000002.txt"):
        assert ((tmp_path / "port" / "labels" / sub).read_text()
                == (tmp_path / "jax" / "labels" / sub).read_text())
    exported = DS.ListDataset(lst)
    assert len(exported) == len(JDS.ListDataset(jlst)) == 2
    for i in range(2):
        b = exported.load_raw(i)
        np.testing.assert_array_equal(b["img"], cvat.load_raw(i)["img"])
        np.testing.assert_allclose(b["label"], cvat.load_raw(i)["label"], atol=1e-5)


def test_cached_dataset_decodes_once_and_freezes(tmp_path):
    xml = _cvat_xml(tmp_path)
    ds = DS.CVATDataset(osp.join(SCENES, "images"), xml,
                        trans_fn=lambda dim: T.eval_transform(dim))
    calls = []
    orig_get = ds.get
    ds.get = lambda *a: (calls.append(a), orig_get(*a))[1]
    cds = DS.CachedDataset(ds)
    s1 = cds.get(0, (64, 64), 7)
    s2 = cds.get(0, (64, 64), 8)          # another seed: still a hit
    assert len(calls) == 1
    np.testing.assert_array_equal(s1["img"], s2["img"])
    with pytest.raises(ValueError):
        s2["img"][0, 0, 0] = 1.0          # frozen
    cds.get(0, (32, 32), 7)
    assert len(calls) == 2 and len(cds) == 2
    # in a DataHelper, drop_keys' pops must not reach the cache
    mk = lambda d: DataHelper(d, CyclicSampler(len(d), 2, seed=0, dim=(64, 64)),  # noqa: E731
                              max_net_batches=2, prefetch=0)
    plain = [b["img"].copy() for b in mk(ds)]
    cached = [b["img"].copy() for b in mk(DS.CachedDataset(ds))]
    for a, b in zip(plain, cached):
        np.testing.assert_array_equal(a, b)


def _batches(helper):
    try:
        return [{k: b[k] for k in ("img", "label", "lb_reverter", "img_path")}
                for b in helper]
    finally:
        helper.close()


def test_python_path_datahelper_matches_jax_and_the_committed_labels(tmp_path):
    """The phase-8 training schedule (multi-scale, uint8 feed) on the Python
    path: batches bit-identical to the JAX DataHelper's, labels bit-equal to
    the committed ones, and the same again on a second run."""
    lst = scenes_list(tmp_path / "scenes.txt")
    want = np.load(osp.join(SCENES, "expected_labels.npz"))
    runs = []
    for pkg in ("port", "jax", "port"):
        ds_cls, sampler_cls, helper_cls, tr = (
            (DS.ListDataset, CyclicSampler, DataHelper, T) if pkg == "port" else
            (JDS.ListDataset, JSampler, JDataHelper, JT))
        ds = ds_cls(lst, trans_fn=functools.partial(tr.training_transform, feed_u8=True))
        sampler = sampler_cls(len(ds), 8, seed=12, rand_dim_interval=16)
        runs.append(_batches(helper_cls(ds, sampler, max_net_batches=3, net_subdivisions=2,
                                        prefetch=0)))
    assert len(runs[0]) == len(runs[1]) == 6
    for b, (port, jax_, again) in enumerate(zip(*runs)):
        for k in ("img", "label", "lb_reverter"):
            np.testing.assert_array_equal(port[k], jax_[k], err_msg=k)
            np.testing.assert_array_equal(port[k], again[k], err_msg=k)
        assert port["img"].dtype == np.uint8 and port["img"].shape[1] == want["dims"][b]
        np.testing.assert_array_equal(port["label"], want["labels"][b])
        assert [osp.basename(p) for p in port["img_path"]] == list(want["paths"][b])
