"""The port's native C++ image runtime (``yolo_v3_tpu_torch/csrc/yolodata.cc``
through ``data/native_loader.py`` and ``data/native_aug.py``), its host build
(``ops/_build.py::build_host``) and the native branch of its ``DataHelper``,
against the JAX package's native path and its Python path.

Tolerances and why:
* port native against JAX native (the same C++ source and g++ flags):
  bit-identical, float32 and uint8;
* native letterbox against OpenCV's (libjpeg's decode and float cubic
  sampling against cv2's decoder and fixed-point cubic): mean |diff| < 0.01
  and max < 0.12 in [0, 1] (``tests/test_native_loader.py:47-48``);
* the native augment chain against the Python chain: labels and reverters
  bit-equal; pixels within one uint8 level on under 0.1% of pixels
  (cv2's HSV2RGB float-order boundary cases, ``tests/test_native_aug.py``'s
  bars); batches decoded from JPEG within the decoder tolerance above;
* image sizes read by the native decode: equal to OpenCV's.

The tests skip where g++ or libjpeg is missing, as the JAX package's do.
"""

import functools
import os
import os.path as osp

import numpy as np
import pytest

from yolo_v3_tpu.data import native_aug as JNA
from yolo_v3_tpu.data import transforms as JT
from yolo_v3_tpu.data.datasets import ListDataset as JListDataset
from yolo_v3_tpu.data.loader import DataHelper as JDataHelper
from yolo_v3_tpu.data.native_loader import NativePrefetcher as JPrefetcher
from yolo_v3_tpu.data.sampler import CyclicSampler as JSampler
from yolo_v3_tpu_torch.data import native_aug as NA
from yolo_v3_tpu_torch.data import native_loader as NL
from yolo_v3_tpu_torch.data import transforms as T
from yolo_v3_tpu_torch.data.datasets import ListDataset
from yolo_v3_tpu_torch.data.loader import DataHelper
from yolo_v3_tpu_torch.data.sampler import CyclicSampler
from yolo_v3_tpu_torch.eval import coco_json
from yolo_v3_tpu_torch.ops import _build
from yolo_v3_tpu_torch.ops.letterbox import letterbox_host

SCENES = osp.join(osp.dirname(osp.abspath(__file__)), "data", "torch_scenes")
LABEL = np.array(
    [[1, 0.5, 0.5, 0.4, 0.3], [7, 0.2, 0.3, 0.15, 0.2],
     [3, 0.9, 0.85, 0.3, 0.4], [0, 0.05, 0.95, 0.08, 0.09]], np.float32)


@pytest.fixture(scope="module", autouse=True)
def native():
    """Skip where the port's library cannot be built (no g++ or libjpeg)."""
    try:
        NL.load_library()
    except RuntimeError as e:
        pytest.skip(f"native toolchain/libjpeg unavailable: {str(e)[:200]}")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The committed scenes' list file and paths (absolute, sorted)."""
    img_dir = osp.join(SCENES, "images")
    paths = [osp.join(img_dir, n) for n in sorted(os.listdir(img_dir)) if n.endswith(".jpg")]
    lst = tmp_path_factory.mktemp("scenes") / "scenes.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst), paths


# ---------------------------------------------------------------------------
# the host build
# ---------------------------------------------------------------------------

def test_host_build_is_hash_keyed_atomic_and_follows_the_source(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    src = csrc / "probe.cc"
    src.write_text('extern "C" int probe() { return 1; }\n')
    first = _build.build_host("probe")
    assert first == build / f"probe-{_build.source_digest(src, _build.HOST_FLAGS + _build.HOST_LIBS)}.so"
    assert _build.source_digest(src, _build.HOST_FLAGS + _build.HOST_LIBS) != \
        _build.source_digest(src)                   # the flags are in the key
    mtime = first.stat().st_mtime_ns
    assert _build.build_host("probe") == first and first.stat().st_mtime_ns == mtime
    src.write_text('extern "C" int probe() { return 2; }\n')
    second = _build.build_host("probe")
    assert second != first and first.exists() and second.exists()
    # a failed build raises with g++'s stderr and leaves no file behind
    before = sorted(os.listdir(build))
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed building probe.cc"):
        _build.build_host("probe")
    assert sorted(os.listdir(build)) == before
    # only finished libraries and their logs: every build was renamed into place
    assert all(n.endswith((".so", ".log")) and n.startswith("probe-") for n in before)


def test_a_library_that_does_not_load_raises_runtime_error(tmp_path, monkeypatch):
    """A cached library whose dependencies this host lacks (one built on
    another machine) fails like a failed build: RuntimeError, which the
    callers turn into their own errors."""
    bogus = tmp_path / "yolodata-0.so"
    bogus.write_text("not a shared object\n")
    monkeypatch.setattr(_build, "build_host", lambda name: bogus)
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="cannot load"):
        _build.load_host("yolodata")


def test_yolodata_builds_from_the_ports_own_source():
    path = _build.build_host("yolodata")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("yolodata-")
    assert _build.CSRC_DIR.parent.name == "yolo_v3_tpu_torch"


def test_native_threads_without_a_library_raise_with_the_build_error(scenes, monkeypatch):
    """No silent fallback: a build that fails (here, a libjpeg that does not
    link) makes DataHelper(native_threads>0) raise with g++'s error."""
    lst, _ = scenes
    ds = ListDataset(lst, trans_fn=T.training_transform)
    sampler = CyclicSampler(len(ds), 8, dim=(96, 96))
    monkeypatch.setattr(_build, "HOST_LIBS", ("-lno_such_jpeg", "-lpthread"))
    monkeypatch.setattr(_build, "_LIBS", {})
    NL.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="no_such_jpeg"):
            DataHelper(ds, sampler, max_batches=1, native_threads=2)
        assert not NL.native_available()
    finally:
        NL.load_library.cache_clear()
    # without native_threads the Python path needs no library
    DataHelper(ds, sampler, max_batches=1).close()


# ---------------------------------------------------------------------------
# NativePrefetcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_prefetcher_matches_jax_and_opencv(scenes, dtype):
    import cv2

    _, paths = scenes
    paths = paths[:6]
    with NL.NativePrefetcher(n_threads=2, dtype=dtype) as pf:
        out, orgs, ok = pf.load_letterboxed(paths, (416, 416))
    with JPrefetcher(n_threads=2, dtype=dtype) as pf:
        jout, jorgs, jok = pf.load_letterboxed(paths, (416, 416))
    assert all(ok) and ok == jok and out.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(orgs, jorgs)
    for i, p in enumerate(paths):
        img = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
        assert tuple(orgs[i]) == (img.shape[1], img.shape[0])
        got = out[i].astype(np.float32) / 255.0 if dtype == "uint8" else out[i]
        diff = np.abs(got - letterbox_host(img, (416, 416)))
        assert diff.mean() < 0.01 and diff.max() < 0.12


def test_prefetcher_missing_and_invalid_files(scenes, tmp_path):
    _, paths = scenes
    bad = tmp_path / "not_a_jpeg.jpg"
    bad.write_bytes(b"hello world")
    with NL.NativePrefetcher(n_threads=1) as pf:
        out, orgs, ok = pf.load_letterboxed([paths[0], str(bad), str(tmp_path / "no.jpg")],
                                            (64, 64))
        sizes, size_ok = pf.image_sizes([paths[0], str(bad), str(tmp_path / "no.jpg")])
    assert ok == size_ok == [True, False, False]
    assert np.all(out[1] == 0) and np.all(out[2] == 0)
    assert tuple(sizes[0]) == tuple(orgs[0]) and not sizes[1:].any()
    with pytest.raises(ValueError):
        NL.NativePrefetcher(dtype="float16")


def test_prefetcher_orders_results_by_tag(scenes):
    _, paths = scenes
    many = paths[:3] * 7                     # 21 jobs across 2 threads
    with NL.NativePrefetcher(n_threads=2) as pf:
        out, _, ok = pf.load_letterboxed(many, (96, 96))
        sizes, size_ok = pf.image_sizes(many)
    assert all(ok) and all(size_ok)
    for i in range(3, len(many)):
        np.testing.assert_array_equal(out[i], out[i % 3])
        np.testing.assert_array_equal(sizes[i], sizes[i % 3])


def test_native_image_sizes_equal_opencvs(scenes):
    """coco_json's two routes to the image sizes agree."""
    _, paths = scenes
    assert coco_json.image_sizes_native(paths) == coco_json.image_sizes_cv2(paths)


# ---------------------------------------------------------------------------
# the augment chain
# ---------------------------------------------------------------------------

def _python_and_native(img, label, seed, dim, trans=None):
    trans = trans or T.training_transform(dim)
    spec = NA.compile_transform(trans)
    py = trans({"img": img.copy(), "label": None if label is None else label.copy(),
                "rng": np.random.default_rng(seed)})
    h, w = img.shape[:2]
    p = NA.draw_aug_params(np.random.default_rng(seed), w, h, spec)
    jp = JNA.draw_aug_params(np.random.default_rng(seed), w, h,
                             JNA.compile_transform(_jax_chain(trans)))
    assert vars(p) == vars(jp)
    nimg = NA.augment_buffer(img, p, dim, dtype="uint8")
    np.testing.assert_array_equal(nimg, JNA.augment_buffer(img, jp, dim, dtype="uint8"))
    nlab, nrev = NA.transform_labels(None if label is None else label.copy(), w, h, p, dim, spec)
    return py, nimg.astype(np.float32) / 255.0, nlab, nrev


def _jax_chain(trans):
    """The JAX Compose with the same steps and hyperparameters."""
    hsv, crop, flip, lbox, toarr = trans.transforms
    return JT.Compose([JT.HSVAug(hsv.hue, hsv.saturation, hsv.exposure),
                       JT.RandomJitterCrop(crop.jitter), JT.RandomHorizontalFlip(flip.p),
                       JT.Letterbox(lbox.dim), JT.ToArray(toarr.max_labels)])


def test_augment_chain_matches_jax_native_and_the_python_path():
    img = np.random.default_rng(7).integers(0, 256, (240, 320, 3), dtype=np.uint8)
    for seed in range(16):
        label = None if seed == 5 else LABEL
        py, nimg, nlab, nrev = _python_and_native(img, label, seed, (416, 416))
        np.testing.assert_array_equal(nlab, py["label"])
        np.testing.assert_array_equal(nrev, py["lb_reverter"])
        diff = np.abs(nimg - py["img"])
        assert diff.max() <= 1.0 / 255 + 1e-6
        assert (diff > 0.5 / 255).mean() < 1e-3


def test_augment_float_output_is_the_uint8_output_over_255():
    img = np.random.default_rng(9).integers(0, 256, (97, 215, 3), dtype=np.uint8)
    p = NA.AugParams(0.05 * 179, 1.2, 0.8, 5, -7, -3, 9, True)
    u8 = NA.augment_buffer(img, p, (128, 128), dtype="uint8")
    f32 = NA.augment_buffer(img, p, (128, 128))
    np.testing.assert_array_equal(f32, JNA.augment_buffer(img, p, (128, 128)))
    assert np.abs(u8.astype(np.float32) - f32 * 255.0).max() <= 0.5 + 1e-3
    with pytest.raises(ValueError):
        NA.augment_buffer(img.astype(np.float32), p, (128, 128))


def test_degenerate_crop_draws_skip_the_label_clip():
    trans = T.Compose([T.HSVAug(0.1, 1.5, 1.5), T.RandomJitterCrop(jitter=0.6),
                       T.RandomHorizontalFlip(0.5), T.Letterbox((64, 64)), T.ToArray(90)])
    spec = NA.compile_transform(trans)
    img = np.random.default_rng(1).integers(0, 256, (10, 10, 3), dtype=np.uint8)
    hit = 0
    for seed in range(200):
        if NA.draw_aug_params(np.random.default_rng(seed), 10, 10, spec).crop_applied:
            continue
        hit += 1
        py, nimg, nlab, nrev = _python_and_native(img, LABEL, seed, (64, 64), trans)
        np.testing.assert_array_equal(nlab, py["label"])
        np.testing.assert_array_equal(nrev, py["lb_reverter"])
        # a 6.4x cubic upscale doubles the HSV one-level cases
        assert np.abs(nimg - py["img"]).max() <= 2.0 / 255 + 1e-6
    assert hit > 0


def test_compile_transform_rejects_chains_it_cannot_take():
    assert NA.compile_transform(T.eval_transform((416, 416))) is None
    assert NA.compile_transform(T.training_transform((416, 416), extra_aug=True)) is None
    custom_pad = T.training_transform((416, 416))
    custom_pad.transforms[1].pad_value = 0
    assert NA.compile_transform(custom_pad) is None
    spec = NA.compile_transform(T.training_transform((416, 416), feed_u8=True))
    assert spec == NA.NativeAugSpec(**vars(JNA.compile_transform(
        JT.training_transform((416, 416), feed_u8=True))))


# ---------------------------------------------------------------------------
# DataHelper's native branch
# ---------------------------------------------------------------------------

def _run(helper):
    try:
        return [{k: b[k] for k in ("img", "label", "lb_reverter", "img_path")}
                for b in helper], getattr(helper, "native_stats", None)
    finally:
        helper.close()


@pytest.mark.parametrize("feed_u8", [True, False])
def test_native_datahelper_matches_jax_native_and_the_python_labels(scenes, feed_u8):
    """The phase-8 schedule (multi-scale, dims 448 and 544) at native_threads=2:
    bit-identical to the JAX DataHelper(native_threads=2), every sample
    native, labels bit-equal to the Python path's and the committed ones;
    pixels within the decoder tolerance of the Python path's."""
    lst, _ = scenes
    want = np.load(osp.join(SCENES, "expected_labels.npz"))
    n_batches = 2 if feed_u8 else 1

    def helper(pkg, threads):
        ds_cls, sampler_cls, helper_cls, tr = (
            (ListDataset, CyclicSampler, DataHelper, T) if pkg == "port" else
            (JListDataset, JSampler, JDataHelper, JT))
        ds = ds_cls(lst, trans_fn=functools.partial(tr.training_transform, feed_u8=feed_u8))
        sampler = sampler_cls(len(ds), 8, seed=12, rand_dim_interval=16)
        # the port prefetches (its close() stops the thread before the pool);
        # the JAX DataHelper closes its pool under a running prefetch thread
        prefetch = int(feed_u8 and pkg == "port")
        return helper_cls(ds, sampler, max_batches=n_batches, prefetch=prefetch,
                          native_threads=threads)

    port, stats = _run(helper("port", 2))
    jax_native, _ = _run(helper("jax", 2))
    python, _ = _run(helper("port", 0))
    # the prefetch thread may assemble a batch ahead of the last one read
    assert stats["fallback"] == 0 and stats["native"] >= 8 * n_batches
    for b in range(n_batches):
        for k in ("img", "label", "lb_reverter"):
            np.testing.assert_array_equal(port[b][k], jax_native[b][k], err_msg=k)
        np.testing.assert_array_equal(port[b]["label"], python[b]["label"])
        np.testing.assert_array_equal(port[b]["lb_reverter"], python[b]["lb_reverter"])
        np.testing.assert_array_equal(port[b]["label"], want["labels"][b])
        assert port[b]["img"].dtype == (np.uint8 if feed_u8 else np.float32)
        scale = 255.0 if feed_u8 else 1.0
        diff = np.abs(port[b]["img"] / scale - python[b]["img"] / scale)
        assert diff.mean() < 0.01 and diff.max() < 0.13


def test_non_jpeg_sample_falls_back_alone(scenes, tmp_path):
    import cv2

    _, paths = scenes
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    png = str(tmp_path / "images" / "scene_000099.png")
    img = np.random.default_rng(2).integers(0, 256, (50, 70, 3), dtype=np.uint8)
    cv2.imwrite(png, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    np.savetxt(str(tmp_path / "labels" / "scene_000099.txt"), LABEL, fmt="%.6f")
    lst = tmp_path / "mixed.txt"
    lst.write_text("\n".join(paths[:3] + [png]) + "\n")
    ds = ListDataset(str(lst), trans_fn=T.training_transform)
    sampler = CyclicSampler(len(ds), batch_size=4, seed=5, dim=(128, 128))
    (batch,), stats = _run(DataHelper(ds, sampler, max_batches=1, prefetch=0,
                                      native_threads=2))
    assert stats == {"native": 3, "fallback": 1}
    assert batch["img"].shape == (4, 128, 128, 3) and batch["label"].shape == (4, 90, 5)
    i = batch["img_path"].index(png)
    base, dim, seed = sampler.schedule(i)
    want = ds.get(base, dim, seed)
    np.testing.assert_array_equal(batch["label"][i], want["label"])
    np.testing.assert_array_equal(batch["img"][i], want["img"])


def test_native_branch_refuses_what_it_cannot_take(scenes):
    lst, _ = scenes
    ds = ListDataset(lst, trans_fn=functools.partial(T.training_transform, extra_aug=True))
    helper = DataHelper(ds, CyclicSampler(len(ds), 4, dim=(96, 96)), max_batches=1,
                        prefetch=0, native_threads=2)
    with pytest.raises(ValueError, match="darknet training chain"):
        _run(helper)

    class NoRawEntry:
        trans_fn = staticmethod(T.training_transform)

        def __len__(self):
            return 4

    with pytest.raises(ValueError, match="raw_entry"):
        DataHelper(NoRawEntry(), CyclicSampler(4, 4, dim=(96, 96)), native_threads=2)


def test_close_under_a_running_prefetch_thread(scenes):
    """close() right after the first batch, while the prefetch thread is
    assembling the next ones on the native pool: it stops and joins the
    thread before it destroys the pool (else the thread would run on a freed
    loader).  Repeated, at more native threads than cores."""
    lst, _ = scenes
    ds = ListDataset(lst, trans_fn=T.training_transform)
    for seed in range(12):
        helper = DataHelper(ds, CyclicSampler(len(ds), 4, seed=seed, dim=(96, 96)),
                            max_batches=6, prefetch=2, native_threads=2 * os.cpu_count())
        batch = next(iter(helper))
        thread = helper._prefetcher[1]
        helper.close()
        assert batch["img"].shape == (4, 96, 96, 3)
        assert not thread.is_alive() and helper._native is None
