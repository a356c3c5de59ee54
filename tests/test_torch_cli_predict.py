"""The port's CLI (``yolo_v3_tpu_torch/cli.py``), ``predict.py``,
``viz/draw.py`` and ``utils/profiling.py`` against the JAX package's, on the
CPU (``--device cpu``); the counterpart of ``tests/test_cli_predict.py``.

Tolerances and why:
* ``detect`` prints rows with 3 decimals of prob and 1 of pixels: the
  port's printed numbers equal the JAX CLI's within one unit of the last
  printed digit (fp32: the two frameworks' float sums differ in order; int8:
  JAX run op by op, where ``jax.jit`` would contract the int8 epilogues into
  FMAs and move rounding ties, ROADMAP section C fact 3);
* the palette, the OpenCV drawing, ``parse_dim_range`` and the parser's
  defaults: equal.
"""

import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time

import cv2
import jax
import numpy as np
import pytest
import torch

from yolo_v3_tpu import cli as jcli
from yolo_v3_tpu.models import darknet as JD
from yolo_v3_tpu.models import weights as JW
from yolo_v3_tpu.viz import draw as jdraw
from yolo_v3_tpu_torch import cli
from yolo_v3_tpu_torch.detector import Detector
from yolo_v3_tpu_torch.models import quantized as Q
from yolo_v3_tpu_torch.models import weights as W
from yolo_v3_tpu_torch.utils.config import YoloConfig
from yolo_v3_tpu_torch.viz import draw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["aaa", "bbb", "ccc"]
ROW = re.compile(r"^(\w+) prob=([\d.]+) xywh=\(([-\d.]+), ([-\d.]+), ([-\d.]+), ([-\d.]+)\)$")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and a
    CPU training step at full width oversubscribes the cores with more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_weights(tmp_path_factory):
    """``tests/test_cli_predict.py``'s model: JAX ``init_yolonet`` seed 0, 3
    classes, blocks (1,1,1,1,1), as darknet ``.weights`` and as a JAX npz
    pytree."""
    root = tmp_path_factory.mktemp("w")
    params, state = JD.init_yolonet(jax.random.PRNGKey(0), num_classes=3,
                                    blocks=(1, 1, 1, 1, 1))
    wpath = str(root / "model.weights")
    JW.save_darknet_weights(params, state, wpath, seen=5)
    npath = str(root / "model.npz")
    JW.save_pytree({"params": params, "state": state}, npath)
    return wpath, npath


@pytest.fixture(scope="module")
def names_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("n") / "names.txt"
    p.write_text("\n".join(NAMES) + "\n")
    return str(p)


@pytest.fixture(scope="module")
def image_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("i") / "img_0001.jpg"
    rng = np.random.default_rng(0)
    cv2.imwrite(str(p), rng.integers(0, 255, (96, 128, 3), dtype=np.uint8))
    return str(p)


@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("clicoco")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(9)
    paths = []
    for i in range(4):
        p = root / "images" / f"img_{i:04d}.jpg"
        cv2.imwrite(str(p), rng.integers(0, 255, (96, 128, 3), dtype=np.uint8))
        np.savetxt(str(root / "labels" / f"img_{i:04d}.txt"),
                   np.array([[1, 0.5, 0.5, 0.4, 0.4]], np.float32), fmt="%.6f")
        paths.append(str(p))
    (root / "list.txt").write_text("\n".join(paths) + "\n")
    return root


def _rows(out):
    """The detection lines of ``detect``'s output, parsed."""
    rows = []
    for ln in out.splitlines():
        m = ROW.match(ln)
        if m:
            rows.append((m.group(1), *(float(v) for v in m.groups()[1:])))
    return rows


def _assert_printed_rows_equal(got, want):
    assert len(got) == len(want) and len(want) > 0
    for g, w in zip(got, want):
        assert g[0] == w[0]
        assert abs(g[1] - w[1]) <= 1e-3 + 1e-9
        np.testing.assert_allclose(g[2:], w[2:], rtol=0, atol=0.1 + 1e-9)


# ---------------------------------------------------------------------------
# the parser
# ---------------------------------------------------------------------------

def _flags(parser):
    """{subcommand: {option string: default}} of an argparse parser."""
    sub = next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction")
    return {name: {opt: a.default for a in p._actions for opt in a.option_strings
                   if opt not in ("-h", "--help")} | {a.dest: a.default for a in p._actions
                                                       if not a.option_strings}
            for name, p in sub.choices.items()}


def test_every_jax_flag_exists_with_its_default():
    """Every subcommand and flag of the JAX ``build_parser()`` is in the
    port's with the same default; the only new flag is ``--device``, on every
    subcommand, defaulting to the card."""
    want, got = _flags(jcli.build_parser()), _flags(cli.build_parser())
    assert set(got) == set(want)
    for name, flags in want.items():
        for flag, default in flags.items():
            assert flag in got[name], (name, flag)
            assert got[name][flag] == default, (name, flag)
        assert set(got[name]) - set(flags) == {"--device"}, name
        assert got[name]["--device"] == "cuda"


def test_parser_covers_reference_train_knobs():
    args = cli.build_parser().parse_args([
        "train", "--train-list", "x.txt", "--names", "n.txt",
        "--batch-size", "64", "--subdivisions", "4", "--lr", "1e-3",
        "--backbone-lr", "1e-4", "--weight-decay", "5e-4",
        "--momentum", "0.9", "--multi-scale", "--freeze-backbone",
        "--backbone-weights", "darknet53.conv.74", "--resume",
        "--data-parallel", "--jitter", "0.3", "--hue", "0.1",
    ])
    assert args.batch_size == 64 and args.multi_scale and args.resume
    assert args.data_parallel and args.device == "cuda"


@pytest.mark.parametrize("spec", ["320,608", "64,96", "32,32", "416,416", "320,600",
                                  "608,320", "0,64", "abc", "64"])
def test_parse_dim_range_equals_jax(spec):
    try:
        want = jcli.parse_dim_range(spec)
    except SystemExit as e:
        with pytest.raises(SystemExit, match=str(e)):
            cli.parse_dim_range(spec)
        return
    assert cli.parse_dim_range(spec) == want


def test_s2d_entry_raises(names_file, coco_dir, tmp_path):
    with pytest.raises(ValueError, match="Do not port"):
        cli.main(["train", "--train-list", str(coco_dir / "list.txt"), "--names", names_file,
                  "--weight-dir", str(tmp_path), "--s2d-entry", "--device", "cpu"])


# ---------------------------------------------------------------------------
# weights, detect
# ---------------------------------------------------------------------------

def test_weights_inspect_equals_jax(tiny_weights, capsys):
    wpath, _ = tiny_weights
    jcli.main(["weights", "inspect", wpath])
    want = json.loads(capsys.readouterr().out)
    cli.main(["weights", "inspect", wpath])
    got = json.loads(capsys.readouterr().out)
    assert got == want and got["seen"] == 5 and got["n_floats"] > 1e6


def test_weights_convert_equals_jax(tiny_weights, tmp_path, capsys):
    wpath, _ = tiny_weights
    args = ["--num-classes", "3", "--blocks", "1,1,1,1,1"]
    cli.main(["weights", "convert", wpath, "--out", str(tmp_path / "port.npz"), *args])
    jcli.main(["weights", "convert", wpath, "--out", str(tmp_path / "jax.npz"), *args])
    (got, got_meta), (want, want_meta) = (W.read_npz(str(tmp_path / f"{n}.npz"))
                                          for n in ("port", "jax"))
    assert got_meta == want_meta and got_meta["seen"] == 5
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_weights_quantize_serves_like_the_in_process_detector(tiny_weights, image_file,
                                                              tmp_path):
    """``weights quantize`` writes an artifact that ``detect`` loads as it is;
    its rows equal an int8 Detector calibrated the same way in this process."""
    _, npath = tiny_weights
    out = str(tmp_path / "q.npz")
    cli.main(["weights", "quantize", npath, "--out", out, "--num-classes", "3",
              "--dim", "96", "--device", "cpu"])
    assert Q.is_quantized_file(out)
    cfg = YoloConfig(num_classes=3, img_dim=96)
    img = cv2.cvtColor(cv2.imread(image_file), cv2.COLOR_BGR2RGB)
    want = Detector.from_checkpoint(npath, cfg, precision="int8", device="cpu")
    got = Detector.from_quantized(out, cfg, device="cpu")
    for g, w in zip(got.detect([img], conf_thr=0.2), want.detect([img], conf_thr=0.2)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_detect_rows_equal_jax_cli(tiny_weights, names_file, image_file, tmp_path, capsys,
                                   precision):
    """``detect`` on the same weights file and image prints the JAX CLI's
    rows (int8: JAX run op by op) and saves a PNG that decodes."""
    _, npath = tiny_weights
    args = ["detect", "--image", image_file, "--weights", npath, "--names", names_file,
            "--dim", "96", "--precision", precision, "--conf-thr", "0.2"]
    out_img = str(tmp_path / "out.png")
    cli.main(args + ["--device", "cpu", "--out", out_img])
    got = _rows(capsys.readouterr().out)
    with jax.disable_jit(precision == "int8"):
        jcli.main(args)
    want = _rows(capsys.readouterr().out)
    _assert_printed_rows_equal(got, want)
    assert cv2.imread(out_img).shape == (96, 128, 3)


# ---------------------------------------------------------------------------
# train, eval
# ---------------------------------------------------------------------------

def test_cli_train_then_eval(coco_dir, names_file, tmp_path, capsys):
    from yolo_v3_tpu_torch.train.checkpoint import get_latest_checkpoint, load_checkpoint

    wdir = str(tmp_path / "weights")
    try:
        cli.main(["train", "--train-list", str(coco_dir / "list.txt"), "--names", names_file,
                  "--model-id", "clitest", "--weight-dir", wdir, "--dim", "64",
                  "--batch-size", "2", "--subdivisions", "1", "--max-net-batches", "2",
                  "--checkpoint-interval", "2", "--device", "cpu"])
        path, it = get_latest_checkpoint("clitest", wdir)
        assert path is not None and it >= 1
        assert load_checkpoint(path)["mesh_shape"] is None
    finally:
        shutil.rmtree(wdir, ignore_errors=True)     # a full-size checkpoint, ~0.5 GB
    for precision in ("fp32", "int8"):
        workdir = str(tmp_path / f"eval_{precision}")
        cli.main(["eval", "--val-list", str(coco_dir / "list.txt"), "--weights", "random",
                  "--names", names_file, "--dim", "64", "--batch-size", "2", "--letterbox",
                  "--precision", precision, "--workdir", workdir, "--device", "cpu"])
        mAP = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["mAP@0.5"]
        assert 0.0 <= mAP <= 1.0
        assert isinstance(json.load(open(os.path.join(workdir, "results.json"))), list)


def test_cli_train_no_aug_cache_metrics(coco_dir, names_file, tmp_path):
    """--no-aug --cache --metrics-jsonl: letterbox-only cached training writes
    one raw-stats JSON line per net-batch."""
    from yolo_v3_tpu_torch.train.checkpoint import get_latest_checkpoint

    wdir = str(tmp_path / "weights")
    mpath = str(tmp_path / "metrics.jsonl")
    try:
        cli.main(["train", "--train-list", str(coco_dir / "list.txt"), "--names", names_file,
                  "--model-id", "noaug", "--weight-dir", wdir, "--dim", "64",
                  "--batch-size", "2", "--subdivisions", "1", "--max-net-batches", "3",
                  "--no-aug", "--cache", "--metrics-jsonl", mpath, "--burn-in", "2",
                  "--checkpoint-interval", "3", "--device", "cpu"])
        path, it = get_latest_checkpoint("noaug", wdir)
        assert path is not None and it >= 1
    finally:
        shutil.rmtree(wdir, ignore_errors=True)
    rows = [json.loads(ln) for ln in open(mpath)]
    assert [r["net_batch"] for r in rows] == [1, 2, 3]
    assert all("loss" in r and "recall" in r for r in rows)


def test_cli_train_cache_requires_no_aug(coco_dir, names_file, tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["train", "--train-list", str(coco_dir / "list.txt"), "--names", names_file,
                  "--weight-dir", str(tmp_path / "w"), "--dim", "64", "--batch-size", "2",
                  "--subdivisions", "1", "--max-net-batches", "1", "--cache",
                  "--device", "cpu"])


def test_cli_train_data_parallel_under_torchrun(coco_dir, names_file, tmp_path):
    """``torchrun --nproc-per-node 2 -m yolo_v3_tpu_torch.cli train
    --data-parallel --device cpu``: two gloo ranks split the global batch,
    rank 0 writes the checkpoints, which record the mesh (2, 1)."""
    from yolo_v3_tpu_torch.train.checkpoint import get_checkpoint_list, load_checkpoint

    wdir = str(tmp_path / "weights")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env.update(PYTHONPATH=os.pathsep.join([REPO, env.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="2")
    try:
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", "yolo_v3_tpu_torch.cli", "train",
             "--data-parallel", "--device", "cpu", "--train-list", str(coco_dir / "list.txt"),
             "--names", names_file, "--model-id", "dp", "--weight-dir", wdir, "--dim", "64",
             "--batch-size", "4", "--subdivisions", "1", "--max-net-batches", "1",
             "--no-aug"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
        assert "mesh: (2, 1)" in r.stderr
        (path,) = get_checkpoint_list("dp", wdir)
        assert load_checkpoint(path)["mesh_shape"] == (2, 1)
    finally:
        shutil.rmtree(wdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# predict, viz, profiling
# ---------------------------------------------------------------------------

def _samples():
    rng = np.random.default_rng(0)
    return [{"img": rng.integers(0, 255, (80, 100, 3), dtype=np.uint8),
             "org_img": rng.integers(0, 255, (80, 100, 3), dtype=np.uint8),
             "label": np.array([[1, 0.5, 0.5, 0.4, 0.4]], np.float32)} for _ in range(3)]


def test_predict_rows_equal_detector(tmp_path):
    from yolo_v3_tpu_torch.models import darknet as D
    from yolo_v3_tpu_torch.predict import (predict, predict_multiple, show_detections,
                                           show_detections_comparisons)

    cfg = YoloConfig(num_classes=3, img_dim=64, pre_nms_topk=64, max_detections=16)
    dets = [Detector(*D.init_yolonet(torch.Generator().manual_seed(s), 3,
                                     blocks=(1, 1, 1, 1, 1)), cfg, precision="fp32",
                     device="cpu") for s in (0, 1)]
    samples = _samples()
    orgs = [s["org_img"] for s in samples]
    imgs, preds = predict(samples, dets[0], conf_thr=0.2, batch_size=2)
    assert all(np.array_equal(a, b) for a, b in zip(imgs, orgs))
    for g, w in zip(preds, dets[0].detect(orgs, conf_thr=0.2)):
        np.testing.assert_array_equal(g, w)

    imgs, per_model, labels = predict_multiple(samples, dets, conf_thr=0.2)
    for det, preds in zip(dets, per_model):
        for g, w in zip(preds, det.detect(orgs, conf_thr=0.2)):
            np.testing.assert_array_equal(g, w)
    assert labels[0][0][3] == pytest.approx(40.0)       # 0.4 * 100, absolute xywh
    # plain HWC arrays are samples too
    _, preds = predict(orgs, dets[1], conf_thr=0.2)
    for g, w in zip(preds, per_model[1]):
        np.testing.assert_array_equal(g, w)

    for path, fn in ((str(tmp_path / "cmp.png"), functools.partial(
            show_detections_comparisons, dets, samples, NAMES)),
                     (str(tmp_path / "one.png"), functools.partial(
            show_detections, samples, dets[0], NAMES))):
        fn(conf_thr=0.2, save_path=path)
        assert cv2.imread(path) is not None


def test_color_palette_equals_jax():
    for n in range(1, 101):
        want = [tuple(float(v) for v in c) for c in jdraw.get_color_palette(n)]
        assert draw.get_color_palette(n) == want, n


@pytest.mark.parametrize("classes", [None, NAMES])
def test_draw_detections_cv2_equals_jax_pixel_for_pixel(classes, tmp_path):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)
    dets = np.array([[0, 10.4, 30.2, 50.0, 40.0, 0.91, 0.8],
                     [2, 80.0, 20.0, 70.0, 90.0, 0.55, 0.6],
                     [1, -5.0, 100.0, 30.0, 30.0, 0.30, 0.4]], np.float32)
    np.testing.assert_array_equal(draw.draw_detections_cv2(img, dets, classes),
                                  jdraw.draw_detections_cv2(img, dets, classes))
    assert np.array_equal(draw.draw_detections_cv2(img, dets[:0]), img)
    draw.save_detections_image(img, dets, str(tmp_path / "p.png"), classes)
    jdraw.save_detections_image(img, dets, str(tmp_path / "j.png"), classes)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "p.png")),
                                  cv2.imread(str(tmp_path / "j.png")))


def test_step_timer_fields():
    """``tests/test_utils_misc.py::TestStepTimer`` on the host clock
    (``device="cpu"``; the card's CUDA events run on the chip)."""
    from yolo_v3_tpu_torch.utils.profiling import StepTimer

    t = StepTimer(warmup=0, device="cpu")
    for _ in range(3):
        with t.step(n_items=4):
            time.sleep(0.01)
    s = t.summary()
    assert s["steps"] == 3
    assert s["p50_ms"] >= 10.0
    assert s["items_per_sec"] > 0
    assert set(s) == {"steps", "p50_ms", "p90_ms", "mean_ms", "items_per_sec"}
    t = StepTimer(warmup=1, device="cpu")
    for _ in range(3):
        with t.step(n_items=2):
            t.mark()
    assert t.summary()["steps"] == 2 and len(t.times) == 3


def test_trace_writes_a_chrome_trace(tmp_path):
    from yolo_v3_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path)) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert any("mm" in e.key for e in prof.key_averages())
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
