"""The port's training loop, checkpoints, sampler and loader: resume ==
one go, preemption, the final checkpoint, GC, determinism, multi-scale, the
worker pool, and composite checkpoints crossing the two packages (mirrors
``tests/test_train_loop.py`` on an in-memory dataset)."""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_v3_tpu.detector import Detector as JDetector
from yolo_v3_tpu.models import darknet as JD
from yolo_v3_tpu.train import checkpoint as JCK
from yolo_v3_tpu.train import display as JDisplay
from yolo_v3_tpu.train import optimizer as JO
from yolo_v3_tpu.train.recorder import Recorder as JRecorder
from yolo_v3_tpu.utils.config import TrainConfig as JTrainConfig
from yolo_v3_tpu.utils.config import YoloConfig as JConfig
from yolo_v3_tpu_torch.data.loader import DataHelper
from yolo_v3_tpu_torch.data.sampler import CyclicSampler
from yolo_v3_tpu_torch.detector import Detector
from yolo_v3_tpu_torch.models import darknet as D
from yolo_v3_tpu_torch.models import weights as TW
from yolo_v3_tpu_torch.train import display as TDisplay
from yolo_v3_tpu_torch.train.checkpoint import (
    get_checkpoint_list,
    get_latest_checkpoint,
    load_checkpoint,
    remove_checkpoints,
    save_checkpoint,
)
from yolo_v3_tpu_torch.train.loop import train
from yolo_v3_tpu_torch.train.optimizer import make_optimizer
from yolo_v3_tpu_torch.train.recorder import Recorder
from yolo_v3_tpu_torch.utils.config import TrainConfig, YoloConfig

CFG = YoloConfig(num_classes=3, img_dim=64)
TCFG = TrainConfig(lr=1e-3, backbone_lr=1e-4, net_subdivisions=2)
BLOCKS = (1, 1, 1, 1, 1)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and a
    CPU training step at full width oversubscribes the cores with more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class MemoryDataset:
    """Seeded uint8 scenes held in memory, one box each; ``get`` resizes to
    the scheduled dim by nearest neighbour (labels are relative, so they
    hold at any dim)."""

    def __init__(self, n=8, hw=96, seed=1):
        rng = np.random.default_rng(seed)
        self.imgs = rng.integers(0, 255, (n, hw, hw, 3), dtype=np.uint8)
        self.labels = np.zeros((n, 4, 5), np.float32)
        self.labels[:, 0] = np.stack([rng.integers(0, 3, n), np.full(n, 0.5),
                                      np.full(n, 0.5), np.full(n, 0.4),
                                      np.full(n, 0.4)], -1)

    def __len__(self):
        return len(self.imgs)

    def get(self, i, dim, seed):
        w, h = dim
        src = self.imgs[i]
        rows = np.arange(h) * src.shape[0] // h
        cols = np.arange(w) * src.shape[1] // w
        return {"img": src[rows][:, cols], "label": self.labels[i].copy(), "rng": seed}


def make_data(max_net_batches, seed=0, **kw):
    ds = MemoryDataset()
    return DataHelper(ds, CyclicSampler(len(ds), 2, seed=seed, dim=(64, 64)),
                      max_net_batches=max_net_batches, net_subdivisions=2, prefetch=0, **kw)


def init():
    return D.init_yolonet(torch.Generator().manual_seed(0), CFG.num_classes, blocks=BLOCKS)


def run(data, **kw):
    return train(data, *init(), CFG, TCFG, device="cpu", log_fn=lambda s: None, **kw)


@pytest.fixture(scope="module")
def one_go():
    """4 net-batches in one run: the reference of the resume tests."""
    return run(make_data(4))


def assert_trees_equal(a, b):
    fa, fb = TW._flatten_with_names(a), TW._flatten_with_names(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("pipeline_stats", [False, True], ids=["drain", "pipelined"])
def test_resume_matches_one_go(one_go, tmp_path, pipeline_stats):
    """Also with the stats read one net-batch late: each checkpoint must
    still hold the recorder up to its own net-batch."""
    p_ref, s_ref, o_ref, rec_ref = one_go
    wdir = str(tmp_path / "w")
    run(make_data(2), model_id="t", weight_dir=wdir, checkpoint_interval=1,
        pipeline_stats=pipeline_stats)
    assert len(get_checkpoint_list("t", wdir)) == 2
    path, it = get_latest_checkpoint("t", wdir)
    assert path is not None and it == 1
    ckpt = load_checkpoint(path)
    assert ckpt["opt_state"]["count"] == 2 and ckpt["recorder"]["net_batches_seen"] == 2
    p2, s2, o2, rec = run(make_data(4), checkpoint=ckpt, pipeline_stats=pipeline_stats)
    assert rec.net_batches_seen == 4 and o2["count"] == o_ref["count"] == 4
    assert rec.state_dict() == rec_ref.state_dict()
    assert_trees_equal(p2, p_ref)
    assert_trees_equal(s2, s_ref)
    assert_trees_equal(o2["trace"], o_ref["trace"])


@pytest.mark.parametrize("pipeline_stats", [False, True], ids=["drain", "pipelined"])
def test_graceful_preemption_checkpoints_and_resumes(one_go, tmp_path, pipeline_stats):
    """SIGTERM while net-batch 0 is logged.  With the stats pipelined that
    line comes after net-batch 1 has run, so the run stops after it."""
    p_ref, s_ref, _, _ = one_go
    wdir = str(tmp_path / "w")
    lines = []

    def log_fn(s):
        lines.append(s)
        if s.startswith("net_batch") and len(lines) == 1:
            signal.raise_signal(signal.SIGTERM)

    handler = signal.getsignal(signal.SIGTERM)
    train(make_data(4), *init(), CFG, TCFG, device="cpu", model_id="t", weight_dir=wdir,
          checkpoint_interval=10_000, log_fn=log_fn, pipeline_stats=pipeline_stats)
    assert signal.getsignal(signal.SIGTERM) == handler       # handlers restored
    assert any("[preempt]" in ln for ln in lines)
    assert sum(ln.startswith("net_batch") for ln in lines) == 1 + pipeline_stats
    path, it = get_latest_checkpoint("t", wdir)
    assert path is not None and it == pipeline_stats   # numbered by net-batch, 0-based
    ckpt = load_checkpoint(path)
    assert ckpt["recorder"]["net_batches_seen"] == 1 + pipeline_stats
    p2, s2, _, _ = run(make_data(4), checkpoint=ckpt, pipeline_stats=pipeline_stats)
    assert_trees_equal(p2, p_ref)
    assert_trees_equal(s2, s_ref)


def test_final_checkpoint_always_written(tmp_path):
    wdir = str(tmp_path / "w")
    p, s, _, _ = run(make_data(3), model_id="t", weight_dir=wdir, checkpoint_interval=10_000)
    path, it = get_latest_checkpoint("t", wdir)
    assert path is not None and it == 3
    ckpt = load_checkpoint(path)
    assert_trees_equal(ckpt["params"], p)
    assert_trees_equal(ckpt["state"], s)


def test_checkpoint_gc(tmp_path):
    d = tmp_path / "gc" / "m"
    d.mkdir(parents=True)
    for i in range(35):
        (d / f"yolov3_m_checkpoint_{i:06d}.npz").write_bytes(b"x")
    remove_checkpoints("m", str(tmp_path / "gc"), num_remove=20, num_keep=10)
    left = sorted(os.listdir(d))
    assert len(left) == 10
    assert left[0] == "yolov3_m_checkpoint_000025.npz"


def test_same_seed_training_is_reproducible():
    p1, _, _, _ = run(make_data(1, seed=11))
    p2, _, _, _ = run(make_data(1, seed=11))
    assert_trees_equal(p1, p2)


def test_multi_scale_training_and_mid_net_batch_dim_change():
    ds = MemoryDataset()
    # dims roll every 4 samples = batch_size * net_subdivisions
    sampler = CyclicSampler(len(ds), 2, seed=4, dim=None, rand_dim_interval=4,
                            dim_mult_range=(2, 4))
    assert {d[0] for d in sampler.dims} <= {64, 96}
    data = DataHelper(ds, sampler, max_net_batches=2, net_subdivisions=2, prefetch=0)
    _, _, _, rec = run(data)
    assert np.isfinite(rec.current_stats["loss"])
    # a dim that changes inside a net-batch (interval 2, S = 2) is refused
    sampler = CyclicSampler(len(ds), 2, seed=0, dim=None, rand_dim_interval=2,
                            dim_mult_range=(2, 4))
    assert len({d[0] for d in sampler.dims}) > 1
    data = DataHelper(ds, sampler, max_net_batches=4, net_subdivisions=2, prefetch=0)
    with pytest.raises(ValueError, match="mid-net-batch"):
        run(data)


def test_worker_pool_and_prefetch_give_the_in_process_batches():
    want = [b["img"] for b in make_data(2)]
    pooled = make_data(2, num_workers=1)
    pooled.prefetch = 2
    try:
        got = [b["img"] for b in pooled]
    finally:
        pooled.close()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_unported_options_raise():
    # the native pool is ported; it takes only a dataset with raw_entry()
    # (ListDataset), and asking for it on another raises, never falls back
    with pytest.raises(ValueError, match="raw_entry"):
        make_data(1, native_threads=2)
    # data parallelism and its height-sharding axis are ported
    # (train(mesh=...)); a space axis wider than the ranks raises
    from yolo_v3_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="space=2"):
        make_mesh(space=2, device="cpu")


class _FakeData:
    def get_net_batch(self): return 3
    def get_epoch(self): return 1
    def get_epoch_batch(self): return 1
    def get_epoch_num_batches(self): return 4
    def is_start_of_epoch(self): return False


@pytest.mark.parametrize("ewma_window", [None, 9])
def test_recorder_and_display_copies_match_jax(ewma_window, capsys, tmp_path):
    """The port's recorder and console display, fed the same stats stream
    as the JAX package's, keep the same stats and state, write the same
    JSON lines and print the same rows."""
    rng = np.random.default_rng(ewma_window or 0)
    paths = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    recs = (Recorder(ewma_window=ewma_window, jsonl_path=paths[0]),
            JRecorder(ewma_window=ewma_window, jsonl_path=paths[1]))
    for epoch in range(2):
        for _ in range(3):
            st = {k: float(rng.uniform(0, 10)) for k in TDisplay.STAT_COLS}
            for r in recs:
                r.on_batch_end(dict(st), 16)
        for r in recs:
            r.on_epoch_end()
    got, want = recs
    assert got.current_stats == want.current_stats
    assert got.state_dict() == want.state_dict()
    assert got.stats_row() == want.stats_row()
    assert open(paths[0]).read() == open(paths[1]).read()
    assert TDisplay.stats_header() == JDisplay.stats_header()
    assert TDisplay.stats_row(3, 1, got) == JDisplay.stats_row(3, 1, want)
    restored = Recorder()
    restored.load_state_dict(got.state_dict())
    assert restored.stats_row() == got.stats_row()
    printed = []
    for mod, r in ((TDisplay, got), (JDisplay, want)):
        d = mod.ProgressDisplay(_FakeData(), use_tqdm=False)
        d.update(r)
        d.close()
        printed.append(capsys.readouterr().err)
    assert printed[0] == printed[1] and "net_batch" in printed[0]


# ---------------------------------------------------------------------------
# composite checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_trees():
    """JAX init with spread BN and scaled detection convs, so scores spread
    and both detectors report rows."""
    jp, js = JD.init_yolonet(jax.random.PRNGKey(0), num_classes=3, blocks=BLOCKS)
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


class _StubData:
    def get_net_batch(self):
        return 7

    def state_dict(self):
        return {"current_batch": 13, "sampler": {}}


def _same_rows(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and len(w) >= 5
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g[:, 1:5], w[:, 1:5], rtol=0, atol=1e-2)
        np.testing.assert_allclose(g[:, 5:], w[:, 5:], rtol=0, atol=1e-4)


def test_jax_composite_checkpoint_serves_in_the_port(jax_trees, images, tmp_path):
    """A JAX training checkpoint (pickled metadata, optax state) serves in
    the port's Detector with the JAX Detector's rows, and is never
    unpickled; resuming it in the port's loop is refused."""
    p, s = jax_trees
    jp, js = jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s)
    opt_state = JO.make_optimizer(jp, JTrainConfig()).init(jp)
    path = JCK.save_checkpoint(_StubData(), jp, js, opt_state, JRecorder(), "j", str(tmp_path))
    cfg = dict(num_classes=3, img_dim=128, max_detections=32)
    want = JDetector(jp, js, JConfig(**cfg), precision="fp32").detect(images, conf_thr=0.7)
    got = Detector.from_checkpoint(path, YoloConfig(**cfg), precision="fp32",
                                   device="cpu").detect(images, conf_thr=0.7)
    _same_rows(got, want)
    ckpt = load_checkpoint(path)
    assert ckpt["opt_state"] is None and ckpt["data"] is None
    assert_trees_equal(ckpt["params"], TW.params_from_numpy(p))
    with pytest.raises(ValueError, match="optimizer state"):
        run(make_data(1), checkpoint=ckpt)


def test_port_checkpoint_loads_in_the_jax_detector(jax_trees, images, tmp_path):
    """The port's composite checkpoint has no pickle: the JAX
    ``Detector.from_checkpoint`` reads it as a plain {params, state} pytree
    and serves the port's rows."""
    p, s = jax_trees
    data = make_data(1)
    tp, ts = TW.params_from_numpy(p), TW.params_from_numpy(s)
    path = save_checkpoint(data, tp, ts, make_optimizer(TCFG).init(tp), Recorder(), "p",
                           str(tmp_path))
    with np.load(path, allow_pickle=False) as z:
        assert z["__meta__"][0] != 0x80 and any(k.startswith("opt/") for k in z.files)
    cfg = dict(num_classes=3, img_dim=128, max_detections=32)
    want = Detector(tp, ts, YoloConfig(**cfg), precision="fp32",
                    device="cpu").detect(images, conf_thr=0.7)
    got = JDetector.from_checkpoint(path, JConfig(**cfg), precision="fp32").detect(
        images, conf_thr=0.7)
    _same_rows(got, want)
