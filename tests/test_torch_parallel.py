"""The port's data parallelism (``yolo_v3_tpu_torch/parallel/``, the
host-sharded ``DataHelper``, BN over the global batch, the step's gradient
all-reduce, ``mesh_shape`` checkpoints, the loop's mesh branch) against the
JAX package's ``parallel/`` and single-device step, on the CPU.

Real multi-process runs: two gloo ranks (``tests/torch_dist_worker.py``,
subprocesses on a free localhost port, each with a timeout), each taking
its contiguous half of ``tests/dist_worker.py``'s fixture (tiny net:
blocks (1,1,1,1,1), 2 classes, 64^2), here a net-batch of 2 subdivisions of
4 images.  Bounds and why:
* the ranks' params after a step: bit-equal (one all-reduce, the same
  update on every rank);
* float32, 2 ranks against the 1-process port step on the global batch:
  params within atol 2e-4, the JAX 2-process test's own bound
  (``tests/test_distributed.py``);
* float64, 2 ranks against the 1-process port step: each leaf's update
  within 1e-9 of its largest (only the reduction order differs); against
  JAX ``make_train_step`` on the global batch in float64: the bound of
  ``test_torch_train_step.py::test_step_matches_jax_make_train_step_in_float64``;
* remat: bit-equal to the same ranks without it;
* BN: the ranks' train-mode forwards, concatenated, against JAX's
  ``apply_yolonet`` on the global batch at
  ``test_torch_train_forward.py``'s bounds, running statistics included.
"""

import functools
import hashlib
import json
import os
import os.path as osp
import shutil
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from test_torch_train_step import port_float64_run, reference_in_float64, tiny_batch
from yolo_v3_tpu.data import transforms as JT
from yolo_v3_tpu.data.datasets import ListDataset as JListDataset
from yolo_v3_tpu.data.loader import DataHelper as JDataHelper
from yolo_v3_tpu.data.sampler import CyclicSampler as JSampler
from yolo_v3_tpu.models import darknet as JD
from yolo_v3_tpu.train import optimizer as JO
from yolo_v3_tpu.train import step as JS
from yolo_v3_tpu.utils import config as JC
from yolo_v3_tpu_torch.data import transforms as T
from yolo_v3_tpu_torch.data.datasets import ListDataset
from yolo_v3_tpu_torch.data.sampler import CyclicSampler
from yolo_v3_tpu_torch.models import darknet as D
from yolo_v3_tpu_torch.models import weights as TW
from yolo_v3_tpu_torch.parallel import distributed as dist
from yolo_v3_tpu_torch.parallel import mesh as M
from yolo_v3_tpu_torch.train import checkpoint as CK
from yolo_v3_tpu_torch.train.loop import train
from yolo_v3_tpu_torch.train.optimizer import make_optimizer
from yolo_v3_tpu_torch.train.recorder import Recorder
from yolo_v3_tpu_torch.train.step import make_train_step
from yolo_v3_tpu_torch.utils.config import TrainConfig, YoloConfig

TESTS = osp.dirname(osp.abspath(__file__))
REPO = osp.dirname(TESTS)
SCENES = osp.join(TESTS, "data", "torch_scenes")
WORKER = osp.join(TESTS, "torch_dist_worker.py")
LAUNCHER_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                 "LOCAL_WORLD_SIZE")
CFG = YoloConfig(num_classes=2, img_dim=64)
TRAIN = dict(lr=1e-3, backbone_lr=1e-4)
S, B = 2, 4                      # the global net-batch: 2 subdivisions of 4 images


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and a
    CPU training step at full width oversubscribes the cores with more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, world=2, timeout=240):
    """Run the worker as ``world`` gloo ranks; returns their outputs."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env.update(PYTHONPATH=os.pathsep.join([REPO, TESTS, env.get("PYTHONPATH", "")]),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, WORKER, *args], cwd=REPO,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"rank {r} (rc {p.returncode}):\n{o}" for r, (p, o) in enumerate(zip(procs, outs)))
    return outs


@pytest.fixture(scope="module")
def net():
    jp, js = JD.init_yolonet(jax.random.PRNGKey(0), num_classes=2, blocks=(1, 1, 1, 1, 1))
    return jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)


def _flat(tree):
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        return {k: np.asarray(v) for k, v in TW._flatten_with_names(tree).items()}
    return _flat(TW.params_from_numpy(jax.tree.map(np.asarray, tree)))


def _sub(arrays, prefix):
    return {k[len(prefix) + 1:]: v for k, v in arrays.items() if k.startswith(prefix + "/")}


@pytest.fixture(scope="module")
def two_ranks(net, tmp_path_factory):
    """Both ranks' results of ``torch_dist_worker.py step`` on the global
    net-batch ``tiny_batch(0, S=2, B=4)``."""
    root = tmp_path_factory.mktemp("dp")
    imgs, labels = tiny_batch(0, S=S, B=B)
    p, s = net
    inp = str(root / "in.npz")
    np.savez(inp, imgs=imgs, labels=labels,
             **{f"params/{k}": v for k, v in _flat(p).items()},
             **{f"state/{k}": v for k, v in _flat(s).items()})
    launch(["step", inp, str(root / "out")])
    ranks = []
    for r in range(2):
        with np.load(str(root / f"out.rank{r}.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
    shutil.rmtree(root)          # ~0.5 GB of trees, held in memory from here
    return ranks


def _deltas(new, old):
    return {k: v - old[k] for k, v in new.items()}


# ---------------------------------------------------------------------------
# process context, mesh, data sharding, checkpoints
# ---------------------------------------------------------------------------

def test_initialize_is_a_noop_without_launcher_variables(monkeypatch):
    for k in LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    ctx = dist.initialize()
    assert ctx == dist.ProcessContext(0, 1, None, 0) and not ctx.is_distributed
    assert not torch.distributed.is_initialized()
    # one process named by the launcher's variables: still a no-op
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert dist.initialize() == dist.ProcessContext(0, 1, None, 0)
    assert not torch.distributed.is_initialized()


def test_nccl_refuses_ranks_without_a_card_each(monkeypatch):
    """Two ranks and fewer cards: the default backend (NCCL) raises on every
    rank before joining, and never switches to gloo."""
    for k, v in dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                     WORLD_SIZE="2", RANK="1", LOCAL_RANK="1").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="one card a rank.*gloo"):
        dist.initialize()
    assert not torch.distributed.is_initialized()


def test_make_mesh_without_a_process_group(monkeypatch):
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    mesh = M.make_mesh()
    assert mesh.shape == (1, 1) and (mesh.rank, mesh.world_size) == (0, 1)
    assert mesh.device == torch.device("cuda", 0)      # the card by default
    assert mesh.group is None and mesh.bn_group is None
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert M.make_mesh().device == torch.device("cuda", 3)
    assert M.make_mesh(device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="space=2"):     # one rank has no 2 stripes
        M.make_mesh(space=2)
    with pytest.raises(ValueError, match="n_devices"):
        M.make_mesh(n_devices=8)
    tree = {"a": torch.arange(3.0), "b": {"count": 4}}
    out = M.replicate(M.make_mesh(device="cpu"), tree)
    assert torch.equal(out["a"], tree["a"]) and out["a"] is not tree["a"]
    assert out["b"]["count"] == 4


@pytest.fixture(scope="module")
def scene_list(tmp_path_factory):
    img_dir = osp.join(SCENES, "images")
    paths = [osp.join(img_dir, n) for n in sorted(os.listdir(img_dir)) if n.endswith(".jpg")]
    lst = tmp_path_factory.mktemp("scenes") / "scenes.txt"
    lst.write_text("\n".join(paths) + "\n")
    return str(lst)


def _batches(helper):
    try:
        return [{k: b[k] for k in ("img", "label", "lb_reverter")} for b in helper]
    finally:
        helper.close()


@pytest.mark.parametrize("route", ["in_process", "workers", "native"])
def test_make_data_helper_shards_like_jax(scene_list, route):
    """Rank 1 of 2 assembles half of every global batch: bit-identical to the
    JAX ``DataHelper(host_id=1, n_hosts=2)`` on the same dataset (JAX's native
    route for the native one, its Python path otherwise), and the two
    shards concatenate to the single-process batch of the same route."""
    kw = {"workers": dict(num_workers=2), "native": dict(native_threads=2)}.get(route, {})
    if route == "native":
        from yolo_v3_tpu_torch.data import native_loader

        try:
            native_loader.load_library()
        except RuntimeError as e:
            pytest.skip(f"native toolchain/libjpeg unavailable: {str(e)[:200]}")
    trans = functools.partial(T.training_transform, feed_u8=True)

    def port(process_id, num_processes):
        ds = ListDataset(scene_list, trans_fn=trans)
        ctx = dist.ProcessContext(process_id, num_processes, None)
        helper = dist.make_data_helper(ds, CyclicSampler(len(ds), 8, seed=12, dim=(128, 128)),
                                       ctx, max_batches=2, prefetch=0, **kw)
        assert (helper.host_id, helper.n_hosts) == (process_id, num_processes)
        return _batches(helper)

    ds = JListDataset(scene_list, trans_fn=functools.partial(JT.training_transform,
                                                              feed_u8=True))
    want = _batches(JDataHelper(ds, JSampler(len(ds), 8, seed=12, dim=(128, 128)),
                                max_batches=2, prefetch=0, host_id=1, n_hosts=2,
                                native_threads=kw.get("native_threads", 0)))
    halves = [port(0, 2), port(1, 2)]
    single = port(0, 1)
    for b in range(2):
        assert halves[1][b]["img"].shape[0] == 4
        for k in ("img", "label", "lb_reverter"):
            np.testing.assert_array_equal(halves[1][b][k], want[b][k], err_msg=k)
            np.testing.assert_array_equal(
                np.concatenate([halves[0][b][k], halves[1][b][k]]), single[b][k], err_msg=k)


def test_data_helper_refuses_an_uneven_shard():
    with pytest.raises(ValueError, match="divisible"):
        dist.make_data_helper([0] * 8, CyclicSampler(8, 4, dim=(64, 64)),
                              dist.ProcessContext(0, 3, None))


def test_assert_mesh_compatible_as_jax():
    """tests/test_distributed.py::TestMeshCompat's cases, on mesh records."""
    mesh = M.Mesh((4, 2), 0, 4, torch.device("cpu"))
    dist.assert_mesh_compatible(mesh, (4, 2))
    dist.assert_mesh_compatible(mesh, (4, 1))       # space may differ
    dist.assert_mesh_compatible(mesh, None)
    with pytest.raises(ValueError, match="data-parallel width"):
        dist.assert_mesh_compatible(mesh, (8, 1))


def test_mesh_shape_checkpoint_roundtrip(net, tmp_path):
    from yolo_v3_tpu.train.checkpoint import save_checkpoint as jsave

    ds = [0] * 8
    helper = dist.make_data_helper(ds, CyclicSampler(8, 4, seed=0, dim=(64, 64)),
                                   dist.ProcessContext(0, 1, None), max_batches=2)
    params, state = D.init_yolonet(torch.Generator().manual_seed(0), 2, blocks=(1, 1, 1, 1, 1))
    opt = make_optimizer(TrainConfig())
    def mesh_shape(path):
        try:
            return CK.load_checkpoint(path)["mesh_shape"]
        finally:
            os.remove(path)

    path = CK.save_checkpoint(helper, params, state, opt.init(params), Recorder(), "m",
                              str(tmp_path), mesh_shape=(4, 2))
    assert mesh_shape(path) == (4, 2)
    # a mesh record: rank 0 writes its shape
    mesh = M.Mesh((1, 1), 0, 1, torch.device("cpu"))
    path = CK.save_checkpoint(helper, params, state, opt.init(params), Recorder(), "n",
                              str(tmp_path), mesh=mesh)
    assert mesh_shape(path) == (1, 1)
    # without a mesh, none; a JAX composite checkpoint's sits in its pickle
    path = CK.save_checkpoint(helper, params, state, opt.init(params), None, "o",
                              str(tmp_path))
    assert mesh_shape(path) is None
    jp, js = jax.tree.map(jax.numpy.asarray, net)
    jpath = jsave(helper, jp, js, JO.make_optimizer(jp, JC.TrainConfig()).init(jp), None,
                  "j", str(tmp_path), mesh_shape=(4, 2))
    assert mesh_shape(jpath) is None


# ---------------------------------------------------------------------------
# two real ranks
# ---------------------------------------------------------------------------

def test_two_ranks_hold_bit_equal_params(two_ranks):
    """Every tree and stat of rank 1 has rank 0's bytes (rank 1 sends their
    SHA-256 digests)."""
    a, b = two_ranks
    keys = [k for k in a if not k.startswith("bn/raw")]
    assert sorted(f"sha256/{k}" for k in keys) == sorted(k for k in b if k.startswith("sha256/"))
    for k in keys:
        assert hashlib.sha256(a[k].tobytes()).digest() == b[f"sha256/{k}"].tobytes(), k


def test_two_ranks_equal_the_single_process_step_in_float32(net, two_ranks):
    p, s = net
    imgs, labels = tiny_batch(0, S=S, B=B)
    opt = make_optimizer(TrainConfig(**TRAIN))
    step = make_train_step(CFG, opt)
    tp = TW.params_from_numpy(p)
    got_p, got_s, _, stats = step(tp, TW.params_from_numpy(s), opt.init(tp),
                                  torch.from_numpy(imgs), torch.from_numpy(labels))
    ranks = two_ranks[0]
    for k, v in _flat(got_p).items():
        np.testing.assert_allclose(ranks[f"f32/params/{k}"], v, atol=2e-4, err_msg=k)
    for k, v in _flat(got_s).items():
        np.testing.assert_allclose(ranks[f"f32/state/{k}"], v, rtol=1e-4, atol=1e-5, err_msg=k)
    for k, v in stats.items():
        got = ranks[f"f32/stats/{k}"]
        if k in ("nCorrect", "nGT"):
            assert float(got) == float(v), k
        else:
            np.testing.assert_allclose(float(got), float(v), rtol=1e-4, err_msg=k)


def test_two_ranks_equal_the_single_process_and_jax_steps_in_float64(net, two_ranks):
    """float64: each leaf's update within 1e-9 of its largest against the
    1-process port step, and within the float64 step test's bound against
    JAX ``make_train_step`` on the global batch; stats and BN state too."""
    p, s = net
    imgs, labels = tiny_batch(0, S=S, B=B)
    (tp, ts, stats), _ = port_float64_run(p, s, imgs, labels, 1, config=CFG, **TRAIN)
    with reference_in_float64():
        tx = JO.make_optimizer(p, JC.TrainConfig(**TRAIN))
        step = JS.make_train_step(JC.YoloConfig(num_classes=2, img_dim=64), tx)
        f64 = functools.partial(jax.tree.map, lambda a: jax.numpy.asarray(a, jax.numpy.float64))
        jp, js, _, jstats = jax.tree.map(np.asarray, step(f64(p), f64(s), tx.init(f64(p)),
                                                          f64(imgs), f64(labels)))
    ranks = two_ranks[0]
    p0 = _flat(p)
    got = _deltas(_sub(ranks, "f64/params"), p0)
    port1, ref = _deltas(_flat(tp), p0), _deltas(_flat(jp), p0)
    assert all(np.abs(w).max() > 0 for w in ref.values())
    for k in got:
        np.testing.assert_allclose(got[k], port1[k], rtol=0,
                                   atol=1e-9 * np.abs(port1[k]).max(), err_msg=k)
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(ref[k]).max(), err_msg=k)
    got_s, want_s = _sub(ranks, "f64/state"), _flat(js)
    for k in got_s:
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=1e-6, atol=1e-12, err_msg=k)
    for k, v in jstats.items():
        g = float(ranks[f"f64/stats/{k}"])
        assert g == pytest.approx(float(stats[k]), rel=1e-9, abs=1e-12), k
        if k in ("nCorrect", "nGT"):
            assert g == float(v), k
        else:
            np.testing.assert_allclose(g, float(v), rtol=1e-6, err_msg=k)


def test_two_ranks_second_step_equals_the_single_process_in_float64(net, two_ranks):
    """A second float64 step, on the momentum and BN state of the first: each
    leaf's update over both steps within 1e-9 of its largest against the
    1-process port's two steps, and the second step's stats within 1e-9."""
    from torch_float64 import port_in_float64

    p, s = net
    imgs, labels = tiny_batch(0, S=S, B=B)
    opt = make_optimizer(TrainConfig(**TRAIN))
    step = make_train_step(CFG, opt, compute_dtype=torch.float64)
    f64 = functools.partial(D.map_tree, lambda a: a.to(torch.float64))
    tp, ts = f64(TW.params_from_numpy(p)), f64(TW.params_from_numpy(s))
    to = opt.init(tp)
    x, y = (torch.from_numpy(a).to(torch.float64) for a in (imgs, labels))
    with port_in_float64():
        for _ in range(2):
            tp, ts, to, stats = step(tp, ts, to, x, y)
    ranks = two_ranks[0]
    p0 = _flat(p)
    got, want = _deltas(_sub(ranks, "f64_2/params"), p0), _deltas(_flat(tp), p0)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-9 * np.abs(want[k]).max(), err_msg=k)
    got_s, want_s = _sub(ranks, "f64_2/state"), _flat(ts)
    for k in want_s:
        np.testing.assert_allclose(got_s[k], want_s[k], rtol=1e-9, atol=1e-15, err_msg=k)
    for k, v in stats.items():
        assert float(ranks[f"f64_2/stats/{k}"]) == pytest.approx(float(v), rel=1e-9,
                                                                 abs=1e-12), k


def test_two_ranks_remat_is_bit_equal(two_ranks):
    """remat re-runs each forward, BN all-reduces included, in the backward:
    the same params and state, bit for bit."""
    for rank in two_ranks:
        for k in rank:
            if k.startswith("f32/params") or k.startswith("f32/state"):
                np.testing.assert_array_equal(rank["remat" + k[3:]], rank[k], err_msg=k)


def test_two_rank_batchnorm_equals_jax_on_the_global_batch(net, two_ranks):
    """``apply_yolonet(training=True, mesh=...)`` on each rank's half of
    micro-batch 0: the heads, concatenated, and the new running statistics
    equal JAX's ``apply_yolonet`` on the whole micro-batch."""
    p, s = net
    imgs, _ = tiny_batch(0, S=S, B=B)
    raws, new_state = JD.apply_yolonet(jax.tree.map(jax.numpy.asarray, p),
                                       jax.tree.map(jax.numpy.asarray, s),
                                       jax.numpy.asarray(imgs[0]), training=True)
    for i, w in enumerate(raws):
        w = np.asarray(w)
        g = np.concatenate([r[f"bn/raw{i}"] for r in two_ranks])
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
    got, want = _sub(two_ranks[0], "bn/state"), _flat(new_state)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_sigterm_to_one_rank_stops_both_at_one_net_batch(tmp_path):
    """Rank 1 alone gets SIGTERM while it assembles the second net-batch of
    4: both ranks finish that net-batch (number 1, 0-based), rank 0 writes
    the one checkpoint (mesh (2, 1)) and both return.  Resuming it under a
    1-rank mesh raises."""
    wdir = str(tmp_path / "w")
    launch(["preempt", wdir, str(tmp_path / "out")])
    stops = [json.load(open(tmp_path / f"out.rank{r}.json")) for r in range(2)]
    assert [st["net_batch"] for st in stops] == [1, 1]
    assert stops[0]["recorded"] == 2 and stops[1]["recorded"] == 0   # rank 0 records
    ckpts = CK.get_checkpoint_list("m", wdir)
    assert [osp.basename(c) for c in ckpts] == ["yolov3_m_checkpoint_000001.npz"]
    ckpt = CK.load_checkpoint(ckpts[0])
    shutil.rmtree(wdir)
    assert ckpt["mesh_shape"] == (2, 1) and ckpt["recorder"]["net_batches_seen"] == 2
    with pytest.raises(ValueError, match="data-parallel width"):
        train(None, ckpt["params"], ckpt["state"], CFG, TrainConfig(), checkpoint=ckpt,
              mesh=M.make_mesh(device="cpu"), log_fn=lambda s: None)


@pytest.fixture
def one_rank_group():
    """A real gloo process group of one rank in this process, torn down
    after the test."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()


def test_one_rank_group_trains_as_no_mesh(one_rank_group, tmp_path):
    """A mesh of one rank with a process group runs every collective (the
    replication, the gradient and stats all-reduce, the stop flag, the
    checkpoint barrier) and trains bit-equal to ``train()`` without one."""
    from yolo_v3_tpu_torch.data.loader import DataHelper

    class Scenes:
        def __init__(self):
            self.imgs = np.random.default_rng(1).integers(0, 255, (8, 64, 64, 3), np.uint8)

        def __len__(self):
            return 8

        def get(self, i, dim, seed):
            label = np.zeros((4, 5), np.float32)
            label[0] = (i % 2, 0.5, 0.5, 0.4, 0.4)
            return {"img": self.imgs[i], "label": label}

    def run(mesh, wdir):
        data = DataHelper(Scenes(), CyclicSampler(8, 2, seed=0, dim=(64, 64)),
                          max_net_batches=2, net_subdivisions=2, prefetch=0)
        params, state = D.init_yolonet(torch.Generator().manual_seed(0), 2,
                                       blocks=(1, 1, 1, 1, 1))
        return train(data, params, state, CFG, TrainConfig(**TRAIN), device="cpu", mesh=mesh,
                     model_id="m", weight_dir=wdir, checkpoint_interval=2,
                     log_fn=lambda s: None)

    mesh = M.make_mesh(device="cpu")
    assert mesh.group is not None and mesh.bn_group is None
    got, want = run(mesh, str(tmp_path / "a")), run(None, str(tmp_path / "b"))
    for g, w in zip(got[:2], want[:2]):
        for k, v in _flat(w).items():
            np.testing.assert_array_equal(_flat(g)[k], v, err_msg=k)
    assert got[3].current_stats == want[3].current_stats
    path, _ = CK.get_latest_checkpoint("m", str(tmp_path / "a"))
    assert CK.load_checkpoint(path)["mesh_shape"] == (1, 1)
    for d in ("a", "b"):
        shutil.rmtree(tmp_path / d)
