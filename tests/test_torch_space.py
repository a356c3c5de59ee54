"""The port's height-sharded (``space``) mesh axis and data-parallel serving
against the JAX package's single-device results, on the CPU.

Real multi-process runs of ``tests/torch_dist_worker.py`` (gloo ranks in
subprocesses on a free localhost port, each with a timeout): two ranks
on the meshes (1, 2) and (2, 1), and four on (2, 2), launched together
before the references are computed.  Tiny net (blocks (1,1,1,1,1), 2
classes) at 96 x 96: R = 3 bands of 32 rows, so the stripes are 64 / 32
and the uneven split is what runs.  Bounds (those of JAX's own
``tests/test_distributed.py`` for the same checks) and why:

* train-mode heads, gathered, against JAX ``apply_yolonet``: rtol = atol =
  1e-4 (summation order);
* the step's stats against JAX ``make_train_step``: rtol = atol = 2e-4; its
  param updates and BN state: atol 2e-4;
* in float64, each leaf's update within 1e-9 of its largest against the
  port's one-process step (only the reduction order differs);
* the collectives: halo rows and gathers exact, their gradients within
  float32 rounding of the whole tensor's gradient cut into stripes (one
  more addition where a halo row's gradient meets its owner's);
* fp32 detection rows against JAX ``detect_fn``: validity equal, atol
  1e-2, rtol 1e-4.  bf16 heads against JAX's bf16 heads within 5e-2 *
  max|head| (the suite's bf16 bound), and the rows against the rows of
  those heads: bf16 rows move with one bf16 rounding (the frameworks round
  at other points, and a stripe's product sums in another order), so they
  are not held to JAX's or to one process's;
* data-parallel serving: each rank's heads against the one-process heads
  of its images (int8 bit-equal; fp32 1e-4 and bf16 5e-2 * max|head|,
  since the CPU's float32 products sum in another order at another
  batch), and every rank's rows the gathered rows of the ranks' heads;
* int8 under space (an s2d tree on the float and the uint8 feed, a tree
  without s2d): the gathered heads bit-equal to JAX's single-device int8
  forward run op by op (see ``tests/test_torch_quantized.py``) and to the
  port's one process (integer sums are exact in any order and every
  epilogue is per element), the rows to the one-process rows at the
  data-parallel bound, and to JAX's int8 ``detect_fn`` at
  ``tests/test_torch_quantized.py``'s Detector bounds; the entry's stripe
  windows (no processes) bit-equal to the whole image's entry.

Detection uses the detector tests' trees (BN spread out, detection convs
scaled up) at conf 0.3, so that rows are valid; the step uses the plain
JAX init, as JAX's test does.
"""

import functools
import hashlib
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_parallel import LAUNCHER_VARS, REPO, TESTS, WORKER, free_port
from test_torch_train_step import port_float64_run
from yolo_v3_tpu.detector import detect_fn as jdetect_fn
from yolo_v3_tpu.models import darknet as JD
from yolo_v3_tpu.models import quantized as JQ
from yolo_v3_tpu.train import optimizer as JO
from yolo_v3_tpu.train import step as JS
from yolo_v3_tpu.utils import config as JC
from yolo_v3_tpu_torch.data.loader import DataHelper
from yolo_v3_tpu_torch.data.sampler import CyclicSampler
from yolo_v3_tpu_torch.detector import Detector, detect_fn
from yolo_v3_tpu_torch.models import darknet as D
from yolo_v3_tpu_torch.models import quantized as Q
from yolo_v3_tpu_torch.models import weights as TW
from yolo_v3_tpu_torch.ops import entry_kernel as EK
from yolo_v3_tpu_torch.parallel import mesh as M
from yolo_v3_tpu_torch.train import checkpoint as CK
from yolo_v3_tpu_torch.train.loop import train
from yolo_v3_tpu_torch.train.optimizer import make_optimizer
from yolo_v3_tpu_torch.train.step import make_train_step
from yolo_v3_tpu_torch.utils.config import TrainConfig, YoloConfig
from torch_dist_worker import INT8_RUNS, Scenes, halo_weights

DIM = 96
CFG = YoloConfig(num_classes=2, img_dim=DIM)
JCFG = JC.YoloConfig(num_classes=2, img_dim=DIM)
TRAIN = dict(lr=1e-3, backbone_lr=1e-4)
S, B = 2, 4
CONF, NMS = 0.3, 0.45
PRECISIONS = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def start(args, world):
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env.update(PYTHONPATH=os.pathsep.join([REPO, TESTS, env.get("PYTHONPATH", "")]),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="2")
    return [subprocess.Popen([sys.executable, WORKER, *args], cwd=REPO,
                             env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def finish(procs, timeout=300):
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


def _flat(tree):
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        return {k: np.asarray(v.float() if v.dtype == torch.bfloat16 else v)
                for k, v in TW._flatten_with_names(tree).items()}
    return _flat(TW.params_from_numpy(jax.tree.map(np.asarray, tree)))


def _sub(arrays, prefix):
    return {k[len(prefix) + 1:]: v for k, v in arrays.items() if k.startswith(prefix + "/")}


def _spread(p, s):
    """The detector tests' trees: BN statistics and scales spread out and
    the detection convs scaled up, so scores spread well apart."""
    rng = np.random.default_rng(0)
    p, s = jax.tree.map(np.copy, p), jax.tree.map(np.copy, s)

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


def _inputs():
    jp, js = JD.init_yolonet(jax.random.PRNGKey(0), num_classes=2, blocks=(1, 1, 1, 1, 1))
    p, s = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    rng = np.random.default_rng(7)
    imgs = rng.uniform(0, 1, (S, B, DIM, DIM, 3)).astype(np.float32)
    labels = np.zeros((S, B, 10, 5), np.float32)
    labels[..., 0, :] = [1, 0.5, 0.5, 0.3, 0.3]
    labels[..., 1, :] = [0, 0.3, 0.6, 0.2, 0.4]
    rng = np.random.default_rng(0)
    det_x = rng.uniform(0, 1, (8, DIM, DIM, 3)).astype(np.float32)
    det_xu8 = np.round(det_x * 255).astype(np.uint8)
    det_org = np.tile([[96.0, 64.0]], (8, 1)).astype(np.float32)
    det_u8 = rng.integers(0, 255, (4, 80, 120, 3), dtype=np.uint8)
    halo = rng.normal(0, 1, (2, 3, DIM, 5)).astype(np.float32)
    gather = rng.normal(0, 1, (2, DIM, 5, 3)).astype(np.float32)
    return dict(net=(p, s), det=_spread(p, s), imgs=imgs, labels=labels, det_x=det_x,
                det_xu8=det_xu8, det_org=det_org, det_u8=det_u8, halo=halo, gather=gather)


def _det_trees(det):
    return tuple(TW.params_from_numpy(t) for t in det)


def _folded(det, dtype):
    return D.YoloNetFolded(D.cast_params(D.fold_batchnorm(*_det_trees(det)), dtype)).eval()


def _jax_reference(inp):
    """JAX's single-device results: the train-mode heads of micro-batch 0,
    one float32 step, fp32 detection rows and bf16 heads."""
    (p, s), (dp, ds) = inp["net"], inp["det"]
    jp, js = (jax.tree.map(jnp.asarray, t) for t in (p, s))
    raws, bn_state = jax.jit(lambda a, b, x: JD.apply_yolonet(a, b, x, training=True))(
        jp, js, jnp.asarray(inp["imgs"][0]))
    tx = JO.make_optimizer(jp, JC.TrainConfig(**TRAIN))
    step = JS.make_train_step(JCFG, tx)
    sp, ss, _, stats = step(jp, js, tx.init(jp), jnp.asarray(inp["imgs"]),
                            jnp.asarray(inp["labels"]))
    folded = JD.fold_batchnorm(jax.tree.map(jnp.asarray, dp), jax.tree.map(jnp.asarray, ds))
    x, org = jnp.asarray(inp["det_x"]), jnp.asarray(inp["det_org"])
    rows = jax.jit(lambda a, v, o: jdetect_fn(a, v, o, JCFG, conf_thr=CONF, nms_thr=NMS,
                                              compute_dtype=jnp.float32))(folded, x, org)
    heads = jax.jit(JD.apply_yolonet_folded)(JD.cast_params(folded, jnp.bfloat16),
                                             x.astype(jnp.bfloat16))
    as_np = functools.partial(jax.tree.map, np.asarray)
    return dict(raws=as_np(raws), bn_state=as_np(bn_state), params=as_np(sp), state=as_np(ss), stats=as_np(stats),
                rows_fp32=np.asarray(rows), heads_bf16=[np.asarray(h, np.float32) for h in heads])


def _jax_int8_reference(root, inp):
    """JAX's single-device int8 heads of every int8 run, on the artifacts
    the ranks load, its forward run op by op (module doc), and the s2d
    tree's rows on the float feed: JAX's ``detect_fn`` on those heads, the
    postprocess jitted (op by op it takes ~15 s more and moves no row
    beyond 2e-5)."""
    x, org = jnp.asarray(inp["det_x"]), jnp.asarray(inp["det_org"])
    trees = {f: JQ.load_quantized(str(root / f)) for f in ("q.npz", "q_plain.npz")}
    heads, raw = {}, {}
    for run, (qfile, images) in INT8_RUNS.items():
        fn = JQ.apply_yolonet_quantized_u8 if run == "int8u8" else JQ.apply_yolonet_quantized
        raw[run] = tuple(fn(trees[qfile], jnp.asarray(inp[images])))
        heads[run] = [np.asarray(h, np.float32) for h in raw[run]]
    rows = jax.jit(lambda v, o: jdetect_fn(None, v, o, JCFG, conf_thr=CONF, nms_thr=NMS,
                                           compute_dtype=jnp.float32,
                                           apply_fn=lambda p, _: raw["int8"]))(x, org)
    return dict(heads=heads, rows=np.asarray(rows))


def _port_reference(inp, qtree):
    """The port in one process: one float32 step, the detect rows in fp32,
    bf16 and int8 (every int8 run), the heads and the Detector rows."""
    p, s = inp["net"]
    opt = make_optimizer(TrainConfig(**TRAIN))
    tp, ts = TW.params_from_numpy(p), TW.params_from_numpy(s)
    sp, ss, _, stats = make_train_step(CFG, opt)(tp, ts, opt.init(tp),
                                                 torch.from_numpy(inp["imgs"]),
                                                 torch.from_numpy(inp["labels"]))
    x, org = torch.from_numpy(inp["det_x"]), torch.from_numpy(inp["det_org"])
    out = dict(params=_flat(sp), state=_flat(ss), stats={k: float(v) for k, v in stats.items()})
    with torch.inference_mode():
        for name, dtype in PRECISIONS.items():
            model = _folded(inp["det"], dtype)
            out[f"rows_{name}"] = detect_fn(model, x, org, CFG, CONF, NMS,
                                            compute_dtype=dtype).numpy()
            out[f"heads_{name}"] = [h.float().numpy() for h in model(x.to(dtype))]
        for run, (qfile, images) in INT8_RUNS.items():
            model = Q.YoloNetQuantized(qtree[qfile]).eval()
            xi = torch.from_numpy(inp[images])
            out[f"rows_{run}"] = detect_fn(model, xi, org, CFG, CONF, NMS,
                                           compute_dtype=torch.float32).numpy()
            heads = model(xi)
            out[f"heads_{run}"] = [h.float().numpy() for h in heads]
        out["heads_dtype"] = dict(int8=heads[0].dtype, **PRECISIONS)
    trees = _det_trees(inp["det"])
    for name, kw in (("fp32", dict(precision="fp32")), ("int8", dict(precision="int8")),
                     ("int8u8", dict(precision="int8", resize_on_device=False))):
        det = Detector(*trees, CFG, device="cpu", **kw)
        out[f"detector_{name}"] = det.detect(list(inp["det_u8"]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worker's two launches (started first, run while the references
    are computed), JAX's single-device results and the port's one-process
    ones."""
    root = tmp_path_factory.mktemp("space")
    inp = _inputs()
    det_p, det_s = _det_trees(inp["det"])
    qtree = {}
    for qfile, s2d in (("q.npz", True), ("q_plain.npz", False)):
        Q.save_quantized(Q.build_quantized(det_p, det_s, torch.from_numpy(inp["det_x"]),
                                           space_to_depth=s2d), str(root / qfile))
        qtree[qfile] = Q.load_quantized(str(root / qfile))   # the tree the ranks load
    p, s = inp["net"]
    np.savez(str(root / "in.npz"), imgs=inp["imgs"], labels=inp["labels"],
             det_x=inp["det_x"], det_xu8=inp["det_xu8"], det_org=inp["det_org"],
             det_u8=inp["det_u8"],
             halo=inp["halo"], gather=inp["gather"],
             **{f"params/{k}": v for k, v in _flat(p).items()},
             **{f"state/{k}": v for k, v in _flat(s).items()},
             **{f"det/params/{k}": v for k, v in _flat(inp["det"][0]).items()},
             **{f"det/state/{k}": v for k, v in _flat(inp["det"][1]).items()})
    two = start(["space", str(root / "in.npz"), str(root / "two")], 2)
    four = start(["space4", str(root / "in.npz"), str(root / "four")], 4)
    try:
        ref = dict(jax=_jax_reference(inp), jax_int8=_jax_int8_reference(root, inp),
                   port=_port_reference(inp, qtree), inp=inp)
    finally:
        finish(two)
        finish(four)
    for name, world in (("two", 2), ("four", 4)):
        ranks = []
        for r in range(world):
            with np.load(str(root / f"{name}.rank{r}.npz")) as z:
                ranks.append({k: z[k] for k in z.files})
        ref[name] = ranks
    ref["ckpt_dir"] = str(root)
    yield ref
    shutil.rmtree(root, ignore_errors=True)


def _deltas(new, old):
    return {k: v - old[k] for k, v in new.items()}


# ---------------------------------------------------------------------------
# the mesh and its stripes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("height,rows", [(416, (224, 192)), (608, (320, 288)),
                                         (320, (160, 160)), (96, (64, 32))])
def test_stripe_bounds(height, rows):
    bounds = M.stripe_bounds(height, 2)
    assert tuple(b - a for a, b in bounds) == rows
    assert bounds[0][0] == 0 and bounds[-1][1] == height
    assert all(a % 32 == 0 for a, _ in bounds)


def test_stripe_bounds_refuse_fewer_bands_than_stripes():
    with pytest.raises(ValueError, match="fewer than space=4"):
        M.stripe_bounds(96, 4)
    with pytest.raises(ValueError, match="multiple of 32"):
        M.stripe_bounds(100, 2)
    # every multi-scale dim from 320 to 608 splits in two and in four
    for h in range(320, 609, 32):
        for sp in (2, 4):
            assert sum(b - a for a, b in M.stripe_bounds(h, sp)) == h


def test_mesh_indices_and_shards():
    """Rank r of a (data, space) mesh: data index r // space, space index
    r % space; its shard of a batch and its stripe of the rows."""
    x = torch.arange(4 * 96 * 2).reshape(4, 96, 2, 1)
    for r in range(4):
        mesh = M.Mesh((2, 2), r, 4, torch.device("cpu"))
        assert (mesh.data_index, mesh.space_index) == divmod(r, 2)
        part = M.stripe(mesh, M.data_shard(mesh, x), 1).contiguous()
        a, b = M.stripe_bounds(96, 2)[r % 2]
        assert torch.equal(part, x[2 * (r // 2):2 * (r // 2) + 2, a:b])
    imgs, labels = torch.zeros(2, 3, 96, 8, 3), torch.ones(2, 3, 10, 5)
    xi, yl = M.shard_train_inputs(M.Mesh((1, 2), 1, 2, torch.device("cpu")), imgs, labels)
    assert xi.shape == (2, 3, 32, 8, 3) and torch.equal(yl, labels)
    with pytest.raises(ValueError, match="does not split"):
        M.data_slice(M.Mesh((2, 1), 0, 2, torch.device("cpu")), 3)


def test_mesh_of_one_rank_changes_nothing():
    """A (1, 1) mesh record (one process, no group): the train-mode forward
    and the detect rows bit-equal to no mesh."""
    mesh = M.Mesh((1, 1), 0, 1, torch.device("cpu"))
    params, state = D.init_yolonet(torch.Generator().manual_seed(0), 2, blocks=(1, 1, 1, 1, 1))
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3))
                         .astype(np.float32))
    want, _ = D.apply_yolonet(params, state, x, training=True)
    got, _ = D.apply_yolonet(params, state, x, training=True, mesh=mesh)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    model = D.YoloNetFolded(D.fold_batchnorm(params, state)).eval()
    org = torch.tensor([[64.0, 64.0]] * 2)
    with torch.inference_mode():
        assert torch.equal(detect_fn(model, x, org, CFG, 0.01, NMS, compute_dtype=torch.float32,
                                     mesh=mesh),
                           detect_fn(model, x, org, CFG, 0.01, NMS, compute_dtype=torch.float32))


# ---------------------------------------------------------------------------
# the int8 entry on a stripe's window (no processes)
# ---------------------------------------------------------------------------

ENTRY_W = 64


def _run_entry(window, qs):
    """The plain entry on a padded window (uint8: the raw bytes, made the
    feed's int8 codes as the forward makes them)."""
    if window.dtype == torch.uint8:
        window = (window ^ 0x80).view(torch.int8)
    return EK.fused_entry_ref(D._space_to_depth2(window).contiguous(), qs, 0.75)


@pytest.fixture(scope="module")
def entry_case():
    """(image codes, the whole image's entry output, the convs) per height
    and feed.  The convs are random with every tap nonzero (a real tree's
    stem has a zero third row of 2x2 blocks), so that the window's whole
    reach, image rows 4i-11 .. 4i+10 of output row i, is read."""
    g = torch.Generator().manual_seed(11)
    qs = {}
    for k, (kh, kw, ci, co) in EK.SHAPES.items():
        w = torch.randint(-20, 21, (kh, kw, ci, co), generator=g).to(torch.int8)
        qs[k] = {"w": torch.where(w == 0, torch.ones_like(w), w),
                 "m": torch.rand(co, generator=g) * 4e-3 + 2e-3,
                 "b": torch.randn(co, generator=g) * 4}
    cases = {}

    def get(height, feed):
        if (height, feed) not in cases:
            rng = np.random.default_rng(height)
            if feed == "uint8":
                codes = torch.from_numpy(rng.integers(0, 256, (2, height, ENTRY_W, 3),
                                                      dtype=np.uint8))
            else:
                x = rng.uniform(0, 1, (2, height, ENTRY_W, 3)).astype(np.float32)
                codes = Q.quantize_image(torch.from_numpy(x), 1 / 127)
            cases[height, feed] = codes, _run_entry(Q.entry_window(codes), qs), qs
        return cases[height, feed]

    return get


@pytest.mark.parametrize("position", ["first", "middle", "last"])
@pytest.mark.parametrize("feed", ["float", "uint8"])
@pytest.mark.parametrize("height", [96, 128])
def test_entry_window_on_every_stripe(entry_case, height, feed, position):
    """An image of 3 (96 rows) or 4 (128 rows) stripes of 32: each stripe's
    window, with the halo rows sliced from the whole image and the output
    cut as the forward cuts it, gives the whole image's entry rows, bit for
    bit."""
    codes, whole, qs = entry_case(height, feed)
    n = height // 32
    s = {"first": 0, "middle": 1, "last": n - 1}[position]
    a, b = M.stripe_bounds(height, n)[s]
    top, bottom = s > 0, s < n - 1
    above = codes[:, a - Q.ENTRY_HALO[0]:a] if top else None
    below = codes[:, b:b + Q.ENTRY_HALO[1]] if bottom else None
    out = Q.cut_entry(_run_entry(Q.entry_window(codes[:, a:b], above, below), qs), top, bottom)
    assert torch.equal(out, whole[:, a // 4:b // 4])


@pytest.mark.parametrize("feed", ["float", "uint8"])
def test_entry_window_halo_and_cut_are_the_least(entry_case, feed):
    """The middle stripe [32, 64) of a 128-row image pins 13 / 7 and 3 / 1.
    The farthest rows read are the 11th above and the 7th below: blanking
    either changes the stripe's first or last output row and nothing else;
    the 12th and 13th rows above only keep the window on the image's 2x2
    blocks and down0's pairs of them.  The next smaller windows that keep
    that alignment (9 above, 3 below) give wrong rows, and one output row
    less of cut at either edge keeps a row that is not the image's."""
    codes, whole, qs = entry_case(128, feed)
    a, b = 32, 64
    want = whole[:, a // 4:b // 4]
    assert Q.ENTRY_HALO == (13, 7) and Q.ENTRY_CUT == (3, 1)

    def run(above, below, cut_top, cut_bottom, blank=None):
        c = codes.clone()
        if blank is not None:
            c[:, blank] = 0                 # the pad value of both feeds' bytes
        out = _run_entry(F.pad(c[:, a - above:b + below], (0, 0, 1, 3)), qs)
        return out.narrow(1, cut_top, out.shape[1] - cut_top - cut_bottom)

    assert torch.equal(run(13, 7, 3, 1), want)
    got = run(13, 7, 3, 1, blank=a - 11)
    assert not torch.equal(got[:, 0], want[:, 0]) and torch.equal(got[:, 1:], want[:, 1:])
    got = run(13, 7, 3, 1, blank=b + 6)
    assert not torch.equal(got[:, -1], want[:, -1]) and torch.equal(got[:, :-1], want[:, :-1])
    for row in (a - 12, a - 13):
        assert torch.equal(run(13, 7, 3, 1, blank=row), want)
    assert not torch.equal(run(9, 7, 2, 1), want)
    assert not torch.equal(run(13, 3, 3, 0), want)
    got = run(13, 7, 2, 1)
    assert torch.equal(got[:, 1:], want) and not torch.equal(got[:, 0], whole[:, a // 4 - 1])
    got = run(13, 7, 3, 0)
    assert torch.equal(got[:, :-1], want) and not torch.equal(got[:, -1], whole[:, b // 4])
    with pytest.raises(ValueError, match="takes 13 rows above"):
        Q.entry_window(codes[:, a:b], codes[:, a - 12:a])


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,top,bottom", [("halo11", 1, 1), ("halo10", 1, 0)])
def test_halo_exchange_forward_and_backward(runs, name, top, bottom):
    """Each rank's stripe with its halo equals the zero-padded whole tensor's
    rows around the stripe; its gradient equals the whole tensor's gradient
    of the sum of both ranks' weighted outputs, cut into stripes."""
    full = runs["inp"]["halo"]
    padded = np.pad(full, ((0, 0), (0, 0), (top, bottom), (0, 0)))
    grad = np.zeros_like(padded)
    for r, (a, b) in enumerate(M.stripe_bounds(DIM, 2)):
        got = runs["two"][r][f"rank/{name}"]
        want = padded[:, :, a:b + top + bottom]
        np.testing.assert_array_equal(got, want)
        grad[:, :, a:b + top + bottom] += halo_weights(r, want.shape, 100)
    grad = grad[:, :, top:top + DIM]
    for r, (a, b) in enumerate(M.stripe_bounds(DIM, 2)):
        np.testing.assert_allclose(runs["two"][r][f"rank/{name}_grad"], grad[:, :, a:b],
                                   rtol=1e-6, atol=1e-6)


def test_gather_rows_forward_and_backward(runs):
    full = runs["inp"]["gather"]
    grad = sum(halo_weights(r, full.shape, 200) for r in range(2))
    for r, (a, b) in enumerate(M.stripe_bounds(DIM, 2)):
        np.testing.assert_array_equal(runs["two"][r]["rank/gather"], full)
        np.testing.assert_allclose(runs["two"][r]["rank/gather_grad"], grad[:, a:b],
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# training under space = 2 and under (2, 2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("launch", ["two", "four"])
def test_ranks_hold_bit_equal_results(runs, launch):
    """Every rank's params, BN state, stats and rows have rank 0's bytes."""
    ranks = runs[launch]
    keys = [k for k in ranks[0] if not k.startswith("rank/")]
    for other in ranks[1:]:
        assert sorted(f"sha256/{k}" for k in keys) == sorted(
            k for k in other if k.startswith("sha256/"))
        for k in keys:
            assert hashlib.sha256(np.ascontiguousarray(ranks[0][k]).tobytes()).digest() == \
                other[f"sha256/{k}"].tobytes(), k


@pytest.mark.parametrize("launch", ["two", "four"])
def test_train_forward_matches_jax(runs, launch):
    """The train-mode heads of micro-batch 0, gathered over the space group,
    against JAX's ``apply_yolonet`` on the whole micro-batch (JAX's forward
    parity bound); the BN state against it too."""
    want = runs["jax"]["raws"]
    ranks = runs[launch]
    data = len(ranks) // 2
    for i, w in enumerate(want):
        got = np.concatenate([ranks[2 * d][f"rank/raw{i}"] for d in range(data)])
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-4)
        for r in range(1, len(ranks), 2):      # each space pair has the same heads
            np.testing.assert_array_equal(ranks[r][f"rank/raw{i}"], ranks[r - 1][f"rank/raw{i}"])
    got = _sub(ranks[0], "bn/state")
    for k, w in _flat(runs["jax"]["bn_state"]).items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("launch", ["two", "four"])
def test_step_matches_jax_make_train_step(runs, launch):
    """One float32 step: the stats within rtol = atol = 2e-4 of JAX's
    single-device step (counts equal), the param updates and BN state within
    atol 2e-4; and within the same bounds of the port's one-process step."""
    got = runs[launch][0]
    p0 = _flat(runs["inp"]["net"][0])
    jax_ref, port = runs["jax"], runs["port"]
    for k, v in jax_ref["stats"].items():
        g = float(got[f"f32/stats/{k}"])
        np.testing.assert_allclose(g, float(v), rtol=2e-4, atol=2e-4, err_msg=k)
        np.testing.assert_allclose(g, port["stats"][k], rtol=2e-4, atol=2e-4, err_msg=k)
        if k in ("nCorrect", "nGT"):
            assert g == float(v), k
    upd = _deltas(_sub(got, "f32/params"), p0)
    for ref in (_flat(jax_ref["params"]), port["params"]):
        for k, v in _deltas(ref, p0).items():
            np.testing.assert_allclose(upd[k], v, rtol=0, atol=2e-4, err_msg=k)
    for ref in (_flat(jax_ref["state"]), port["state"]):
        for k, v in ref.items():
            np.testing.assert_allclose(got[f"f32/state/{k}"], v, rtol=0, atol=2e-4, err_msg=k)


@pytest.fixture(scope="module")
def port_f64(runs):
    p, s = runs["inp"]["net"]
    (tp, ts, stats), _ = port_float64_run(p, s, runs["inp"]["imgs"], runs["inp"]["labels"], 1,
                                          config=CFG, **TRAIN)
    return _flat(tp), _flat(ts), {k: float(v) for k, v in stats.items()}


@pytest.mark.parametrize("launch", ["two", "four"])
def test_step_in_float64_equals_one_process(runs, port_f64, launch):
    """float64: each leaf's update within 1e-9 of its largest against the
    port's one-process step on the whole net-batch; BN state and stats
    within 1e-9 too.  Only the reduction order differs."""
    got = runs[launch][0]
    p0 = _flat(runs["inp"]["net"][0])
    tp, ts, stats = port_f64
    upd, want = _deltas(_sub(got, "f64/params"), p0), _deltas(tp, p0)
    assert all(np.abs(w).max() > 0 for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(upd[k], w, rtol=0, atol=1e-9 * np.abs(w).max(), err_msg=k)
    for k, w in ts.items():
        np.testing.assert_allclose(got[f"f64/state/{k}"], w, rtol=1e-9, atol=1e-15, err_msg=k)
    for k, v in stats.items():
        assert float(got[f"f64/stats/{k}"]) == pytest.approx(v, rel=1e-9, abs=1e-12), k


def test_train_under_space_checkpoints_and_resumes(runs, tmp_path):
    """train() over the (1, 2) mesh for one net-batch: the params within
    atol 2e-4 of train() in one process on the same data, and a checkpoint
    with mesh_shape (1, 2).  It resumes at (1, 1); a (2, 1) mesh refuses
    it."""
    p, s = (TW.params_from_numpy(t) for t in runs["inp"]["net"])
    data = DataHelper(Scenes(), CyclicSampler(8, 4, seed=0, dim=(96, 96)), max_net_batches=1,
                      net_subdivisions=2, prefetch=0)
    want, *_ = train(data, p, s, CFG, TrainConfig(**TRAIN), device="cpu", log_fn=lambda x: None)
    got = _sub(runs["two"][0], "train/params")
    for k, v in _flat(want).items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=2e-4, err_msg=k)
    path, n = CK.get_latest_checkpoint("m", runs["ckpt_dir"])
    ckpt = CK.load_checkpoint(path)
    assert ckpt["mesh_shape"] == (1, 2) and n == 0
    for k, v in _flat(ckpt["params"]).items():
        np.testing.assert_array_equal(v, got[k])
    data = DataHelper(Scenes(), CyclicSampler(8, 4, seed=0, dim=(96, 96)), max_net_batches=2,
                      net_subdivisions=2, prefetch=0)
    *_, recorder = train(data, ckpt["params"], ckpt["state"], CFG, TrainConfig(**TRAIN),
                         checkpoint=ckpt, mesh=M.make_mesh(device="cpu"),
                         log_fn=lambda x: None)
    assert recorder.net_batches_seen == 2
    with pytest.raises(ValueError, match="data-parallel width"):
        train(None, ckpt["params"], ckpt["state"], CFG, TrainConfig(), checkpoint=ckpt,
              mesh=M.Mesh((2, 1), 0, 2, torch.device("cpu")), log_fn=lambda x: None)


# ---------------------------------------------------------------------------
# serving: space = 2 and data = 2
# ---------------------------------------------------------------------------

def _rows_close(got, want):
    np.testing.assert_array_equal(got[..., 7], want[..., 7])      # validity
    np.testing.assert_allclose(got, want, atol=1e-2, rtol=1e-4)


def test_space2_detect_fp32_matches_jax(runs):
    got = runs["two"][0]["space/rows/fp32"]
    assert got[..., 7].sum() > 0
    _rows_close(got, runs["jax"]["rows_fp32"])
    _rows_close(got, runs["port"]["rows_fp32"])
    for i, h in enumerate(runs["port"]["heads_fp32"]):
        np.testing.assert_allclose(runs["two"][0][f"space/heads/fp32/{i}"], h,
                                   rtol=1e-4, atol=1e-4)


def test_space2_detect_bf16(runs):
    """bf16 under space = 2: the gathered heads within 5e-2 * max|head| of
    JAX's bf16 heads and of the one-process port's, and the rows those
    heads give in one process equal to the rows every rank returned.  The
    rows are not held to the one-process rows: a float32 product over
    other rows (a stripe's) sums in another order, one bf16 rounding in a
    few thousand moves, and the heads' convs spread it (on these trees ~1
    bf16 ulp in half the head values), which reorders near-tied boxes."""
    ranks, inp = runs["two"], runs["inp"]
    heads = []
    for i, (w, p) in enumerate(zip(runs["jax"]["heads_bf16"], runs["port"]["heads_bf16"])):
        h = ranks[0][f"space/heads/bf16/{i}"]
        assert np.abs(h - w).max() <= 5e-2 * np.abs(w).max(), i
        assert np.abs(h - p).max() <= 5e-2 * np.abs(p).max(), i
        heads.append(torch.from_numpy(h).to(torch.bfloat16))
    x, org = torch.from_numpy(inp["det_x"]), torch.from_numpy(inp["det_org"])
    with torch.inference_mode():
        want = detect_fn(lambda v, plain: tuple(heads), x, org, CFG, CONF, NMS,
                         compute_dtype=torch.bfloat16).numpy()
    got = ranks[0]["space/rows/bf16"]
    assert got[..., 7].sum() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_data2_detect_matches_one_process(runs, precision):
    """Data-parallel serving over 2 ranks, 4 images each.  Each rank's heads
    against the one-process heads of its images: int8 bit-equal, fp32 within
    rtol = atol = 1e-4 and bf16 within 5e-2 * max|head| (the CPU's float32
    products sum in another order at another batch, and bf16 rounds that
    once).  Every rank returns the whole batch's rows, and they are the
    rows of each rank's own heads, bit for bit.  fp32 and int8 rows are also
    held to the one-process rows (validity equal, rtol 1e-6, atol 1e-5:
    the CPU's vectorized float math gives a last bit by the tensor's length),
    fp32 also to JAX's at JAX's bounds."""
    ranks, port, inp = runs["two"], runs["port"], runs["inp"]
    got = ranks[0][f"data/rows/{precision}"]
    assert got.shape == port[f"rows_{precision}"].shape and got[..., 7].sum() > 0
    dtype = port["heads_dtype"][precision]
    x, org = torch.from_numpy(inp["det_x"]), torch.from_numpy(inp["det_org"])
    for r in range(2):
        mesh = M.Mesh((2, 1), r, 2, torch.device("cpu"))
        heads = [ranks[r][f"rank/data/heads/{precision}/{i}"] for i in range(3)]
        for h, w in zip(heads, port[f"heads_{precision}"]):
            w = w[M.data_slice(mesh, 8)]
            if precision == "int8":
                np.testing.assert_array_equal(h, w)
            elif precision == "fp32":
                np.testing.assert_allclose(h, w, rtol=1e-4, atol=1e-4)
            else:
                assert np.abs(h - w).max() <= 5e-2 * np.abs(w).max()
        own = tuple(torch.from_numpy(h).to(dtype) for h in heads)
        with torch.inference_mode():
            want = detect_fn(lambda v, plain: own, M.data_shard(mesh, x),
                             M.data_shard(mesh, org), CFG, CONF, NMS).numpy()
        np.testing.assert_array_equal(got[M.data_slice(mesh, 8)], want)
    if precision != "bf16":
        np.testing.assert_array_equal(got[..., 7], port[f"rows_{precision}"][..., 7])
        np.testing.assert_allclose(got, port[f"rows_{precision}"], rtol=1e-6, atol=1e-5)
    if precision == "fp32":
        _rows_close(got, runs["jax"]["rows_fp32"])


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_detector_over_a_mesh(runs, mesh):
    """``Detector(mesh=...)`` in fp32 preprocesses its part and returns every
    image's rows: the one-process Detector's, within the rows' bounds
    (data = 2: the last bit of the CPU's float math; space = 2: JAX's)."""
    want = runs["port"]["detector_fp32"]
    got = [runs["two"][0][f"detector/{mesh}/fp32/{i}"] for i in range(len(want))]
    assert sum(len(w) for w in want) > 0
    tol = dict(rtol=1e-6, atol=1e-5) if mesh == "2x1" else dict(rtol=1e-4, atol=1e-2)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **tol)


# ---------------------------------------------------------------------------
# int8 under space: both feeds of an s2d tree and a tree without s2d
# ---------------------------------------------------------------------------

def _int8_rows_close(got, want):
    """``tests/test_torch_quantized.py``'s int8 Detector bounds on [B, M, 8]
    rows: validity equal; on valid rows the class equal, boxes within 1e-2
    px, obj and prob within 1e-4."""
    np.testing.assert_array_equal(got[..., 7], want[..., 7])
    v = got[..., 7] > 0
    np.testing.assert_array_equal(got[v][:, 6], want[v][:, 6])
    np.testing.assert_allclose(got[v][:, :4], want[v][:, :4], rtol=0, atol=1e-2)
    np.testing.assert_allclose(got[v][:, 4:6], want[v][:, 4:6], rtol=0, atol=1e-4)


@pytest.mark.parametrize("run", list(INT8_RUNS))
def test_space2_int8_heads_bit_equal(runs, run):
    """(1, 2), stripes 64 / 32: the heads every rank gathers (rank 1's held
    to rank 0's bytes by digest) bit-equal to JAX's single-device int8
    forward (``apply_yolonet_quantized``, ``_u8`` on the uint8 feed) and to
    the port's one process."""
    got = runs["two"][0]
    for i, (w_jax, w_port) in enumerate(zip(runs["jax_int8"]["heads"][run],
                                            runs["port"][f"heads_{run}"])):
        h = got[f"space/heads/{run}/{i}"]
        assert h.shape == w_port.shape
        np.testing.assert_array_equal(h, w_jax)
        np.testing.assert_array_equal(h, w_port)


@pytest.mark.parametrize("run", list(INT8_RUNS))
def test_space2_int8_rows(runs, run):
    """(1, 2): every rank's rows are the one-process port's, bit for bit
    (the heads are, and the postprocess runs on the same whole batch); the
    s2d tree's float-feed rows are also within the int8 Detector bounds of
    JAX's ``detect_fn`` run op by op."""
    got = runs["two"][0][f"space/rows/{run}"]
    assert got[..., 7].sum() > 0
    np.testing.assert_array_equal(got, runs["port"][f"rows_{run}"])
    if run == "int8":
        _int8_rows_close(got, runs["jax_int8"]["rows"])


@pytest.mark.parametrize("name", ["int8", "int8u8"])
def test_detector_int8_over_space(runs, name):
    """``Detector(precision="int8", mesh=(1, 2))``, on the card's float
    letterbox (``int8``) and on the host's uint8 letterbox (``int8u8``, the
    uint8 feed): each rank calibrates on the whole images as one process
    does, so the rows are the one-process Detector's, bit for bit."""
    want = runs["port"][f"detector_{name}"]
    assert sum(len(w) for w in want) > 0
    for i, w in enumerate(want):
        np.testing.assert_array_equal(runs["two"][0][f"detector/1x2/{name}/{i}"], w)


def test_space4_int8_detect(runs):
    """(2, 2): 4 images a data rank in stripes of 64 / 32.  Each rank's heads
    (gathered over its space pair) bit-equal to the one-process heads of its
    images, and every rank returns the whole batch's rows: the one-process
    rows at the data-parallel bound (validity equal, rtol 1e-6, atol 1e-5),
    since each data rank's postprocess runs on 4 images, and the CPU's
    vectorized float math gives a last bit by the tensor's length."""
    ranks, port = runs["four"], runs["port"]
    for r in range(4):
        sl = M.data_slice(M.Mesh((2, 2), r, 4, torch.device("cpu")), 8)
        for i, w in enumerate(port["heads_int8"]):
            np.testing.assert_array_equal(ranks[r][f"rank/space4/heads/int8/{i}"], w[sl])
    got, want = ranks[0]["space4/rows/int8"], port["rows_int8"]
    assert got[..., 7].sum() > 0
    np.testing.assert_array_equal(got[..., 7], want[..., 7])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
