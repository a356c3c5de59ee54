"""Child worker of the port's real multi-process tests
(``tests/test_torch_parallel.py``): one rank of a gloo run on the CPU,
joined through ``parallel.distributed.initialize`` from the launcher's
variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
Imports the port only.

    torch_dist_worker.py step IN.npz OUT_PREFIX
        IN.npz holds ``params/...``, ``state/...`` (float32 trees), ``imgs``
        [S, B, H, W, 3] and ``labels`` [S, B, T, 5], the global net-batch.
        On this rank's contiguous shard: one step in float32, again with
        remat, two in float64, and the train-mode forward of micro-batch 0;
        writes OUT_PREFIX.rank<r>.npz (ranks after 0: the heads, and a
        SHA-256 digest of every other array).
    torch_dist_worker.py preempt WEIGHT_DIR OUT_PREFIX
        train() over a host-sharded DataHelper for up to 4 net-batches, rank
        1 sending itself SIGTERM while it assembles the second; writes
        OUT_PREFIX.rank<r>.json with where the rank stopped.
    torch_dist_worker.py space IN.npz OUT_PREFIX
        (``tests/test_torch_space.py``) Two ranks, meshes (1, 2) and (2, 1).
        IN.npz holds the step's ``params/...``, ``state/...``, ``imgs`` and
        ``labels`` (the global net-batch), the detect trees ``det/...``,
        ``det_x`` [B, H, W, 3] and ``det_org`` [B, 2], the same images as
        uint8 ``det_xu8``, the uint8 Detector images ``det_u8`` [N, h, w,
        3], and ``halo`` / ``gather`` (whole tensors whose stripes the
        collectives get); the int8 artifacts are ``q.npz`` (s2d) and
        ``q_plain.npz`` (no s2d) beside it.  On (1, 2): halo_exchange and
        gather_rows with their gradients, the train-mode forward, one step
        in float32 and in float64, detect (heads and rows) in bf16, fp32 and
        int8 (:data:`INT8_RUNS`), fp32 and int8 Detectors (int8 on both
        feeds), and train() for one net-batch with a checkpoint; on (2, 1):
        detect in fp32, bf16 and int8 (rows, and each rank's heads) and an
        fp32 Detector.  Writes
        OUT_PREFIX.rank<r>.npz (ranks after 0: a digest of every array but
        the per-rank ``rank/...`` ones).
    torch_dist_worker.py space4 IN.npz OUT_PREFIX
        Four ranks, mesh (2, 2): the train-mode forward and one step in
        float32 and float64, and int8 detect (rows, each rank's heads), on
        the same IN.npz.
"""

import hashlib
import json
import os
import signal
import sys

import numpy as np
import torch

from torch_float64 import port_in_float64
from yolo_v3_tpu_torch.models import darknet as D
from yolo_v3_tpu_torch.models import weights as W
from yolo_v3_tpu_torch.parallel import distributed as dist
from yolo_v3_tpu_torch.train.optimizer import make_optimizer
from yolo_v3_tpu_torch.train.step import make_train_step
from yolo_v3_tpu_torch.utils.config import TrainConfig, YoloConfig

CFG = YoloConfig(num_classes=2, img_dim=64)
TCFG = TrainConfig(lr=1e-3, backbone_lr=1e-4)
BLOCKS = (1, 1, 1, 1, 1)


def flat(prefix, tree):
    return {f"{prefix}/{k}": v for k, v in W._flatten_with_names(tree).items()}


def step_mode(ctx, mesh, inp, out):
    with np.load(inp) as z:
        arrays = {k: z[k] for k in z.files}
    tree = W.tree_from_flat({k: v for k, v in arrays.items() if "/" in k})
    B = arrays["imgs"].shape[1]
    sl = slice(ctx.process_id * B // ctx.num_processes,
               (ctx.process_id + 1) * B // ctx.num_processes)
    imgs, labels = (torch.from_numpy(arrays[k][:, sl]) for k in ("imgs", "labels"))
    res = {}
    for name, dtype, remat in (("f32", torch.float32, False), ("remat", torch.float32, True),
                               ("f64", torch.float64, False)):
        params, state = (D.map_tree(lambda t: t.to(dtype), tree[k]) for k in ("params", "state"))
        opt = make_optimizer(TCFG)
        step = make_train_step(CFG, opt, compute_dtype=dtype, remat=remat, mesh=mesh)
        o = opt.init(params)
        # float64 takes a second step, on the momentum of the first
        for tag in (name, "f64_2") if name == "f64" else (name,):
            with port_in_float64():
                params, state, o, stats = step(params, state, o, imgs.to(dtype),
                                               labels.to(dtype))
            res.update(flat(f"{tag}/params", params))
            res.update(flat(f"{tag}/state", state))
            res.update({f"{tag}/stats/{k}": v.numpy() for k, v in stats.items()})
    raws, new_state = D.apply_yolonet(tree["params"], tree["state"], imgs[0], training=True,
                                      mesh=mesh)
    res.update(flat("bn/state", new_state))
    if ctx.process_id > 0:
        # the other ranks' trees are held bit-equal to rank 0's: a digest each
        res = {f"sha256/{k}": np.frombuffer(hashlib.sha256(v.tobytes()).digest(), np.uint8)
               for k, v in res.items()}
    res.update({f"bn/raw{i}": r.detach().numpy() for i, r in enumerate(raws)})
    np.savez(f"{out}.rank{ctx.process_id}.npz", **res)


class SignallingDataset:
    """Seeded 64 x 64 scenes, one box each; on rank 1 the fifth sample it
    assembles (the second net-batch's first, in 2-image shards at 2
    subdivisions) sends the process SIGTERM."""

    def __init__(self, rank, n=8):
        rng = np.random.default_rng(1)
        self.imgs = rng.integers(0, 255, (n, 64, 64, 3), dtype=np.uint8)
        self.rank, self.calls = rank, 0

    def __len__(self):
        return len(self.imgs)

    def get(self, i, dim, seed):
        self.calls += 1
        if self.rank == 1 and self.calls == 5:
            os.kill(os.getpid(), signal.SIGTERM)
        label = np.zeros((4, 5), np.float32)
        label[0] = (i % 2, 0.5, 0.5, 0.4, 0.4)
        return {"img": self.imgs[i], "label": label}


def preempt_mode(ctx, mesh, weight_dir, out):
    from yolo_v3_tpu_torch.data.sampler import CyclicSampler
    from yolo_v3_tpu_torch.train.loop import train

    ds = SignallingDataset(ctx.process_id)
    data = dist.make_data_helper(ds, CyclicSampler(len(ds), 4, seed=0, dim=(64, 64)), ctx,
                                 max_net_batches=4, net_subdivisions=2, prefetch=0)
    params, state = D.init_yolonet(torch.Generator().manual_seed(0), CFG.num_classes,
                                   blocks=BLOCKS)
    *_, recorder = train(data, params, state, CFG, TCFG, model_id="m", weight_dir=weight_dir,
                         checkpoint_interval=100, mesh=mesh, log_fn=lambda s: None)
    with open(f"{out}.rank{ctx.process_id}.json", "w") as f:
        json.dump({"net_batch": data.get_net_batch(),
                   "recorded": recorder.net_batches_seen}, f)


SPACE_CFG = YoloConfig(num_classes=2, img_dim=96)


def digests(res, rank):
    """Ranks after 0 keep their ``rank/...`` arrays and send a SHA-256 digest
    of every other array, which the test holds to rank 0's bytes."""
    if rank == 0:
        return res
    return {k if k.startswith("rank/") else f"sha256/{k}":
            v if k.startswith("rank/") else
            np.frombuffer(hashlib.sha256(np.ascontiguousarray(v).tobytes()).digest(), np.uint8)
            for k, v in res.items()}


def halo_weights(rank, shape, seed):
    """The per-rank weights of the collectives' test losses (the test makes
    the same ones)."""
    return np.random.default_rng(seed + rank).uniform(-1, 1, shape).astype(np.float32)


def space_steps(mesh, arrays, tree, res):
    """The train-mode forward of micro-batch 0 (heads gathered) and one step
    in float32 and in float64 on this rank's part of the net-batch."""
    from yolo_v3_tpu_torch.parallel import halo as H
    from yolo_v3_tpu_torch.parallel import mesh as M

    imgs, labels = (M.data_shard(mesh, torch.from_numpy(arrays[k]).transpose(0, 1))
                    .transpose(0, 1) for k in ("imgs", "labels"))
    x, y = M.shard_train_inputs(mesh, imgs, labels)
    raws, new_state = D.apply_yolonet(tree["params"], tree["state"], x[0], training=True,
                                      mesh=mesh)
    res.update({f"rank/raw{i}": H.gather_rows(r, mesh).detach().numpy()
                for i, r in enumerate(raws)})
    res.update(flat("bn/state", new_state))
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        params, state = (D.map_tree(lambda t: t.to(dtype), tree[k]) for k in ("params", "state"))
        opt = make_optimizer(TCFG)
        step = make_train_step(SPACE_CFG, opt, compute_dtype=dtype, mesh=mesh)
        with port_in_float64():
            params, state, _, stats = step(params, state, opt.init(params), x.to(dtype),
                                           y.to(dtype))
        res.update(flat(f"{name}/params", params))
        res.update(flat(f"{name}/state", state))
        res.update({f"{name}/stats/{k}": v.numpy() for k, v in stats.items()})


def collectives(mesh, arrays, res):
    """halo_exchange at stride 1 and 2 (NCHW) and gather_rows (NHWC) on this
    rank's stripe of ``halo`` / ``gather``, with the gradients of a sum of
    the outputs weighted by :func:`halo_weights`."""
    from yolo_v3_tpu_torch.parallel import halo as H
    from yolo_v3_tpu_torch.parallel import mesh as M

    for name, top, bottom in (("halo11", 1, 1), ("halo10", 1, 0)):
        x = M.stripe(mesh, torch.from_numpy(arrays["halo"]), 2).clone().requires_grad_(True)
        out = H.halo_exchange(x, mesh, top, bottom)
        (out * torch.from_numpy(halo_weights(mesh.rank, out.shape, 100))).sum().backward()
        res[f"rank/{name}"], res[f"rank/{name}_grad"] = out.detach().numpy(), x.grad.numpy()
    x = M.stripe(mesh, torch.from_numpy(arrays["gather"]), 1).clone().requires_grad_(True)
    out = H.gather_rows(x, mesh)
    (out * torch.from_numpy(halo_weights(mesh.rank, out.shape, 200))).sum().backward()
    res["rank/gather"], res["rank/gather_grad"] = out.detach().numpy(), x.grad.numpy()


# the int8 runs: (artifact beside IN.npz, images): an s2d tree on the float
# feed and on the uint8 feed, and a tree without s2d
INT8_RUNS = {"int8": ("q.npz", "det_x"), "int8u8": ("q.npz", "det_xu8"),
             "int8plain": ("q_plain.npz", "det_x")}


def space_detects(mesh, arrays, det_tree, tag, res, precisions=("fp32", "bf16")):
    """detect_fn on this rank's part of the images in each precision (the
    int8 ones of :data:`INT8_RUNS`), the heads too: under space gathered
    over the space group (a ``rank/`` key where the data axis splits the
    batch too), else this rank's images'."""
    from yolo_v3_tpu_torch.detector import detect_fn
    from yolo_v3_tpu_torch.models import quantized as Q
    from yolo_v3_tpu_torch.parallel import mesh as M

    org = torch.from_numpy(arrays["det_org"])
    orgs = M.data_shard(mesh, org)
    for prec in precisions:
        if prec in INT8_RUNS:
            qfile, images = INT8_RUNS[prec]
            model = Q.YoloNetQuantized(Q.load_quantized(os.path.join(arrays["dir"], qfile)))
            dtype = torch.float32
        else:
            images, dtype = "det_x", {"fp32": torch.float32, "bf16": torch.bfloat16}[prec]
            model = D.YoloNetFolded(D.cast_params(D.fold_batchnorm(*det_tree), dtype))
        x = torch.from_numpy(arrays[images])
        xs = M.stripe(mesh, M.data_shard(mesh, x), 1).contiguous()
        xd = xs if xs.dtype == torch.uint8 else xs.to(dtype)
        with torch.inference_mode():
            rows = detect_fn(model.eval(), xs, orgs, SPACE_CFG, 0.3, 0.45,
                             compute_dtype=dtype, mesh=mesh)
            res[f"{tag}/rows/{prec}"] = rows.numpy()
            if mesh.space_size > 1:
                heads = model(xd, mesh=mesh)
                key = f"rank/{tag}" if mesh.data_size > 1 else tag
            else:                               # this rank's images' heads
                heads = model(xd)
                key = f"rank/{tag}"
            res.update({f"{key}/heads/{prec}/{i}": h.float().numpy()
                        for i, h in enumerate(heads)})


def detector_rows(mesh, arrays, det_tree, precision, resize_on_device=True):
    """A Detector's rows for ``det_u8`` over ``mesh``; ``resize_on_device=
    False`` (int8: the uint8 feed) is tagged ``<precision>u8``."""
    from yolo_v3_tpu_torch.detector import Detector

    det = Detector(*det_tree, SPACE_CFG, precision=precision, device="cpu", mesh=mesh,
                   resize_on_device=resize_on_device)
    rows = det.detect(list(arrays["det_u8"]))
    name = precision if resize_on_device else f"{precision}u8"
    return {f"detector/{mesh.shape[0]}x{mesh.shape[1]}/{name}/{i}": r
            for i, r in enumerate(rows)}


class Scenes:
    """Seeded 96 x 96 scenes with one box each, the same on every rank."""

    def __init__(self, n=8):
        self.imgs = np.random.default_rng(3).integers(0, 255, (n, 96, 96, 3), dtype=np.uint8)

    def __len__(self):
        return len(self.imgs)

    def get(self, i, dim, seed):
        label = np.zeros((4, 5), np.float32)
        label[0] = (i % 2, 0.5, 0.5, 0.4, 0.4)
        return {"img": self.imgs[i], "label": label}


def space_train(ctx, mesh, tree, weight_dir, res):
    """train() under the mesh for one net-batch of 4 x 2 at 96 x 96, with a
    checkpoint: the ranks of the one data group assemble the same images
    and cut their stripes."""
    from yolo_v3_tpu_torch.data.sampler import CyclicSampler
    from yolo_v3_tpu_torch.train.loop import train

    ds = Scenes()
    data = dist.make_data_helper(ds, CyclicSampler(len(ds), 4, seed=0, dim=(96, 96)), ctx,
                                 space=mesh.space_size, max_net_batches=1,
                                 net_subdivisions=2, prefetch=0)
    params, state, *_ = train(data, tree["params"], tree["state"], SPACE_CFG, TCFG,
                              model_id="m", weight_dir=weight_dir, mesh=mesh,
                              log_fn=lambda s: None)
    res.update(flat("train/params", params))
    res.update(flat("train/state", state))


def space_mode(ctx, mode, inp, out):
    with np.load(inp) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["dir"] = os.path.dirname(inp)
    tree = W.tree_from_flat({k: v for k, v in arrays.items()
                             if k.startswith(("params/", "state/"))})
    det = W.tree_from_flat({k[4:]: v for k, v in arrays.items() if k.startswith("det/")})
    det_tree = (D.cast_params(det["params"], torch.float32),
                D.cast_params(det["state"], torch.float32))
    res = {}
    if mode == "space4":
        mesh = dist.make_global_mesh(space=2, device="cpu")
        assert mesh.shape == (2, 2) and (mesh.data_index, mesh.space_index) == divmod(
            ctx.process_id, 2), mesh
        space_steps(mesh, arrays, tree, res)
        space_detects(mesh, arrays, det_tree, "space4", res, ("int8",))
    else:
        mesh = dist.make_global_mesh(space=2, device="cpu")
        assert mesh.shape == (1, 2) and mesh.space_index == ctx.process_id, mesh
        collectives(mesh, arrays, res)
        space_steps(mesh, arrays, tree, res)
        space_detects(mesh, arrays, det_tree, "space", res, ("fp32", "bf16", *INT8_RUNS))
        res.update(detector_rows(mesh, arrays, det_tree, "fp32"))
        res.update(detector_rows(mesh, arrays, det_tree, "int8"))
        res.update(detector_rows(mesh, arrays, det_tree, "int8", resize_on_device=False))
        space_train(ctx, mesh, tree, os.path.dirname(inp), res)
        dp = dist.make_global_mesh(device="cpu")
        assert dp.shape == (2, 1) and dp.data_index == ctx.process_id, dp
        space_detects(dp, arrays, det_tree, "data", res, ("fp32", "bf16", "int8"))
        res.update(detector_rows(dp, arrays, det_tree, "fp32"))
    np.savez(f"{out}.rank{ctx.process_id}.npz", **digests(res, ctx.process_id))


def main():
    mode, arg, out = sys.argv[1:4]
    torch.set_num_threads(2)
    ctx = dist.initialize(backend="gloo")
    assert ctx.num_processes == int(os.environ["WORLD_SIZE"]), ctx
    assert ctx.process_id == int(os.environ["RANK"]), ctx
    try:
        if mode in ("space", "space4"):
            space_mode(ctx, mode, arg, out)
            return
        mesh = dist.make_global_mesh(device="cpu")
        assert mesh.shape == (ctx.num_processes, 1) and mesh.rank == ctx.process_id, mesh
        (step_mode if mode == "step" else preempt_mode)(ctx, mesh, arg, out)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
