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
                                      bn_group=mesh.bn_group)
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


def main():
    mode, arg, out = sys.argv[1:4]
    torch.set_num_threads(2)
    ctx = dist.initialize(backend="gloo")
    assert ctx.num_processes == int(os.environ["WORLD_SIZE"]), ctx
    assert ctx.process_id == int(os.environ["RANK"]), ctx
    mesh = dist.make_global_mesh(device="cpu")
    assert mesh.shape == (ctx.num_processes, 1) and mesh.rank == ctx.process_id, mesh
    try:
        (step_mode if mode == "step" else preempt_mode)(ctx, mesh, arg, out)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
