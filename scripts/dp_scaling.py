"""Data-parallel training over the cards of one host, against one card.

    python3 scripts/dp_scaling.py OUT                  # one process, card 0
    torchrun --standalone --nproc-per-node 4 scripts/dp_scaling.py OUT
                                                       # 4 ranks, NCCL, a card each
    torchrun --standalone --nproc-per-node 4 scripts/dp_scaling.py OUT --space 2
                                                       # mesh (2, 2): 2 ranks an image
    python3 scripts/dp_scaling.py OUT --compare        # the runs side by side

YOLOv3-416 fp32 (80 classes, Darknet-53 blocks (1,2,8,8,4), random weights
from ``torch.Generator`` seed 0) trains on 64 seeded in-memory scenes
(``chip_smoke.SceneDataset``, 1-8 boxes each) at a global net-batch of
32 x 2 subdivisions, the same for every world size (8 x 2 a rank at 4
ranks): one net-batch with a checkpoint, then a resume for 5 more.
``--space S`` puts S ranks on each image, each on a stripe of its rows
(the mesh ``(N / S, S)``, halo rows exchanged around every 3x3 conv).
Each run writes, from rank 0, its first net-batch's stats and its ms per
net-batch (between consecutive stats readbacks, over the last 4) to
``OUT/ranks<N>[_space<S>].json``; the checkpoints go to
``OUT/ranks<N>[_space<S>]/``.
``--compare`` holds every run's first net-batch against one process's,
as ``chip_smoke.py`` phase 9 does (params within atol 2e-4, BN state
within rtol 1e-4 / atol 1e-5, loss and stats within rtol 1e-4, counts
equal; a ``space`` run as phase 10 does: BN state within atol 2e-4,
stats within rtol = atol = 2e-4), and prints each run's ms per net-batch and speed-up with the card's
name and power limit.  ``--device cpu --tiny`` runs the same on CPU ranks
(gloo) with a small net at 64^2, to rehearse without a card.  Imports no
JAX.
"""

import argparse
import glob
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as S  # noqa: E402

IMAGES = 64
BATCH = 32                  # the global micro-batch
SUBDIVISIONS = 2
NET_BATCHES = 6             # 1, then a resume for 5; timed over the last 4
TINY = dict(blocks=(1, 1, 1, 1, 1), num_classes=2, dim=64)


def run_name(ranks, space):
    return f"ranks{ranks}" + (f"_space{space}" if space > 1 else "")


def run(out, device, tiny, space):
    from yolo_v3_tpu_torch.data.sampler import CyclicSampler
    from yolo_v3_tpu_torch.models import darknet as D
    from yolo_v3_tpu_torch.parallel import distributed as dist
    from yolo_v3_tpu_torch.train.checkpoint import load_checkpoint
    from yolo_v3_tpu_torch.train.loop import train
    from yolo_v3_tpu_torch.utils.config import TrainConfig, YoloConfig

    ctx = dist.initialize(backend="gloo" if device == "cpu" else None)
    mesh = None
    if ctx.is_distributed:
        mesh = dist.make_global_mesh(space=space, device="cpu" if device == "cpu" else None)
    if tiny:
        blocks, num_classes, dim = TINY["blocks"], TINY["num_classes"], TINY["dim"]
    else:
        blocks, num_classes, dim = S.DARKNET53_BLOCKS, 80, 416
    config = YoloConfig(num_classes=num_classes, img_dim=dim)
    tcfg = TrainConfig(batch_size=BATCH, net_subdivisions=SUBDIVISIONS)
    dataset = S.SceneDataset(IMAGES, num_classes, hw=dim)
    params, state = D.init_yolonet(torch.Generator().manual_seed(0), num_classes,
                                   blocks=blocks)
    name = run_name(ctx.num_processes, space)
    wdir = os.path.join(out, name)

    def data(n):
        sampler = CyclicSampler(len(dataset), BATCH, shuffle=False, dim=(dim, dim))
        return dist.make_data_helper(dataset, sampler, ctx, space=space, max_net_batches=n,
                                     net_subdivisions=SUBDIVISIONS)

    marks = []

    def log_fn(line):
        if line.startswith("net_batch"):
            marks.append(time.perf_counter())

    run_device = device if mesh is None else mesh.device
    *_, recorder = train(data(1), params, state, config, tcfg, model_id="dp",
                         weight_dir=wdir, mesh=mesh, device=run_device,
                         log_fn=lambda line: None)
    first = dict(recorder.current_stats)
    checkpoint = load_checkpoint(os.path.join(wdir, "dp", "yolov3_dp_checkpoint_000000.npz"))
    train(data(NET_BATCHES), params, state, config, tcfg, checkpoint=checkpoint, mesh=mesh,
          device=run_device, log_fn=log_fn)
    if ctx.process_id == 0:
        steps = np.diff(marks[-5:]) * 1000
        with open(os.path.join(out, f"{name}.json"), "w") as f:
            json.dump({"ranks": ctx.num_processes, "space": space, "stats": first,
                       "ms_per_net_batch": steps.tolist(),
                       "device": (torch.cuda.get_device_name(0) if device != "cpu"
                                  else "cpu")}, f)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def compare(out, device):
    from yolo_v3_tpu_torch.train.checkpoint import load_checkpoint

    card = S.card_line() if device != "cpu" else "cpu (rehearsal, not a device time)"
    runs = {}
    for path in sorted(glob.glob(os.path.join(out, "ranks*.json"))):
        with open(path) as f:
            r = json.load(f)
        runs[(r["ranks"], r.get("space", 1))] = r
    S.check((1, 1) in runs and len(runs) > 1,
            f"need one process and a multi-rank run: {sorted(runs)}")

    def ckpt(key):
        return load_checkpoint(os.path.join(out, run_name(*key), "dp",
                                            "yolov3_dp_checkpoint_000000.npz"))

    one = ckpt((1, 1))
    base = float(np.median(runs[(1, 1)]["ms_per_net_batch"]))
    print(f"1 process: {base:.1f} ms per net-batch of {BATCH} x {SUBDIVISIONS} (median of "
          f"{runs[(1, 1)]['ms_per_net_batch']}) | {card}")
    for key in sorted(runs):
        if key == (1, 1):
            continue
        got = ckpt(key)
        n, space = key
        shape = (n // space, space)
        S.check(got["mesh_shape"] == shape, f"ranks {n}: mesh_shape {got['mesh_shape']}")
        a, b = S.flat_trees(got["params"]), S.flat_trees(one["params"])
        err, leaf = max((float(np.abs(a[k] - b[k]).max()), k) for k in b)
        S.check(err <= 2e-4, f"ranks {n}: params {err} from one process's ({leaf})")
        # the space axis's bounds are the CPU space tests' (JAX's own): BN state
        # atol 2e-4, stats rtol = atol = 2e-4
        s_atol, s_rtol, rtol, atol = (1e-5, 1e-4, 1e-4, 1e-12) if space == 1 else (
            2e-4, 0.0, 2e-4, 2e-4)
        a, b = S.flat_trees(got["state"]), S.flat_trees(one["state"])
        s_err, s_leaf = max((float((np.abs(a[k] - b[k]) / (s_atol + s_rtol * np.abs(b[k]))).max()),
                             k) for k in b)
        S.check(s_err <= 1, f"ranks {n}: BN state {s_leaf} at {s_err} x rtol {s_rtol} / "
                            f"atol {s_atol}")
        for k, v in runs[(1, 1)]["stats"].items():
            g = runs[key]["stats"][k]
            if k in ("nCorrect", "nGT"):
                S.check(g == v, f"ranks {n}: {k} {g} vs {v}")
            else:
                S.check(abs(g - v) <= rtol * abs(v) + atol, f"ranks {n}: {k} {g} vs {v}")
        ms = float(np.median(runs[key]["ms_per_net_batch"]))
        part = (f"{BATCH // n} x {SUBDIVISIONS} a rank" if space == 1 else
                f"{BATCH // shape[0]} x {SUBDIVISIONS} a data group of {space} ranks, each a "
                f"stripe of the rows")
        print(f"{n} ranks, mesh {shape}: {ms:.1f} ms per net-batch of {BATCH} x {SUBDIVISIONS} "
              f"({part}; median of {runs[key]['ms_per_net_batch']}), "
              f"{base / ms:.2f}x one process; first net-batch: params within {err:.2e} "
              f"({leaf}), BN state {s_err:.2f} x its bound, loss and stats within rtol {rtol} "
              f"| {card}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--space", type=int, default=1,
                    help="ranks an image (height sharding); the world must divide by it")
    args = ap.parse_args()
    if args.device != "cpu" and not torch.cuda.is_available():
        sys.exit("dp_scaling: no CUDA device (--device cpu --tiny rehearses on the CPU)")
    os.makedirs(args.out, exist_ok=True)
    if args.compare:
        compare(args.out, args.device)
    else:
        run(args.out, args.device, args.tiny, args.space)


if __name__ == "__main__":
    main()
