"""Time the batched letterbox kernel (``csrc/letterbox.cu``) on the card
against its plain version and against the per-image path it replaced.

    python3 scripts/letterbox_times.py [--batch 32] [--dims 320 416 608]

For a batch of seeded uint8 scenes of COCO val's six common sizes (as the
benchmark's traffic has them) at each net size, prints one JSON line: the
kernel's and the plain version's device ms (CUDA-graph replay), the bound
(the packed bytes read once and the float32 output written once at 3.35
TB/s), the kernel's largest distance from the plain version, and the whole
preprocess, host clock to a synchronize: staged (one pinned upload and one
launch) against the per-image path (a blocking upload and a letterbox an
image, then a stack), with the per-image path's device ms (the profiler's
sum of its kernels and copies).  The card's name and power limit close
each line.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from yolo_v3_tpu_torch.ops import letterbox as L  # noqa: E402

COCO_WH = ((640, 480), (480, 640), (640, 427), (500, 375), (640, 360), (427, 640))
HBM_BYTES_PER_S = 3.35e12


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def device_ms(fn, iters=10, warmup=3):
    """Device ms of one call: ``iters`` calls in a CUDA graph, replayed
    between two events (as chip_smoke.py times every kernel)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def per_image(images, dim, dev):
    """The preprocess before the batch was staged: each image uploaded from
    pageable memory and letterboxed on its own, the sizes uploaded, a stack."""
    org = torch.tensor([[im.shape[1], im.shape[0]] for im in images], dtype=torch.float32,
                       device=dev)
    x = [L.letterbox_batch_ref(torch.from_numpy(im).reshape(-1).to(dev),
                               torch.from_numpy(L._descriptors([im], dim, True)), dim)
         for im in images]
    return torch.cat(x), org


def staged(images, dim, dev):
    src, desc, org = L.stage_batch(images, dim, True, dev)
    return L.letterbox_batch(src, desc, dim), org


def wall_ms(fn, iters=20):
    """Median host ms of a call of ``fn`` followed by a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def profiled_device_ms(fn, iters=5):
    """Summed device ms of the kernels and copies of one call (profiler)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages() if e.device_time_total > 0
                and not e.key.startswith(("aten::", "cuda")))
    return total / 1e3 / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--dims", type=int, nargs="+", default=[320, 416, 608])
    args = ap.parse_args()
    dev = torch.device("cuda")
    line = card()
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
              for w, h in (COCO_WH[i % len(COCO_WH)] for i in range(args.batch))]
    for dim in args.dims:
        src, desc, _ = L.stage_batch(images, dim, True, dev)
        cdesc = desc.cpu()
        kernel = device_ms(lambda: L.letterbox_batch(src, desc, dim))
        plain = device_ms(lambda: L.letterbox_batch_ref(src, cdesc, dim))
        got = L.letterbox_batch(src, desc, dim)
        want = L.letterbox_batch_ref(*L.stage_batch(images, dim, True, "cpu")[:2], dim)
        bytes_moved = src.numel() + got.numel() * 4
        print(json.dumps(dict(
            batch=args.batch, dim=dim, kernel_ms=kernel, plain_ms=plain,
            bound_ms=bytes_moved / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            bytes_moved=bytes_moved, max_abs_vs_plain=(got.cpu() - want).abs().max().item(),
            preprocess_wall_ms=dict(staged=wall_ms(lambda: staged(images, dim, dev)),
                                    per_image=wall_ms(lambda: per_image(images, dim, dev))),
            per_image_device_ms=profiled_device_ms(lambda: per_image(images, dim, dev)),
            card=line)), flush=True)


if __name__ == "__main__":
    main()
