"""Drive the PyTorch port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile every kernel of the path from ``yolo_v3_tpu_torch/csrc``;
3. kernel vs plain: the fused residual-block kernel against its plain
   PyTorch version at the 5 residual-block shapes of YOLOv3-416 at batch 8,
   in fp32 and bf16, with CUDA-event times of both;
4. main path: full-width YOLOv3-416 (80 classes, blocks (1,2,8,8,4)) from
   ``torch.Generator`` seed 0, written as darknet ``.weights`` and loaded
   through ``Detector.from_darknet_weights``; ``detect`` on 8 seeded uint8
   images of assorted sizes in bf16 and fp32, with the kernel's launch count
   read around each run and the outputs checked against the plain path;
5. timing: e2e ``detect`` images/sec at batch 8 and forward ms.

The line before the last is the kernel summary as JSON; the last line is
``{"ok": true, "device": {...}}``.  Needs CUDA; imports no JAX.
"""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

DARKNET53_BLOCKS = (1, 2, 8, 8, 4)
# (H, C) of the residual blocks of YOLOv3-416, stage by stage
RES_SHAPES_416 = ((208, 64), (104, 128), (52, 256), (26, 512), (13, 1024))
BATCH = 8
IMAGE_HW = ((480, 640), (375, 500), (416, 416), (300, 700))
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),      # summation order
       torch.bfloat16: dict(rtol=1.6e-2, atol=1.6e-2)}  # 2 bf16 ulps
NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def log(msg):
    print(msg, flush=True)


def check(ok, what):
    """Fail the run (a raise, so it also holds under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def block_inputs(h, c, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    cmid = c // 2

    def t(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)

    return (t(BATCH, h, h, c, scale=0.5), t(c, cmid, scale=c ** -0.5),
            t(cmid, scale=0.1), t(3, 3, cmid, c, scale=(9 * cmid) ** -0.5),
            t(c, scale=0.1))


def check_kernel(card):
    """Phase 3: kernel vs plain at every residual-block shape; returns
    per-dtype {max_abs_err, ms, plain_ms} with ms summed over one forward's
    23 blocks."""
    from yolo_v3_tpu_torch.ops.fused_res_block import fused_res_block, fused_res_block_ref

    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        err = ms = plain_ms = 0.0
        for (h, c), n in zip(RES_SHAPES_416, DARKNET53_BLOCKS):
            args = block_inputs(h, c, dtype, seed=h)
            got = fused_res_block(*args)
            torch.cuda.synchronize()
            want = fused_res_block_ref(*args)
            torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
            e = (got.float() - want.float()).abs().max().item()
            k_ms = cuda_ms(lambda: fused_res_block(*args))
            p_ms = cuda_ms(lambda: fused_res_block_ref(*args))
            log(f"kernel {NAMES[dtype]} [{BATCH},{h},{h},{c}] max_abs_err={e:.3e} "
                f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} x{n} blocks "
                f"tol={TOL[dtype]} | {card}")
            err, ms, plain_ms = max(err, e), ms + n * k_ms, plain_ms + n * p_ms
        summary[dtype] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
        log(f"kernel {NAMES[dtype]} per-forward residual blocks: kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} | {card}")
    return summary


def spread_batchnorm(params, state, gen):
    """Give the random model BN statistics and scales drawn from ``gen``,
    so activations keep their size through the 75 convs and some scores
    pass 0.5 (identity BN leaves every score near 0.25, nothing to detect)."""
    def walk(p, s):
        if "bn" in p:
            c = p["bn"]["scale"].shape[0]
            p["bn"]["scale"] = 1.0 + torch.rand(c, generator=gen)
            p["bn"]["bias"] = 0.1 * torch.randn(c, generator=gen)
            s["mean"] = 0.1 * torch.randn(c, generator=gen)
            s["var"] = 0.5 + torch.rand(c, generator=gen)
        elif "b" not in p:
            for k in p:
                walk(p[k], s.get(k, {}))

    walk(params, state)


def make_images():
    rng = np.random.default_rng(0)
    imgs = []
    for i in range(BATCH):
        h, w = IMAGE_HW[i % len(IMAGE_HW)]
        # smooth random scenes: a coarse noise field upsampled, plus grain
        coarse = rng.integers(0, 255, (h // 16 + 1, w // 16 + 1, 3))
        img = np.repeat(np.repeat(coarse, 16, 0), 16, 1)[:h, :w]
        img = img + rng.integers(-20, 20, (h, w, 3))
        imgs.append(np.clip(img, 0, 255).astype(np.uint8))
    return imgs


def check_rows(rows, imgs, num_classes):
    for r, im in zip(rows, imgs):
        check(r.ndim == 2 and r.shape[1] == 7, f"rows shape {r.shape}")
        check(np.isfinite(r).all(), "finite rows")
        check(np.all((r[:, 0] >= 0) & (r[:, 0] < num_classes)), "class ids in range")
        check(np.all(r[:, 1:3] >= -1e-3)
              and np.all(r[:, 1] + r[:, 3] <= im.shape[1] + 1e-2)
              and np.all(r[:, 2] + r[:, 4] <= im.shape[0] + 1e-2), "boxes inside the frame")
        check(np.all((r[:, 5] > 0) & (r[:, 5] <= 1)), "probabilities in (0, 1]")


def same_rows(a, b, box_atol=1e-2, prob_atol=1e-4):
    """Every row of ``a`` has one row of ``b`` with the same class, boxes
    within ``box_atol`` px and probabilities within ``prob_atol`` (order may
    differ where two scores tie to fp32 noise)."""
    if a.shape != b.shape:
        return False
    used = np.zeros(len(b), bool)
    for row in a:
        ok = ((b[:, 0] == row[0]) & ~used
              & (np.abs(b[:, 1:5] - row[1:5]).max(1) <= box_atol)
              & (np.abs(b[:, 5:] - row[5:]).max(1) <= prob_atol))
        if not ok.any():
            return False
        used[np.argmax(ok)] = True
    return True


def main_path(card, weights_path):
    """Phase 4 and 5.  Returns {dtype: launches in that dtype's main run}."""
    from yolo_v3_tpu_torch.detector import Detector
    from yolo_v3_tpu_torch.models import darknet as D
    from yolo_v3_tpu_torch.models import weights as W
    from yolo_v3_tpu_torch.ops.fused_res_block import fused_res_block, fused_res_block_ref
    from yolo_v3_tpu_torch.ops.postprocess import postprocess_from_raws
    from yolo_v3_tpu_torch.utils.config import YoloConfig

    config = YoloConfig()                                # 80 classes, 416
    gen = torch.Generator().manual_seed(0)
    params, state = D.init_yolonet(gen, config.num_classes, blocks=DARKNET53_BLOCKS)
    spread_batchnorm(params, state, gen)
    W.save_darknet_weights(params, state, weights_path)
    imgs = make_images()
    n_blocks = sum(DARKNET53_BLOCKS)
    launches = {}
    for precision, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        det = Detector.from_darknet_weights(weights_path, config, device="cuda",
                                            precision=precision)
        check(det.model.num_res_blocks == n_blocks, "23 residual blocks")

        fused_res_block.launches = 0
        rows = det.detect(imgs)
        torch.cuda.synchronize()
        launches[dtype] = fused_res_block.launches
        check(launches[dtype] == n_blocks,
              f"{launches[dtype]} kernel launches in one forward, want {n_blocks}")
        check_rows(rows, imgs, config.num_classes)
        n_det = [len(r) for r in rows]
        log(f"main {precision}: detect(8 images) ok, kernel launches={launches[dtype]} "
            f"(= {n_blocks} residual blocks), detections per image={n_det} | {card}")

        # raw heads, kernel path vs plain path, on the card
        x, _ = det.preprocess(imgs)
        with torch.inference_mode():
            heads = det.model(x.to(dtype))
            plain = det.model(x.to(dtype), res_block=fused_res_block_ref)
        for i, (h, p) in enumerate(zip(heads, plain)):
            check(tuple(h.shape) == (BATCH, 13 * 2 ** i, 13 * 2 ** i, 255),
                  f"head{i} shape {tuple(h.shape)}")
            check(bool(torch.isfinite(h).all()), f"head{i} finite")
            scale = p.float().abs().max().item()
            err = (h.float() - p.float()).abs().max().item()
            if dtype == torch.float32:
                torch.testing.assert_close(h, p, rtol=1e-3, atol=1e-3 * scale)
                tol = "rtol 1e-3, atol 1e-3*max|head|"
            else:
                check(err <= 5e-2 * scale, f"bf16 head{i} err {err} > 5e-2 * {scale}")
                tol = "max-abs-err <= 5e-2*max|head|"
            log(f"main {precision}: head{i} {tuple(h.shape)} kernel vs plain "
                f"max_abs_err={err:.3e} max|head|={scale:.3e} ({tol}) | {card}")
        if dtype == torch.float32:
            plain_rows = det.detect(imgs, res_block=fused_res_block_ref)
            check(all(same_rows(a, b) for a, b in zip(rows, plain_rows)),
                  "fp32 detections equal on kernel and plain paths")
            log("main fp32: detection rows equal on kernel and plain paths "
                f"(boxes atol 1e-2 px, probs atol 1e-4) | {card}")

        # phase 5: timing after warm-up
        with torch.inference_mode():
            xd = x.to(dtype)
            fwd_ms = cuda_ms(lambda: det.model(xd))
            fwd_plain_ms = cuda_ms(lambda: det.model(xd, res_block=fused_res_block_ref))
            pre_ms = cuda_ms(lambda: det.preprocess(imgs))
            post_ms = cuda_ms(lambda: postprocess_from_raws(
                heads, config, config.img_dim, config.conf_thr, config.nms_thr))
        e2e_ms = cuda_ms(lambda: det.detect(imgs), iters=5, warmup=2)
        e2e_plain_ms = cuda_ms(lambda: det.detect(imgs, res_block=fused_res_block_ref),
                               iters=5, warmup=2)
        log(f"time {precision} bs{BATCH} 416: e2e detect {BATCH * 1000 / e2e_ms:.2f} imgs/sec "
            f"({e2e_ms:.3f} ms/batch), forward {fwd_ms:.3f} ms; plain path: "
            f"{BATCH * 1000 / e2e_plain_ms:.2f} imgs/sec ({e2e_plain_ms:.3f} ms/batch), "
            f"forward {fwd_plain_ms:.3f} ms | {card}")
        log(f"time {precision} bs{BATCH} 416 kernel path split: preprocess "
            f"{pre_ms:.3f} ms, forward {fwd_ms:.3f} ms, postprocess {post_ms:.3f} ms | {card}")
        del det
        torch.cuda.empty_cache()
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this check runs only on a GPU")
    import yolo_v3_tpu_torch
    from yolo_v3_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.load("fused_res_block")
    log(f"build: fused_res_block {time.perf_counter() - t0:.2f} s (set-up) | {card}")

    summary = check_kernel(card)

    work = os.path.join(os.path.dirname(os.path.abspath(yolo_v3_tpu_torch.__file__)),
                        "build", "smoke")
    os.makedirs(work, exist_ok=True)
    try:
        launches = main_path(card, os.path.join(work, "yolov3_seed0.weights"))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [dict(name=f"fused_res_block_{NAMES[dt]}", route="cuda",
                    source="yolo_v3_tpu_torch/csrc/fused_res_block.cu",
                    replaces="yolo_v3_tpu/ops/pallas_kernels.py:97",
                    launches=launches[dt], **summary[dt])
               for dt in (torch.float32, torch.bfloat16)]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
