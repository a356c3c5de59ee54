"""Drive the PyTorch port's serving, training, eval, CLI and data-parallel
paths once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --yolov4      # phase 11 alone
    python3 chip_smoke.py --conv-down   # phase 3b alone

Phases, each of which raises on failure (exit code != 0, no result line):

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile every kernel of the paths from ``yolo_v3_tpu_torch/csrc``
   (the batched letterbox, ``letterbox.cu``, too), one nvcc per source, all
   started together; print each kernel's ptxas report (registers, spills)
   and, for the four ``wgmma`` sources, fail on
   a ``C75xx`` warning (``fused_res_block``: other than C7519, the
   ``warpgroup.arrive`` ptxas inserts before its register-A ``wgmma``), on
   SASS where a ``WARPGROUP.DEPBAR.LE gsb0, 0x0`` follows every ``HGMMA``
   (bf16, tf32) or ``IGMMA`` (int8), each ``wgmma`` waiting for the one
   before, and on any kernel of the four with no GMMA at all (the fp32
   residual block's included: 3xTF32 on ``wgmma``);
3. kernel vs plain, with the device time of both (CUDA-graph replay), the
   card's bound for the same work and, where one PyTorch call computes the
   same function, that call's time: the fused residual-block kernel at the 5
   residual-block shapes of YOLOv3-416 at batch 8 in fp32 and bf16 (beside
   cuDNN convs in the working dtype, TF32 off; with the launch plan: tile
   geometry, tiles an image, cluster, splits); the bf16 padded-2D kernels
   (conv1x1_p2d, conv3x3_p2d) at every head and up shape of the bf16
   forward (with the tile shape the planner picks, and the host time of
   one launch), and their composition res_block_p2d at 26^2, within rtol =
   atol = 2e-2 (beside the cuDNN bf16 chain, channels-last conv + bias +
   leaky);
   the int8 kernels (conv1x1_p2d, conv3x3_p2d, their composition
   res_block_p2d, fused_entry) bit-equal at every shape the int8 forward
   launches them at batch 8 (the p2d convs with the tile shape the planner
   picks and the host time of one launch; the 1x1s beside cuBLASLt's int8
   product alone, ``torch._int_mm``, which has no epilogue);
3b. the bf16 stem and stride-2 conv kernel (``conv_down.cu``, also alone,
   ``--conv-down``) at every such conv of YOLOv3-416 (leaky) and YOLOv4-608
   (Mish; PANet's two leaky) at batch 8: one rounding against an fp32 conv
   with TF32 off (the card tests' limits), the tile plan, and the device time
   of the kernel, its plain version (the chunked TF32 convs) and one cuDNN bf16
   conv with bias and activation (library), beside the bound, summed per
   forward; alone, one bf16 ``detect`` of each model then counts 6 and 8
   launches (in the whole run phases 4 and 11 count them, and phases 6-10
   count the 6 in every bf16 YOLOv3 run, the stripes' too);
4. main paths: full-width YOLOv3-416 (80 classes, blocks (1,2,8,8,4)) from
   ``torch.Generator`` seed 0, written as darknet ``.weights`` and loaded
   through ``Detector.from_darknet_weights``; ``detect`` on 8 seeded uint8
   images of assorted sizes in bf16, fp32 and int8 (calibrated on the same
   8 images), each path's launch counts set to 0 just before its run and
   read just after (the batched letterbox, ``csrc/letterbox.cu``, once a
   detect; bf16's stem and 5 downs on ``csrc/conv_down.cu``, fp32's on
   cuDNN), and its outputs checked against the plain path, which shares
   the preprocess; so the letterbox kernel is held on its own against its
   plain version (``letterbox_batch_ref``) on the same card operands, at
   these 8 images and at 32 of COCO val's six sizes (the benchmark's), both
   geometries, within 2e-6;
5. timing: e2e ``detect`` images/sec at batch 8, forward ms and the
   preprocess / forward / postprocess split, per precision; the letterbox
   kernel at the 32 images at 416 (CUDA-graph replay) beside its plain
   version and its bound (bytes);
6. serving options, on the same seed-0 model: (a) the int8 uint8 feed,
   ``detect_fn`` on a seeded uint8 batch already 416 x 416 (the card's host
   has no OpenCV for the host letterbox) with phase 4's calibrated tree,
   ``fused_entry`` on the uint8 operands (-128 pad, ``stem4_u8``'s
   multipliers) bit-equal to its plain version and timed beside the float
   feed's; (b) the int8 tree without space-to-depth, calibrated on phase
   4's batch, whose stage-0 residual block runs on the p2d kernels at
   208^2, C 64 -> 32 -> 64 (timed beside its bound); (c) the bf16
   ``Detector(letterbox=False)`` in display and eval mode; (d) the global
   top-k display and the eval-mode postprocess on (c)'s heads, on the card
   and on the CPU.  Each run's launch counts set to 0 just before it and
   read just after, heads held against the plain path (int8 bit-equal, bf16
   within 5e-2 * max|head|), rows too where the heads are bit-equal (int8;
   bf16's rows are printed beside the plain path's as information), and
   (d)'s rows on the card against the CPU's;
7. training, on the same seed-0 model loaded from its ``.weights`` into the
   training form, 16 seeded uint8 416 x 416 scenes in memory (1-8 boxes
   each), ``DataHelper`` at batch 8 x 2 subdivisions: ``train()`` for 5
   net-batches in fp32 and in bf16 (finite loss that falls on the repeated
   net-batch, every param and BN-state leaf moved, a final checkpoint), the
   step alone timed (ms per net-batch, train imgs/sec, peak memory) and, in
   bf16, its top 5 device ops (torch.profiler); forward + loss on 2 images
   on the card against the CPU (fp32, rtol 1e-4, nGT / nCorrect equal);
   resume == one go (2 net-batches against 1 + checkpoint + resume + 1,
   params and BN state bit-equal) in a child process with deterministic
   algorithms; 2 multi-scale net-batches at the sampler's dims (320-608);
   the final checkpoint served by ``Detector.from_checkpoint`` in fp32 and
   bf16 (phase 4's launch counts, fp32 rows and heads against the plain
   path); the bf16 stem and 5 downs against an fp32 single-rounding
   reference with TF32 off (under 0.1% of outputs differ), timed beside the
   double-rounding bf16 conv + leaky they replace;
8. eval and the data engine, on the 24 committed scenes of
   ``tests/data/torch_scenes`` (list file written at run time), decoded
   with OpenCV: the card's host has no libjpeg, so the native decode and
   augment pool (``csrc/yolodata.cc``) is not on this route.  (a) g++,
   libjpeg and the attempted build of ``csrc/yolodata.cc``, printed;
   (b) ``evaluate_detector`` at 416, batch 8, eval mode, letterboxed, on
   the same seed-0 model in int8 on the uint8 feed (phase 4's tree;
   results.json identical to ``generate_results_file(plain=True)``'s, mAP
   equal), fp32 (rows equal, mAP within 1e-3) and bf16 (on the scenes in 4
   orientations, 96 images: heads bit-equal over repeated forwards and
   within 5e-2 * max|head| of the plain path's, the eval postprocess on
   them equal on the card and the CPU, row shares and mAP printed), launch
   counts per batch, and ground truth fed back as detections scoring 1.0;
   (c) the eval's imgs/sec and host ms per batch (load, detect, readback,
   rows to JSON) over 42 batches (the scenes repeated), and the device's
   busy time per batch over a profiled pass of 6; (d) ``DataHelper`` over
   a ``ListDataset`` with ``training_transform`` (uint8 feed) on the
   seeded multi-scale schedule: two runs bit-identical, labels bit-equal
   to the committed ``expected_labels.npz`` (made by the JAX package's
   Python path), samples/sec over 51 batches with 1 and 2 worker
   processes, and ``train()`` (bf16) for 11 net-batches of 8 x 2 from it,
   ms per net-batch over the last 10;
9. the CLI, data parallelism and profiling.  (a) CLI children (this script
   with ``--cli ARGS`` runs the CLI's ``main(ARGS)`` with the kernels'
   launch counts zeroed just before and printed just after): ``weights
   inspect`` and ``convert`` (through ``python -m yolo_v3_tpu_torch.cli``;
   the float count and the npz equal to the ``.weights``), ``quantize`` on
   phase 4's 8 images (the artifact equal to phase 4's tree), ``detect`` in
   int8 and bf16 on a committed scene (the printed rows equal to
   ``Detector.detect``'s formatted in this process, phase 4's launch
   counts, the saved PNG decodes) and ``eval --precision int8 --letterbox``
   on the 24 scenes (mAP equal to phase 8's, results.json identical to
   ``evaluate_detector``'s here on the same artifact), with each child's
   seconds; (b) ``train --bf16 --feed-u8 --multi-scale`` for 2 net-batches
   of 8 x 2 on the scenes, then ``--resume`` for 1, against 3 in one go
   (children with deterministic algorithms): params and BN state bit-equal;
   (c) ``train(mesh=...)`` (this script with ``--dp-worker``) on phase 7's
   seed model and in-memory scenes, YOLOv3-416 fp32, a global net-batch of
   8 x 2 for 1 net-batch + checkpoint + resume + 1: 2 gloo ranks sharing the
   card (CUDA tensors) against one process on the global batch (the ranks
   bit-equal after each net-batch; the first net-batch's loss and stats
   within rtol 1e-4 and its params within atol 2e-4, the second's loss
   within rtol 1e-4 and its params as close to a float64 evaluation as one
   process's, twice at most), a 1-rank NCCL group bit-equal to no mesh, a
   (2, 1) checkpoint refused under a 1-rank mesh, ms per net-batch
   (information); (d) ``StepTimer`` (CUDA events) around 5 detects after 2
   in int8 and bf16 beside phase 5's e2e, and ``trace()`` around one int8
   detect, bare and then behind 64 spinning kernels and a synchronize:
   the second trace holds every kernel of the detect
   (``letterbox_kernel``, ``fused_entry``, the 67 ``conv_p2d``); the kernel
   events each window recorded, and its launches without one, are printed.
10. the mesh, 2 gloo ranks sharing the card (this script with
   ``--space-worker``): ``Detector(mesh=(2, 1))`` on phase 4's 8 images in
   bf16, fp32 and int8, ``Detector(mesh=(1, 2))`` on stripes of 224 / 192
   rows in bf16, fp32 and int8 on the float and the uint8 feed (phase 9's
   artifact), and one fp32 ``train(mesh=(1, 2))`` net-batch, against one
   process: every kernel launch kept at its mesh shape and held to its
   plain version (int8 bit-equal), launches a rank as one process's, int8
   heads and rows bit-equal, float heads within phase 5's bounds; detect ms
   a rank and each kernel's per-forward ms, bound and plain ms;
11. YOLOv4-608 in bf16 (also alone, ``--yolov4``): the Mish residual-block
   kernel at the five CSP shapes (Cmid = C from stage 1 on) and the bf16
   padded-2D kernels at every shape of the forward (Mish, leaky, linear), at
   batch 8, within the bf16 tolerances of their plain versions on the same
   card operands, timed beside the same launches with leaky, the plain
   versions and the bound; ``Detector(arch="yolov4")`` with the benchmark
   cell's seeded weights, ``detect`` on 32 seeded images of COCO val's six
   sizes at 608, launch counts set to 0 just before (23 Mish blocks, 38 1x1
   and 13 3x3 padded-2D convs, 8 stem / stride-2 convs, one letterbox),
   heads within 5e-2 *
   max|head| of the plain path, e2e and forward times.

TF32 is turned off only around this script's own plain references and
cuDNN yardsticks; the Detector paths run under PyTorch's default flags, so
the fp32 forward's own switch is what the fp32 gates see.  The line before
the last is the kernel summary as JSON; the last line is
``{"ok": true, "device": {...}}``.  Needs CUDA; imports no JAX.
"""

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

DARKNET53_BLOCKS = (1, 2, 8, 8, 4)
# (H, C) of the residual blocks of YOLOv3-416, stage by stage
RES_SHAPES_416 = ((208, 64), (104, 128), (52, 256), (26, 512), (13, 1024))
BATCH = 8
IMAGE_HW = ((480, 640), (375, 500), (416, 416), (300, 700))
# (w, h) of COCO val's six common sizes: the benchmark's scenes
COCO_WH = ((640, 480), (480, 640), (640, 427), (500, 375), (640, 360), (427, 640))
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),      # summation order
       torch.bfloat16: dict(rtol=1.6e-2, atol=1.6e-2)}  # 2 bf16 ulps
NAMES = {torch.float32: "f32", torch.bfloat16: "bf16"}
SOURCES = ("fused_res_block", "conv_p2d", "fused_entry", "letterbox", "conv_down")
# the sources whose kernels run wgmma, and the ptxas warnings each may carry
# (C7519: a warpgroup.arrive inserted before a wgmma whose A is in
# registers, which fused_res_block's bf16 conv2 and both fp32 convs have;
# not a serialization)
WGMMA_SOURCES = {"conv_p2d": (), "fused_res_block": ("C7519",), "fused_entry": (),
                 "conv_down": ()}
# a kernel's name, its input type (conv_p2d_kernel's template argument) and
# its integer and bool template arguments, in a mangled name
KERNEL_NAME = re.compile(r"\d((?:conv_p2d|conv_down|res_block)_(?:\w+?_)?kernel|"
                         r"fused_entry(?:_kernel)?)"
                         r"I?(?:N\w*?\d(Bf16In|I8In)E)?((?:L[ib]\d+E)*)")
IN_TYPES = {"Bf16In": "bf16", "I8In": "i8"}
# Every padded-2D conv the int8 forward launches at 416: (taps, grid H = W,
# C, N, residual, out) -> launches per forward.  Residual-block convs first
# (conv1 C -> C/2, conv2 C/2 -> C + residual), then heads, dets and ups.
INT8_CONVS = {
    (1, 104, 128, 64, False, "i8"): 2, (1, 52, 256, 128, False, "i8"): 8 + 2,
    (1, 26, 512, 256, False, "i8"): 8 + 2, (1, 13, 1024, 512, False, "i8"): 4 + 3,
    (9, 104, 64, 128, True, "i8"): 2, (9, 52, 128, 256, True, "i8"): 8,
    (9, 26, 256, 512, True, "i8"): 8, (9, 13, 512, 1024, True, "i8"): 4,
    (9, 13, 512, 1024, False, "i8"): 3, (9, 26, 256, 512, False, "i8"): 3,
    (9, 52, 128, 256, False, "i8"): 3,
    (1, 26, 768, 256, False, "i8"): 1, (1, 52, 384, 128, False, "i8"): 1,
    (1, 13, 1024, 255, False, "bf16"): 1, (1, 26, 512, 255, False, "bf16"): 1,
    (1, 52, 256, 255, False, "bf16"): 1,
    (1, 13, 512, 256, False, "i8"): 1, (1, 26, 256, 128, False, "i8"): 1,
}
# Every padded-2D conv the bf16 forward launches at 416 (its heads and up
# convs): (taps, grid H = W, C, N, leaky) -> launches per forward.
BF16_CONVS = {
    (1, 13, 1024, 512, True): 3, (9, 13, 512, 1024, True): 3,
    (1, 13, 1024, 255, False): 1, (1, 13, 512, 256, True): 1,
    (1, 26, 768, 256, True): 1, (1, 26, 512, 256, True): 2,
    (9, 26, 256, 512, True): 3, (1, 26, 512, 255, False): 1,
    (1, 26, 256, 128, True): 1,
    (1, 52, 384, 128, True): 1, (1, 52, 256, 128, True): 2,
    (9, 52, 128, 256, True): 3, (1, 52, 256, 255, False): 1,
}
BF16_LAUNCHES = {"fused_res_block": 23, "conv1x1_p2d": 14, "conv3x3_p2d": 9, "conv_down": 6}
P2D_BF16_TOL = dict(rtol=2e-2, atol=2e-2)     # the JAX suite's bf16 tolerance
# residual blocks of the int8 forward: (grid, C) -> blocks (stage 0 is in
# the entry)
INT8_RES = {(104, 128): 2, (52, 256): 8, (26, 512): 8, (13, 1024): 4}
INT8_LAUNCHES = {"fused_entry": 1, "conv1x1_p2d": 36, "conv3x3_p2d": 31,
                 "res_block_p2d": 22}
# a tree without space-to-depth: no entry kernel; stage 0's block on the p2d
# kernels adds one launch of each
INT8_LAUNCHES_NO_S2D = {"fused_entry": 0, "conv1x1_p2d": 37, "conv3x3_p2d": 32,
                        "res_block_p2d": 23}
# YOLOv4-608's bf16 forward (models/yolov4.py): its CSP blocks (grid H = W,
# C, Cmid) -> blocks, stage by stage, and its padded-2D convs (taps, grid
# H = W, C, N, activation) -> launches per forward; the split pair is one
# launch, C -> 2 x the part
V4_DIM, V4_BATCH = 608, 32
V4_BLOCKS = {(304, 64, 32): 1, (152, 64, 64): 2, (76, 128, 128): 8, (38, 256, 256): 8,
             (19, 512, 512): 4}
V4_CONVS = {
    # the CSP split pairs, transitions and fuses
    (1, 304, 64, 128, "mish"): 1, (1, 304, 64, 64, "mish"): 1, (1, 304, 128, 64, "mish"): 1,
    (1, 152, 128, 128, "mish"): 2, (1, 152, 64, 64, "mish"): 1,
    (1, 76, 256, 256, "mish"): 2, (1, 76, 128, 128, "mish"): 1,
    (1, 38, 512, 512, "mish"): 2, (1, 38, 256, 256, "mish"): 1,
    (1, 19, 1024, 1024, "mish"): 2, (1, 19, 512, 512, "mish"): 1,
    # the neck and the heads' 3x3s
    (1, 19, 1024, 512, "leaky"): 6, (1, 19, 2048, 512, "leaky"): 1,
    (1, 19, 512, 256, "leaky"): 1, (1, 38, 512, 256, "leaky"): 7,
    (1, 38, 256, 128, "leaky"): 1, (1, 76, 256, 128, "leaky"): 4,
    (9, 19, 512, 1024, "leaky"): 5, (9, 38, 256, 512, "leaky"): 5,
    (9, 76, 128, 256, "leaky"): 3,
    # the detection convs
    (1, 19, 1024, 255, "linear"): 1, (1, 38, 512, 255, "linear"): 1,
    (1, 76, 256, 255, "linear"): 1,
}
V4_LAUNCHES = {"fused_res_block": 23, "conv1x1_p2d": 38, "conv3x3_p2d": 13, "conv_down": 8}
# The bf16 stem and stride-2 convs of both forwards: (model, name, C, N,
# input H = W, stride, activation); one launch each a forward
CONV_DOWN_SHAPES = (
    ("yolov3-416", "stem", 3, 32, 416, 1, "leaky"),
    ("yolov3-416", "down0", 32, 64, 416, 2, "leaky"),
    ("yolov3-416", "down1", 64, 128, 208, 2, "leaky"),
    ("yolov3-416", "down2", 128, 256, 104, 2, "leaky"),
    ("yolov3-416", "down3", 256, 512, 52, 2, "leaky"),
    ("yolov3-416", "down4", 512, 1024, 26, 2, "leaky"),
    ("yolov4-608", "stem", 3, 32, 608, 1, "mish"),
    ("yolov4-608", "down0", 32, 64, 608, 2, "mish"),
    ("yolov4-608", "down1", 64, 128, 304, 2, "mish"),
    ("yolov4-608", "down2", 128, 256, 152, 2, "mish"),
    ("yolov4-608", "down3", 256, 512, 76, 2, "mish"),
    ("yolov4-608", "down4", 512, 1024, 38, 2, "mish"),
    ("yolov4-608", "pan-down0", 128, 256, 76, 2, "leaky"),
    ("yolov4-608", "pan-down1", 256, 512, 38, 2, "leaky"),
)
CONV_DOWN_LAUNCHES = {"yolov3-416": BF16_LAUNCHES["conv_down"],
                      "yolov4-608": V4_LAUNCHES["conv_down"]}
# The card's published peaks (H100 SXM, dense, at 700 W): the bound of a
# kernel is the larger of its operations over the peak of their type and
# its bytes (each input read once, each output written once) over HBM's rate.
# fp32 products count as 3 TF32 products (the kernel's 3xTF32).
PEAK_OPS = {"bf16": 989e12, "f32": 495e12 / 3, "int8": 1979e12}
HBM_BYTES_PER_S = 3.35e12


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


def short_name(mangled):
    """conv_p2d_kernel<i8,9,2,128,1> from a mangled kernel name."""
    m = KERNEL_NAME.search(mangled)
    if m is None:
        return mangled[:60]
    args = ([IN_TYPES[m.group(2)]] if m.group(2) else []) + re.findall(r"L[ib](\d+)E",
                                                                        m.group(3))
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def check_build(card, libs, sources=SOURCES):
    """Phase 2's report: every kernel's registers and spills from ptxas;
    for the wgmma sources, no unexpected C75xx warning and no serialized
    wgmma in the SASS (cuobjdump): per kernel, fewer waits for all wgmma
    groups than GMMAs (HGMMA bf16 and tf32, IGMMA int8); every kernel has
    GMMAs."""
    from torch.utils.cpp_extension import CUDA_HOME
    from yolo_v3_tpu_torch.ops import _build

    cuobjdump = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    for name, lib in zip(sources, libs):
        report, kernel, spills = _build.build_log(name), None, ""
        for line in report.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                kernel = short_name(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills = f"spills {m.group(1)}/{m.group(2)} B"
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                log(f"ptxas {name}: {kernel} {m.group(1)} registers, {spills}")
                kernel = None
        if name not in WGMMA_SOURCES:
            continue
        warns = sorted(set(re.findall(r"\((C75\d\d)\)", report)))
        log(f"ptxas {name}: C75xx warnings {warns or 'none'} | {card}")
        bad = [w for w in warns if w not in WGMMA_SOURCES[name]]
        check(not bad, f"{name}: ptxas warns {bad} (wgmma serialized or misplaced)")
        sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                              check=True, timeout=300).stdout
        counts, kernel = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                kernel = short_name(m.group(1))
                counts[kernel] = [0, 0, 0]
            elif kernel and "HGMMA" in line:
                counts[kernel][0] += 1
            elif kernel and "IGMMA" in line:
                counts[kernel][1] += 1
            elif kernel and "WARPGROUP.DEPBAR.LE gsb0, 0x0" in line:
                counts[kernel][2] += 1
        for kernel, (hgmma, igmma, waits) in counts.items():
            check(hgmma + igmma > 0, f"{kernel}: no GMMA in the SASS")
            if hgmma + igmma:
                log(f"sass {name}: {kernel} HGMMA {hgmma}, IGMMA {igmma}, "
                    f"WARPGROUP.DEPBAR.LE gsb0 0x0 {waits}")
                check(waits < hgmma + igmma,
                      f"{kernel}: every GMMA waits for the one before")
        check(any(h + i for h, i, _ in counts.values()), f"{name}: no GMMA in the SASS")


def host_us(fn, iters=200):
    """Host time of one call of ``fn`` (enqueue only: the device runs
    behind), in microseconds."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


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


def device_ms(fn, iters=10, warmup=3):
    """Device time of one call of ``fn``: ``iters`` calls captured in a CUDA
    graph and replayed between two events, so the host's launch time, which
    exceeds a short kernel's, does not enter (events around back-to-back
    eager calls would read it)."""
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


def busy_ms(fn, iters=5):
    """Summed device time of the kernels and copies one call of ``fn``
    launches (torch.profiler), or None where the profiler returned no
    device events (it does so now and then on short windows)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / iters / 1000 if us > 0 else None


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.3f} ms"


def bound(ops, nbytes, kind):
    """(ms, "operations" or "bytes"): the least time the card could take."""
    t_ops, t_bytes = ops / PEAK_OPS[kind] * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def add_bound(acc, n, ops, nbytes, kind):
    """Add ``n`` launches of one shape's bound to a per-forward summary."""
    ms, by = bound(ops, nbytes, kind)
    acc["bound_ms"] = acc.get("bound_ms", 0.0) + n * ms
    shares = acc.setdefault("_bound_shares", {"operations": 0.0, "bytes": 0.0})
    shares[by] += n * ms
    return ms, by


def finish_bound(acc):
    shares = acc.pop("_bound_shares")
    acc["bound_by"] = max(shares, key=shares.get)
    return acc


def cudnn_block(y, w1, b1, w2, b2):
    """The residual block as one cuDNN chain in ``y``'s dtype, channels-last
    (TF32 off): the yardstick for bf16, which the port never calls."""
    x = y.permute(0, 3, 1, 2)                                 # NHWC memory
    k1 = w1.t()[:, :, None, None].contiguous(memory_format=torch.channels_last)
    k2 = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def run():
        mid = F.leaky_relu(F.conv2d(x, k1, b1), 0.1)
        return x + F.leaky_relu(F.conv2d(mid, k2, b2, padding=1), 0.1)

    return run


def block_inputs(h, c, dtype, seed, cmid=None):
    gen = torch.Generator().manual_seed(seed)
    cmid = cmid or c // 2

    def t(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)

    return (t(BATCH, h, h, c, scale=0.5), t(c, cmid, scale=c ** -0.5),
            t(cmid, scale=0.1), t(3, 3, cmid, c, scale=(9 * cmid) ** -0.5),
            t(c, scale=0.1))


def check_kernel(card):
    """Phase 3: kernel vs plain at every residual-block shape; returns
    per-dtype {max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by},
    device ms summed over one forward's 23 blocks."""
    from yolo_v3_tpu_torch.ops.fused_res_block import (
        fused_res_block, fused_res_block_ref, plan)
    from yolo_v3_tpu_torch.utils.precision import full_fp32

    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        acc = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0)
        size = torch.tensor([], dtype=dtype).element_size()
        for (h, c), n in zip(RES_SHAPES_416, DARKNET53_BLOCKS):
            args = block_inputs(h, c, dtype, seed=h)
            got = fused_res_block(*args)
            torch.cuda.synchronize()
            want = fused_res_block_ref(*args)
            torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
            e = (got.float() - want.float()).abs().max().item()
            k_ms = device_ms(lambda: fused_res_block(*args))
            p_ms = device_ms(lambda: fused_res_block_ref(*args))   # TF32 off inside
            # fp32: the plain version is the cuDNN fp32 chain itself
            with full_fp32():
                l_ms = p_ms if dtype == torch.float32 else device_ms(cudnn_block(*args))
            cmid = c // 2
            macs = BATCH * h * h * (c * cmid + 9 * cmid * c)
            nbytes = size * (2 * BATCH * h * h * c + 10 * c * cmid + cmid + c)
            b_ms, by = add_bound(acc, n, 2 * macs, nbytes, NAMES[dtype])
            p = plan(BATCH, h, h, c, cmid, dtype)
            split = (f" cluster={p['cluster']} geometry={p['geometry']} tiles={p['tiles']}/image "
                     f"splits={p['splits']} channels/warpgroup={p['variant']} "
                     f"smem={p['smem']} B")
            log(f"kernel {NAMES[dtype]} [{BATCH},{h},{h},{c}] max_abs_err={e:.3e} "
                f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
                f"bound_ms={b_ms:.4f} ({by}){split} x{n} blocks tol={TOL[dtype]} | {card}")
            acc["max_abs_err"] = max(acc["max_abs_err"], e)
            acc["ms"] += n * k_ms
            acc["plain_ms"] += n * p_ms
            acc["library_ms"] += n * l_ms
        summary[dtype] = finish_bound(acc)
        log(f"kernel {NAMES[dtype]} per-forward residual blocks: kernel_ms={acc['ms']:.4f} "
            f"plain_ms={acc['plain_ms']:.4f} library_ms={acc['library_ms']:.4f} "
            f"bound_ms={acc['bound_ms']:.4f} ({acc['bound_by']}) | {card}")
    return summary


def i8(gen, shape, lo=-20, hi=20):
    return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int8).to("cuda")


def scale_bias(gen, n, k):
    """Multipliers that put leaky(acc*m+b) mostly inside +-127 for K=k."""
    m = (0.5 + torch.rand(n, generator=gen)) * 40.0 / (k ** 0.5 * 133.0)
    return m.to("cuda"), (3.0 * torch.randn(n, generator=gen)).to("cuda")


def plan_line(rows, c, n, taps, dtype, sms):
    """The tile shape the C launcher picks for a p2d conv, checked against
    ``plan_tiles``: ("BMxBNxSLOTS", shared bytes of a block)."""
    from yolo_v3_tpu_torch.ops import fused_conv as FC

    variant = FC.plan_on_device(rows, c, n, taps, dtype)
    check(variant == FC.plan_tiles(rows, c, n, taps, dtype, sms),
          f"the C planner ({variant}) and plan_tiles differ at {(taps, rows, c, n, dtype)}")
    wgs, bn, _ = FC.P2D_TILES[variant]
    return f"{64 * wgs}x{bn}x{FC.ring_slots(variant, taps)}", FC.smem_bytes(variant, taps)


def check_int8_kernels(card):
    """Phase 3, int8: each kernel bit-equal to its plain version at every
    shape the int8 forward launches it at batch 8; returns per-kernel
    {max_abs_err, ms, plain_ms}, device ms summed over one forward's
    launches."""
    from yolo_v3_tpu_torch.ops import entry_kernel as EK
    from yolo_v3_tpu_torch.ops import fused_conv as FC

    gen = torch.Generator().manual_seed(1)
    summary = {}

    def record(name, what, got, want, run, run_plain, n, ops, nbytes):
        check(got.dtype == want.dtype and torch.equal(got, want),
              f"{name} {what}: kernel and plain differ")
        err = (got.float() - want.float()).abs().max().item()
        k_ms, p_ms = device_ms(run), device_ms(run_plain)
        acc = summary.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                            library_ms=None))
        b_ms, by = add_bound(acc, n, ops, nbytes, "int8")
        log(f"kernel {name} {what} max_abs_err={err:.1e} (bit-equal) kernel_ms={k_ms:.4f} "
            f"plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({by}) x{n} | {card}")
        acc["max_abs_err"] = max(acc["max_abs_err"], err)
        acc["ms"] += n * k_ms
        acc["plain_ms"] += n * p_ms
        return k_ms

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    host, product = [], dict(ms=0.0, int_mm_ms=0.0, launches=0)
    for (taps, hw, c, n, residual, out), count in INT8_CONVS.items():
        x2d = FC.pack_p2d(i8(gen, (BATCH, hw, hw, c)))
        w = i8(gen, (3, 3, c, n) if taps == 9 else (c, n))
        m, b = scale_bias(gen, n, taps * c)
        res = i8(gen, (x2d.shape[0], n), -127, 128) if residual else None
        rows, hp, wp = FC.p2d_geometry(BATCH, hw, hw)
        fn, ref = ((FC.conv3x3_p2d, FC.conv3x3_p2d_ref) if taps == 9
                   else (FC.conv1x1_p2d, FC.conv1x1_p2d_ref))
        kw = dict(leaky=out == "i8", residual=res, res_scale=0.7,
                  out_dtype=torch.int8 if out == "i8" else torch.bfloat16)
        got = fn(x2d, w, m, b, hp, wp, **kw)
        torch.cuda.synchronize()
        tiles, shared = plan_line(rows, c, n, taps, torch.int8, sms)
        # host time of the wrapper, and of its C launcher alone (ctypes call)
        dst, wt = torch.empty_like(got), FC.k_major(w, w.reshape(taps * c, n))
        entry = getattr(FC._lib(), f"yolo_{fn.__name__}_i8")
        host.append((host_us(lambda: fn(x2d, w, m, b, hp, wp, **kw)),
                     host_us(lambda: entry(x2d.data_ptr(), wt.data_ptr(), m.data_ptr(),
                                           b.data_ptr(), 0 if res is None else res.data_ptr(),
                                           0.7, dst.data_ptr(), int(out != "i8"), rows, c,
                                           n, hp, wp, int(out == "i8"), stream))))
        what = (f"[{BATCH},{hw},{hw},{c}]->{n} {out}{' +res' if residual else ''} tiles "
                f"{tiles} slots ({shared} B shared) host_us={host[-1][0]:.1f} (C launcher "
                f"{host[-1][1]:.1f})")
        mm_ms = None
        if taps == 1:
            # the yardstick of the 1x1: cuBLASLt's int8 product of the same
            # operands, without the epilogue (where cuBLASLt takes N)
            try:
                torch._int_mm(x2d, w)
                mm_ms = device_ms(lambda: torch._int_mm(x2d, w))
            except RuntimeError:
                pass
            what += f" cuBLASLt int8 product only (no epilogue) {fmt_ms(mm_ms)}"
        nbytes = (rows * c + w.numel() + 8 * n + rows * n * got.element_size()
                  + (rows * n if residual else 0))
        k_ms = record(f"{fn.__name__}_int8", what, got, ref(x2d, w, m, b, hp, wp, **kw),
                      lambda: fn(x2d, w, m, b, hp, wp, **kw),
                      lambda: ref(x2d, w, m, b, hp, wp, **kw), count,
                      2 * BATCH * hw * hw * taps * c * n, nbytes)
        if mm_ms is not None:
            product["ms"] += count * k_ms
            product["int_mm_ms"] += count * mm_ms
            product["launches"] += count

    wrapper, launcher = np.array(host).T
    log(f"kernel int8 p2d host time per launch (enqueue only), mean over the {len(host)} "
        f"shapes: wrapper {wrapper.mean():.1f} us (min {wrapper.min():.1f}, max "
        f"{wrapper.max():.1f}), of which the C launcher {launcher.mean():.1f} us | {card}")
    log(f"kernel conv1x1_p2d_int8 beside cuBLASLt int8 product only (no epilogue), the "
        f"{product['launches']} 1x1 launches it takes (N % 8 == 0): kernel_ms="
        f"{product['ms']:.4f} int_mm_ms={product['int_mm_ms']:.4f} | {card}")

    for (hw, c), count in INT8_RES.items():
        x2d = FC.pack_p2d(i8(gen, (BATCH, hw, hw, c)))
        w1, w2 = i8(gen, (c, c // 2)), i8(gen, (3, 3, c // 2, c))
        (s1, b1), (s2, b2) = scale_bias(gen, c // 2, c), scale_bias(gen, c, 9 * c // 2)
        _, hp, wp = FC.p2d_geometry(BATCH, hw, hw)
        args = (x2d, w1, s1, b1, w2, s2, b2, hp, wp)
        got = FC.res_block_p2d(*args, res_scale=0.8)
        torch.cuda.synchronize()
        record("res_block_p2d_int8", f"[{BATCH},{hw},{hw},{c}]", got,
               FC.res_block_p2d_ref(*args, res_scale=0.8),
               lambda: FC.res_block_p2d(*args, res_scale=0.8),
               lambda: FC.res_block_p2d_ref(*args, res_scale=0.8), count,
               2 * BATCH * hw * hw * 10 * c * (c // 2),
               2 * x2d.numel() + w1.numel() + w2.numel() + 8 * (c // 2 + c))

    xb = i8(gen, (BATCH, 210, 210, 12), -127, 128)
    qs2d = {}
    for name, (kh, kw_, cin, cout) in EK.SHAPES.items():
        m, b = scale_bias(gen, cout, kh * kw_ * cin)
        qs2d[name] = {"w": i8(gen, (cin, cout) if kh == 1 else (kh, kw_, cin, cout)),
                      "m": m, "b": b}
    got = EK.fused_entry(xb, qs2d, 0.6)
    torch.cuda.synchronize()
    h = got.shape[1]                     # 104: the stem runs at 2h, the rest at h
    geo = EK.plan_on_device(BATCH, h, h)
    mirror = EK.plan_entry(BATCH, h, h, sms)
    check(all(geo[k] == mirror[k] for k in ("strip", "step", "band"))
          and geo["smem"] == EK.SMEM_BYTES,
          f"fused_entry: the C planner {geo} and plan_entry {mirror} differ")
    log(f"kernel fused_entry_int8 geometry at [{BATCH},{h},{h}]: strips of {geo['strip']} "
        f"output columns, bands of {geo['band']} rows, {geo['step']} rows a step "
        f"({mirror['steps']} steps a band), clusters of 1 (no multicast), {mirror['units']} "
        f"work items, {geo['smem']} B shared a block (registers and spills: the ptxas lines "
        f"above) | {card}")
    ops = sum(2 * BATCH * (2 * h if name == "stem" else h) ** 2 * kh * kw_ * cin * cout
              for name, (kh, kw_, cin, cout) in EK.SHAPES.items())
    nbytes = (xb.numel() + got.numel()
              + sum(p["w"].numel() + 8 * p["m"].numel() for p in qs2d.values()))
    record("fused_entry_int8", f"[{BATCH},210,210,12]", got,
           EK.fused_entry_ref(xb, qs2d, 0.6), lambda: EK.fused_entry(xb, qs2d, 0.6),
           lambda: EK.fused_entry_ref(xb, qs2d, 0.6), 1, ops, nbytes)
    for name, acc in summary.items():
        finish_bound(acc)
        log(f"kernel {name} per forward: kernel_ms={acc['ms']:.4f} "
            f"plain_ms={acc['plain_ms']:.4f} bound_ms={acc['bound_ms']:.4f} "
            f"({acc['bound_by']}) library_ms=none (no single PyTorch call) | {card}")
    return summary


def cudnn_conv(x2d, w, bias, b, hw, taps, leaky):
    """One padded-2D bf16 conv as a cuDNN chain on the same input without
    its border (channels-last conv + bias + leaky, bf16): the yardstick,
    which the port never calls."""
    from yolo_v3_tpu_torch.ops import fused_conv as FC

    x = FC.unpack_p2d(x2d, b, hw, hw).contiguous().permute(0, 3, 1, 2)   # NHWC memory
    k = (w.reshape(3, 3, *w.shape[-2:]) if taps == 9 else w[None, None])
    k = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    pad = 1 if taps == 9 else 0

    def run():
        y = F.conv2d(x, k, bias, padding=pad)
        return F.leaky_relu(y, 0.1) if leaky else y

    return run


def check_bf16_p2d_kernels(card):
    """Phase 3, bf16 padded-2D kernels: each within rtol = atol = 2e-2 of
    its plain version at every head and up shape of the bf16 forward at
    batch 8, and res_block_p2d at 26^2 beside the fused residual block;
    returns per-kernel {max_abs_err, ms, plain_ms, library_ms, bound_ms,
    bound_by}: device ms summed over one forward's launches (res_block_p2d,
    which no forward launches: one call at 26^2)."""
    from yolo_v3_tpu_torch.ops import fused_conv as FC
    from yolo_v3_tpu_torch.ops.fused_res_block import fused_res_block
    from yolo_v3_tpu_torch.utils.precision import full_fp32

    gen = torch.Generator().manual_seed(2)
    summary = {}

    def t(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)

    def record(name, what, got, want, runs, n, ops, nbytes):
        torch.testing.assert_close(got.float(), want.float(), **P2D_BF16_TOL)
        err = (got.float() - want.float()).abs().max().item()
        k_ms, p_ms = device_ms(runs[0]), device_ms(runs[1])
        with full_fp32():
            l_ms = device_ms(runs[2])
        acc = summary.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                            library_ms=0.0))
        b_ms, by = add_bound(acc, n, ops, nbytes, "bf16")
        log(f"kernel {name} {what} max_abs_err={err:.3e} kernel_ms={k_ms:.4f} "
            f"plain_ms={p_ms:.4f} library_ms={l_ms:.4f} bound_ms={b_ms:.4f} ({by}) "
            f"x{n} tol={P2D_BF16_TOL} | {card}")
        acc["max_abs_err"] = max(acc["max_abs_err"], err)
        acc["ms"] += n * k_ms
        acc["plain_ms"] += n * p_ms
        acc["library_ms"] += n * l_ms
        return k_ms

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    host = []
    for (taps, hw, c, n, leaky), count in BF16_CONVS.items():
        x2d = FC.pack_p2d(t(BATCH, hw, hw, c, scale=0.5))
        w = t(*((3, 3, c, n) if taps == 9 else (c, n)), scale=(taps * c) ** -0.5)
        ones, b = torch.ones(n, device="cuda"), t(n, scale=0.1, dtype=torch.float32)
        rows, hp, wp = FC.p2d_geometry(BATCH, hw, hw)
        fn, ref = ((FC.conv3x3_p2d, FC.conv3x3_p2d_ref) if taps == 9
                   else (FC.conv1x1_p2d, FC.conv1x1_p2d_ref))
        kw = dict(leaky=leaky, out_dtype=torch.bfloat16)
        got = fn(x2d, w, ones, b, hp, wp, **kw)
        torch.cuda.synchronize()
        tiles, shared = plan_line(rows, c, n, taps, torch.bfloat16, sms)
        # host time of the wrapper, and of its C launcher alone (ctypes call)
        out, wt = torch.empty_like(got), FC.k_major(w, w.reshape(taps * c, n))
        entry = getattr(FC._lib(), f"yolo_{fn.__name__}_bf16")
        stream = torch.cuda.current_stream().cuda_stream
        host.append((host_us(lambda: fn(x2d, w, ones, b, hp, wp, **kw)),
                     host_us(lambda: entry(x2d.data_ptr(), wt.data_ptr(), ones.data_ptr(),
                                           b.data_ptr(), 0, 1.0, out.data_ptr(), 1, rows, c,
                                           n, hp, wp, int(leaky), stream))))
        nbytes = 2 * (rows * c + w.numel() + rows * n) + 8 * n
        record(f"{fn.__name__}_bf16", f"[{BATCH},{hw},{hw},{c}]->{n}"
               f"{'' if leaky else ' no leaky'} tiles {tiles} slots ({shared} B shared) "
               f"host_us={host[-1][0]:.1f} (C launcher {host[-1][1]:.1f})", got,
               ref(x2d, w, ones, b, hp, wp, **kw),
               (lambda: fn(x2d, w, ones, b, hp, wp, **kw),
                lambda: ref(x2d, w, ones, b, hp, wp, **kw),
                cudnn_conv(x2d, w, b.bfloat16(), BATCH, hw, taps, leaky)), count,
               2 * BATCH * hw * hw * taps * c * n, nbytes)

    wrapper, launcher = np.array(host).T
    log(f"kernel bf16 p2d host time per launch (enqueue only), mean over the {len(host)} "
        f"shapes: wrapper {wrapper.mean():.1f} us (min {wrapper.min():.1f}, max "
        f"{wrapper.max():.1f}), of which the C launcher {launcher.mean():.1f} us | {card}")

    hw, c = 26, 512
    y, w1, b1, w2, b2 = block_inputs(hw, c, torch.bfloat16, seed=3)
    _, hp, wp = FC.p2d_geometry(BATCH, hw, hw)
    ones = torch.ones(c, device="cuda")
    args = (FC.pack_p2d(y), w1, ones[:c // 2], b1.float(), w2, ones, b2.float(), hp, wp)
    got = FC.res_block_p2d(*args, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    b4 = fused_res_block(y, w1, b1, w2, b2)
    torch.testing.assert_close(FC.unpack_p2d(got, BATCH, hw, hw).float(), b4.float(),
                               **P2D_BF16_TOL)
    rows = args[0].shape[0]
    k_ms = record("res_block_p2d_bf16", f"[{BATCH},{hw},{hw},{c}] (one call)", got,
                  FC.res_block_p2d_ref(*args, out_dtype=torch.bfloat16),
                  (lambda: FC.res_block_p2d(*args, out_dtype=torch.bfloat16),
                   lambda: FC.res_block_p2d_ref(*args, out_dtype=torch.bfloat16),
                   cudnn_block(y, w1, b1, w2, b2)), 1,
                  2 * BATCH * hw * hw * 10 * c * (c // 2),
                  2 * (2 * rows * c + w1.numel() + w2.numel()) + 8 * (c // 2 + c))
    log(f"kernel res_block_p2d_bf16 [{BATCH},{hw},{hw},{c}] beside fused_res_block: "
        f"{k_ms:.4f} vs {device_ms(lambda: fused_res_block(y, w1, b1, w2, b2)):.4f} ms "
        f"| {card}")
    for name, acc in summary.items():
        finish_bound(acc)
        per = "one call at 26^2" if name.startswith("res_block") else "per forward"
        log(f"kernel {name} {per}: kernel_ms={acc['ms']:.4f} "
            f"plain_ms={acc['plain_ms']:.4f} library_ms={acc['library_ms']:.4f} "
            f"(cuDNN bf16 chain) bound_ms={acc['bound_ms']:.4f} ({acc['bound_by']}) "
            f"| {card}")
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


def make_images(n=BATCH, sizes_hw=IMAGE_HW):
    rng = np.random.default_rng(0)
    imgs = []
    for i in range(n):
        h, w = sizes_hw[i % len(sizes_hw)]
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


def unmatched(a, b, box_atol=1e-2, prob_atol=1e-4):
    """Indices of the rows of ``a`` left without a row of ``b`` of the same
    class, boxes within ``box_atol`` px and probabilities within
    ``prob_atol`` (each row of ``b`` taken once, in ``a``'s order)."""
    used = np.zeros(len(b), bool)
    out = []
    for i, row in enumerate(a):
        ok = ((b[:, 0] == row[0]) & ~used
              & (np.abs(b[:, 1:5] - row[1:5]).max(1) <= box_atol)
              & (np.abs(b[:, 5:] - row[5:]).max(1) <= prob_atol))
        if ok.any():
            used[np.argmax(ok)] = True
        else:
            out.append(i)
    return out


def same_rows(a, b, box_atol=1e-2, prob_atol=1e-4):
    """Every row of ``a`` has one row of ``b`` with the same class, boxes
    within ``box_atol`` px and probabilities within ``prob_atol`` (order may
    differ where two scores tie to fp32 noise)."""
    return a.shape == b.shape and not unmatched(a, b, box_atol, prob_atol)


def main_path(card, weights_path, imgs, e2e):
    """Phases 4 and 5 in bf16 and fp32.  Returns ({dtype: {kernel: launches
    in that dtype's main run}}, the fp32 detection rows); puts each
    precision's e2e ms per batch into ``e2e``."""
    from yolo_v3_tpu_torch.detector import Detector
    from yolo_v3_tpu_torch.models import darknet as D
    from yolo_v3_tpu_torch.models import weights as W
    from yolo_v3_tpu_torch.ops import conv_down as CD
    from yolo_v3_tpu_torch.ops import fused_conv as FC
    from yolo_v3_tpu_torch.ops.fused_res_block import fused_res_block
    from yolo_v3_tpu_torch.ops.letterbox import letterbox_batch
    from yolo_v3_tpu_torch.ops.postprocess import postprocess_from_raws
    from yolo_v3_tpu_torch.utils.config import YoloConfig

    config = YoloConfig()                                # 80 classes, 416
    gen = torch.Generator().manual_seed(0)
    params, state = D.init_yolonet(gen, config.num_classes, blocks=DARKNET53_BLOCKS)
    spread_batchnorm(params, state, gen)
    W.save_darknet_weights(params, state, weights_path)
    n_blocks = sum(DARKNET53_BLOCKS)
    launches = {}
    for precision, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        det = Detector.from_darknet_weights(weights_path, config, device="cuda",
                                            precision=precision)
        check(det.model.num_res_blocks == n_blocks, "23 residual blocks")

        counters = {"fused_res_block": fused_res_block, "conv1x1_p2d": FC.conv1x1_p2d,
                    "conv3x3_p2d": FC.conv3x3_p2d, "res_block_p2d": FC.res_block_p2d,
                    "conv_down": CD.conv_down}
        for fn in counters.values():
            fn.launches = 0
        letterbox_batch.launches = 0
        rows = det.detect(imgs)
        torch.cuda.synchronize()
        launches[dtype] = {k: fn.launches for k, fn in counters.items()}
        # fp32 runs its heads, stem and downs on cuDNN: the padded-2D and
        # stem / down kernels have no fp32 mode
        want = (dict(BF16_LAUNCHES, res_block_p2d=0) if dtype == torch.bfloat16 else
                dict(fused_res_block=n_blocks, conv1x1_p2d=0, conv3x3_p2d=0,
                     res_block_p2d=0, conv_down=0))
        check(launches[dtype] == want,
              f"{precision} launches in one forward {launches[dtype]}, want {want}")
        check(letterbox_batch.launches == 1,
              f"{precision}: {letterbox_batch.launches} letterbox launches in one detect")
        launches[dtype]["letterbox"] = letterbox_batch.launches
        check_rows(rows, imgs, config.num_classes)
        if dtype == torch.float32:
            fp32_rows = rows
        n_det = [len(r) for r in rows]
        log(f"main {precision}: detect(8 images) ok, kernel launches {launches[dtype]} "
            f"({n_blocks} residual blocks), detections per image={n_det} | {card}")

        # raw heads, kernel path vs plain path, on the card
        x, _ = det.preprocess(imgs)
        with torch.inference_mode():
            heads = det.model(x.to(dtype))
            plain = det.model(x.to(dtype), plain=True)
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
            plain_rows = det.detect(imgs, plain=True)
            check(all(same_rows(a, b) for a, b in zip(rows, plain_rows)),
                  "fp32 detections equal on kernel and plain forward paths")
            log("main fp32: detection rows equal on kernel and plain forward paths "
                f"(boxes atol 1e-2 px, probs atol 1e-4; one preprocess) | {card}")

        # phase 5: timing after warm-up
        with torch.inference_mode():
            xd = x.to(dtype)
            fwd_ms = cuda_ms(lambda: det.model(xd))
            fwd_busy = busy_ms(lambda: det.model(xd))
            fwd_plain_ms = cuda_ms(lambda: det.model(xd, plain=True))
            pre_ms = cuda_ms(lambda: det.preprocess(imgs))
            post_ms = cuda_ms(lambda: postprocess_from_raws(
                heads, config, config.img_dim, config.conf_thr, config.nms_thr))
        e2e_ms = e2e[precision] = cuda_ms(lambda: det.detect(imgs), iters=5, warmup=2)
        e2e_plain_ms = cuda_ms(lambda: det.detect(imgs, plain=True),
                               iters=5, warmup=2)
        log(f"time {precision} bs{BATCH} 416: e2e detect {BATCH * 1000 / e2e_ms:.2f} imgs/sec "
            f"({e2e_ms:.3f} ms/batch), forward {fwd_ms:.3f} ms; plain path: "
            f"{BATCH * 1000 / e2e_plain_ms:.2f} imgs/sec ({e2e_plain_ms:.3f} ms/batch), "
            f"forward {fwd_plain_ms:.3f} ms | {card}")
        log(f"time {precision} bs{BATCH} 416 kernel path split: preprocess "
            f"{pre_ms:.3f} ms, forward {fwd_ms:.3f} ms (device busy {fmt_ms(fwd_busy)}), "
            f"postprocess {post_ms:.3f} ms | {card}")
        del det
        torch.cuda.empty_cache()
    return launches, fp32_rows


def letterbox_path(card, imgs, launches):
    """Phases 4 and 5 for the batched letterbox (``csrc/letterbox.cu``),
    which ``detect`` runs on its kernel and plain paths alike: the kernel
    against ``letterbox_batch_ref`` on the same card operands, at phase 4's
    images and at 32 of COCO val's six sizes, both geometries, within 2e-6;
    its device ms at the 32 at 416 (CUDA-graph replay) beside the plain
    version's and its bound (the packed bytes read once, the float32 output
    written once).  ``launches``: the letterbox's launches in each main
    path's detect.  Returns its entry of the ``kernels`` line."""
    from yolo_v3_tpu_torch.ops import letterbox as L

    dim = 416
    rng = np.random.default_rng(7)
    coco = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for w, h in (COCO_WH[i % len(COCO_WH)] for i in range(32))]
    worst = 0.0
    for what, batch in ((f"phase 4's {len(imgs)} images", imgs), ("32 of COCO's sizes", coco)):
        for letterbox in (True, False):
            src, desc, _ = L.stage_batch(batch, dim, letterbox, "cuda")
            before = L.letterbox_batch.launches
            got = L.letterbox_batch(src, desc, dim)
            check(L.letterbox_batch.launches == before + 1, "letterbox: one launch a batch")
            err = (got - L.letterbox_batch_ref(src, desc, dim)).abs().max().item()
            geometry = "letterbox" if letterbox else "plain resize"
            check(err <= 2e-6, f"letterbox kernel, {what}, {geometry}: max abs {err:.3e} "
                  "against its plain version > 2e-6")
            log(f"letterbox kernel vs plain, {what} at {dim}, {geometry}: max_abs_err="
                f"{err:.3e} (<= 2e-6) | {card}")
            worst = max(worst, err)
    src, desc, _ = L.stage_batch(coco, dim, True, "cuda")
    cdesc = desc.cpu()                  # the plain version reads its table on the host
    ms = device_ms(lambda: L.letterbox_batch(src, desc, dim))
    plain_ms = device_ms(lambda: L.letterbox_batch_ref(src, cdesc, dim))
    nbytes = src.numel() + len(coco) * dim * dim * 3 * 4
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"time letterbox kernel, 32 of COCO's sizes at {dim}: ms={ms:.4f} plain_ms="
        f"{plain_ms:.4f} bound_ms={b_ms:.4f} (bytes: {nbytes}); launches a detect "
        f"{launches} | {card}")
    return dict(name="letterbox", route="cuda", source="yolo_v3_tpu_torch/csrc/letterbox.cu",
                replaces=None, launches=launches["bf16"], launches_by_path=launches,
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=b_ms, bound_by="bytes")


def conv_down_path(card):
    """Phase 3b: the bf16 stem and stride-2 conv kernel at every such conv
    of both forwards at batch 8 (:data:`CONV_DOWN_SHAPES`), held to the
    card tests' single-rounding limits against an fp32 conv with TF32 off,
    bias and activation in fp32; the tile plan; and the device time (CUDA-graph
    replay) of the kernel, its plain version (the chunked TF32 convs, bias
    and activation in float32, one cast) and one cuDNN bf16 conv with bias
    and activation (library: its own roundings), beside the bound, summed
    per forward.  Returns {model: {ms, plain_ms, library_ms, bound_ms,
    bound_by, worst_off_share}}."""
    from yolo_v3_tpu_torch.models import darknet as D
    from yolo_v3_tpu_torch.ops import activations as A
    from yolo_v3_tpu_torch.ops import conv_down as CD
    from yolo_v3_tpu_torch.utils.precision import full_fp32

    def ordered(a):
        bits = (a.float().view(torch.int32) >> 16).to(torch.int64) & 0xFFFF
        return torch.where(bits >= 0x8000, -(bits & 0x7FFF), bits)

    acts = {"leaky": lambda y: F.leaky_relu(y, 0.1), "mish": A.mish}
    summary = {}
    for model, name, c, n, hw, stride, act in CONV_DOWN_SHAPES:
        gen = torch.Generator().manual_seed(c + hw)
        w = (torch.randn(3, 3, c, n, generator=gen) / np.sqrt(9 * c)).to(torch.bfloat16)
        b = (torch.randn(n, generator=gen) * 0.3).to(torch.bfloat16)
        conv = D._ConvBias({"w": w, "b": b}, stride=stride, act=act).cuda()
        x = torch.randn(BATCH, c, hw, hw, generator=gen).to("cuda", torch.bfloat16)
        x = x.contiguous(memory_format=torch.channels_last)
        with torch.inference_mode():
            got = conv(x)
            with full_fp32():
                ref = F.conv2d(x.float(), conv.weight.float(), None, stride, 1)
            ref = acts[act](ref + conv.bias.float()[:, None, None]).to(torch.bfloat16)
            step = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp(min=2.0 ** -126)))
                              - 7)
            over = ((got.float() - ref.float()).abs() - step - C1_ABS_FLOOR).max().item()
            share = (ordered(got) != ordered(ref)).float().mean().item()
            del ref, step
            check(over <= 0 and share < C1_MAX_OFF_SHARE,
                  f"conv_down {model} {name}: {share:.4%} of outputs off the single-rounding "
                  f"reference (beyond one step by {over})")
            k_ms = device_ms(lambda: conv(x))
            p_ms = device_ms(lambda: conv(x, plain=True))

            def library():
                y = F.conv2d(x, conv.weight, conv.bias, stride, 1)
                return F.mish(y) if act == "mish" else F.leaky_relu(y, 0.1)

            l_ms = device_ms(library)
        ho = got.shape[2]
        ops = 2 * BATCH * ho * ho * n * 9 * c
        nbytes = 2 * (BATCH * hw * hw * c + 9 * c * n + BATCH * ho * ho * n) + 4 * n
        acc = summary.setdefault(model, dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                                             worst_off_share=0.0))
        b_ms, by = add_bound(acc, 1, ops, nbytes, "bf16")
        acc["ms"] += k_ms
        acc["plain_ms"] += p_ms
        acc["library_ms"] += l_ms
        acc["worst_off_share"] = max(acc["worst_off_share"], share)
        tiles = "stem" if c == 3 else CD.plan_on_device(BATCH, hw, hw, c, n)
        log(f"kernel conv_down {model} {name} [{BATCH},{hw},{hw},{c}]->{n} {act} "
            f"tiles={tiles}: "
            f"off the single-rounding reference {share:.5%} "
            f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms={l_ms:.4f} "
            f"bound_ms={b_ms:.4f} ({by}) roofline {100 * b_ms / k_ms:.1f}% | {card}")
        del conv, x, got
        torch.cuda.empty_cache()
    for model, acc in summary.items():
        finish_bound(acc)
        log(f"kernel conv_down per {model} forward at batch {BATCH}: kernel_ms={acc['ms']:.4f} "
            f"plain_ms={acc['plain_ms']:.4f} library_ms={acc['library_ms']:.4f} "
            f"bound_ms={acc['bound_ms']:.4f} ({acc['bound_by']}), roofline "
            f"{100 * acc['bound_ms'] / acc['ms']:.1f}%, worst off-share "
            f"{acc['worst_off_share']:.5%} | {card}")
    return summary


def conv_down_launches(card):
    """One bf16 ``detect`` of each model on seeded weights launches the
    stem / stride-2 kernel 6 (YOLOv3-416) and 8 (YOLOv4-608) times."""
    from portbench import weights_yolov4
    from yolo_v3_tpu_torch.detector import Detector
    from yolo_v3_tpu_torch.models import darknet as D
    from yolo_v3_tpu_torch.models import yolov4 as Y4
    from yolo_v3_tpu_torch.ops import conv_down as CD
    from yolo_v3_tpu_torch.utils.config import YoloConfig

    gen = torch.Generator().manual_seed(0)
    params, state = D.init_yolonet(gen, 80, blocks=DARKNET53_BLOCKS)
    dets = {"yolov3-416": (Detector(params, state, YoloConfig(), precision="bf16",
                                    device="cuda"), make_images())}
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "portbench",
                           "configs", "yolov4-608-bf16.json")) as f:
        cfg = json.load(f)
    imgs = make_images(V4_BATCH, [(h, w) for w, h in COCO_WH])
    p4, s4 = weights_yolov4.make(cfg, 0, torch.device("cuda"), imgs[:8])
    dets["yolov4-608"] = (Detector(p4, s4, YoloConfig(num_classes=80, img_dim=V4_DIM,
                                                      anchors=Y4.ANCHORS,
                                                      anchor_masks=Y4.ANCHOR_MASKS),
                                   precision="bf16", device="cuda", arch="yolov4"), imgs)
    for model, (det, images) in dets.items():
        _, launches = counted({"conv_down": CD.conv_down}, lambda: det.detect(images))
        check(launches["conv_down"] == CONV_DOWN_LAUNCHES[model],
              f"{model}: {launches['conv_down']} conv_down launches in one detect, want "
              f"{CONV_DOWN_LAUNCHES[model]}")
        log(f"conv_down {model}: one bf16 detect of {len(images)} images launches the kernel "
            f"{launches['conv_down']} times | {card}")
    del dets
    torch.cuda.empty_cache()


def conv_down_main():
    """Phase 3b alone (``--conv-down``): builds and checks its source, and the
    sources a detect runs."""
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this check runs only on a GPU")
    from yolo_v3_tpu_torch.ops import _build

    card = card_line()
    log(card)
    sources = ("conv_down", "fused_res_block", "conv_p2d", "letterbox")
    with ThreadPoolExecutor(len(sources)) as pool:     # one nvcc per source
        libs = list(pool.map(_build.build, sources))
    check_build(card, libs[:1], sources[:1])
    summary = conv_down_path(card)
    conv_down_launches(card)
    print(json.dumps({"conv_down": summary}))
    print(json.dumps({"ok": True, "device": device_entry()}))


def check_yolov4_kernels(card):
    """Phase 11, kernels: the Mish residual block at YOLOv4-608's five CSP
    shapes (Cmid = C from stage 1 on) and the bf16 padded-2D convs at every
    shape of its forward (Mish, leaky, linear), at batch 8, each within the
    bf16 tolerance of its plain version on the same card operands, timed
    (CUDA-graph replay) beside the same launch with leaky where it has Mish,
    the plain version and the bound.  Returns {kernel: {max_abs_err, ms,
    leaky_ms, plain_ms, bound_ms, bound_by, by_act}}, device ms summed over
    one forward's launches."""
    from yolo_v3_tpu_torch.ops import fused_conv as FC
    from yolo_v3_tpu_torch.ops.fused_res_block import (
        fused_res_block, fused_res_block_ref, plan)

    summary = {}

    def record(name, act, what, got, want, tol, runs, n, ops, nbytes):
        torch.testing.assert_close(got.float(), want.float(), **tol)
        err = (got.float() - want.float()).abs().max().item()
        k_ms, l_ms, p_ms = (device_ms(runs[0]), device_ms(runs[1]) if act == "mish" else None,
                            device_ms(runs[2]))
        acc = summary.setdefault(name, dict(max_abs_err=0.0, ms=0.0, leaky_ms=0.0,
                                            plain_ms=0.0, library_ms=None, by_act={}))
        b_ms, by = add_bound(acc, n, ops, nbytes, "bf16")
        log(f"kernel {name} {act} {what} max_abs_err={err:.3e} kernel_ms={k_ms:.4f} "
            f"leaky_ms={fmt_ms(l_ms)} plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({by}) "
            f"x{n} tol={tol} | {card}")
        acc["max_abs_err"] = max(acc["max_abs_err"], err)
        part = acc["by_act"].setdefault(act, dict(launches=0, ms=0.0, leaky_ms=0.0,
                                                  plain_ms=0.0, bound_ms=0.0))
        for d in (acc, part):
            d["ms"] += n * k_ms
            d["leaky_ms"] += n * (k_ms if l_ms is None else l_ms)
            d["plain_ms"] += n * p_ms
        part["launches"] += n
        part["bound_ms"] += n * b_ms

    for (h, c, cmid), n in V4_BLOCKS.items():
        args = block_inputs(h, c, torch.bfloat16, seed=h, cmid=cmid)
        got = fused_res_block(*args, act="mish")
        torch.cuda.synchronize()
        p = plan(BATCH, h, h, c, cmid, torch.bfloat16, act="mish")
        record("fused_res_block_bf16_mish", "mish",
               f"[{BATCH},{h},{h},{c}] Cmid {cmid} cluster={p['cluster']} "
               f"geometry={p['geometry']} splits={p['splits']}", got,
               fused_res_block_ref(*args, act="mish"), TOL[torch.bfloat16],
               (lambda: fused_res_block(*args, act="mish"), lambda: fused_res_block(*args),
                lambda: fused_res_block_ref(*args, act="mish")), n,
               2 * BATCH * h * h * (c * cmid + 9 * cmid * c),
               2 * (2 * BATCH * h * h * c + 10 * c * cmid + cmid + c))

    gen = torch.Generator().manual_seed(4)

    def t(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda", dtype)

    for (taps, hw, c, n, act), count in V4_CONVS.items():
        x2d = FC.pack_p2d(t(BATCH, hw, hw, c, scale=0.5))
        w = t(*((3, 3, c, n) if taps == 9 else (c, n)), scale=(taps * c) ** -0.5)
        ones, b = torch.ones(n, device="cuda"), t(n, scale=0.1, dtype=torch.float32)
        rows, hp, wp = FC.p2d_geometry(BATCH, hw, hw)
        fn, ref = ((FC.conv3x3_p2d, FC.conv3x3_p2d_ref) if taps == 9
                   else (FC.conv1x1_p2d, FC.conv1x1_p2d_ref))

        def run(f, a):
            return lambda: f(x2d, w, ones, b, hp, wp, act=a, out_dtype=torch.bfloat16)

        got = run(fn, act)()
        torch.cuda.synchronize()
        record(f"{fn.__name__}_bf16_yolov4", act, f"[{BATCH},{hw},{hw},{c}]->{n}", got,
               run(ref, act)(), P2D_BF16_TOL, (run(fn, act), run(fn, "leaky"), run(ref, act)),
               count, 2 * BATCH * hw * hw * taps * c * n,
               2 * (rows * c + w.numel() + rows * n) + 8 * n)

    for name, acc in summary.items():
        finish_bound(acc)
        parts = ", ".join(f"{a}: {d['launches']} launches {d['ms']:.4f} ms (leaky "
                          f"{d['leaky_ms']:.4f}) plain {d['plain_ms']:.4f} bound "
                          f"{d['bound_ms']:.4f}" for a, d in acc["by_act"].items())
        log(f"kernel {name} per YOLOv4-608 forward at batch {BATCH}: kernel_ms="
            f"{acc['ms']:.4f} (the same launches with leaky {acc['leaky_ms']:.4f}) plain_ms="
            f"{acc['plain_ms']:.4f} bound_ms={acc['bound_ms']:.4f} ({acc['bound_by']}); "
            f"{parts} | {card}")
    return summary


def yolov4_path(card):
    """Phase 11: YOLOv4-608 in bf16 (``Detector(arch="yolov4")``).  The Mish
    kernels against their plain versions (:func:`check_yolov4_kernels`);
    then the benchmark cell's seeded weights (``portbench/weights_yolov4.py``,
    BN statistics measured on 8 of the images) and ``detect`` on 32 seeded
    images of COCO val's six sizes at 608, the kernels' launch counts set to
    0 just before and read just after (23 Mish blocks, 38 1x1 and 13 3x3
    padded-2D convs, one letterbox), heads held to the plain path within
    5e-2 * max|head|, the rows' count beside the plain path's
    (information), and the e2e and forward times.  Returns the ``kernels``
    line's entries for the Mish block and the two padded-2D kernels."""
    from portbench import weights_yolov4
    from yolo_v3_tpu_torch.detector import Detector
    from yolo_v3_tpu_torch.models import yolov4 as Y4
    from yolo_v3_tpu_torch.ops import conv_down as CD
    from yolo_v3_tpu_torch.ops import fused_conv as FC
    from yolo_v3_tpu_torch.ops.fused_res_block import fused_res_block
    from yolo_v3_tpu_torch.ops.letterbox import letterbox_batch
    from yolo_v3_tpu_torch.utils.config import YoloConfig

    summary = check_yolov4_kernels(card)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "portbench",
                           "configs", "yolov4-608-bf16.json")) as f:
        cfg = json.load(f)
    check(cfg["input_size"] == V4_DIM and tuple(cfg["blocks"]) == Y4.CSP_BLOCKS,
          "the cell's configuration is YOLOv4-608")
    imgs = make_images(V4_BATCH, [(h, w) for w, h in COCO_WH])
    params, state = weights_yolov4.make(cfg, 0, torch.device("cuda"), imgs[:8])
    config = YoloConfig(num_classes=cfg["classes"], img_dim=V4_DIM, anchors=Y4.ANCHORS,
                        anchor_masks=Y4.ANCHOR_MASKS)
    det = Detector(params, state, config, precision="bf16", device="cuda", arch="yolov4")
    counters = {"fused_res_block": fused_res_block, "conv1x1_p2d": FC.conv1x1_p2d,
                "conv3x3_p2d": FC.conv3x3_p2d, "conv_down": CD.conv_down}
    rows, launches = counted(dict(counters, letterbox=letterbox_batch),
                             lambda: det.detect(imgs))
    check(launches == dict(V4_LAUNCHES, letterbox=1),
          f"YOLOv4 launches in one detect {launches}, want {V4_LAUNCHES} and one letterbox")
    check_rows(rows, imgs, config.num_classes)
    plain_rows = det.detect(imgs, plain=True)
    log(f"yolov4 bf16: detect({V4_BATCH} images at {V4_DIM}) ok, kernel launches {launches}, "
        f"detections {sum(map(len, rows))} (plain path {sum(map(len, plain_rows))}; bf16 "
        f"rows are information) | {card}")

    x, _ = det.preprocess(imgs)
    xd = x.to(torch.bfloat16)
    with torch.inference_mode():
        heads, plain = det.model(xd), det.model(xd, plain=True)
    for i, (h, p) in enumerate(zip(heads, plain)):
        g = V4_DIM // 32 * 2 ** i
        check(tuple(h.shape) == (V4_BATCH, g, g, 255), f"yolov4 head{i} shape {tuple(h.shape)}")
        check(bool(torch.isfinite(h).all()), f"yolov4 head{i} finite")
        scale = p.float().abs().max().item()
        err = (h.float() - p.float()).abs().max().item()
        check(err <= 5e-2 * scale, f"yolov4 head{i} err {err} > 5e-2 * {scale}")
        log(f"yolov4 bf16: head{i} {tuple(h.shape)} kernel vs plain max_abs_err={err:.3e} "
            f"max|head|={scale:.3e} (<= 5e-2*max|head|) | {card}")
    del plain
    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: det.model(xd), iters=5, warmup=2)
        fwd_busy = busy_ms(lambda: det.model(xd), iters=3)
    torch.cuda.reset_peak_memory_stats()
    e2e_ms = cuda_ms(lambda: det.detect(imgs), iters=5, warmup=2)
    log(f"time yolov4 bf16 bs{V4_BATCH} {V4_DIM}: e2e detect {V4_BATCH * 1000 / e2e_ms:.2f} "
        f"imgs/sec ({e2e_ms:.3f} ms/batch), forward {fwd_ms:.3f} ms (device busy "
        f"{fmt_ms(fwd_busy)}), peak memory {torch.cuda.max_memory_allocated()} bytes | {card}")
    del det, heads
    torch.cuda.empty_cache()

    source = {"fused_res_block_bf16_mish": "csrc/fused_res_block.cu",
              "conv1x1_p2d_bf16_yolov4": "csrc/conv_p2d.cu",
              "conv3x3_p2d_bf16_yolov4": "csrc/conv_p2d.cu"}
    return [dict(name=name, route="cuda", source=f"yolo_v3_tpu_torch/{source[name]}",
                 replaces=None, model="yolov4-608", batch=BATCH,
                 launches=launches[name.split("_bf16")[0]], **acc)
            for name, acc in summary.items()], launches


def iou_xywh(a, b):
    """IoU of one [x, y, w, h] box against rows [n, 4]."""
    ix = np.clip(np.minimum(a[0] + a[2], b[:, 0] + b[:, 2]) - np.maximum(a[0], b[:, 0]), 0, None)
    iy = np.clip(np.minimum(a[1] + a[3], b[:, 1] + b[:, 3]) - np.maximum(a[1], b[:, 1]), 0, None)
    inter = ix * iy
    return inter / (a[2] * a[3] + b[:, 2] * b[:, 3] - inter + 1e-9)


def agreement(ref, rows, same_class=True):
    """Share of ``ref``'s rows with a row of ``rows`` of the same class (any
    class with ``same_class=False``) at IoU > 0.5, one to one, each taking
    its best-IoU free candidate (eval mode keeps many overlapping rows,
    where the first candidate would take another row's match)."""
    used = np.zeros(len(rows), bool)
    hit = 0
    for r in ref:
        iou = iou_xywh(r[1:5], rows[:, 1:5])
        ok = ~used & (iou > 0.5)
        if same_class:
            ok &= rows[:, 0] == r[0]
        if ok.any():
            used[np.argmax(np.where(ok, iou, -1.0))] = True
            hit += 1
    return hit / max(len(ref), 1)


def int8_path(card, weights_path, imgs, fp32_rows, e2e):
    """Phases 4 and 5 in int8.  Returns the kernels' launch counts of the
    int8 path's run, its calibrated tree and the float batch it serves; puts
    the e2e ms per batch into ``e2e``."""
    from yolo_v3_tpu_torch.detector import Detector
    from yolo_v3_tpu_torch.ops import entry_kernel as EK
    from yolo_v3_tpu_torch.ops import fused_conv as FC
    from yolo_v3_tpu_torch.ops.letterbox import letterbox_batch
    from yolo_v3_tpu_torch.ops.postprocess import postprocess_from_raws
    from yolo_v3_tpu_torch.utils.config import YoloConfig

    config = YoloConfig()
    t0 = time.perf_counter()
    det = Detector.from_darknet_weights(weights_path, config, device="cuda",
                                        precision="int8", calib_images=imgs)
    torch.cuda.synchronize()
    log(f"main int8: fold + calibration on the {len(imgs)} images + quantization "
        f"{time.perf_counter() - t0:.2f} s (set-up) | {card}")
    check(det.model.num_res_blocks == sum(DARKNET53_BLOCKS) - 1,
          "22 residual blocks after the entry")

    counters = {"fused_entry": EK.fused_entry, "conv1x1_p2d": FC.conv1x1_p2d,
                "conv3x3_p2d": FC.conv3x3_p2d, "res_block_p2d": FC.res_block_p2d}
    for fn in counters.values():
        fn.launches = 0
    letterbox_batch.launches = 0
    rows = det.detect(imgs)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    check(launches == INT8_LAUNCHES,
          f"int8 launches in one forward {launches}, want {INT8_LAUNCHES}")
    check(letterbox_batch.launches == 1,
          f"int8: {letterbox_batch.launches} letterbox launches in one detect")
    launches["letterbox"] = letterbox_batch.launches
    check_rows(rows, imgs, config.num_classes)
    log(f"main int8: detect(8 images) ok, launches {launches}, detections per "
        f"image={[len(r) for r in rows]} | {card}")

    x, _ = det.preprocess(imgs)
    with torch.inference_mode():
        heads = det.model(x)
        plain = det.model(x, plain=True)
    for i, (h, p) in enumerate(zip(heads, plain)):
        check(tuple(h.shape) == (BATCH, 13 * 2 ** i, 13 * 2 ** i, 255),
              f"int8 head{i} shape {tuple(h.shape)}")
        check(h.dtype == torch.bfloat16 and bool(torch.isfinite(h).all()),
              f"int8 head{i} finite bf16")
        check(torch.equal(h, p), f"int8 head{i} kernel and plain paths differ")
        log(f"main int8: head{i} {tuple(h.shape)} kernel vs plain bit-equal, "
            f"max|head|={h.float().abs().max().item():.3e} | {card}")
    plain_rows = det.detect(imgs, plain=True)
    check(all(same_rows(a, b, 0.0, 0.0) for a, b in zip(rows, plain_rows)),
          "int8 detections equal on kernel and plain forward paths")
    log(f"main int8: detection rows equal on kernel and plain forward paths (one "
        f"preprocess) | {card}")
    agree = [agreement(f, r) for f, r in zip(fp32_rows, rows)]
    log(f"main int8 vs fp32 (information, not a gate): share of fp32 detections "
        f"matched by an int8 one (same class, IoU > 0.5) per image="
        f"{[round(a, 3) for a in agree]}, mean {np.mean(agree):.3f} | {card}")

    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: det.model(x))
        fwd_busy = busy_ms(lambda: det.model(x))
        fwd_plain_ms = cuda_ms(lambda: det.model(x, plain=True))
        pre_ms = cuda_ms(lambda: det.preprocess(imgs))
        post_ms = cuda_ms(lambda: postprocess_from_raws(
            heads, config, config.img_dim, config.conf_thr, config.nms_thr))
    e2e_ms = e2e["int8"] = cuda_ms(lambda: det.detect(imgs), iters=5, warmup=2)
    e2e_plain_ms = cuda_ms(lambda: det.detect(imgs, plain=True), iters=5, warmup=2)
    log(f"time int8 bs{BATCH} 416: e2e detect {BATCH * 1000 / e2e_ms:.2f} imgs/sec "
        f"({e2e_ms:.3f} ms/batch), forward {fwd_ms:.3f} ms; plain path: "
        f"{BATCH * 1000 / e2e_plain_ms:.2f} imgs/sec ({e2e_plain_ms:.3f} ms/batch), "
        f"forward {fwd_plain_ms:.3f} ms | {card}")
    log(f"time int8 bs{BATCH} 416 kernel path split: preprocess {pre_ms:.3f} ms, "
        f"forward {fwd_ms:.3f} ms (device busy {fmt_ms(fwd_busy)}), postprocess "
        f"{post_ms:.3f} ms | {card}")
    qtree = det.qtree
    del det
    torch.cuda.empty_cache()
    return launches, qtree, x


def scene_u8(seed):
    """A seeded uint8 batch [BATCH, 416, 416, 3] of smooth random scenes,
    already at the net input (the uint8 feed's host letterbox needs OpenCV)."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 255, (BATCH, 27, 27, 3))
    img = np.repeat(np.repeat(coarse, 16, 1), 16, 2)[:, :416, :416]
    img = img + rng.integers(-20, 20, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def rows_agreement(a, b):
    """(same class, any class): the smaller of the two directions' shares of
    rows matched one to one at IoU > 0.5 (:func:`agreement`)."""
    if len(a) == len(b) == 0:
        return 1.0, 1.0
    return tuple(min(agreement(a, b, c), agreement(b, a, c)) for c in (True, False))


def counted(counters, fn):
    """``fn()`` with the kernels' launch counts set to 0 just before it and
    read just after."""
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items()}


def serving_options_path(card, weights_path, imgs, qtree, x_i8, summary_i8):
    """Phase 6: the uint8 feed, the int8 tree without space-to-depth, the bf16
    Detector without letterbox in display and eval mode, and the global-top-k
    display and eval postprocess on the card against the CPU.  Returns the
    kernel summary entries of the launches it adds."""
    import dataclasses

    from yolo_v3_tpu_torch.detector import Detector, detect_fn
    from yolo_v3_tpu_torch.models import darknet as D
    from yolo_v3_tpu_torch.models import quantized as Q
    from yolo_v3_tpu_torch.models import weights as W
    from yolo_v3_tpu_torch.ops import conv_down as CD
    from yolo_v3_tpu_torch.ops import entry_kernel as EK
    from yolo_v3_tpu_torch.ops import fused_conv as FC
    from yolo_v3_tpu_torch.ops import postprocess as P
    from yolo_v3_tpu_torch.ops.fused_res_block import fused_res_block
    from yolo_v3_tpu_torch.utils.config import YoloConfig

    config = YoloConfig()
    dim = config.img_dim
    i8_counters = {"fused_entry": EK.fused_entry, "conv1x1_p2d": FC.conv1x1_p2d,
                   "conv3x3_p2d": FC.conv3x3_p2d, "res_block_p2d": FC.res_block_p2d}
    bf_counters = {"fused_res_block": fused_res_block, "conv1x1_p2d": FC.conv1x1_p2d,
                   "conv3x3_p2d": FC.conv3x3_p2d, "conv_down": CD.conv_down}

    def as_rows(res):
        return [r[:, [6, 0, 1, 2, 3, 5, 4]] for r in P.detections_to_lists(res)]

    def int8_heads_equal(model, x, what):
        with torch.inference_mode():
            heads, plain = model(x), model(x, plain=True)
        for i, (h, p) in enumerate(zip(heads, plain)):
            check(tuple(h.shape) == (BATCH, 13 * 2 ** i, 13 * 2 ** i, 255)
                  and h.dtype == torch.bfloat16 and bool(torch.isfinite(h).all()),
                  f"{what} head{i}: finite bf16 of the right shape")
            check(torch.equal(h, p), f"{what} head{i}: kernel and plain paths differ")
        log(f"options {what}: heads kernel vs plain bit-equal, max|head|="
            f"{[round(h.float().abs().max().item(), 3) for h in heads]} | {card}")

    entries = []

    # (a) the uint8 feed, through detect_fn on phase 4's calibrated tree
    u8_np = scene_u8(10)
    u8 = torch.from_numpy(u8_np).to("cuda")
    org = torch.full((BATCH, 2), float(dim), device="cuda")
    det = Detector(None, None, config, quantized_tree=qtree, resize_on_device=False,
                   device="cuda")
    check(det._u8_feed, "int8 with resize_on_device=False serves the uint8 feed")
    model = det.model

    def run_u8(plain=False):
        with torch.inference_mode():
            return detect_fn(model, u8, org, config, config.conf_thr, config.nms_thr,
                             compute_dtype=det.compute_dtype, plain=plain)

    res, launches = counted(i8_counters, run_u8)
    check(launches == INT8_LAUNCHES,
          f"int8 uint8-feed launches in one detect_fn {launches}, want {INT8_LAUNCHES}")
    rows, plain_rows = as_rows(res), as_rows(run_u8(plain=True))
    check_rows(rows, list(u8_np), config.num_classes)
    check(all(same_rows(a, b, 0.0, 0.0) for a, b in zip(rows, plain_rows)),
          "int8 uint8-feed detections equal on kernel and plain paths")
    log(f"options int8 uint8 feed: detect_fn(uint8 [{BATCH},{dim},{dim},3]) ok, launches "
        f"{launches}, detections per image={[len(r) for r in rows]}, rows equal on kernel "
        f"and plain paths | {card}")
    int8_heads_equal(model, u8, "int8 uint8 feed")

    with torch.inference_mode():
        xb_u8, qs_u8 = model.entry_operands(u8)
        xb_f, qs_f = model.entry_operands(x_i8)
    rs = model.entry_res_scale
    got = EK.fused_entry(xb_u8, qs_u8, rs)
    torch.cuda.synchronize()
    want = EK.fused_entry_ref(xb_u8, qs_u8, rs)
    check(torch.equal(got, want), "fused_entry on the uint8 operands: kernel and plain differ")
    err = (got.float() - want.float()).abs().max().item()
    u8_ms, u8_plain_ms = (device_ms(lambda: EK.fused_entry(xb_u8, qs_u8, rs)),
                          device_ms(lambda: EK.fused_entry_ref(xb_u8, qs_u8, rs)))
    f_ms = device_ms(lambda: EK.fused_entry(xb_f, qs_f, rs))
    h = got.shape[1]
    ops = sum(2 * BATCH * (2 * h if name == "stem" else h) ** 2 * kh * kw_ * cin * cout
              for name, (kh, kw_, cin, cout) in EK.SHAPES.items())
    nbytes = (xb_u8.numel() + got.numel()
              + sum(p["w"].numel() + 8 * p["m"].numel() for p in qs_u8.values()))
    b_ms, by = bound(ops, nbytes, "int8")
    with torch.inference_mode():
        busy_u8 = busy_ms(lambda: model(u8))
        busy_f = busy_ms(lambda: model(x_i8))
    log(f"kernel fused_entry_int8_u8 [{BATCH},{xb_u8.shape[1]},{xb_u8.shape[2]},12] (-128 pad, "
        f"stem4_u8 multipliers) max_abs_err={err:.1e} (bit-equal) kernel_ms={u8_ms:.4f} "
        f"plain_ms={u8_plain_ms:.4f} bound_ms={b_ms:.4f} ({by}); the float feed's operands "
        f"in this phase: kernel_ms={f_ms:.4f} | {card}")
    log(f"time int8 bs{BATCH} {dim}: forward device busy, uint8 feed {fmt_ms(busy_u8)}, "
        f"float feed {fmt_ms(busy_f)} | {card}")
    entries.append(dict(
        name="fused_entry_int8_u8", route="cuda", source="yolo_v3_tpu_torch/csrc/fused_entry.cu",
        replaces="yolo_v3_tpu/ops/entry_kernel.py:193", launches=launches["fused_entry"],
        max_abs_err=err, ms=u8_ms, plain_ms=u8_plain_ms, bound_ms=b_ms, bound_by=by,
        library_ms=None, feed="uint8: -128 pad, stem4_u8 multipliers and biases"))
    del det, model
    torch.cuda.empty_cache()

    # (b) the int8 tree without space-to-depth, calibrated on phase 4's batch
    params, state = D.init_yolonet(torch.Generator().manual_seed(0), config.num_classes)
    params, state, _, _ = W.load_darknet_weights(params, state, weights_path)
    tree = Q.build_quantized(params, state, x_i8, space_to_depth=False)
    check("s2d" not in tree and "stage0" in tree["backbone"], "a tree without s2d")
    det = Detector(None, None, config, quantized_tree=tree, device="cuda")
    model = det.model
    check(model.num_res_blocks == sum(DARKNET53_BLOCKS), "23 residual blocks on the p2d path")
    rows, launches = counted(i8_counters, lambda: det.detect(imgs))
    check(launches == INT8_LAUNCHES_NO_S2D,
          f"int8 tree without s2d: launches {launches}, want {INT8_LAUNCHES_NO_S2D}")
    check_rows(rows, imgs, config.num_classes)
    check(all(same_rows(a, b, 0.0, 0.0) for a, b in zip(rows, det.detect(imgs, plain=True))),
          "int8 tree without s2d: detections equal on kernel and plain paths")
    log(f"options int8 tree without s2d: detect(8 images) ok, launches {launches}, "
        f"detections per image={[len(r) for r in rows]}, rows equal on kernel and plain "
        f"paths | {card}")
    x, _ = det.preprocess(imgs)
    int8_heads_equal(model, x, "int8 tree without s2d")

    # its stage-0 block at 208^2 on the stage's real input
    with torch.inference_mode():
        y = model.downs[0].nhwc(model.stem.nhwc(Q.quantize_image(x, model.scales["image"])),
                                stride=2)
    b_, h0, w0, c0 = y.shape
    rows0, hp, wp = FC.p2d_geometry(b_, h0, w0)
    x2d = FC.pack_p2d(y)
    blk = model.stages[0][0]
    c1, c2 = blk.conv1, blk.conv2
    cmid = c1.w.shape[1]
    args = (x2d, c1.w, c1.m, c1.b, c2.w, c2.m, c2.b, hp, wp)
    got = FC.res_block_p2d(*args, res_scale=blk.res_scale)
    torch.cuda.synchronize()
    check(torch.equal(got, FC.res_block_p2d_ref(*args, res_scale=blk.res_scale)),
          "stage-0 block: kernel and plain differ")
    mid = FC.conv1x1_p2d(x2d, c1.w, c1.m, c1.b, hp, wp)
    conv2 = dict(residual=x2d, res_scale=blk.res_scale)
    parts = {
        "conv1x1_p2d": (lambda: FC.conv1x1_p2d(x2d, c1.w, c1.m, c1.b, hp, wp),
                        lambda: FC.conv1x1_p2d_ref(x2d, c1.w, c1.m, c1.b, hp, wp),
                        2 * rows0 * c0 * cmid, rows0 * (c0 + cmid) + c1.w.numel() + 8 * cmid),
        "conv3x3_p2d": (lambda: FC.conv3x3_p2d(mid, c2.w, c2.m, c2.b, hp, wp, **conv2),
                        lambda: FC.conv3x3_p2d_ref(mid, c2.w, c2.m, c2.b, hp, wp, **conv2),
                        2 * rows0 * 9 * cmid * c0,
                        rows0 * (cmid + 2 * c0) + c2.w.numel() + 8 * c0),
        "res_block_p2d": (lambda: FC.res_block_p2d(*args, res_scale=blk.res_scale),
                          lambda: FC.res_block_p2d_ref(*args, res_scale=blk.res_scale),
                          2 * rows0 * 10 * c0 * cmid,
                          2 * x2d.numel() + c1.w.numel() + c2.w.numel() + 8 * (cmid + c0)),
    }
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tiles = {"conv1x1_p2d": plan_line(rows0, c0, cmid, 1, torch.int8, sms),
             "conv3x3_p2d": plan_line(rows0, cmid, c0, 9, torch.int8, sms)}
    for name, (run, run_plain, ops, nbytes) in parts.items():
        check(torch.equal(run(), run_plain()), f"stage-0 {name}: kernel and plain differ")
        k_ms, p_ms = device_ms(run), device_ms(run_plain)
        b_ms, by = bound(ops, nbytes, "int8")
        tile = (f" tiles {tiles[name][0]} slots ({tiles[name][1]} B shared)"
                if name in tiles else "")
        log(f"kernel {name}_int8 stage 0 of the tree without s2d [{BATCH},{h0},{w0},"
            f"{c0 if name != 'conv3x3_p2d' else cmid}]{tile} (bit-equal) kernel_ms={k_ms:.4f} "
            f"plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({by}) | {card}")
        base = summary_i8[f"{name}_int8"]
        source, replaces = {"conv1x1_p2d": ("csrc/conv_p2d.cu", "fused_conv.py:131"),
                            "conv3x3_p2d": ("csrc/conv_p2d.cu", "fused_conv.py:236"),
                            "res_block_p2d": ("ops/fused_conv.py", "fused_conv.py:313")}[name]
        entry = dict(
            name=f"{name}_int8_no_s2d", route="cuda", source=f"yolo_v3_tpu_torch/{source}",
            replaces=f"yolo_v3_tpu/ops/{replaces}", launches=launches[name],
            max_abs_err=base["max_abs_err"], ms=base["ms"] + k_ms,
            plain_ms=base["plain_ms"] + p_ms, bound_ms=base["bound_ms"] + b_ms,
            bound_by=base["bound_by"] if base["bound_ms"] >= b_ms else by, library_ms=None,
            per_forward="the s2d forward's launches (phase 3) plus stage 0's block at 208^2")
        if name == "res_block_p2d":
            entry["composition_of"] = ["conv1x1_p2d_int8_no_s2d", "conv3x3_p2d_int8_no_s2d"]
        entries.append(entry)
    del det, model, params, state, tree
    torch.cuda.empty_cache()

    # (c) the bf16 Detector without letterbox, display and eval.  Its heads
    # are held to the plain path's as phase 4 holds bf16's; its rows cannot
    # be held equal: both paths round every conv to bf16 after summing in
    # another order, and on this random model many scores lie near the
    # threshold (display) or the max_detections cut (eval), so such steps
    # move rows in and out, and NMS with them (the shares printed below)
    det = Detector.from_darknet_weights(weights_path, config, device="cuda", precision="bf16",
                                        letterbox=False)
    x, _ = det.preprocess(imgs)
    with torch.inference_mode():
        heads = det.model(x.to(torch.bfloat16))
        plain = det.model(x.to(torch.bfloat16), plain=True)
    for i, (h, p) in enumerate(zip(heads, plain)):
        scale = p.float().abs().max().item()
        err = (h.float() - p.float()).abs().max().item()
        check(bool(torch.isfinite(h).all()) and err <= 5e-2 * scale,
              f"bf16 letterbox=False head{i} err {err} > 5e-2 * {scale}")
        log(f"options bf16 letterbox=False: head{i} {tuple(h.shape)} kernel vs plain "
            f"max_abs_err={err:.3e} max|head|={scale:.3e} (max-abs-err <= 5e-2*max|head|) "
            f"| {card}")
    for is_eval in (False, True):
        mode = "eval" if is_eval else "display"
        rows, launches = counted(bf_counters, lambda: det.detect(imgs, is_eval=is_eval))
        check(launches == BF16_LAUNCHES,
              f"bf16 letterbox=False {mode}: launches {launches}, want {BF16_LAUNCHES}")
        check_rows(rows, imgs, config.num_classes)
        shares = [rows_agreement(a, b)
                  for a, b in zip(rows, det.detect(imgs, is_eval=is_eval, plain=True))]
        log(f"options bf16 letterbox=False {mode}: detect(8 images) ok, launches {launches}, "
            f"detections per image={[len(r) for r in rows]}; kernel vs plain rows "
            f"(information, not a gate): share matched one to one at IoU > 0.5 per image, "
            f"same class {[round(a, 3) for a, _ in shares]}, any class "
            f"{[round(b, 3) for _, b in shares]} | {card}")

    # (d) global top-k display and eval postprocess: the card against the CPU
    heads_cpu = [h.cpu() for h in heads]
    for mode, cfg, kw in (
            ("global top-k display", dataclasses.replace(config, display_per_scale_topk=0),
             dict(conf_thr=config.conf_thr, nms_thr=config.nms_thr)),
            ("eval", config, dict(conf_thr=config.eval_conf_thr, nms_thr=config.eval_nms_thr,
                                  is_eval=True))):
        on_card = as_rows(P.postprocess_from_raws(heads, cfg, dim, **kw))
        on_cpu = as_rows(P.postprocess_from_raws(heads_cpu, cfg, dim, **kw))
        check(all(same_rows(a, b) for a, b in zip(on_card, on_cpu)),
              f"{mode} postprocess: rows on the card and on the CPU differ")
        ms = cuda_ms(lambda: P.postprocess_from_raws(heads, cfg, dim, **kw))
        log(f"options {mode} postprocess on bf16 heads [{BATCH}, 13/26/52, 255]: rows on the "
            f"card equal to the CPU's (boxes atol 1e-2 px, probs atol 1e-4), detections per "
            f"image={[len(r) for r in on_card]}, {ms:.3f} ms on the card | {card}")
    del det
    torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# Phase 7: training
# ---------------------------------------------------------------------------

TRAIN_IMAGES = 16           # the in-memory dataset: one net-batch
TRAIN_BATCH = 8             # micro-batch
TRAIN_SUBDIVISIONS = 2
TRAIN_STEPS = 5
TRAIN_MAX_LABELS = 8
# bf16 outputs that may differ from the single-rounding reference at all,
# and the fp32 summation-order floor near zero (tests/test_torch_bf16_single_rounding.py)
C1_MAX_OFF_SHARE = 1e-3
C1_ABS_FLOOR = 2.0 ** -12
# the trained checkpoint's rows are also compared at a threshold that
# leaves between this many candidates of the batch
SERVE_ROWS = (8, 64)


class SceneDataset:
    """Seeded uint8 416 x 416 scenes in memory, each with 1-8 boxes drawn on
    it in its class's colour; ``get`` resizes to the scheduled dim by nearest
    neighbour (the card's host has no OpenCV; labels are relative, so they
    hold at any dim)."""

    def __init__(self, n, num_classes, seed=7, hw=416):
        rng = np.random.default_rng(seed)
        coarse = rng.integers(60, 190, (n, hw // 16 + 1, hw // 16 + 1, 3))
        imgs = np.repeat(np.repeat(coarse, 16, 1), 16, 2)[:, :hw, :hw]
        imgs = imgs + rng.integers(-10, 10, imgs.shape)
        colours = rng.integers(0, 255, (num_classes, 3))
        self.labels = np.zeros((n, TRAIN_MAX_LABELS, 5), np.float32)
        for i in range(n):
            for t in range(int(rng.integers(1, 9))):
                c = int(rng.integers(0, num_classes))
                w, h = rng.uniform(0.08, 0.5, 2)
                cx, cy = rng.uniform(w / 2, 1 - w / 2), rng.uniform(h / 2, 1 - h / 2)
                self.labels[i, t] = (c, cx, cy, w, h)
                x0, x1 = int((cx - w / 2) * hw), int((cx + w / 2) * hw)
                y0, y1 = int((cy - h / 2) * hw), int((cy + h / 2) * hw)
                imgs[i, y0:y1, x0:x1] = colours[c]
        self.imgs = np.clip(imgs, 0, 255).astype(np.uint8)

    def __len__(self):
        return len(self.imgs)

    def get(self, i, dim, seed):
        w, h = dim
        src = self.imgs[i]
        rows = np.arange(h) * src.shape[0] // h
        cols = np.arange(w) * src.shape[1] // w
        return {"img": src[rows][:, cols], "label": self.labels[i].copy(), "rng": seed}


def train_data(dataset, max_net_batches, dim=(416, 416), rand_dim_interval=None, seed=0):
    from yolo_v3_tpu_torch.data.loader import DataHelper
    from yolo_v3_tpu_torch.data.sampler import CyclicSampler

    sampler = CyclicSampler(len(dataset), TRAIN_BATCH, shuffle=False, dim=dim,
                            rand_dim_interval=rand_dim_interval, seed=seed)
    return DataHelper(dataset, sampler, max_net_batches=max_net_batches,
                      net_subdivisions=TRAIN_SUBDIVISIONS, prefetch=0)


def seed_trees(weights_path, num_classes):
    """The training-form {params, state} of phase 4's seed .weights."""
    from yolo_v3_tpu_torch.models import darknet as D
    from yolo_v3_tpu_torch.models import weights as W

    params, state = D.init_yolonet(torch.Generator().manual_seed(0), num_classes,
                                   blocks=DARKNET53_BLOCKS)
    params, state, _, _ = W.load_darknet_weights(params, state, weights_path)
    return params, state


def flat_trees(tree):
    from yolo_v3_tpu_torch.models.weights import _flatten_with_names

    return _flatten_with_names(tree)


def row_threshold(heads, config):
    """A display threshold in the widest relative gap between the batch's
    sorted row scores (sigmoid(obj) * sigmoid(max class), as the display
    postprocess ranks them), among those that leave SERVE_ROWS candidates."""
    lo, hi = SERVE_ROWS
    scores = torch.cat([
        (torch.sigmoid(r[..., 4]) * torch.sigmoid(r[..., 5:].amax(-1))).flatten()
        for r in (h.float().reshape(*h.shape[:3], -1, 5 + config.num_classes)
                  for h in heads)])
    top = torch.sort(scores, descending=True).values[:hi + 1].double()
    k = lo + int(torch.argmax(top[lo - 1:hi] / top[lo:hi + 1]))
    return float(torch.sqrt(top[k - 1] * top[k]))


def resume_check(weights_path, work):
    """Child process of phase 7 (``--resume-check``): with deterministic
    algorithms on, 2 fp32 net-batches in one run against 1 + checkpoint +
    resume + 1.  Prints one JSON line: bit-equal, or the ops that have no
    deterministic CUDA form and the largest difference."""
    import warnings

    from yolo_v3_tpu_torch.train.checkpoint import get_latest_checkpoint, load_checkpoint
    from yolo_v3_tpu_torch.train.loop import train
    from yolo_v3_tpu_torch.utils.config import TrainConfig, YoloConfig

    config = YoloConfig()
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, net_subdivisions=TRAIN_SUBDIVISIONS)
    dataset = SceneDataset(TRAIN_IMAGES, config.num_classes)

    def runs():
        params, state = seed_trees(weights_path, config.num_classes)
        quiet = dict(device="cuda", log_fn=lambda s: None)
        one_go = train(train_data(dataset, 2), params, state, config, tcfg, **quiet)
        train(train_data(dataset, 1), params, state, config, tcfg, model_id="r",
              weight_dir=work, **quiet)
        path, _ = get_latest_checkpoint("r", work)
        resumed = train(train_data(dataset, 2), params, state, config, tcfg,
                        checkpoint=load_checkpoint(path), **quiet)
        return one_go, resumed

    torch.use_deterministic_algorithms(True)
    nondeterministic = []
    try:
        one_go, resumed = runs()
    except RuntimeError as e:
        if "deterministic" not in str(e):
            raise
        torch.use_deterministic_algorithms(True, warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            one_go, resumed = runs()
        nondeterministic = sorted({str(w.message).split(" does not have")[0]
                                   for w in caught if "deterministic" in str(w.message)})
    max_diff, equal = 0.0, True
    for i in (0, 1):                                  # params, BN state
        a, b = flat_trees(one_go[i]), flat_trees(resumed[i])
        for k in a:
            equal &= bool(np.array_equal(a[k], b[k]))
            max_diff = max(max_diff, float(np.abs(a[k] - b[k]).max()))
    print(json.dumps({"bit_equal": equal, "max_abs_diff": max_diff,
                      "nondeterministic_ops": nondeterministic,
                      "loss": resumed[3].current_stats["loss"]}))


def c1_gate(card, weights_path, imgs):
    """The bf16 stem and 5 downs of the folded forward (one fp32 conv with
    TF32 on the bf16 values, bias and leaky in fp32, one rounding) against
    an fp32 single-rounding reference with TF32 off, on the inputs a bf16
    forward of phase 4's batch gives them; and the 6 convs' device time
    against the double-rounding bf16 conv + leaky they replace."""
    from yolo_v3_tpu_torch.detector import Detector
    from yolo_v3_tpu_torch.models.darknet import LEAKY_SLOPE
    from yolo_v3_tpu_torch.utils.config import YoloConfig
    from yolo_v3_tpu_torch.utils.precision import full_fp32

    det = Detector.from_darknet_weights(weights_path, YoloConfig(), device="cuda",
                                        precision="bf16")
    convs = [det.model.stem, *det.model.downs]
    inputs = []
    hooks = [c.register_forward_pre_hook(lambda m, a: inputs.append(a[0])) for c in convs]
    x, _ = det.preprocess(imgs)
    with torch.inference_mode():
        det.model(x.to(torch.bfloat16))
    for h in hooks:
        h.remove()

    def ordered(a):
        bits = (a.float().view(torch.int32) >> 16).to(torch.int64) & 0xFFFF
        return torch.where(bits >= 0x8000, -(bits & 0x7FFF), bits)

    def double_rounding(conv, xi):
        y = F.conv2d(xi, conv.weight, conv.bias, conv.stride, conv.pad)
        return F.leaky_relu(y, LEAKY_SLOPE)

    worst, new_ms, old_ms = 0.0, 0.0, 0.0
    with torch.inference_mode():
        for i, (conv, xi) in enumerate(zip(convs, inputs)):
            got = conv(xi)
            with full_fp32():
                ref = F.conv2d(xi.float(), conv.weight.float(), None, conv.stride, conv.pad)
            ref = F.leaky_relu(ref + conv.bias.float()[:, None, None], LEAKY_SLOPE)
            ref = ref.to(torch.bfloat16)
            step = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp(min=2.0 ** -126)))
                              - 7)
            over = ((got.float() - ref.float()).abs() - step - C1_ABS_FLOOR).max().item()
            share = (ordered(got) != ordered(ref)).float().mean().item()
            old = double_rounding(conv, xi)
            old_share = (ordered(old) != ordered(ref)).float().mean().item()
            name = "stem" if i == 0 else f"down{i - 1}"
            check(over <= 0 and share < C1_MAX_OFF_SHARE,
                  f"C.1 {name}: {share:.4%} of outputs differ from the single-rounding "
                  f"reference (beyond one step by {over})")
            worst = max(worst, share)
            t_new = device_ms(lambda: conv(xi))
            t_old = device_ms(lambda: double_rounding(conv, xi))
            new_ms, old_ms = new_ms + t_new, old_ms + t_old
            log(f"train C.1 {name} {tuple(xi.shape)} -> {tuple(got.shape)}: "
                f"{share:.5%} of outputs differ from the fp32 single-rounding reference "
                f"(double rounding: {old_share:.3%}); {t_new:.3f} ms (double-rounding "
                f"bf16 conv + leaky {t_old:.3f} ms) | {card}")
    log(f"train C.1 gate: the 6 convs single-rounding {new_ms:.3f} ms per forward, "
        f"double-rounding {old_ms:.3f} ms (bs{BATCH} 416); worst share differing "
        f"{worst:.5%} < {C1_MAX_OFF_SHARE:.1%} | {card}")
    del det
    torch.cuda.empty_cache()
    return new_ms, old_ms


def training_path(card, weights_path, imgs, work):
    """Phase 7: the port's training path at full width."""
    from yolo_v3_tpu_torch.detector import Detector
    from yolo_v3_tpu_torch.models.darknet import map_tree
    from yolo_v3_tpu_torch.ops import conv_down as CD
    from yolo_v3_tpu_torch.ops import fused_conv as FC
    from yolo_v3_tpu_torch.ops.fused_res_block import fused_res_block
    from yolo_v3_tpu_torch.train.checkpoint import get_latest_checkpoint
    from yolo_v3_tpu_torch.train.loop import train
    from yolo_v3_tpu_torch.train.optimizer import global_norm, make_optimizer
    from yolo_v3_tpu_torch.train.recorder import Recorder
    from yolo_v3_tpu_torch.train.step import COMPUTE_DTYPES, loss_fn, make_train_step
    from yolo_v3_tpu_torch.utils.config import TrainConfig, YoloConfig
    from yolo_v3_tpu_torch.utils.precision import full_fp32

    t_phase = time.perf_counter()
    config = YoloConfig()
    dataset = SceneDataset(TRAIN_IMAGES, config.num_classes)
    n_boxes = int((dataset.labels.sum(-1) != 0).sum())
    params0, state0 = seed_trees(weights_path, config.num_classes)
    flat0 = {**flat_trees(params0), **{f"state/{k}": v for k, v in flat_trees(state0).items()}}
    log(f"train set-up: YOLOv3-416 ({config.num_classes} classes, blocks "
        f"{DARKNET53_BLOCKS}) from the seed .weights, {TRAIN_IMAGES} uint8 scenes with "
        f"{n_boxes} boxes, batch {TRAIN_BATCH} x {TRAIN_SUBDIVISIONS} subdivisions | {card}")

    # the card against the CPU: forward + loss on one micro-batch of 2, fp32
    sample = [dataset.get(i, (416, 416), 0) for i in range(2)]
    xb = torch.from_numpy(np.stack([s["img"] for s in sample]))
    lb = torch.from_numpy(np.stack([s["label"] for s in sample]))
    stats = {}
    for dev in ("cuda", "cpu"):
        move = lambda t: t.to(dev)                     # noqa: E731
        with torch.no_grad(), full_fp32():
            loss, (st, _) = loss_fn(map_tree(move, params0), map_tree(move, state0),
                                    move(xb), move(lb), config)
        stats[dev] = {k: float(v) for k, v in st.items()} | {"total": float(loss)}
    rel = abs(stats["cuda"]["total"] - stats["cpu"]["total"]) / abs(stats["cpu"]["total"])
    check(rel <= 1e-4, f"train loss on the card {stats['cuda']['total']} vs the CPU "
                       f"{stats['cpu']['total']} (rel {rel:.2e} > 1e-4)")
    check(all(stats["cuda"][k] == stats["cpu"][k] for k in ("nGT", "nCorrect")),
          f"train nGT / nCorrect on the card {stats['cuda']} vs the CPU {stats['cpu']}")
    log(f"train card vs CPU (fp32, TF32 off, 2 images at 416): loss "
        f"{stats['cuda']['total']:.6f} vs {stats['cpu']['total']:.6f} (rel {rel:.2e} <= 1e-4), "
        f"nGT {stats['cuda']['nGT']:.0f} nCorrect {stats['cuda']['nCorrect']:.0f} equal | {card}")

    summary = {}
    final_ckpt = None
    for dtype_name in ("float32", "bfloat16"):
        tcfg = TrainConfig(batch_size=TRAIN_BATCH, net_subdivisions=TRAIN_SUBDIVISIONS,
                           compute_dtype=dtype_name)
        jsonl = os.path.join(work, f"curve_{dtype_name}.jsonl")
        wdir = os.path.join(work, f"ckpt_{dtype_name}")
        t0 = time.perf_counter()
        params, state, opt_state, rec = train(
            train_data(dataset, TRAIN_STEPS), params0, state0, config, tcfg,
            recorder=Recorder(jsonl_path=jsonl), model_id=dtype_name, weight_dir=wdir,
            device="cuda", log_fn=lambda s: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(jsonl) as f:
            losses = [json.loads(line)["loss"] for line in f]
        check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
              f"train {dtype_name}: finite loss at every net-batch {losses}")
        check(losses[-1] < losses[0],
              f"train {dtype_name}: loss on the repeated net-batch falls {losses}")
        gnorm = float(global_norm(opt_state["trace"]))
        check(np.isfinite(gnorm) and gnorm > 0,
              f"train {dtype_name}: momentum (accumulated gradients) finite and non-zero")
        flat = {**flat_trees(params), **{f"state/{k}": v for k, v in flat_trees(state).items()}}
        check(all(np.isfinite(v).all() for v in flat.values()),
              f"train {dtype_name}: params and BN state finite")
        moved = sum(not np.array_equal(flat[k], flat0[k]) for k in flat0)
        check(moved == len(flat0), f"train {dtype_name}: {len(flat0) - moved} leaves "
                                   "of params and BN state did not move")
        final_ckpt, last = get_latest_checkpoint(dtype_name, wdir)
        check(last == TRAIN_STEPS - 1, f"train {dtype_name}: final checkpoint {last}")
        log(f"train {dtype_name}: {TRAIN_STEPS} net-batches of {TRAIN_IMAGES} images "
            f"({wall:.2f} s with set-up), loss per net-batch "
            f"{[round(v, 3) for v in losses]}, every param and BN-state leaf moved, "
            f"momentum norm {gnorm:.4g}, final checkpoint net-batch {last} | {card}")

        # timing: the step alone on one net-batch already on the card
        opt = make_optimizer(tcfg)
        step = make_train_step(config, opt, COMPUTE_DTYPES[dtype_name])
        batch = [dataset.get(i, (416, 416), 0) for i in range(TRAIN_IMAGES)]
        imgs_d = torch.from_numpy(np.stack([s["img"] for s in batch])).reshape(
            TRAIN_SUBDIVISIONS, TRAIN_BATCH, 416, 416, 3).cuda()
        labels_d = torch.from_numpy(np.stack([s["label"] for s in batch])).reshape(
            TRAIN_SUBDIVISIONS, TRAIN_BATCH, TRAIN_MAX_LABELS, 5).cuda()
        p, s_, o = params, state, opt_state
        p, s_, o, _ = step(p, s_, o, imgs_d, labels_d)            # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            p, s_, o, _ = step(p, s_, o, imgs_d, labels_d)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        summary[dtype_name] = dict(ms=ms, imgs_per_sec=TRAIN_IMAGES * 1000 / ms, peak_gib=peak)
        log(f"time train {dtype_name} 416: {ms:.3f} ms per net-batch of {TRAIN_IMAGES} "
            f"({TRAIN_SUBDIVISIONS} x {TRAIN_BATCH}), {TRAIN_IMAGES * 1000 / ms:.2f} train "
            f"imgs/sec, peak memory {peak:.2f} GiB | {card}")
        if dtype_name == "bfloat16":
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                p, s_, o, _ = step(p, s_, o, imgs_d, labels_d)
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages() if e.self_device_time_total > 0]
            total = sum(e.self_device_time_total for e in ev)
            top = sorted(ev, key=lambda e: -e.self_device_time_total)[:5]
            log("train bf16 net-batch top 5 device ops (torch.profiler, self time): "
                + "; ".join(f"{e.key[:70]} {e.self_device_time_total / 1000:.3f} ms "
                            f"x{e.count}" for e in top)
                + f"; device busy {total / 1000:.3f} ms | {card}")
            summary[dtype_name]["busy_ms"] = total / 1000
        del p, s_, o, imgs_d, labels_d
        torch.cuda.empty_cache()

    # resume equals one go, in a child with deterministic algorithms
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    resume_dir = os.path.join(work, "resume")
    os.makedirs(resume_dir, exist_ok=True)
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--resume-check",
                          weights_path, resume_dir], env=env, capture_output=True, text=True,
                         timeout=300)
    check(out.returncode == 0, f"resume check failed: {out.stderr[-2000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    if res["nondeterministic_ops"]:
        check(res["max_abs_diff"] <= 1e-6,
              f"resume vs one go: {res['max_abs_diff']} > 1e-6 with ops without a "
              f"deterministic form {res['nondeterministic_ops']}")
        verdict = (f"within {res['max_abs_diff']:.2e} (<= 1e-6; no deterministic CUDA form: "
                   f"{res['nondeterministic_ops']})")
    else:
        check(res["bit_equal"], f"resume vs one go not bit-equal ({res['max_abs_diff']})")
        verdict = "bit-equal"
    log(f"train resume == one go (fp32, 2 net-batches vs 1 + checkpoint + resume + 1, "
        f"deterministic algorithms): params and BN state {verdict} | {card}")

    # multi-scale: dims from the sampler in 320..608, one per net-batch
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, net_subdivisions=TRAIN_SUBDIVISIONS,
                       compute_dtype="bfloat16")
    lines = []
    data = train_data(dataset, 2, dim=None, rand_dim_interval=TRAIN_BATCH * TRAIN_SUBDIVISIONS,
                      seed=3)
    dims = sorted({d[0] for d in data.sampler.dims})
    _, _, _, rec = train(data, params0, state0, config, tcfg, device="cuda",
                         log_fn=lines.append)
    seen = [int(ln.split(" dim ")[1].split()[0]) for ln in lines if ln.startswith("net_batch")]
    check(len(seen) == 2 and all(320 <= d <= 608 and d % 32 == 0 for d in seen)
          and np.isfinite(rec.current_stats["loss"]),
          f"train multi-scale: dims {seen}, loss {rec.current_stats['loss']}")
    log(f"train multi-scale (bf16): 2 net-batches at dims {seen} (sampler schedule {dims}), "
        f"final loss {rec.current_stats['loss']:.3f} | {card}")

    # serve the final checkpoint on the kernels
    counters = {"fused_res_block": fused_res_block, "conv1x1_p2d": FC.conv1x1_p2d,
                "conv3x3_p2d": FC.conv3x3_p2d, "conv_down": CD.conv_down}
    want = {"fp32": dict(fused_res_block=23, conv1x1_p2d=0, conv3x3_p2d=0, conv_down=0),
            "bf16": {k: BF16_LAUNCHES[k] for k in counters}}
    for precision in ("fp32", "bf16"):
        det = Detector.from_checkpoint(final_ckpt, config, device="cuda", precision=precision)
        for c in counters.values():
            c.launches = 0
        rows = det.detect(imgs)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        check(launches == want[precision],
              f"trained checkpoint {precision} launches {launches}, want {want[precision]}")
        check_rows(rows, imgs, config.num_classes)
        note = ""
        if precision == "fp32":
            x, _ = det.preprocess(imgs)
            with torch.inference_mode():
                heads, plain = det.model(x), det.model(x, plain=True)
            for h, p in zip(heads, plain):
                torch.testing.assert_close(h, p, rtol=1e-3, atol=1e-3 * p.abs().max().item())
            # five net-batches push every score under the display threshold,
            # so the rows are also compared at one in the widest gap of the
            # plain heads' scores that leaves SERVE_ROWS candidates
            thr = row_threshold(plain, config)
            low = [det.detect(imgs, conf_thr=thr, plain=p) for p in (False, True)]
            check(all(same_rows(a, b) for a, b in zip(rows, det.detect(imgs, plain=True)))
                  and all(same_rows(a, b) for a, b in zip(*low))
                  and sum(len(r) for r in low[0]) > 0,
                  "trained checkpoint fp32 rows equal on kernel and plain paths")
            note = (f", rows equal to the plain path's (also at conf_thr {thr:.4g}: "
                    f"{[len(r) for r in low[0]]} per image), heads within rtol 1e-3")
        log(f"train serve {os.path.basename(final_ckpt)} {precision}: Detector.from_checkpoint"
            f" on the card, launches {launches}, detections per image "
            f"{[len(r) for r in rows]}{note} | {card}")
        del det
        torch.cuda.empty_cache()

    summary["c1_new_ms"], summary["c1_old_ms"] = c1_gate(card, weights_path, imgs)
    log(f"train phase: {time.perf_counter() - t_phase:.1f} s | {card}")
    return summary


# ---------------------------------------------------------------------------
# Phase 8: eval and the data engine
# ---------------------------------------------------------------------------

SCENES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                      "torch_scenes")
# The route of this phase, fixed by a probe of the card's host: g++ 13.3 but
# no jpeglib.h and no libjpeg in ldconfig (OpenCV 4.13 headless and Pillow
# carry private copies, without headers), so the native decode and augment
# pool (csrc/yolodata.cc) cannot be built there.  The phase decodes with
# OpenCV: eval through Detector.preprocess, training on DataHelper's Python
# path.
EVAL_BATCH = 8
# the timed eval: the scene list repeated to 42 batches of 8
EVAL_TIMED_REPEATS = 14
# the bf16 eval's gates run on the scenes in each of these orientations
ORIENTATIONS = {"as is": lambda im: im, "mirrored": lambda im: im[:, ::-1],
                "upside down": lambda im: im[::-1],
                "transposed": lambda im: im.transpose(1, 0, 2)}
# phase 8's training schedule (scripts/make_torch_scenes.py SCHEDULE): 3
# net-batches of 8 x 2, multi-scale, one dim a net-batch
DATA_SCHEDULE = dict(batch_size=8, seed=12, rand_dim_interval=16)
DATA_NET_BATCHES = 3
# the timed data runs: augmentation over 1 + 51 batches at 416, train()
# over 1 + 10 net-batches
DATA_TIMED_NET_BATCHES = 26
TRAIN_TIMED_NET_BATCHES = 11


def results_rows(path):
    """{image_id: [n, 7] rows [cls, x, y, w, h, score, score]} of a results
    json, in the Detector's row layout (so :func:`same_rows` applies)."""
    out = {}
    with open(path) as f:
        for e in json.load(f):
            out.setdefault(e["image_id"], []).append(
                [e["category_id"], *e["bbox"], e["score"], e["score"]])
    return {k: np.array(v) for k, v in out.items()}


def same_results(a, b):
    ra, rb = results_rows(a), results_rows(b)
    return sorted(ra) == sorted(rb) and all(same_rows(ra[k], rb[k]) for k in rb)


def scene_list(work, repeats=1, name="scenes.txt"):
    """(list file of the scenes, ``repeats`` times over; the scene paths;
    the class names)."""
    img_dir = os.path.join(SCENES, "images")
    paths = sorted(os.path.join(img_dir, n) for n in os.listdir(img_dir) if n.endswith(".jpg"))
    lst = os.path.join(work, name)
    with open(lst, "w") as f:
        f.write("\n".join(paths * repeats) + "\n")
    with open(os.path.join(SCENES, "scenes.names")) as f:
        names = [ln.strip() for ln in f if ln.strip()]
    return lst, paths, names


def host_library(card):
    """(a) g++, libjpeg and the attempted build of the native pool on this
    host, printed; the route is OpenCV's whatever they say."""
    import cv2

    from yolo_v3_tpu_torch.data import native_loader

    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         timeout=60).stdout.splitlines()[0]
    ldconfig = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True,
                              timeout=60).stdout
    jpeg = sorted({ln.split("=>")[-1].strip() for ln in ldconfig.splitlines()
                   if "libjpeg" in ln}) or ["none in ldconfig"]
    t0 = time.perf_counter()
    try:
        native_loader.load_library()
        build = "ok"
    except RuntimeError as e:
        build = "failed: " + next((ln.strip() for ln in str(e).splitlines() if "error" in ln),
                                  str(e)[:200])
    log(f"data host: {gxx}; libjpeg {jpeg}; yolodata.cc build {build} "
        f"({time.perf_counter() - t0:.2f} s) | {card}")
    log(f"data route (fixed): OpenCV {cv2.__version__} decode; the native decode and "
        f"augment pool is unverified on the card (no libjpeg on its host) | {card}")


def bf16_eval_gates(det, config, scenes):
    """The bf16 eval's gates on the scenes in every orientation, a batch of
    8 at a time: heads bit-equal over two forwards and within 5e-2 *
    max|head| of the plain path's, and the eval postprocess on the same
    heads equal on the card and on the CPU (a failure names the image and
    its unmatched rows).  Returns the largest err / max|head| of each head."""
    from yolo_v3_tpu_torch.ops import postprocess as P

    kw = dict(conf_thr=config.eval_conf_thr, nms_thr=config.eval_nms_thr, is_eval=True)

    def as_rows(res):                      # [x y w h obj prob cls] -> [cls x y w h prob obj]
        return [r[:, [6, 0, 1, 2, 3, 5, 4]] for r in P.detections_to_lists(res)]

    worst = [0.0] * 3
    for turn, f in ORIENTATIONS.items():
        for start in range(0, len(scenes), EVAL_BATCH):
            imgs = [np.ascontiguousarray(f(im)) for im in scenes[start:start + EVAL_BATCH]]
            where = f"scenes {start}-{start + len(imgs) - 1} {turn}"
            x, _ = det.preprocess(imgs)
            with torch.inference_mode():
                heads = det.model(x.to(torch.bfloat16))
                again = det.model(x.to(torch.bfloat16))
                plain = det.model(x.to(torch.bfloat16), plain=True)
            check(all(torch.equal(h, g) for h, g in zip(heads, again)),
                  f"bf16 eval, {where}: the heads of two forwards differ")
            for i, (h, p) in enumerate(zip(heads, plain)):
                scale = p.float().abs().max().item()
                err = (h.float() - p.float()).abs().max().item()
                check(bool(torch.isfinite(h).all()) and err <= 5e-2 * scale,
                      f"bf16 eval, {where}: head{i} err {err} > 5e-2 * {scale}")
                worst[i] = max(worst[i], err / scale)
            on_card = as_rows(P.postprocess_from_raws(heads, config, 416, **kw))
            on_cpu = as_rows(P.postprocess_from_raws([h.cpu() for h in heads], config, 416, **kw))
            for j, (a, b) in enumerate(zip(on_card, on_cpu)):
                if not same_rows(a, b):
                    check(False, f"bf16 eval postprocess, {where}, image {start + j}: rows on "
                          f"the card and on the CPU differ: {unmatched_rows(a, b)}")
    return [round(w, 4) for w in worst]


def unmatched_rows(a, b):
    """The rows :func:`same_rows` left unmatched, both ways, each with its
    class, score and rank: a near-tie at the max_detections cut or in NMS
    shows as two such rows of nearly equal score."""
    out = [f"{len(a)} vs {len(b)} rows"]
    for side, x, y in (("card", a, b), ("CPU", b, a)):
        out += [f"{side} only: class {int(x[i, 0])} score {x[i, 5]:.9g} rank "
                f"{int((x[:, 5] > x[i, 5]).sum())}" for i in unmatched(x, y)[:8]]
    return "; ".join(out)


def eval_path(card, weights_path, qtree, work):
    """(b), (c): evaluate_detector at 416 on the scenes in int8 (uint8 feed),
    fp32 and bf16, each against the same pipeline on the plain path.
    Returns {precision: mAP}."""
    from yolo_v3_tpu_torch.data.datasets import ListDataset
    from yolo_v3_tpu_torch.detector import Detector
    from yolo_v3_tpu_torch.eval.coco_json import JsonPredictionWriter
    from yolo_v3_tpu_torch.eval.cocoeval import evaluate_map
    from yolo_v3_tpu_torch.eval.pipeline import STAGES, evaluate_detector, generate_results_file
    from yolo_v3_tpu_torch.ops import conv_down as CD
    from yolo_v3_tpu_torch.ops import entry_kernel as EK
    from yolo_v3_tpu_torch.ops import fused_conv as FC
    from yolo_v3_tpu_torch.ops.fused_res_block import fused_res_block
    from yolo_v3_tpu_torch.utils.config import YoloConfig

    config = YoloConfig()
    lst, paths, names = scene_list(work)
    timed, _, _ = scene_list(work, EVAL_TIMED_REPEATS, "timed.txt")
    profiled, _, _ = scene_list(work, 2, "profiled.txt")
    n_batches = -(-len(paths) // EVAL_BATCH)
    n_timed = -(-len(paths) * EVAL_TIMED_REPEATS // EVAL_BATCH)
    route = dict(batch_size=EVAL_BATCH, is_letterbox=True, use_native_loader=False)
    counters = {
        "int8": {"fused_entry": EK.fused_entry, "conv1x1_p2d": FC.conv1x1_p2d,
                 "conv3x3_p2d": FC.conv3x3_p2d, "res_block_p2d": FC.res_block_p2d,
                 "conv_down": CD.conv_down},
        "fp32": {"fused_res_block": fused_res_block, "conv1x1_p2d": FC.conv1x1_p2d,
                 "conv3x3_p2d": FC.conv3x3_p2d, "conv_down": CD.conv_down},
        "bf16": {"fused_res_block": fused_res_block, "conv1x1_p2d": FC.conv1x1_p2d,
                 "conv3x3_p2d": FC.conv3x3_p2d, "conv_down": CD.conv_down}}
    per_forward = {"int8": dict(INT8_LAUNCHES, conv_down=0),
                   "fp32": dict(fused_res_block=23, conv1x1_p2d=0, conv3x3_p2d=0, conv_down=0),
                   "bf16": BF16_LAUNCHES}
    scenes = [ListDataset(lst).load_raw(i)["img"] for i in range(len(paths))]
    maps = {}
    for precision in ("int8", "fp32", "bf16"):
        if precision == "int8":
            det = Detector(None, None, config, quantized_tree=qtree, resize_on_device=False,
                           device="cuda")
            check(det._u8_feed, "int8 eval runs on the uint8 feed")
        else:
            det = Detector.from_darknet_weights(weights_path, config, device="cuda",
                                                precision=precision)
        wdir = os.path.join(work, f"eval_{precision}")
        os.makedirs(wdir)
        t0 = time.perf_counter()
        m_ap, launches = counted(counters[precision],
                                 lambda: evaluate_detector(det, lst, names, wdir, **route))
        first_s = time.perf_counter() - t0
        maps[precision] = m_ap
        want = {k: v * n_batches for k, v in per_forward[precision].items()}
        check(launches == want, f"eval {precision}: launches {launches}, want {want}")
        res, gt = os.path.join(wdir, "results.json"), os.path.join(wdir, "annotations.json")
        res_plain = os.path.join(wdir, "results_plain.json")
        generate_results_file(det, lst, names, res_plain, progress=False, plain=True, **route)
        m_ap_plain = evaluate_map(gt, res_plain)
        rows = results_rows(res)
        n_rows = sum(len(r) for r in rows.values())
        check(n_rows > 0 and all(np.isfinite(r).all() for r in rows.values()),
              f"eval {precision}: finite rows")
        if precision == "int8":
            with open(res) as f, open(res_plain) as g:
                check(f.read() == g.read(), "int8 eval: results.json differs from the plain path's")
            check(m_ap == m_ap_plain, f"int8 eval: mAP {m_ap} vs plain {m_ap_plain}")
            verdict = "results.json identical to the plain path's, mAP equal"
        elif precision == "fp32":
            check(same_results(res, res_plain), "fp32 eval: rows differ from the plain path's")
            check(abs(m_ap - m_ap_plain) <= 1e-3, f"fp32 eval: mAP {m_ap} vs plain {m_ap_plain}")
            verdict = ("rows equal to the plain path's (boxes atol 1e-2 px, scores atol 1e-4), "
                       "mAP within 1e-3")
        else:
            worst = bf16_eval_gates(det, config, scenes)
            rp = results_rows(res_plain)
            none = np.zeros((0, 7))
            shares = [rows_agreement(rows.get(k, none), rp.get(k, none))[0]
                      for k in sorted(set(rows) | set(rp))]
            verdict = (f"on the scenes in {len(ORIENTATIONS)} orientations "
                       f"({len(ORIENTATIONS) * len(scenes)} images): heads bit-equal over two "
                       f"forwards and within 5e-2*max|head| of the plain path's (largest err / "
                       f"max|head| {worst}), eval postprocess on the same heads equal on the "
                       f"card and the CPU; kernel vs plain rows (information, not a gate): share "
                       f"matched one to one (same class, best IoU > 0.5) per image, mean "
                       f"{np.mean(shares):.3f}, min {min(shares):.3f}; mAP plain "
                       f"{m_ap_plain:.6f}")
        log(f"eval {precision} 416 on {len(paths)} scenes (batch {EVAL_BATCH}, letterbox, "
            f"eval mode): evaluate_detector mAP@0.5 {m_ap:.6f} (random seed-0 weights), "
            f"{n_rows} rows, launches {launches} ({n_batches} batches), first run "
            f"{first_s:.2f} s; {verdict} | {card}")

        # (c) the eval's host stages over n_timed batches, every shape warm
        # from the runs above; the device's busy time per batch over a
        # profiled pass of the scenes twice (the profiler slows the host)
        timings = {}
        t0 = time.perf_counter()
        generate_results_file(det, timed, names, os.path.join(wdir, "timed.json"),
                              progress=False, timings=timings, **route)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000
        check(timings["batches"] == n_timed, f"timed eval: {timings['batches']} batches")
        busy = busy_ms(lambda: generate_results_file(
            det, profiled, names, os.path.join(wdir, "profiled.json"), progress=False,
            **route), iters=1)
        busy = None if busy is None else busy / (2 * n_batches)
        stages = ", ".join(f"{k} {timings[k] * 1000 / n_timed:.3f} ms" for k in STAGES)
        idle = "not measured" if busy is None else f"{1 - busy * n_timed / wall_ms:.3f}"
        log(f"time eval {precision} 416 over {n_timed} batches of {EVAL_BATCH} (the scenes "
            f"{EVAL_TIMED_REPEATS} times): {n_timed * EVAL_BATCH * 1000 / wall_ms:.2f} imgs/sec "
            f"end to end ({wall_ms / n_timed:.3f} ms per batch); host per batch: {stages} "
            f"(load: OpenCV decode + {'host' if det._u8_feed else 'device'} letterbox; detect: "
            f"the detect_fn call, which waits on the NMS rounds); device busy per batch "
            f"{fmt_ms(busy)} (a profiled pass of {2 * n_batches} batches), idle share of the "
            f"wall {idle} | {card}")
        del det
        torch.cuda.empty_cache()

    # ground truth fed back as detections scores 1.0
    gt_path = os.path.join(work, "eval_int8", "annotations.json")
    with open(gt_path) as f:
        gt = json.load(f)
    res = os.path.join(work, "gt_as_detections.json")
    with JsonPredictionWriter(res, names) as w:
        for img in gt["images"]:
            anns = [a for a in gt["annotations"] if a["image_id"] == img["id"]]
            w.add(img["id"], np.array([[a["category_id"], *a["bbox"], 1.0, 1.0]
                                       for a in anns]).reshape(-1, 7))
    score = evaluate_map(gt_path, res)
    check(abs(score - 1.0) <= 1e-9, f"ground truth as detections scores {score}")
    log(f"eval ground truth as detections ({len(gt['annotations'])} boxes, "
        f"{len(gt['images'])} images): mAP@0.5 {score:.6f} | {card}")
    return maps


def data_train_path(card, weights_path, work, train_summary):
    """(d): train() from the scenes through DataHelper's Python path
    (OpenCV) with training_transform and multi-scale, deterministic, labels
    equal to the committed ones; its samples/sec and ms per net-batch."""
    import functools

    from yolo_v3_tpu_torch.data import transforms as T
    from yolo_v3_tpu_torch.data.datasets import ListDataset
    from yolo_v3_tpu_torch.data.loader import DataHelper
    from yolo_v3_tpu_torch.data.sampler import CyclicSampler
    from yolo_v3_tpu_torch.train.loop import train
    from yolo_v3_tpu_torch.utils.config import TrainConfig, YoloConfig

    config = YoloConfig()
    lst, _, _ = scene_list(work)
    ds = ListDataset(lst, trans_fn=functools.partial(T.training_transform, feed_u8=True))
    want = np.load(os.path.join(SCENES, "expected_labels.npz"))

    def helper(workers, net_batches=DATA_NET_BATCHES, dim=None):
        """A DataHelper on the schedule with ``workers`` worker processes
        (1: in this process)."""
        sampler = CyclicSampler(len(ds), dim=dim, **DATA_SCHEDULE)
        return DataHelper(ds, sampler, max_net_batches=net_batches, net_subdivisions=2,
                          prefetch=0, num_workers=workers if workers > 1 else 0)

    def batches(h):
        try:
            return [{k: b[k].copy() for k in ("img", "label")} for b in h]
        finally:
            h.close()

    first, second = batches(helper(1)), batches(helper(1))
    check(len(first) == len(want["labels"]) == 2 * DATA_NET_BATCHES,
          f"data: {len(first)} batches")
    for b, (x, y) in enumerate(zip(first, second)):
        check(np.array_equal(x["img"], y["img"]) and np.array_equal(x["label"], y["label"]),
              f"data batch {b}: a second run with the same seed differs")
        check(np.array_equal(x["label"], want["labels"][b]),
              f"data batch {b}: labels differ from the committed expected_labels.npz")
        check(x["img"].dtype == np.uint8 and x["img"].shape[1] == want["dims"][b],
              f"data batch {b}: {x['img'].dtype} {x['img'].shape}, dim {want['dims'][b]}")
    log(f"data Python path (OpenCV): {len(first)} batches of 8 at dims "
        f"{[int(d) for d in want['dims']]}, uint8 feed, bit-identical on a second run, labels "
        f"bit-equal to the committed ones (the JAX Python path's) | {card}")

    rates = []
    for workers in (1, 2):
        h = helper(workers, net_batches=DATA_TIMED_NET_BATCHES, dim=(416, 416))
        it = iter(h)
        next(it)                                   # warm-up (and the workers' start)
        t0 = time.perf_counter()
        k = sum(1 for _ in it)
        rates.append(k * 8 / (time.perf_counter() - t0))
        h.close()
    log(f"time data Python path (OpenCV) training_transform at 416 over {k} batches of 8 "
        f"after one: {rates[0]:.1f} samples/sec with 1 and {rates[1]:.1f} with 2 worker "
        f"processes | {card}")

    params0, state0 = seed_trees(weights_path, config.num_classes)
    tcfg = TrainConfig(batch_size=8, net_subdivisions=2, compute_dtype="bfloat16")
    stamps = []
    _, _, _, rec = train(helper(1, net_batches=TRAIN_TIMED_NET_BATCHES), params0, state0,
                         config, tcfg, device="cuda",
                         log_fn=lambda ln: stamps.append((time.perf_counter(), ln)))
    torch.cuda.synchronize()
    stamps = [(t, ln) for t, ln in stamps if ln.startswith("net_batch")]
    seen = [int(ln.split(" dim ")[1].split()[0]) for _, ln in stamps]
    check(len(seen) == TRAIN_TIMED_NET_BATCHES and np.isfinite(rec.current_stats["loss"]),
          f"data train: net-batches at dims {seen}, loss {rec.current_stats['loss']}")
    ms = (stamps[-1][0] - stamps[0][0]) * 1000 / (len(stamps) - 1)
    log(f"data train (bf16) from the scenes: {len(seen)} net-batches of 8 x 2 at dims "
        f"{seen}, final loss {rec.current_stats['loss']:.3f}, {ms:.1f} ms per net-batch "
        f"over the last {len(seen) - 1} (between the first and the last stats readback; "
        f"the data path in the loop, one process) (phase 7, in memory at 416, the step "
        f"alone: {train_summary['bfloat16']['ms']:.1f} ms) | {card}")


# ---------------------------------------------------------------------------
# Phase 9: the CLI, data parallelism and profiling
# ---------------------------------------------------------------------------

CLI_SCENE = "scene_000001.jpg"
# the data-parallel check: 2 ranks of 4 x 2 against one process of 8 x 2
DP_RANKS = 2
# the CLI training run: 2 net-batches, then --resume for 1, against 3 in one
# go, checkpointing every net-batch (the CLI's default: a run resumes from an
# in-loop checkpoint: resuming from a final one skips data, ROADMAP section C)
CLI_TRAIN = ["--dim", "416", "--multi-scale", "--batch-size", str(TRAIN_BATCH),
             "--subdivisions", str(TRAIN_SUBDIVISIONS), "--bf16", "--feed-u8"]


def kernel_counters():
    from yolo_v3_tpu_torch.ops import conv_down as CD
    from yolo_v3_tpu_torch.ops import entry_kernel as EK
    from yolo_v3_tpu_torch.ops import fused_conv as FC
    from yolo_v3_tpu_torch.ops.fused_res_block import fused_res_block

    return {"fused_res_block": fused_res_block, "fused_entry": EK.fused_entry,
            "conv1x1_p2d": FC.conv1x1_p2d, "conv3x3_p2d": FC.conv3x3_p2d,
            "res_block_p2d": FC.res_block_p2d, "conv_down": CD.conv_down}


def cli_child(argv, deterministic):
    """Child process of phase 9 (``--cli`` / ``--cli-deterministic``): the
    CLI's ``main`` (what ``python -m yolo_v3_tpu_torch.cli`` runs) on
    ``argv``, every kernel's launch count set to 0 just before and printed
    just after as the last line of stderr, with the wall seconds."""
    from yolo_v3_tpu_torch import cli

    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.perf_counter()
    _, launches = counted(kernel_counters(), lambda: cli.main(argv))
    print(json.dumps({"launches": launches, "seconds": time.perf_counter() - t0}),
          file=sys.stderr, flush=True)


def start(args, env=None):
    """A child process whose output goes to temporary files, so that children
    waiting on one another never block on a full pipe."""
    import tempfile

    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, *args], env=env, stdout=out, stderr=err,
                            text=True)
    proc.logs = out, err
    return proc


def start_cli(argv, deterministic=False):
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8") if deterministic else None
    mode = "--cli-deterministic" if deterministic else "--cli"
    return start([os.path.abspath(__file__), mode, *argv], env)


def finish(proc, what, timeout=300):
    """(stdout, the child's last stderr line as JSON or None) of a child
    that must exit 0."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise
    out, err = proc.logs
    out.seek(0)
    err.seek(0)
    out, err = out.read(), err.read()
    proc.logs[0].close()
    proc.logs[1].close()
    check(proc.returncode == 0, f"{what}: exit {proc.returncode}: {err[-3000:]}")
    last = err.strip().splitlines()[-1] if err.strip() else ""
    return out, (json.loads(last) if last.startswith("{") else None)


def finish_all(procs, timeout=300):
    """{name: finish(...)} of children that must all exit 0 within
    ``timeout`` s together; on a failure every child still running is
    killed."""
    deadline = time.monotonic() + timeout
    try:
        return {k: finish(p, k, max(deadline - time.monotonic(), 1.0))
                for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def trees_equal(a, b):
    fa, fb = flat_trees(a), flat_trees(b)
    return sorted(fa) == sorted(fb) and all(np.array_equal(fa[k], fb[k]) for k in fa)


def cli_serving(card, weights_path, imgs, qtree, work, eval_map):
    """(a) weights convert / inspect / quantize, detect in int8 and bf16, eval
    in int8, each a child process through the CLI."""
    import cv2

    from yolo_v3_tpu_torch import cli
    from yolo_v3_tpu_torch.detector import Detector
    from yolo_v3_tpu_torch.eval.pipeline import evaluate_detector
    from yolo_v3_tpu_torch.models import quantized as Q
    from yolo_v3_tpu_torch.models import weights as W
    from yolo_v3_tpu_torch.utils.config import YoloConfig

    config = YoloConfig()
    d = os.path.join(work, "cli")
    calib = os.path.join(d, "calib")
    os.makedirs(calib)
    # phase 4's calibration images, lossless and in order, so the CLI's
    # artifact is phase 4's tree
    for i, im in enumerate(imgs):
        cv2.imwrite(os.path.join(calib, f"calib_{i}.png"), cv2.cvtColor(im, cv2.COLOR_RGB2BGR))
    conv, q = os.path.join(d, "convert.npz"), os.path.join(d, "q.npz")
    scene = os.path.join(SCENES, "images", CLI_SCENE)
    png = os.path.join(d, "detections.png")
    module = ["-m", "yolo_v3_tpu_torch.cli"]
    # the weights tools and the bf16 detect at once, then the int8 detect and
    # eval on the quantized artifact
    t0 = time.perf_counter()
    procs = {"weights inspect": start(module + ["weights", "inspect", weights_path]),
             "weights convert": start(module + ["weights", "convert", weights_path,
                                                "--out", conv]),
             "weights quantize": start_cli(["weights", "quantize", weights_path, "--out", q,
                                            "--calib-images", calib, "--calib-count",
                                            str(len(imgs))]),
             "detect bf16": start_cli(["detect", "--image", scene, "--weights", weights_path,
                                       "--precision", "bf16", "--out", png])}
    outs = finish_all(procs)
    wall = time.perf_counter() - t0
    params, state = seed_trees(weights_path, config.num_classes)
    n_floats = sum(v.size for t in (params, state) for v in flat_trees(t).values())
    info = json.loads(outs["weights inspect"][0])
    check(info == {"version": [0, 2, 0], "seen": 0, "n_floats": n_floats},
          f"cli weights inspect: {info}, want {n_floats} floats")
    tree, meta = W.load_pytree(conv)
    check(trees_equal(tree["params"], params) and trees_equal(tree["state"], state)
          and meta["seen"] == 0, "cli weights convert: the npz differs from the .weights")
    check(Q.is_quantized_file(q), "cli weights quantize wrote no artifact")
    got = Q.load_quantized(q)
    names, kinds, got_leaves, want_leaves = [], [], [], []
    Q._flatten_q(got, [], names, kinds, got_leaves)
    Q._flatten_q(qtree, [], [], [], want_leaves)

    def host(v):
        return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    check(len(got_leaves) == len(want_leaves)
          and all(np.array_equal(host(a), host(b)) for a, b in zip(got_leaves, want_leaves)),
          "cli weights quantize: the artifact differs from phase 4's calibrated tree")
    log(f"cli weights and detect bf16 (4 children at once, {wall:.1f} s): inspect "
        f"{info['n_floats']} floats; "
        f"convert: npz equal to the .weights; quantize "
        f"(calibrated on phase 4's 8 images): artifact equal to phase 4's int8 tree, "
        f"{outs['weights quantize'][1]['seconds']:.1f} s in main | {card}")

    lst, paths, names_ = scene_list(work, name="cli_scenes.txt")
    names_file = os.path.join(SCENES, "scenes.names")
    eval_dir = os.path.join(d, "eval")
    procs = {
        "detect int8": start_cli(["detect", "--image", scene, "--weights", q,
                                  "--precision", "int8"]),
        "eval int8": start_cli(["eval", "--val-list", lst, "--weights", q, "--names",
                                names_file, "--letterbox", "--precision", "int8",
                                "--workdir", eval_dir]),
    }
    t0 = time.perf_counter()
    outs = {"detect bf16": outs["detect bf16"], **finish_all(procs)}
    wall = time.perf_counter() - t0
    img = cv2.cvtColor(cv2.imread(scene), cv2.COLOR_BGR2RGB)
    n_batches = -(-len(paths) // EVAL_BATCH)
    want_launches = {
        "detect int8": dict(INT8_LAUNCHES, fused_res_block=0, conv_down=0),
        "detect bf16": dict(BF16_LAUNCHES, fused_entry=0, res_block_p2d=0),
        "eval int8": {k: v * n_batches for k, v in dict(INT8_LAUNCHES, fused_res_block=0,
                                                        conv_down=0).items()}}
    for what, (out, res) in outs.items():
        check(res["launches"] == want_launches[what],
              f"cli {what}: launches {res['launches']}, want {want_launches[what]}")
    for precision, det in (
            ("int8", Detector.from_quantized(q, config, device="cuda")),
            ("bf16", Detector.from_darknet_weights(weights_path, config, device="cuda",
                                                   precision="bf16"))):
        want = [cli.format_detection(r)
                for r in det.detect([img], conf_thr=0.5, nms_thr=0.4, dim=416)[0]]
        got = [ln for ln in outs[f"detect {precision}"][0].splitlines()
               if not ln.startswith("saved ")]
        check(got == want, f"cli detect {precision}: printed rows differ from "
                           f"Detector.detect's in this process ({len(got)} vs {len(want)})")
        log(f"cli detect {precision} ({CLI_SCENE}, {img.shape[1]}x{img.shape[0]}): "
            f"{len(got)} rows printed, equal to Detector.detect's formatted in this process; "
            f"launches {outs[f'detect {precision}'][1]['launches']}; "
            f"{outs[f'detect {precision}'][1]['seconds']:.1f} s in main | {card}")
        del det
    saved = cv2.imread(png)
    check(saved is not None and saved.shape == img.shape[:2] + (3,),
          f"cli detect --out: {png} does not decode to the scene's shape")
    m_ap = json.loads(outs["eval int8"][0].strip().splitlines()[-1])["mAP@0.5"]
    check(m_ap == eval_map["int8"], f"cli eval int8: mAP {m_ap} vs phase 8's {eval_map['int8']}")
    same_dir = os.path.join(d, "eval_same")
    os.makedirs(same_dir)
    det = Detector.from_quantized(q, config, device="cuda")
    m_same = evaluate_detector(det, lst, names_, same_dir, is_letterbox=True,
                               use_native_loader=False)
    del det
    with open(os.path.join(eval_dir, "results.json")) as f, \
            open(os.path.join(same_dir, "results.json")) as g:
        check(f.read() == g.read(), "cli eval int8: results.json differs from "
                                    "evaluate_detector's on the same artifact")
    log(f"cli eval int8 --letterbox on {len(paths)} scenes: mAP@0.5 {m_ap:.6f} equal to phase "
        f"8's evaluate_detector on the same tree ({eval_map['int8']:.6f}); results.json "
        f"identical to evaluate_detector's in this process with the CLI's Detector (float "
        f"feed, card letterbox, OpenCV decode; mAP {m_same:.6f}); launches "
        f"{outs['eval int8'][1]['launches']}; {outs['eval int8'][1]['seconds']:.1f} s in "
        f"main | {card}")
    log(f"cli detect int8, eval int8 (2 children at once): {wall:.1f} s | {card}")


def start_cli_training(work):
    """(b)'s first two children, 2 and 3 net-batches of ``train --bf16
    --feed-u8 --multi-scale`` with deterministic algorithms, started to run
    beside (a)'s.  Returns what :func:`cli_training` finishes."""
    lst, _, _ = scene_list(work, name="cli_train.txt")
    wdir = os.path.join(work, "cli", "weights")
    base = ["train", "--train-list", lst, "--names", os.path.join(SCENES, "scenes.names"),
            "--weight-dir", wdir, *CLI_TRAIN]
    procs = {"2 net-batches": start_cli(base + ["--model-id", "r", "--max-net-batches", "2"],
                                        True),
             "3 net-batches": start_cli(base + ["--model-id", "g", "--max-net-batches", "3"],
                                        True)}
    return base, wdir, procs, time.perf_counter()


def cli_training(card, started):
    """(b) the 2-net-batch run resumed with ``--resume`` for 1 more, against
    3 in one go."""
    from yolo_v3_tpu_torch.train.checkpoint import get_latest_checkpoint, load_checkpoint

    base, wdir, procs, t0 = started
    outs = finish_all(procs)
    t1 = time.perf_counter()
    _, resumed = finish_all({"train --resume": start_cli(
        base + ["--model-id", "r", "--max-net-batches", "3", "--resume"], True)})[
        "train --resume"]
    t2 = time.perf_counter()
    ckpts = {}
    for model_id in ("r", "g"):
        path, it = get_latest_checkpoint(model_id, wdir)
        check(it == 2, f"cli train {model_id}: latest checkpoint {path}")
        ckpts[model_id] = load_checkpoint(path)
    a, b = ckpts["r"], ckpts["g"]
    check(trees_equal(a["params"], b["params"]) and trees_equal(a["state"], b["state"]),
          "cli train: 2 net-batches + --resume 1 differ from 3 in one go")
    launches = {k: v for k, v in resumed["launches"].items() if v}
    log(f"cli train --bf16 --feed-u8 --multi-scale (8 x 2 on the scenes, OpenCV + "
        f"darknet augmentation): 2 net-batches then --resume for 1: params and BN state "
        f"bit-equal to 3 in one go (deterministic algorithms); wall {t1 - t0:.1f} s for the "
        f"2- and 3-net-batch children beside (a)'s ({outs['2 net-batches'][1]['seconds']:.1f} / "
        f"{outs['3 net-batches'][1]['seconds']:.1f} s in main), --resume {t2 - t1:.1f} s "
        f"({resumed['seconds']:.1f} s in main); hand-kernel launches {launches or 'none'} "
        f"(training runs on cuDNN) | {card}")


def digest(*trees):
    import hashlib

    h = hashlib.sha256()
    for t in trees:
        for k, v in sorted(flat_trees(t).items()):
            h.update(k.encode())
            h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def dp_worker(weights_path, out, mode):
    """Child process of phase 9 (``--dp-worker``): YOLOv3-416 fp32 from phase
    7's seed model on its in-memory scenes, a global net-batch of 8 x 2, for
    1 net-batch, then a resume from that checkpoint for 1 more, with
    deterministic algorithms.  ``mode``: ``gloo`` (this rank of a gloo run,
    from the launcher's variables, on card 0), ``nccl`` (a process group of
    one rank on NCCL) or ``none`` (no mesh).  Writes one JSON file a rank:
    a digest of params and BN state after each net-batch, rank 0's stats
    and each call's seconds."""
    from yolo_v3_tpu_torch.data.sampler import CyclicSampler
    from yolo_v3_tpu_torch.parallel import distributed as dist
    from yolo_v3_tpu_torch.train.checkpoint import get_latest_checkpoint, load_checkpoint
    from yolo_v3_tpu_torch.train.loop import train
    from yolo_v3_tpu_torch.utils.config import TrainConfig, YoloConfig

    torch.use_deterministic_algorithms(True, warn_only=True)
    if mode == "gloo":
        ctx = dist.initialize(backend="gloo")
        mesh = dist.make_global_mesh(device="cuda:0")     # the ranks share one card
    elif mode == "nccl":
        torch.distributed.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
            world_size=1, rank=0)
        ctx, mesh = dist.initialize(), dist.make_global_mesh()
    else:
        ctx, mesh = dist.initialize(), None
    config = YoloConfig()
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, net_subdivisions=TRAIN_SUBDIVISIONS)
    dataset = SceneDataset(TRAIN_IMAGES, config.num_classes)
    params, state = seed_trees(weights_path, config.num_classes)
    wdir = os.path.join(out, mode)

    def data(n):
        sampler = CyclicSampler(len(dataset), TRAIN_BATCH, shuffle=False, dim=(416, 416))
        return dist.make_data_helper(dataset, sampler, ctx, max_net_batches=n,
                                     net_subdivisions=TRAIN_SUBDIVISIONS, prefetch=0)

    rec, checkpoint = [], None
    for n in (1, 2):
        if n == 2:
            checkpoint = load_checkpoint(get_latest_checkpoint("dp", wdir)[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, s, _, recorder = train(data(n), params, state, config, tcfg, model_id="dp",
                                  weight_dir=wdir, checkpoint=checkpoint, mesh=mesh,
                                  device="cuda", log_fn=lambda line: None)
        torch.cuda.synchronize()
        rec.append({"digest": digest(p, s), "seconds": time.perf_counter() - t0,
                    "stats": dict(recorder.current_stats) if ctx.process_id == 0 else None})
    with open(os.path.join(out, f"{mode}.rank{ctx.process_id}.json"), "w") as f:
        json.dump(rec, f)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


@contextlib.contextmanager
def float64_training():
    """The port's training step evaluated in float64 on float64 trees:
    ``Tensor.float()``, which the step calls for its BN math, loss and clip,
    leaves a float64 tensor as it is inside the block (the CPU tests'
    ``port_in_float64``)."""
    to_float = torch.Tensor.float

    def keep_float64(self, *args, **kw):
        return self if self.dtype == torch.float64 else to_float(self, *args, **kw)

    torch.Tensor.float = keep_float64
    try:
        yield
    finally:
        torch.Tensor.float = to_float


def float64_run(weights_path):
    """The data-parallel check's 2 net-batches, one process on the global
    batch, evaluated in float64 on the card: the flat params after each."""
    from yolo_v3_tpu_torch.data.sampler import CyclicSampler
    from yolo_v3_tpu_torch.models.darknet import map_tree
    from yolo_v3_tpu_torch.train.optimizer import make_optimizer
    from yolo_v3_tpu_torch.train.step import make_train_step
    from yolo_v3_tpu_torch.utils.config import TrainConfig, YoloConfig

    config = YoloConfig()
    tcfg = TrainConfig(batch_size=TRAIN_BATCH, net_subdivisions=TRAIN_SUBDIVISIONS)
    dataset = SceneDataset(TRAIN_IMAGES, config.num_classes)
    sampler = CyclicSampler(len(dataset), TRAIN_BATCH, shuffle=False, dim=(416, 416))
    from yolo_v3_tpu_torch.data.loader import DataHelper

    data = DataHelper(dataset, sampler, max_net_batches=2,
                      net_subdivisions=TRAIN_SUBDIVISIONS, prefetch=0)
    samples = list(data)
    params, state = (map_tree(lambda t: t.to("cuda", torch.float64), t)
                     for t in seed_trees(weights_path, config.num_classes))
    opt = make_optimizer(tcfg)
    step = make_train_step(config, opt, compute_dtype=torch.float64)
    opt_state = opt.init(params)
    out = []
    with float64_training():
        for nb in range(2):
            micro = samples[nb * TRAIN_SUBDIVISIONS:(nb + 1) * TRAIN_SUBDIVISIONS]
            imgs = torch.from_numpy(np.stack([m["img"] for m in micro])).cuda()
            labels = torch.from_numpy(np.stack([m["label"] for m in micro])).cuda().double()
            params, state, opt_state, _ = step(params, state, opt_state, imgs, labels)
            out.append(flat_trees(params))
    return out


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def data_parallel(card, weights_path, work):
    """(c) 2 gloo ranks on the one card against one process on the global
    batch, and a 1-rank NCCL mesh against no mesh."""
    from yolo_v3_tpu_torch.parallel import mesh as M
    from yolo_v3_tpu_torch.train.checkpoint import load_checkpoint
    from yolo_v3_tpu_torch.train.loop import train
    from yolo_v3_tpu_torch.utils.config import TrainConfig, YoloConfig

    out = os.path.join(work, "dp")
    os.makedirs(out)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8", MASTER_ADDR="127.0.0.1")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    me = [os.path.abspath(__file__), "--dp-worker", weights_path, out]
    t0 = time.perf_counter()
    finish_all({f"dp worker ({m})": start(me + [m], dict(env, MASTER_PORT=str(free_port())))
                for m in ("none", "nccl")})
    t1 = time.perf_counter()
    port = str(free_port())
    finish_all({f"dp worker (gloo rank {r})": start(
        me + ["gloo"], dict(env, MASTER_PORT=port, WORLD_SIZE=str(DP_RANKS), RANK=str(r),
                            LOCAL_RANK="0")) for r in range(DP_RANKS)})
    t2 = time.perf_counter()

    def load(name):
        with open(os.path.join(out, name)) as f:
            return json.load(f)

    ref, nccl = load("none.rank0.json"), load("nccl.rank0.json")
    gloo = [load(f"gloo.rank{r}.json") for r in range(DP_RANKS)]
    # the first net-batch runs on equal params, so its loss and stats are held
    # as phase 7 holds the card's against the CPU's (rtol 1e-4, counts
    # equal); the second runs on params that already differ by the first
    # update's rounding (held below at atol 2e-4): its loss is held, its
    # other stats are printed
    rel = []
    for nb in range(2):
        check(gloo[0][nb]["digest"] == gloo[1][nb]["digest"],
              f"dp: the ranks' params differ after net-batch {nb}")
        check(nccl[nb]["digest"] == ref[nb]["digest"],
              f"dp: the 1-rank NCCL mesh differs from no mesh after net-batch {nb}")
        diffs = {}
        for k, v in ref[nb]["stats"].items():
            g = gloo[0][nb]["stats"][k]
            diffs[k] = abs(g - v) / max(abs(v), 1e-12)
            if k == "nGT" or (nb == 0 and k == "nCorrect"):
                check(g == v, f"dp net-batch {nb}: {k} {g} vs {v}")
            elif (nb == 0 or k == "loss") and k != "nCorrect":
                check(abs(g - v) <= 1e-4 * abs(v) + 1e-12, f"dp net-batch {nb}: {k} {g} vs {v}")
        rel.append(diffs)
    # After the first net-batch (one step from equal params) the params are
    # held within atol 2e-4 of one process's (the JAX 2-process test's bound
    # for one step), the BN state within rtol 1e-4 / atol 1e-5 (the step
    # tests' bound).  After the second, the float32 rounding of the first
    # update has gone through a second step; there both runs are held to a
    # float64 evaluation of the same 2 net-batches, as the CPU step test
    # holds the port's float32 step: each leaf's error relative to its
    # largest float64 update, the largest and the median over the tree no
    # more than twice the single process's own.
    t3 = time.perf_counter()
    exact = float64_run(weights_path)
    t_f64 = time.perf_counter() - t3
    p0 = flat_trees(seed_trees(weights_path, 80)[0])
    worst = []
    for nb in range(2):
        ck = {m: load_checkpoint(os.path.join(out, m, "dp", f"yolov3_dp_checkpoint_{nb:06d}.npz"))
              for m in ("none", "gloo")}
        check(ck["gloo"]["mesh_shape"] == (DP_RANKS, 1) and ck["none"]["mesh_shape"] is None,
              f"dp mesh_shape {ck['gloo']['mesh_shape']}, {ck['none']['mesh_shape']}")
        a, b = flat_trees(ck["gloo"]["params"]), flat_trees(ck["none"]["params"])
        err, leaf = max((float(np.abs(a[k] - b[k]).max()), k) for k in b)
        a_s, b_s = flat_trees(ck["gloo"]["state"]), flat_trees(ck["none"]["state"])
        s_err, s_leaf = max((float((np.abs(a_s[k] - b_s[k])
                                    / (1e-5 + 1e-4 * np.abs(b_s[k]))).max()), k) for k in b_s)

        def leaf_errors(new):
            return np.array([np.abs(new[k] - exact[nb][k]).max()
                             / np.abs(exact[nb][k] - p0[k]).max() for k in p0])

        e_dp, e_one = leaf_errors(a), leaf_errors(b)
        line = (f"params {err:.2e} ({leaf}); BN state {s_err:.2f} x its bound ({s_leaf}); "
                f"against float64, error / largest update: 2 ranks largest {e_dp.max():.2e} "
                f"median {np.median(e_dp):.2e}, one process largest {e_one.max():.2e} median "
                f"{np.median(e_one):.2e}")
        log(f"dp net-batch {nb}: 2 ranks against one process: {line} | {card}")
        if nb == 0:
            check(err <= 2e-4, f"dp net-batch 0: params differ by {err} > 2e-4 ({leaf})")
            check(s_err <= 1, f"dp net-batch 0: BN state {s_leaf} beyond rtol 1e-4 / atol 1e-5 "
                              f"({s_err} x the bound)")
            first = ck["gloo"]
        else:
            check(e_dp.max() <= 2 * e_one.max() and np.median(e_dp) <= 2 * np.median(e_one),
                  f"dp net-batch 1: 2 ranks further from float64 than twice one process: {line}")
        worst.append(f"params {err:.2e}, BN state {s_err:.2f} x its bound")
    # a checkpoint of 2 ranks does not resume under 1
    try:
        train(None, first["params"], first["state"], YoloConfig(), TrainConfig(),
              checkpoint=first, mesh=M.make_mesh(device="cuda"), log_fn=lambda line: None)
        refused = False
    except ValueError as e:
        refused = "data-parallel width" in str(e)
    check(refused, "dp: a (2, 1) checkpoint resumed under a 1-rank mesh")
    loss = [round(r["stats"]["loss"], 4) for r in ref]

    def worst_rel(d):
        return ", ".join(f"{k} {v:.1e}" for k, v in d.items() if k not in ("nGT",))

    log(f"dp train(mesh=...) YOLOv3-416 fp32, global net-batch {TRAIN_BATCH} x "
        f"{TRAIN_SUBDIVISIONS} ({TRAIN_BATCH // DP_RANKS} x {TRAIN_SUBDIVISIONS} a rank), "
        f"{DP_RANKS} gloo ranks on one card (CUDA tensors), 1 net-batch + checkpoint + "
        f"resume + 1: ranks bit-equal after each net-batch; first net-batch's loss and stats "
        f"within rtol 1e-4 of one process on the global batch (relative: {worst_rel(rel[0])}), "
        f"second net-batch's loss within rtol 1e-4 (information, relative: "
        f"{worst_rel(rel[1])}); losses {loss}; after each net-batch, the largest "
        f"difference: {'; '.join(worst)} (net-batch 0 within atol 2e-4; net-batch 1 as close "
        f"to float64 as one process, the float64 run {t_f64:.1f} s); checkpoint mesh_shape "
        f"{first['mesh_shape']}; a 1-rank "
        f"NCCL mesh bit-equal to no mesh; a (2, 1) checkpoint refused under a 1-rank mesh | "
        f"{card}")
    log(f"time dp (information: the ranks share one card): the resumed net-batch "
        f"(resume, replication, assembly, step, checkpoint) one process "
        f"{ref[1]['seconds'] * 1e3:.1f} ms (beside the NCCL child), 1-rank NCCL "
        f"{nccl[1]['seconds'] * 1e3:.1f} ms, {DP_RANKS} gloo ranks "
        f"{max(g[1]['seconds'] for g in gloo) * 1e3:.1f} ms; first net-batch "
        f"{ref[0]['seconds'] * 1e3:.1f} / {nccl[0]['seconds'] * 1e3:.1f} / "
        f"{max(g[0]['seconds'] for g in gloo) * 1e3:.1f} ms; children {t1 - t0:.1f} s "
        f"(two at once) and {t2 - t1:.1f} s | {card}")


def traced_kernels(path):
    """Of a Chrome trace: the names of its kernel events, and the launches
    it recorded on the host (CUDA runtime or driver calls) that have no
    kernel event: their number, whether they are the window's first
    launches, and the ms from the window's first launch to the last of
    them."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    seen = {e.get("args", {}).get("correlation") for e in kernels}
    launches = sorted((e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and "LaunchKernel" in e.get("name", "")), key=lambda e: e["ts"])
    lost = [i for i, e in enumerate(launches)
            if e.get("args", {}).get("correlation") not in seen]
    span_ms = (launches[lost[-1]]["ts"] - launches[0]["ts"]) / 1e3 if lost else 0.0
    return [e["name"] for e in kernels], len(lost), lost == list(range(len(lost))), span_ms


def profiling(card, weights_path, imgs, work, e2e_ms):
    """(d) StepTimer with CUDA events around 5 detects after 2, beside phase
    5's e2e; trace() around one int8 detect, bare and then behind 64
    spinning kernels and a synchronize (a profiler window of this
    long-lived process has lost the kernel events of its first launches,
    whichever kernels they are: the same number of them bare as behind 16
    spinning kernels of 8 ms in all, which were all lost), names every
    kernel of the detect; each window's lost launches are printed."""
    from yolo_v3_tpu_torch.detector import Detector
    from yolo_v3_tpu_torch.ops.entry_kernel import fused_entry
    from yolo_v3_tpu_torch.ops.letterbox import letterbox_batch
    from yolo_v3_tpu_torch.utils.config import YoloConfig
    from yolo_v3_tpu_torch.utils.profiling import StepTimer, trace

    config = YoloConfig()
    q = os.path.join(work, "cli", "q.npz")
    for precision, det in (
            ("int8", Detector.from_quantized(q, config, device="cuda")),
            ("bf16", Detector.from_darknet_weights(weights_path, config, device="cuda",
                                                   precision="bf16"))):
        timer = StepTimer(warmup=2)
        for _ in range(7):
            with timer.step(n_items=len(imgs)):
                timer.mark(det.detect(imgs))
        s = timer.summary()
        check(s["steps"] == 5 and s["p50_ms"] > 0, f"StepTimer {precision}: {s}")
        log(f"profiling StepTimer {precision} bs{BATCH} 416 (CUDA events, 5 detects after 2): "
            f"p50 {s['p50_ms']:.3f} ms, p90 {s['p90_ms']:.3f} ms, mean {s['mean_ms']:.3f} ms, "
            f"{s['items_per_sec']:.2f} imgs/sec; phase 5 e2e {e2e_ms[precision]:.3f} ms "
            f"({BATCH * 1000 / e2e_ms[precision]:.2f} imgs/sec) | {card}")
        if precision == "int8":
            # a detect's kernels: the letterbox, the entry and the p2d convs
            # (the blocks' two convs included)
            want = {"letterbox_kernel": 1, "fused_entry": 1,
                    "conv_p2d": INT8_LAUNCHES["conv1x1_p2d"] + INT8_LAUNCHES["conv3x3_p2d"]}
            n_spin = 64
            for lead_in in (False, True):
                logdir = os.path.join(work, f"trace_{'lead_in' if lead_in else 'bare'}")
                before = fused_entry.launches, letterbox_batch.launches
                with trace(logdir) as prof:
                    if lead_in:
                        for _ in range(n_spin):
                            torch.cuda._sleep(2_000_000)        # ~1 ms each
                        torch.cuda.synchronize()
                    det.detect(imgs)
                    torch.cuda.synchronize()
                check((fused_entry.launches, letterbox_batch.launches)
                      == (before[0] + 1, before[1] + 1),
                      "trace: one fused_entry and one letterbox launch in one detect")
                names, n_lost, first, lost_ms = traced_kernels(
                    os.path.join(logdir, "trace.json"))
                found = {k: sum(k in n for n in names) for k in want}
                spun = sum("spin_kernel" in n for n in names)
                device_us = sum(e.self_device_time_total for e in prof.key_averages()
                                if e.device_type == torch.autograd.DeviceType.CUDA)
                window = (f"behind {n_spin} spinning kernels ({spun} of them in the trace)"
                          if lead_in else "bare")
                log(f"profiling trace() around one int8 detect, {window}: {len(names)} kernel "
                    f"events, the detect's {found} (launched {want}); {n_lost} recorded launches "
                    f"without a kernel event ({'the window' if first else 'not all the window'}"
                    f"'s first, issued over {lost_ms:.3f} ms); device time "
                    f"{device_us / 1e3:.3f} ms | {card}")
            check(found == want and device_us > 0,
                  f"trace behind the lead-in: kernels {found}, want {want}; device time "
                  f"{device_us} us")
        del det
        torch.cuda.empty_cache()


def cli_dp_profiling_path(card, weights_path, imgs, qtree, work, eval_map, e2e_ms):
    """Phase 9: the CLI, data parallelism and profiling."""
    t0 = time.perf_counter()
    training = start_cli_training(work)
    cli_serving(card, weights_path, imgs, qtree, work, eval_map)
    t1 = time.perf_counter()
    cli_training(card, training)
    t2 = time.perf_counter()
    data_parallel(card, weights_path, work)
    t3 = time.perf_counter()
    profiling(card, weights_path, imgs, work, e2e_ms)
    log(f"cli, dp and profiling phase: {time.perf_counter() - t0:.1f} s (cli serving "
        f"{t1 - t0:.1f} s beside cli training's first children, then cli training "
        f"{t2 - t1:.1f} s, dp {t3 - t2:.1f} s) | {card}")


# ---------------------------------------------------------------------------
# Phase 10: the mesh's space axis (height sharding) and data-parallel serving
# ---------------------------------------------------------------------------

SPACE_RANKS = 2             # 2 gloo ranks sharing card 0, as phase 9's
# each rank's launches in one forward: at space 2 every rank runs every layer
# on its stripe; at data 2 every rank runs the whole net on its 4 images
SPACE_LAUNCHES = {"bf16": dict(BF16_LAUNCHES, fused_entry=0, res_block_p2d=0),
                  "fp32": dict(fused_res_block=23, fused_entry=0, conv1x1_p2d=0,
                               conv3x3_p2d=0, res_block_p2d=0, conv_down=0),
                  "int8": dict(INT8_LAUNCHES, fused_res_block=0, conv_down=0)}
SPACE_LAUNCHES["int8u8"] = SPACE_LAUNCHES["int8"]      # the uint8 feed: the same kernels
# phase 3's tolerances per kernel and input type (int8: bit-equal)
SPY_TOL = {("fused_res_block", torch.float32): TOL[torch.float32],
           ("fused_res_block", torch.bfloat16): TOL[torch.bfloat16],
           ("conv1x1_p2d", torch.bfloat16): P2D_BF16_TOL,
           ("conv3x3_p2d", torch.bfloat16): P2D_BF16_TOL,
           ("conv_down", torch.bfloat16): P2D_BF16_TOL,
           **{(k, torch.int8): dict(rtol=0.0, atol=0.0)
              for k in ("conv1x1_p2d", "conv3x3_p2d", "res_block_p2d", "fused_entry")}}


def replay_border(filled, hp, wp):
    """A ``border`` callable for ``res_block_p2d`` that writes the top and
    bottom border rows of ``filled`` (the 1x1's output as a launch under
    ``space`` had it after its halo) into the 1x1's output: that launch's
    neighbour rows, with no collective, so that one rank can check and time
    the block alone."""
    def fill(mid):
        v, f = (t.view(-1, hp, wp, t.shape[-1]) for t in (mid, filled))
        v[:, 0], v[:, -1] = f[:, 0], f[:, -1]
        return mid
    return fill


def spy_kernels(model):
    """Wrap the model's kernel calls (float: the residual blocks through
    ``darknet.fused_res_block``, the p2d convs through each ``_P2dConv``,
    and in bf16 the stem and downs through ``darknet.CD.conv_down``; int8:
    ``quantized.KERNELS``) to keep the inputs and
    output of the first launch at each shape and count the launches there;
    returns (the captures, a function that undoes the wrapping).  The
    wrappers call the kernel wrappers as they are, so launch counts hold.
    An int8 block's ``border`` (its halo between the two launches under
    ``space``) is kept as :func:`replay_border` of what it wrote."""
    from yolo_v3_tpu_torch.models import darknet as D
    from yolo_v3_tpu_torch.models import quantized as Q
    from yolo_v3_tpu_torch.ops import conv_down as CD

    seen = {}

    def wrap(name, fn, plain):
        def run(*args, **kw):
            filled, border = [], kw.get("border")
            if border is not None:
                def keep(mid):
                    filled.append(border(mid))
                    return filled[-1]
                kw = dict(kw, border=keep)
            out = fn(*args, **kw)
            key = (name,) + tuple(tuple(a.shape) if torch.is_tensor(a) else a
                                  for a in args if torch.is_tensor(a) or isinstance(a, int))
            if key not in seen:
                kept = {k: v.clone() if torch.is_tensor(v) else v for k, v in kw.items()}
                if filled:
                    kept["border"] = replay_border(filled[0].clone(), args[-2], args[-1])
                seen[key] = [plain, [a.clone() if torch.is_tensor(a) else a for a in args],
                             kept, out.clone(), 0]
            seen[key][4] += 1
            return out
        return run

    block, kernels = D.fused_res_block, Q.KERNELS
    D.fused_res_block = wrap("fused_res_block", block, D.fused_res_block_ref)
    # the model's view of ops/conv_down.py, so that the kernel wrapper's own
    # module (and its launch counter) stays as it is
    D.CD = types.SimpleNamespace(**dict(vars(CD), conv_down=wrap("conv_down", CD.conv_down,
                                                                 CD.conv_down_ref)))
    Q.KERNELS = Q.Int8Ops(*(wrap(name, fn, plain) for name, fn, plain in zip(
        ("fused_entry", "conv1x1_p2d", "conv3x3_p2d", "res_block_p2d"), kernels, Q.PLAIN)))
    convs = [m for m in model.modules() if isinstance(m, D._P2dConv)]
    fns = [m.fns for m in convs]
    for m in convs:
        m.fns = (wrap("conv3x3_p2d" if m.taps == 9 else "conv1x1_p2d", *m.fns), m.fns[1])

    def undo():
        D.fused_res_block, Q.KERNELS, D.CD = block, kernels, CD
        for m, f in zip(convs, fns):
            m.fns = f

    return seen, undo


def launch_cost(name, args, out):
    """(operations, bytes, peak kind) of one launch, counted as phase 3
    counts them: each input read once, each output written once."""
    from yolo_v3_tpu_torch.ops import entry_kernel as EK

    x = args[0]
    if name == "fused_res_block":
        b, h, w, c = x.shape
        cmid = args[1].shape[-1]
        return (2 * b * h * w * (c * cmid + 9 * cmid * c),
                x.element_size() * (2 * b * h * w * c + 10 * c * cmid + cmid + c),
                NAMES[x.dtype])
    kind = "int8" if x.dtype == torch.int8 else "bf16"
    if name == "conv_down":                     # x and out NCHW, a 3x3 weight
        b, n, ho, wo = out.shape
        return (2 * b * ho * wo * n * 9 * x.shape[1],
                2 * (x.numel() + args[1].numel() + out.numel()) + 4 * n, kind)
    if name == "fused_entry":
        b, h, w = out.shape[:3]                 # a stripe's window is not square
        ops = sum(2 * b * h * w * (4 if k == "stem" else 1) * kh * kw * cin * cout
                  for k, (kh, kw, cin, cout) in EK.SHAPES.items())
        return ops, x.numel() + out.numel() + sum(
            p["w"].numel() + 8 * p["m"].numel() for p in args[1].values()), kind
    hp, wp = args[-2], args[-1]
    rows, c = x.shape
    inner = rows // (hp * wp) * (hp - 2) * (wp - 2)
    if name == "res_block_p2d":
        return (2 * inner * 10 * c * (c // 2),
                2 * x.numel() + args[1].numel() + args[4].numel() + 8 * (c // 2 + c), kind)
    taps, n = (9 if name == "conv3x3_p2d" else 1), args[2].shape[0]
    ops = 2 * inner * taps * c * n
    if kind == "bf16":
        return ops, 2 * (rows * c + args[1].numel() + rows * n) + 8 * n, kind
    return ops, rows * c + args[1].numel() + 8 * n + rows * n * out.element_size(), kind


def check_and_time(seen):
    """Each captured launch against its plain version on the same inputs, at
    phase 3's tolerances, with its launch plan (the residual block's cluster
    size and tile geometry; the p2d kernel's tiles, checked against
    ``plan_tiles`` by
    :func:`plan_line`) and the device ms of the kernel and of the plain
    version at that shape beside the bound: one dict a shape."""
    from yolo_v3_tpu_torch.ops import conv_down as CD
    from yolo_v3_tpu_torch.ops.fused_res_block import plan as res_plan

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kernels = kernel_counters()
    out = []
    for key, (plain, args, kw, got, count) in seen.items():
        name, x = key[0], args[0]
        want = plain(*args, **kw)
        tol = SPY_TOL[(name, x.dtype)]
        diff = (got.float() - want.float()).abs()
        ok = bool((diff <= tol["atol"] + tol["rtol"] * want.float().abs()).all())
        if name == "fused_res_block":
            p = res_plan(*x.shape, args[1].shape[-1], x.dtype)
            plan = f"cluster {p['cluster']} {p['geometry']}"
        elif name in ("conv1x1_p2d", "conv3x3_p2d"):
            plan = "tiles " + plan_line(x.shape[0], x.shape[1], args[2].shape[0],
                                        9 if name == "conv3x3_p2d" else 1, x.dtype, sms)[0]
        elif name == "conv_down" and x.shape[1] != CD.STEM_CHANNELS:
            pad = args[4] if isinstance(args[4], int) else args[4][0]
            plan = f"tiles {CD.plan_on_device(*x.permute(0, 2, 3, 1).shape, got.shape[1], pad)}"
        else:
            plan = ""
        ops, nbytes, kind = launch_cost(name, args, got)
        b_ms, by = bound(ops, nbytes, kind)
        out.append(dict(name=name, shape=list(x.shape), dtype=str(x.dtype).split(".")[-1],
                        count=count, max_abs_err=float(diff.max()), ok=ok, plan=plan,
                        ms=device_ms(lambda: kernels[name](*args, **kw)),
                        plain_ms=device_ms(lambda: plain(*args, **kw)),
                        bound_ms=b_ms, bound_by=by))
    return out


def space_worker(weights_path, work):
    """Child process of phase 10 (``--space-worker``): one of 2 gloo ranks on
    card 0.  (a) ``Detector(mesh=(2, 1))`` in bf16, fp32 and int8 (phase
    9's artifact) on phase 4's 8 images, 4 a rank; (b) ``Detector(mesh=(1,
    2))`` in bf16, fp32 and int8 on the float feed and on the uint8 feed
    (``int8u8``: ``resize_on_device=False``, the host's uint8 letterbox),
    each launch's inputs kept; (c) ``train(mesh=(1,
    2))`` for one fp32 net-batch of phase 7's scenes with a checkpoint.
    Writes ``space/rank<r>.npz`` (rows, heads) and ``space/rank<r>.json``
    (launch counts, each kept launch against its plain version, ms, the
    training digest and stats)."""
    from yolo_v3_tpu_torch.data.sampler import CyclicSampler
    from yolo_v3_tpu_torch.detector import Detector
    from yolo_v3_tpu_torch.parallel import distributed as dist
    from yolo_v3_tpu_torch.parallel import mesh as M
    from yolo_v3_tpu_torch.train.loop import train
    from yolo_v3_tpu_torch.utils.config import TrainConfig, YoloConfig

    torch.use_deterministic_algorithms(True, warn_only=True)
    ctx = dist.initialize(backend="gloo")
    dp = dist.make_global_mesh(device="cuda:0")           # the ranks share one card
    sp = dist.make_global_mesh(space=SPACE_RANKS, device="cuda:0")
    check(dp.shape == (2, 1) and sp.shape == (1, 2), f"meshes {dp.shape} {sp.shape}")
    config = YoloConfig()
    imgs = make_images()
    out = os.path.join(work, "space")
    arrays, info = {}, {"launches": {}, "spied": {}, "ms": {}}
    counters = kernel_counters()

    def detector(precision, mesh):
        if precision.startswith("int8"):
            return Detector.from_quantized(os.path.join(work, "cli", "q.npz"), config,
                                           mesh=mesh, resize_on_device=precision == "int8")
        return Detector.from_darknet_weights(weights_path, config, precision=precision,
                                             mesh=mesh)

    for tag, mesh, precisions in (("data", dp, ("bf16", "fp32", "int8")),
                                  ("space", sp, ("bf16", "fp32", "int8", "int8u8"))):
        for precision in precisions:
            run = f"{tag}/{precision}"
            det = detector(precision, mesh)
            seen, undo = spy_kernels(det.model)
            try:
                rows, info["launches"][run] = counted(counters, lambda: det.detect(imgs))
            finally:
                undo()
            # each kept launch checked and timed with the card to this rank alone
            for r in range(SPACE_RANKS):
                if r == ctx.process_id:
                    info["spied"][run] = check_and_time(seen)
                torch.distributed.barrier()
            del seen
            arrays.update({f"{run}/rows/{i}": r for i, r in enumerate(rows)})
            x, _ = det.preprocess(imgs[M.data_slice(mesh, len(imgs))])
            with torch.inference_mode():
                xd = x if x.dtype == torch.uint8 else x.to(det.compute_dtype)
                heads = (det.model(M.stripe(mesh, xd, 1).contiguous(), mesh=mesh)
                         if tag == "space" else det.model(xd))
            arrays.update({f"{run}/heads/{i}": h.float().cpu().numpy()
                           for i, h in enumerate(heads)})
            info["ms"][run] = cuda_ms(lambda: det.detect(imgs), iters=3, warmup=1)
            del det, heads
            torch.cuda.empty_cache()

    tcfg = TrainConfig(batch_size=TRAIN_BATCH, net_subdivisions=TRAIN_SUBDIVISIONS)
    dataset = SceneDataset(TRAIN_IMAGES, config.num_classes)
    params, state = seed_trees(weights_path, config.num_classes)
    sampler = CyclicSampler(len(dataset), TRAIN_BATCH, shuffle=False, dim=(416, 416))
    data = dist.make_data_helper(dataset, sampler, ctx, space=SPACE_RANKS, max_net_batches=1,
                                 net_subdivisions=TRAIN_SUBDIVISIONS, prefetch=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p, s, _, recorder = train(data, params, state, config, tcfg, model_id="space",
                              weight_dir=os.path.join(out, "ckpt"), mesh=sp,
                              log_fn=lambda line: None)
    torch.cuda.synchronize()
    info["train"] = {"digest": digest(p, s), "seconds": time.perf_counter() - t0,
                     "stats": dict(recorder.current_stats) if ctx.process_id == 0 else None}
    np.savez(os.path.join(out, f"rank{ctx.process_id}.npz"), **arrays)
    with open(os.path.join(out, f"rank{ctx.process_id}.json"), "w") as f:
        json.dump(info, f)
    torch.distributed.destroy_process_group()


def kept_launches(card, run, rank, kept):
    """Check a rank's kept launches of one run (each within phase 3's
    tolerance of its plain version), log them, and return per kernel its
    per-forward sums: {kernel: {launches, ms, plain_ms, bound_ms, bound_by,
    max_abs_err}}."""
    per = {}
    for k in kept:
        check(k["ok"], f"{run} rank {rank}: {k['name']} at {k['shape']} {k['dtype']} against "
                       f"its plain version: max abs err {k['max_abs_err']} beyond phase 3's "
                       f"tolerance")
        acc = per.setdefault(k["name"], dict(launches=0, ms=0.0, plain_ms=0.0,
                                             max_abs_err=0.0, _bound_shares={
                                                 "operations": 0.0, "bytes": 0.0}))
        acc["launches"] += k["count"]
        acc["ms"] += k["count"] * k["ms"]
        acc["plain_ms"] += k["count"] * k["plain_ms"]
        acc["bound_ms"] = acc.get("bound_ms", 0.0) + k["count"] * k["bound_ms"]
        acc["_bound_shares"][k["bound_by"]] += k["count"] * k["bound_ms"]
        acc["max_abs_err"] = max(acc["max_abs_err"], k["max_abs_err"])
    log(f"{run} rank {rank}, each kernel at each shape it ran at (x launches a forward): "
        + "; ".join(f"{k['name']} {k['shape']} {k['dtype']} {k['plan']} x{k['count']} "
                    f"err {k['max_abs_err']:.1e} kernel_ms={k['ms']:.4f} "
                    f"plain_ms={k['plain_ms']:.4f} bound_ms={k['bound_ms']:.4f} "
                    f"({k['bound_by']})" for k in kept) + f" | {card}")
    for name, acc in per.items():
        finish_bound(acc)
        log(f"{run} rank {rank} per forward: {name} x{acc['launches']} kernel_ms="
            f"{acc['ms']:.4f} plain_ms={acc['plain_ms']:.4f} bound_ms={acc['bound_ms']:.4f} "
            f"({acc['bound_by']}) | {card}")
    return per


def spied_counts_agree(run, rank, per, counts):
    """Check that the launches the spy saw in a run (``per``, from
    :func:`kept_launches`) are the ones the kernel wrappers counted in it
    (``counts``).  A ``res_block_p2d`` launches one ``conv1x1_p2d`` and one
    ``conv3x3_p2d``, which the wrappers count and the spy, wrapping only the
    block, does not see."""
    spied = {k: v["launches"] for k, v in per.items()}
    blocks = spied.get("res_block_p2d", 0)
    want = {k: n - (blocks if k in ("conv1x1_p2d", "conv3x3_p2d") else 0)
            for k, n in counts.items()}
    want = {k: n for k, n in want.items() if n}
    check(spied == want, f"{run} rank {rank}: the spy saw launches {spied}, the kernel "
                         f"wrappers counted {want}")


def heads_within(got, want, precision):
    """(within phase 5's head bound, max abs err, max|head|): fp32 rtol 1e-3
    and atol 1e-3 * max|head|, bf16 5e-2 * max|head|."""
    scale = float(np.abs(want).max())
    diff = np.abs(got - want)
    ok = (diff.max() <= 5e-2 * scale if precision == "bf16"
          else bool((diff <= 1e-3 * scale + 1e-3 * np.abs(want)).all()))
    return ok, float(diff.max()), scale


def space_path(card, weights_path, imgs, work):
    """Phase 10: data-parallel serving (batch 8 split 4 / 4) in bf16, fp32
    and int8, height-sharded serving (stripes 224 / 192) in bf16, fp32 and
    int8 on both feeds, and one height-sharded fp32 training net-batch of 8 x 2, on 2 gloo ranks
    sharing the card, against one process.  Returns each run's launch
    counts per rank."""
    from yolo_v3_tpu_torch.detector import Detector
    from yolo_v3_tpu_torch.parallel import mesh as M
    from yolo_v3_tpu_torch.train.checkpoint import load_checkpoint
    from yolo_v3_tpu_torch.utils.config import YoloConfig

    t0 = time.perf_counter()
    out = os.path.join(work, "space")
    os.makedirs(out)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(SPACE_RANKS), LOCAL_RANK="0")
    env.pop("LOCAL_WORLD_SIZE", None)
    me = [os.path.abspath(__file__), "--space-worker", weights_path, work]
    procs = {f"space worker (gloo rank {r})": start(me, dict(env, RANK=str(r)))
             for r in range(SPACE_RANKS)}

    # one process on the whole batch, while the ranks run
    config = YoloConfig()
    one = {}
    with torch.inference_mode():
        for precision in ("bf16", "fp32", "int8", "int8u8"):
            det = (Detector.from_quantized(os.path.join(work, "cli", "q.npz"), config,
                                           resize_on_device=precision == "int8")
                   if precision.startswith("int8") else
                   Detector.from_darknet_weights(weights_path, config, precision=precision))
            x, _ = det.preprocess(imgs)
            xd = x if x.dtype == torch.uint8 else x.to(det.compute_dtype)
            one[precision] = (det.detect(imgs), [h.float().cpu().numpy() for h in det.model(xd)],
                              cuda_ms(lambda: det.detect(imgs), iters=3, warmup=1))
            del det
            torch.cuda.empty_cache()
    t1 = time.perf_counter()
    finish_all(procs, timeout=600)
    t2 = time.perf_counter()
    ranks, infos = [], []
    for r in range(SPACE_RANKS):
        with np.load(os.path.join(out, f"rank{r}.npz")) as z:
            ranks.append({k: z[k] for k in z.files})
        with open(os.path.join(out, f"rank{r}.json")) as f:
            infos.append(json.load(f))

    def rows(r, tag, precision):
        return [ranks[r][f"{tag}/{precision}/rows/{i}"] for i in range(len(imgs))]

    per_forward = {}
    for run in infos[0]["spied"]:
        per_forward[run] = [kept_launches(card, run, r, infos[r]["spied"][run])
                            for r in range(SPACE_RANKS)]
        for r in range(SPACE_RANKS):
            spied_counts_agree(run, r, per_forward[run][r], infos[r]["launches"][run])

    # (a) data-parallel serving
    for precision in ("bf16", "fp32", "int8"):
        want_rows, want_heads, one_ms = one[precision]
        for r in range(SPACE_RANKS):
            n = infos[r]["launches"][f"data/{precision}"]
            check(n == SPACE_LAUNCHES[precision],
                  f"dp {precision} rank {r} launches {n}, want {SPACE_LAUNCHES[precision]}")
            check(all(np.array_equal(a, b) for a, b in
                      zip(rows(r, "data", precision), rows(0, "data", precision))),
                  f"dp {precision}: rank {r} returned other rows than rank 0")
        got = rows(0, "data", precision)
        check_rows(got, imgs, config.num_classes)
        equal = all(np.array_equal(a, b) for a, b in zip(got, want_rows))
        if precision == "int8":
            check(equal, "dp int8: rows differ from one process's")
            case = "rows bit-equal to one process's"
        elif equal:
            case = "rows bit-equal to one process's"
        else:
            errs = []
            for r in range(SPACE_RANKS):
                sl = M.data_slice(M.Mesh((2, 1), r, 2, torch.device("cpu")), len(imgs))
                for i, w in enumerate(want_heads):
                    ok, err, scale = heads_within(ranks[r][f"data/{precision}/heads/{i}"],
                                                  w[sl], precision)
                    check(ok, f"dp {precision} rank {r} head{i}: err {err} (max|head| {scale})")
                    errs.append(err)
            check([len(a) for a in got] == [len(b) for b in want_rows],
                  f"dp {precision}: valid rows {[len(a) for a in got]} vs "
                  f"{[len(b) for b in want_rows]}")
            case = (f"the kernels' plan differs with the batch: heads within phase 5's bound "
                    f"(max abs err {max(errs):.3e}), valid rows per image equal")
        log(f"dp serving {precision}: Detector(mesh=(2, 1)) on 8 images, 4 a rank, each rank "
            f"returns all 8 images' rows; {case}; launches per rank "
            f"{infos[0]['launches'][f'data/{precision}']} | {card}")
        log(f"time dp serving {precision} (information: the ranks share one card): detect ms "
            f"per rank {[round(i['ms'][f'data/{precision}'], 3) for i in infos]}, one process "
            f"{one_ms:.3f} | {card}")

    # (b) height-sharded serving: float heads within phase 5's bounds of one
    # process's, int8 heads and rows bit-equal on both feeds
    for precision in ("bf16", "fp32", "int8", "int8u8"):
        want_rows, want_heads, one_ms = one[precision]
        exact = precision.startswith("int8")
        for r in range(SPACE_RANKS):
            n = infos[r]["launches"][f"space/{precision}"]
            check(n == SPACE_LAUNCHES[precision],
                  f"space {precision} rank {r} launches {n}, want {SPACE_LAUNCHES[precision]}")
            check(all(np.array_equal(a, b) for a, b in
                      zip(rows(r, "space", precision), rows(0, "space", precision))),
                  f"space {precision}: rank {r} returned other rows than rank 0")
        errs = []
        for r in range(SPACE_RANKS if exact else 1):
            for i, w in enumerate(want_heads):
                got_h = ranks[r][f"space/{precision}/heads/{i}"]
                if exact:
                    check(np.array_equal(got_h, w), f"space {precision} rank {r} head{i}: not "
                          f"bit-equal to one process's (max abs err "
                          f"{float(np.abs(got_h - w).max())})")
                    continue
                ok, err, scale = heads_within(got_h, w, precision)
                check(ok, f"space {precision} head{i}: err {err} (max|head| {scale})")
                errs.append(err)
        got = rows(0, "space", precision)
        check_rows(got, imgs, config.num_classes)
        if exact:
            check(all(np.array_equal(a, b) for a, b in zip(got, want_rows)),
                  f"space {precision}: rows differ from one process's")
            case = "heads on both ranks and rows bit-equal to one process's"
        else:
            check(all(a.shape == b.shape and np.allclose(a, b, rtol=0, atol=1e-2)
                      for a, b in zip(got, want_rows)),
                  f"space {precision}: rows beyond atol 1e-2 of one process's or other valid "
                  f"counts ({[len(a) for a in got]} vs {[len(b) for b in want_rows]})")
            case = (f"heads within phase 5's bound of one process's (max abs err "
                    f"{', '.join(f'{e:.3e}' for e in errs)}), rows of equal validity within "
                    f"atol 1e-2")
        log(f"space serving {precision}: Detector(mesh=(1, 2)), stripes 224 / 192 rows of 8 "
            f"images: {case}; launches per rank {infos[0]['launches'][f'space/{precision}']}; "
            f"every kernel launch at its stripe shape within phase 3's tolerance of its plain "
            f"version (above) | {card}")
        log(f"time space serving {precision} (information: the ranks share one card): detect "
            f"ms per rank {[round(i['ms'][f'space/{precision}'], 3) for i in infos]}, one "
            f"process {one_ms:.3f} | {card}")

    # (c) height-sharded training, against phase 9's one process on the same
    # model, scenes and net-batch (deterministic algorithms in both)
    check(infos[0]["train"]["digest"] == infos[1]["train"]["digest"],
          "space training: the ranks' params and BN state differ")
    ck = load_checkpoint(os.path.join(out, "ckpt", "space", "yolov3_space_checkpoint_000000.npz"))
    check(ck["mesh_shape"] == (1, SPACE_RANKS), f"space mesh_shape {ck['mesh_shape']}")
    ref = load_checkpoint(os.path.join(work, "dp", "none", "dp", "yolov3_dp_checkpoint_000000.npz"))
    with open(os.path.join(work, "dp", "none.rank0.json")) as f:
        ref_run = json.load(f)[0]
    a, b = flat_trees(ck["params"]), flat_trees(ref["params"])
    err, leaf = max((float(np.abs(a[k] - b[k]).max()), k) for k in b)
    check(err <= 2e-4, f"space training: params {err} from one process's ({leaf})")
    rel = {}
    for k, v in ref_run["stats"].items():
        g = infos[0]["train"]["stats"][k]
        rel[k] = abs(g - v) / max(abs(v), 1e-12)
        if k in ("nCorrect", "nGT"):
            check(g == v, f"space training: {k} {g} vs {v}")
        else:
            check(abs(g - v) <= 2e-4 * abs(v) + 2e-4, f"space training: {k} {g} vs {v}")
    log(f"space train(mesh=(1, 2)) YOLOv3-416 fp32, net-batch {TRAIN_BATCH} x "
        f"{TRAIN_SUBDIVISIONS} in stripes of 224 / 192 rows: ranks bit-equal; against one "
        f"process (phase 9): params within {err:.2e} ({leaf}; atol 2e-4), stats within rtol "
        f"2e-4 ({', '.join(f'{k} {v:.1e}' for k, v in rel.items() if k != 'nGT')}); "
        f"checkpoint mesh_shape {ck['mesh_shape']} | {card}")
    log(f"time space training (information: the ranks share one card): the net-batch "
        f"(replication, assembly, step, checkpoint) {max(i['train']['seconds'] for i in infos) * 1e3:.1f} "
        f"ms a rank, one process {ref_run['seconds'] * 1e3:.1f} ms (phase 9) | {card}")
    log(f"space phase: {time.perf_counter() - t0:.1f} s (one process {t1 - t0:.1f} s beside "
        f"the ranks, then the ranks {t2 - t1:.1f} s more) | {card}")
    return {run: {name: dict(launches=infos[0]["launches"][run][name],
                             per_rank=[pf[name] for pf in per_forward[run] if name in pf])
                  for name in infos[0]["launches"][run]}
            for run in infos[0]["launches"]}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this check runs only on a GPU")
    import yolo_v3_tpu_torch
    from yolo_v3_tpu_torch.ops import _build

    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:     # one nvcc per source
        libs = list(pool.map(_build.build, SOURCES))
    for name in SOURCES:
        _build.load(name)
    log(f"build: {', '.join(SOURCES)} {time.perf_counter() - t0:.2f} s "
        f"(set-up, in parallel) | {card}")
    check_build(card, libs)

    summary = check_kernel(card)
    summary_bf16 = check_bf16_p2d_kernels(card)
    summary_i8 = check_int8_kernels(card)
    summary_down = conv_down_path(card)

    work = os.path.join(os.path.dirname(os.path.abspath(yolo_v3_tpu_torch.__file__)),
                        "build", "smoke")
    os.makedirs(work, exist_ok=True)
    try:
        weights_path = os.path.join(work, "yolov3_seed0.weights")
        imgs = make_images()
        e2e = {}
        launches, fp32_rows = main_path(card, weights_path, imgs, e2e)
        launches_i8, qtree, x_i8 = int8_path(card, weights_path, imgs, fp32_rows, e2e)
        letterbox_entry = letterbox_path(card, imgs, {
            "bf16": launches[torch.bfloat16]["letterbox"],
            "fp32": launches[torch.float32]["letterbox"], "int8": launches_i8["letterbox"]})
        options = serving_options_path(card, weights_path, imgs, qtree, x_i8, summary_i8)
        train_summary = training_path(card, weights_path, imgs, work)
        t8 = time.perf_counter()
        host_library(card)
        eval_map = eval_path(card, weights_path, qtree, work)
        t_data = time.perf_counter()
        data_train_path(card, weights_path, work, train_summary)
        log(f"eval and data phase: {time.perf_counter() - t8:.1f} s (eval "
            f"{t_data - t8:.1f} s) | {card}")
        cli_dp_profiling_path(card, weights_path, imgs, qtree, work, eval_map, e2e)
        mesh_launches = space_path(card, weights_path, imgs, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    v4_kernels, v4_launches = yolov4_path(card)

    kernels = [dict(name=f"fused_res_block_{NAMES[dt]}", route="cuda",
                    source="yolo_v3_tpu_torch/csrc/fused_res_block.cu",
                    replaces="yolo_v3_tpu/ops/pallas_kernels.py:97",
                    launches=launches[dt]["fused_res_block"], **summary[dt])
               for dt in (torch.float32, torch.bfloat16)]
    kernels[0]["design"] = ("3xTF32 on wgmma m64nNk8 (A split in registers, B hi / lo "
                            "planes by TMA from a producer warpgroup), fresh partial sums "
                            "in two banks, 8x8 or flat 64-pixel tiles, conv1 shared in a "
                            "cluster")
    p2d = (("conv1x1_p2d", "csrc/conv_p2d.cu", "fused_conv.py:131"),
           ("conv3x3_p2d", "csrc/conv_p2d.cu", "fused_conv.py:236"),
           ("res_block_p2d", "ops/fused_conv.py", "fused_conv.py:313"))
    for mode, counts, measured in (("bf16", launches[torch.bfloat16], summary_bf16),
                                   ("int8", launches_i8, summary_i8)):
        for name, source, replaces in p2d + ((("fused_entry", "csrc/fused_entry.cu",
                                                "entry_kernel.py:193"),)
                                              if mode == "int8" else ()):
            entry = dict(name=f"{name}_{mode}", route="cuda",
                         source=f"yolo_v3_tpu_torch/{source}",
                         replaces=f"yolo_v3_tpu/ops/{replaces}",
                         launches=counts[name], **measured[f"{name}_{mode}"])
            if name == "res_block_p2d":
                entry["composition_of"] = [f"conv1x1_p2d_{mode}", f"conv3x3_p2d_{mode}"]
            if name == "fused_entry":
                entry["design"] = ("row-streaming strip walk, wgmma s8 on swizzled row rings, "
                                   "weights by TMA from a producer warp")
            kernels.append(entry)
    # phase 10's runs, each counted from 0 on each rank (data/...: 4 of the 8
    # images a rank; space/...: a stripe of every image): rank 0's launches,
    # and each rank's per-forward device ms, plain ms and bound at the shapes
    # it ran
    for entry in kernels:
        name, mode = entry["name"].rsplit("_", 1)
        precision = {"f32": "fp32"}.get(mode, mode)
        entry["mesh_runs"] = {run: kernels_of[name] for run, kernels_of in mesh_launches.items()
                              if run.split("/")[1] in (precision, precision + "u8")}
    kernels += options
    kernels.append(letterbox_entry)
    kernels += v4_kernels
    # launches: one detect's, counted in phase 4 (YOLOv3) and phase 11 (YOLOv4)
    down_launches = {"yolov3-416": launches[torch.bfloat16]["conv_down"],
                     "yolov4-608": v4_launches["conv_down"]}
    # and YOLOv3's in phase 10's bf16 runs, as the other kernels' mesh_runs
    down_mesh = {"yolov3-416": {run: kernels_of["conv_down"]
                                for run, kernels_of in mesh_launches.items()
                                if run.split("/")[1] == "bf16"}}
    kernels += [dict(name=f"conv_down_bf16_{model}", route="cuda",
                     source="yolo_v3_tpu_torch/csrc/conv_down.cu", replaces=None,
                     batch=BATCH, launches=down_launches[model], **acc,
                     **({"mesh_runs": down_mesh[model]} if model in down_mesh else {}))
                for model, acc in summary_down.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device_entry()}))


def device_entry():
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def yolov4_main():
    """Phase 11 alone (``--yolov4``): builds the three sources it runs."""
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this check runs only on a GPU")
    from yolo_v3_tpu_torch.ops import _build

    card = card_line()
    log(card)
    sources = ("fused_res_block", "conv_p2d", "letterbox", "conv_down")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:     # one nvcc per source
        list(pool.map(_build.build, sources))
    for name in sources:
        _build.load(name)
    log(f"build: {', '.join(sources)} {time.perf_counter() - t0:.2f} s | {card}")
    print(json.dumps({"kernels": yolov4_path(card)[0]}))
    print(json.dumps({"ok": True, "device": device_entry()}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resume-check"]:
        resume_check(*sys.argv[2:4])
    elif sys.argv[1:2] in (["--cli"], ["--cli-deterministic"]):
        cli_child(sys.argv[2:], sys.argv[1] == "--cli-deterministic")
    elif sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(*sys.argv[2:5])
    elif sys.argv[1:2] == ["--space-worker"]:
        space_worker(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--yolov4"]:
        yolov4_main()
    elif sys.argv[1:2] == ["--conv-down"]:
        conv_down_main()
    else:
        main()
