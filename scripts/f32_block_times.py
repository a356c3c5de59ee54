"""Time the fp32 residual-block kernel on the card, and measure its error
against the depth of its partial sums.

    python3 scripts/f32_block_times.py [--tree DIR] [--kpart-sweep]

Imports ``yolo_v3_tpu_torch`` from ``DIR`` (default: this checkout), so
that two trees can be compared in one call on one card: unpack the other
with ``git archive`` into a git-ignored directory and run both, in turns.
For every fp32 block shape ``chip_smoke.py`` launches (YOLOv3-416 at batch
8; phase 10's batch 4 and 224 / 192-row stripes) it prints one JSON line:
the kernel against its plain version (rtol = atol = 1e-4), the device ms of
both (CUDA-graph replay), the bound (3 TF32 products at 495 TFLOP/s), the
launch plan where the tree reports one, and the card's name and power
limit.  ``--kpart-sweep`` runs [8, 13, 13, 1024] (conv2's K = 4608) at
every partial depth (steps of K = 32 a partial sum spans) and prints the
kernel's and the plain version's error against float64.
"""

import argparse
import json
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

BLOCKS_416 = ((208, 64, 1), (104, 128, 2), (52, 256, 8), (26, 512, 8), (13, 1024, 4))
# (batch, H, W, C, launches a forward): phase 10's fp32 block shapes
MESH = {
    "data, batch 4": [(4, h, h, c, n) for h, c, n in BLOCKS_416],
    "space, rank 0": [(8, 113, 208, 64, 1), (8, 57, 104, 128, 2), (8, 29, 52, 256, 8),
                      (8, 15, 26, 512, 8), (8, 8, 13, 1024, 4)],
    "space, rank 1": [(8, 97, 208, 64, 1), (8, 49, 104, 128, 2), (8, 25, 52, 256, 8),
                      (8, 13, 26, 512, 8), (8, 7, 13, 1024, 4)],
}
TF32_OPS_PER_S = 495e12 / 3


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
    return start.elapsed_time(end) / iters


def inputs(b, h, w, c, seed):
    """chip_smoke.py's block inputs (phase 3) at any shape."""
    gen = torch.Generator().manual_seed(seed)
    cmid = c // 2

    def t(*shape, scale):
        return (torch.randn(*shape, generator=gen) * scale).to("cuda")

    return (t(b, h, w, c, scale=0.5), t(c, cmid, scale=c ** -0.5), t(cmid, scale=0.1),
            t(3, 3, cmid, c, scale=(9 * cmid) ** -0.5), t(c, scale=0.1))


def float64_block(y, w1, b1, w2, b2):
    x = y.double().permute(0, 3, 1, 2)
    mid = F.conv2d(x, w1.double().t()[:, :, None, None], b1.double())
    mid = torch.where(mid > 0, mid, 0.1 * mid)
    r = F.conv2d(mid, w2.double().permute(3, 2, 0, 1), b2.double(), padding=1)
    return y.double() + torch.where(r > 0, r, 0.1 * r).permute(0, 2, 3, 1)


def times(frb, line):
    for group, shapes in [("416, batch 8", [(8, h, h, c, n) for h, c, n in BLOCKS_416]),
                          *MESH.items()]:
        total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
        for b, h, w, c, n in shapes:
            args = inputs(b, h, w, c, seed=h)
            got = frb.fused_res_block(*args)
            torch.cuda.synchronize()
            want = frb.fused_res_block_ref(*args)
            ok = bool(torch.allclose(got, want, rtol=1e-4, atol=1e-4))
            k_ms = device_ms(lambda: frb.fused_res_block(*args))
            p_ms = device_ms(lambda: frb.fused_res_block_ref(*args))
            cmid = c // 2
            b_ms = 2 * b * h * w * 10 * c * cmid / TF32_OPS_PER_S * 1e3
            plan = (frb.plan(b, h, w, c, cmid) if hasattr(frb, "plan")
                    else {"cluster": frb.cluster_size(b, h, w, c, cmid)})
            print(json.dumps(dict(group=group, shape=[b, h, w, c], launches=n, ok=ok,
                                  max_abs_err=float((got - want).abs().max()), ms=k_ms,
                                  plain_ms=p_ms, bound_ms=b_ms, plan=plan, card=line)),
                  flush=True)
            if not ok:
                raise SystemExit(f"kernel and plain differ at {[b, h, w, c]}")
            for k, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", b_ms)):
                total[k] += n * v
        print(json.dumps(dict(group=group, per_forward=total, card=line)), flush=True)


def kpart_sweep(frb, line):
    b, h, w, c = 8, 13, 13, 1024
    args = inputs(b, h, w, c, seed=h)
    exact = float64_block(*args)
    scale = exact.abs().max().item()
    plain = frb.fused_res_block_ref(*args).double()
    print(json.dumps(dict(sweep="plain fp32 (cuDNN, TF32 off)", shape=[b, h, w, c],
                          max_abs_err=(plain - exact).abs().max().item(), max_abs=scale,
                          card=line)), flush=True)
    steps2 = 9 * (c // 2) // 32
    for kpart in (1, 2, 4, 8, 16, 36, steps2 // 2):
        got = frb._launch(*args, kpart=kpart).double()
        torch.cuda.synchronize()
        err = (got - exact).abs()
        print(json.dumps(dict(sweep="kernel", shape=[b, h, w, c], kpart=kpart,
                              k_per_partial=32 * kpart, max_abs_err=err.max().item(),
                              mean_abs_err=err.mean().item(),
                              within_1e4_of_plain=bool(torch.allclose(
                                  got, plain, rtol=1e-4, atol=1e-4)),
                              ms=device_ms(lambda: frb._launch(*args, kpart=kpart)),
                              card=line)), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--kpart-sweep", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("f32_block_times: no CUDA device")
    sys.path.insert(0, os.path.abspath(a.tree))
    from yolo_v3_tpu_torch.ops import fused_res_block as frb
    assert frb.__file__.startswith(os.path.abspath(a.tree)), frb.__file__
    line = card()
    print(json.dumps(dict(tree=a.tree, card=line, torch=torch.__version__)), flush=True)
    if a.kpart_sweep:
        kpart_sweep(frb, line)
    else:
        times(frb, line)


if __name__ == "__main__":
    main()
