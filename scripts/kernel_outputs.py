"""Outputs of the port's int8 and residual-block kernels on seeded inputs,
to show that a change leaves them bit-identical.

    (cd <tree> && python3 <this script> out.pt)   # save, from a tree's root
    python3 scripts/kernel_outputs.py a.pt b.pt   # compare two saved files

Saves int8 conv1x1_p2d / conv3x3_p2d (7 shapes, int8 and bf16 out), bf16
conv1x1_p2d / conv3x3_p2d (6 shapes), fused_entry and the fp32 and bf16
fused residual block at the 5 YOLOv3-416 shapes, at batch 8, computed by
the ``yolo_v3_tpu_torch`` of the current directory on one CUDA device
through its public wrappers only, so that the script runs in an older tree
too.  Comparing prints each output's verdict and exits non-zero unless all
are bit-identical.
"""
import os
import sys

import torch


def compare(path_a, path_b):
    a, b = torch.load(path_a), torch.load(path_b)
    bad = [k for k in a if k not in b or not torch.equal(a[k], b[k])]
    for k in a:
        print(f"same {k}: {'bit-identical' if k not in bad else 'DIFFERENT'}")
    return 1 if bad or a.keys() != b.keys() else 0


def save(path):
    sys.path.insert(0, os.getcwd())
    from yolo_v3_tpu_torch.ops import entry_kernel as EK
    from yolo_v3_tpu_torch.ops import fused_conv as FC
    from yolo_v3_tpu_torch.ops.fused_res_block import fused_res_block

    if not os.path.dirname(FC.__file__).startswith(os.getcwd()):
        raise RuntimeError(f"run from a tree's root: imported {FC.__file__}")
    g = torch.Generator().manual_seed(5)
    out = {}

    def i8(*shape, lo=-20, hi=20):
        return torch.randint(lo, hi, shape, generator=g, dtype=torch.int8).cuda()

    def mult(n, k):
        return ((0.5 + torch.rand(n, generator=g)) * 40 / (k ** 0.5 * 133)).cuda()

    for taps, hw, c, n, res, od in [(1, 13, 1024, 512, False, "i8"),
                                    (9, 13, 512, 1024, True, "i8"),
                                    (1, 52, 256, 255, False, "bf16"),
                                    (9, 52, 128, 256, False, "i8"),
                                    (1, 104, 128, 64, False, "i8"),
                                    (9, 26, 256, 512, True, "i8"),
                                    (9, 3, 40, 36, True, "bf16")]:
        x2d = FC.pack_p2d(i8(8, hw, hw, c))
        w = i8(*((3, 3, c, n) if taps == 9 else (c, n)))
        m, b = mult(n, taps * c), (3 * torch.randn(n, generator=g)).cuda()
        r = i8(x2d.shape[0], n, lo=-127, hi=128) if res else None
        _, hp, wp = FC.p2d_geometry(8, hw, hw)
        fn = FC.conv3x3_p2d if taps == 9 else FC.conv1x1_p2d
        out[f"int8 {taps} {hw} {c}->{n} {od}"] = fn(
            x2d, w, m, b, hp, wp, leaky=od == "i8", residual=r, res_scale=0.7,
            out_dtype=torch.int8 if od == "i8" else torch.bfloat16)
    for taps, hw, c, n, res, leaky in [(1, 13, 1024, 512, False, True),
                                       (9, 13, 512, 1024, False, True),
                                       (1, 26, 512, 255, False, False),
                                       (9, 26, 256, 512, True, True),
                                       (1, 52, 256, 128, False, True),
                                       (9, 52, 128, 256, False, True)]:
        def bf(*shape, scale):
            return (torch.randn(*shape, generator=g) * scale).to("cuda", torch.bfloat16)

        x2d = FC.pack_p2d(bf(8, hw, hw, c, scale=0.5))
        w = bf(*((3, 3, c, n) if taps == 9 else (c, n)), scale=(taps * c) ** -0.5)
        b = (0.1 * torch.randn(n, generator=g)).cuda()
        r = bf(x2d.shape[0], n, scale=1.0) if res else None
        _, hp, wp = FC.p2d_geometry(8, hw, hw)
        fn = FC.conv3x3_p2d if taps == 9 else FC.conv1x1_p2d
        out[f"bf16 {taps} {hw} {c}->{n}"] = fn(
            x2d, w, torch.ones(n, device="cuda"), b, hp, wp, leaky=leaky, residual=r,
            out_dtype=torch.bfloat16)
    xb = i8(8, 210, 210, 12, lo=-127, hi=128)
    qs2d = {}
    for name, (kh, kw, cin, cout) in EK.SHAPES.items():
        qs2d[name] = {"w": i8(*((cin, cout) if kh == 1 else (kh, kw, cin, cout))),
                      "m": mult(cout, kh * kw * cin),
                      "b": (3 * torch.randn(cout, generator=g)).cuda()}
    out["fused_entry"] = EK.fused_entry(xb, qs2d, 0.6)
    for dtype in (torch.float32, torch.bfloat16):
        for h, c in ((208, 64), (104, 128), (52, 256), (26, 512), (13, 1024)):
            def t(*shape, scale):
                return (torch.randn(*shape, generator=g) * scale).to("cuda", dtype)

            args = (t(8, h, h, c, scale=0.5), t(c, c // 2, scale=c ** -0.5),
                    t(c // 2, scale=0.1), t(3, 3, c // 2, c, scale=(9 * c // 2) ** -0.5),
                    t(c, scale=0.1))
            out[f"fused_res_block {dtype} {h} {c}"] = fused_res_block(*args)
    torch.cuda.synchronize()
    torch.save({k: v.cpu() for k, v in out.items()}, path)
    print(f"saved {len(out)} outputs to {path}")
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3:
        sys.exit(compare(sys.argv[1], sys.argv[2]))
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        sys.exit("usage on a CUDA host: kernel_outputs.py OUT.pt | kernel_outputs.py A.pt B.pt")
    sys.exit(save(sys.argv[1]))
