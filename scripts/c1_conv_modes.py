"""How the bf16 stem and stride-2 downs can round once, on one NVIDIA GPU.

    python3 scripts/c1_conv_modes.py

At the 6 convs' shapes in YOLOv3-416 at batch 8, on two sets of inputs
(random bf16 inputs and weights, seeded; and the inputs, folded weights and
biases that ``chip_smoke.py``'s seed model and images give the bf16 folded
forward), each way of computing conv + bias + leaky in fp32 with one
rounding to bf16 is held against an fp32 conv with TF32 off (bias and leaky
in fp32, one rounding): the share of outputs that differ, and the device
time (CUDA-graph replay) beside the double-rounding bf16 conv + leaky:
- tf32: one fp32 conv with TF32 allowed on the bf16 values;
- tf32 deterministic: the same with ``cudnn.deterministic`` (no algorithm
  search, no split reductions);
- tf32 split K 64 / 32: the input channels in chunks of 64 (K = 576 a
  chunk) or 32, one TF32 conv each, the partial sums added in fp32;
- fp32: TF32 off (the reference's own algorithm);
and, on the forward's inputs, the folded model's own conv module
(``models/darknet.py::_ConvBias``: the kernel of ``ops/conv_down.py``) and
its plain version (chunks of ``TF32_K_CHANNELS``).
Needs CUDA; imports no JAX.
"""

import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as S  # noqa: E402
from yolo_v3_tpu_torch.utils.precision import full_fp32  # noqa: E402

CONVS = (("stem", 3, 32, 1, 416), ("down0", 32, 64, 2, 416), ("down1", 64, 128, 2, 208),
         ("down2", 128, 256, 2, 104), ("down3", 256, 512, 2, 52),
         ("down4", 512, 1024, 2, 26))
CHUNKS = (64, 32)


def tf32(flag=True, deterministic=False):
    """Scoped cuDNN switches (the caller's come back)."""
    class _Scope:
        def __enter__(self):
            c = torch.backends.cudnn
            self.saved = (c.allow_tf32, c.deterministic)
            c.allow_tf32, c.deterministic = flag, deterministic

        def __exit__(self, *exc):
            torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = self.saved

    return _Scope()


def finish(y, b):
    return F.leaky_relu(y + b.float()[:, None, None], 0.1).to(torch.bfloat16)


def ordered(a):
    bits = (a.float().view(torch.int32) >> 16).to(torch.int64) & 0xFFFF
    return torch.where(bits >= 0x8000, -(bits & 0x7FFF), bits)


def random_convs():
    """(name, x, w, b, stride, None) at the 6 convs' shapes, seeded."""
    gen = torch.Generator().manual_seed(0)
    for name, cin, cout, stride, hw in CONVS:
        x = torch.randn(8, cin, hw, hw, generator=gen).to(torch.bfloat16)
        w = (torch.randn(cout, cin, 3, 3, generator=gen) / (9 * cin) ** 0.5).to(torch.bfloat16)
        b = (torch.randn(cout, generator=gen) * 0.3).to(torch.bfloat16)
        yield (name, x.cuda().contiguous(memory_format=torch.channels_last),
               w.cuda().contiguous(memory_format=torch.channels_last), b.cuda(), stride, None)


def forward_convs():
    """(name, x, w, b, stride, module) of the bf16 folded forward of
    chip_smoke.py's seed model on its images: each conv's input as the
    forward gives it."""
    from yolo_v3_tpu_torch.detector import Detector
    from yolo_v3_tpu_torch.models import darknet as D
    from yolo_v3_tpu_torch.utils.config import YoloConfig

    config = YoloConfig()
    gen = torch.Generator().manual_seed(0)
    params, state = D.init_yolonet(gen, config.num_classes, blocks=S.DARKNET53_BLOCKS)
    S.spread_batchnorm(params, state, gen)
    det = Detector(params, state, config, device="cuda", precision="bf16")
    convs = [det.model.stem, *det.model.downs]
    inputs = []
    hooks = [c.register_forward_pre_hook(lambda m, a: inputs.append(a[0])) for c in convs]
    x, _ = det.preprocess(S.make_images())
    with torch.inference_mode():
        det.model(x.to(torch.bfloat16))
    for h in hooks:
        h.remove()
    for (name, *_), conv, xi in zip(CONVS, convs, inputs):
        yield name, xi, conv.weight, conv.bias, conv.stride, conv


def main():
    if not torch.cuda.is_available():
        sys.exit("c1_conv_modes: needs a CUDA device")
    card = S.card_line()
    for inputs, convs in (("random", random_convs), ("forward", forward_convs)):
        for name, x, w, b, stride, module in convs():
            report(card, inputs, name, x, w, b, stride, module)


def report(card, inputs, name, x, w, b, stride, module):
    cin, hw = x.shape[1], x.shape[2]

    def mode_tf32(deterministic=False):
        with tf32(True, deterministic):
            return finish(F.conv2d(x.float(), w.float(), None, stride, 1), b)

    def mode_split(chunk):
        with tf32(True):
            parts = [F.conv2d(x[:, c:c + chunk].float(), w[:, c:c + chunk].float(),
                              None, stride, 1) for c in range(0, cin, chunk)]
        y = parts[0]
        for p in parts[1:]:
            y = y + p
        return finish(y, b)

    def mode_fp32():
        with full_fp32():
            return finish(F.conv2d(x.float(), w.float(), None, stride, 1), b)

    def double_rounding():
        return F.leaky_relu(F.conv2d(x, w, b, stride, 1), 0.1)

    with torch.inference_mode():
        ref = ordered(mode_fp32())
        row = []
        modes = [("tf32", mode_tf32), ("tf32 deterministic", lambda: mode_tf32(True))]
        modes += [(f"tf32 split K {c}", lambda c=c: mode_split(c)) for c in CHUNKS]
        modes += [("fp32", mode_fp32), ("double rounding bf16", double_rounding)]
        if module is not None:
            modes += [("_ConvBias", lambda: module(x)),
                      ("_ConvBias plain", lambda: module(x, plain=True))]
        for label, fn in modes:
            share = (ordered(fn()) != ref).float().mean().item()
            row.append(f"{label}: {share:.5%} differ, {S.device_ms(fn):.4f} ms")
    print(f"{inputs} {name} [{x.shape[0]},{cin},{hw},{hw}] -> {w.shape[0]}: "
          + "; ".join(row) + f" | {card}", flush=True)


if __name__ == "__main__":
    main()
