"""Plain references of what the benchmark's cells compute.

They are written from the published model (arXiv:1804.02767, darknet's
``yolov3.cfg``) and the semantics the serving and int8 paths document, in
plain PyTorch, and import nothing of the package they judge: they take the
benchmark's own inputs (seeded weights, scenes, calibration images) and work
out BN folding, calibration and quantization again.  Where a reference reads
the program's outputs it does so only to judge them.
"""

import contextlib

import torch


def _switch_list():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    out = [(lambda: cudnn.allow_tf32, lambda v: setattr(cudnn, "allow_tf32", v), False, True),
           (torch.get_float32_matmul_precision, torch.set_float32_matmul_precision,
            "highest", "high")]
    if hasattr(cudnn, "conv") and hasattr(cudnn.conv, "fp32_precision"):
        out.append((lambda: cudnn.conv.fp32_precision,
                    lambda v: setattr(cudnn.conv, "fp32_precision", v), "ieee", "tf32"))
    try:
        matmul.fp32_precision
    except (AttributeError, RuntimeError):
        pass
    else:
        out.append((lambda: matmul.fp32_precision,
                    lambda v: setattr(matmul, "fp32_precision", v), "ieee", "tf32"))
    return out


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 off (``on=False``: float32 convs and matmuls in full float32) or
    on inside the block; the caller's settings come back after it."""
    saved = []
    for get, set_, off, on_value in _switch_list():
        try:
            saved.append((set_, get()))
            set_(on_value if on else off)
        except RuntimeError:      # a legacy getter after the two APIs were mixed
            continue
    try:
        yield
    finally:
        for set_, value in reversed(saved):
            try:
                set_(value)
            except RuntimeError:
                pass


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 ``x`` rounded to ``bits`` explicit mantissa bits, to nearest,
    ties away from zero (TF32's 10 bits: what the tensor cores do to an
    operand); the exponent range is float32's."""
    drop = 23 - bits
    i = x.float().contiguous().view(torch.int32)
    i = (i + (1 << (drop - 1))) & ~((1 << drop) - 1)
    return i.view(torch.float32)
