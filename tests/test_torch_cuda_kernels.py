"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; without them it skips.  The
file imports no JAX, so it also runs on a host without it:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from yolo_v3_tpu_torch.ops.fused_res_block import (
    fused_res_block,
    fused_res_block_ref,
)

pytestmark = pytest.mark.cuda

# fp32: summation order only.  bf16: 2 bf16 ulps, for rounding-point flips
# of mid or of conv2's result between two fp32 summation orders.
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=1.6e-2, atol=1.6e-2)}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _block_inputs(shape, cmid, dtype, dev, seed=0):
    b, h, w, c = shape
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev, dtype)

    return (t(rng.normal(size=shape) * 0.5),
            t(rng.normal(size=(c, cmid)) / np.sqrt(c)),
            t(rng.normal(size=(cmid,)) * 0.1),
            t(rng.normal(size=(3, 3, cmid, c)) / np.sqrt(9 * cmid)),
            t(rng.normal(size=(c,)) * 0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,cmid", [
    ((2, 32, 16, 8), 4),          # the Pallas suite's shapes
    ((1, 48, 24, 16), 8),
    ((2, 13, 13, 64), 32),        # ragged tiles
    ((1, 19, 21, 128), 64),
    ((2, 26, 26, 512), 256),      # YOLOv3 stage 3 / 4 widths
    ((1, 13, 13, 1024), 512),
])
def test_kernel_matches_plain(dev, shape, cmid, dtype):
    args = _block_inputs(shape, cmid, dtype, dev)
    before = fused_res_block.launches
    got = fused_res_block(*args)
    torch.cuda.synchronize()
    assert fused_res_block.launches == before + 1
    want = fused_res_block_ref(*args)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_kernel_rejects_bad_operands(dev):
    y, w1, b1, w2, b2 = _block_inputs((1, 8, 8, 16), 8, torch.float32, dev)
    with pytest.raises(TypeError):
        fused_res_block(y.half(), w1, b1, w2, b2)
    with pytest.raises(ValueError):
        fused_res_block(y, w1, b1, w2[:, :, :4], b2)
    with pytest.raises(ValueError):
        fused_res_block(y.transpose(1, 2), w1, b1, w2, b2)
