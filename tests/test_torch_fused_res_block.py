"""The port's residual block (plain version, and the wrapper on CPU tensors)
against the JAX Pallas kernel in interpret mode and the JAX XLA chain."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_v3_tpu.models import darknet as JD
from yolo_v3_tpu.ops.pallas_kernels import fused_res_block as jax_fused_res_block
from yolo_v3_tpu_torch.ops.fused_res_block import (
    fused_res_block,
    fused_res_block_ref,
)


def _inputs(shape, cmid, seed=0):
    b, h, w, c = shape
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) * 0.5,
            rng.normal(size=(1, 1, c, cmid)).astype(np.float32) * 0.2,
            rng.normal(size=(cmid,)).astype(np.float32) * 0.1,
            rng.normal(size=(3, 3, cmid, c)).astype(np.float32) * 0.2,
            rng.normal(size=(c,)).astype(np.float32) * 0.1]


def _xla_chain(y, w1, b1, w2, b2):
    r = JD._conv_bias_leaky({"w": w1, "b": b1}, y)
    return y + JD._conv_bias_leaky({"w": w2, "b": b2}, r)


def _torch(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


@pytest.mark.parametrize("shape,cmid", [((2, 32, 16, 8), 4), ((1, 48, 24, 16), 8)])
def test_plain_matches_pallas_interpret(shape, cmid):
    arrs = _inputs(shape, cmid)
    want = jax_fused_res_block(*[jnp.asarray(a) for a in arrs], tile_h=16,
                               interpret=True)
    got = fused_res_block_ref(*_torch(arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_plain_matches_xla_chain_ragged_fp32():
    """H=13, W=11: not a multiple of any tile (the 416 stage-4 height)."""
    arrs = _inputs((2, 13, 11, 16), 8, seed=1)
    want = _xla_chain(*[jnp.asarray(a) for a in arrs])
    got = fused_res_block_ref(*_torch(arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_plain_matches_xla_chain_bf16():
    """bf16 storage, fp32 accumulation, the same two rounding points.  The
    tolerance is 2 bf16 ulps (2 * 2^-8 relative): a rounding-point flip of
    mid or of conv2's result between two fp32 summation orders."""
    arrs = _inputs((2, 13, 13, 32), 16, seed=2)
    want = _xla_chain(*[jnp.asarray(a, jnp.bfloat16) for a in arrs])
    got = fused_res_block_ref(*_torch(arrs, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1.6e-2, atol=1.6e-2)


def test_halo_is_zero_not_leaky_bias():
    """Out-of-image mid is 0, not leaky(b1): with a large b1 the edge rows
    and columns would differ (reference pallas_kernels.py:69-77)."""
    arrs = _inputs((1, 8, 8, 8), 4, seed=3)
    arrs[2] = np.full((4,), 3.0, np.float32)
    want = np.asarray(_xla_chain(*[jnp.asarray(a) for a in arrs]))
    got = fused_res_block_ref(*_torch(arrs)).numpy()
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_allclose(got[edge], want[edge], rtol=1e-4, atol=1e-5)


def test_wrapper_on_cpu_runs_plain_version():
    args = _torch(_inputs((1, 9, 7, 16), 8, seed=4))
    before = fused_res_block.launches
    got = fused_res_block(*args)
    assert fused_res_block.launches == before  # no kernel on the CPU
    torch.testing.assert_close(got, fused_res_block_ref(*args), rtol=0, atol=0)


def test_wrapper_rejects_bad_shapes():
    y, w1, b1, w2, b2 = _torch(_inputs((1, 8, 8, 16), 8))
    with pytest.raises(ValueError):
        fused_res_block(y, w1, b1, w2[:, :, :4], b2)
    with pytest.raises(ValueError):
        fused_res_block(y, w1, b1[:4], w2, b2)
