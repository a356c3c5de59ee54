"""The port's fused int8 entry (``yolo_v3_tpu_torch/ops/entry_kernel.py``)
against the JAX Pallas ``fused_entry`` in interpret mode and the XLA s2d
entry chain, on ``tests/test_entry_kernel.py``'s DIM-96 fixture.

Bound (``tests/test_entry_kernel.py``'s): int32 accumulation is exact, but
the float epilogue's rounding ties can flip a requantized value between two
evaluation orders (XLA contracts ``acc * m + b`` into a fused multiply-add),
and a flip on the residual input moves the sum by up to 2.  So max |diff|
<= 2, a differing share below 5e-3 and a share above 1 below 1e-4.  The
port's chain and the XLA chain run op by op agree bit for bit here."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_v3_tpu.models import darknet as JD
from yolo_v3_tpu.models import quantized as JQ
from yolo_v3_tpu.ops import entry_kernel as JEK
from yolo_v3_tpu_torch.models.quantized import qtree_from_numpy
from yolo_v3_tpu_torch.ops import entry_kernel as TEK

DIM = 96


@pytest.fixture(scope="module")
def qnet():
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.uniform(0, 1, (2, DIM, DIM, 3)).astype(np.float32))
    params, state = JD.init_yolonet(jax.random.PRNGKey(5), 8, blocks=(1, 1, 1, 1, 1))
    _, ns = JD.apply_yolonet(params, state, x, training=True)

    def fix(old, new):
        if set(old.keys()) == {"mean", "var"}:
            mean = (np.asarray(new["mean"]) - 0.9 * np.asarray(old["mean"])) / 0.1
            var = (np.asarray(new["var"]) - 0.9 * np.asarray(old["var"])) / 0.1
            return {"mean": jnp.asarray(mean), "var": jnp.asarray(np.maximum(var, 1e-3))}
        return {k: fix(old[k], new[k]) for k in old}

    qtree = JQ.build_quantized(params, fix(state, ns), x, space_to_depth=True)
    sc = qtree["scales"]
    x_q = JQ.quantize_image(x, sc["image"])
    xb = JD._space_to_depth2(jnp.pad(x_q, ((0, 0), (1, 3), (1, 3), (0, 0))))
    return qtree, xb, sc["s2d/down0"] / sc["s2d/res0_2"]


def _xla_entry(q, xb, res_scale):
    """The s2d entry section of apply_yolonet_quantized, op by op."""
    sp = q["s2d"]
    y = JQ._conv_i8(sp["stem"], xb, padding=((0, 0), (0, 0)))
    y = JQ._conv_i8(sp["down0"], y, stride=2, padding=((1, 1), (1, 1)))
    r = JQ._conv_i8(sp["res0_1"], y, padding=((0, 0), (0, 0)))
    r = JQ._conv_i8(sp["res0_2"], r, padding=((1, 1), (1, 1)), residual=y,
                    res_scale=res_scale)
    return JQ._conv_i8(sp["down1"], r, padding=((1, 0), (1, 0)))


def _within_entry_bound(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 2, diff.max()
    assert (diff != 0).mean() < 5e-3, (diff != 0).mean()
    assert (diff > 1).mean() < 1e-4, (diff > 1).mean()
    return diff


@pytest.mark.parametrize("reference", ["pallas_interpret", "xla"])
def test_fused_entry_matches_jax(qnet, reference):
    qtree, xb, res_scale = qnet
    if reference == "xla":
        want = _xla_entry(qtree, xb, res_scale)
    else:
        want = JEK.fused_entry(xb, qtree["s2d"], res_scale=res_scale, band=24,
                               interpret=True)
    want = np.asarray(want)
    qs2d = qtree_from_numpy(jax.device_get(qtree["s2d"]))
    got = TEK.fused_entry(torch.from_numpy(np.array(xb)), qs2d, res_scale)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape
    diff = _within_entry_bound(got.numpy(), want)
    if reference == "xla":
        assert diff.max() == 0


def test_fused_entry_shapes_and_cpu_launch_count(qnet):
    qtree, xb, res_scale = qnet
    qs2d = qtree_from_numpy(jax.device_get(qtree["s2d"]))
    for name, shape in TEK.SHAPES.items():
        w = qs2d[name]["w"]
        assert tuple(TEK._w4(w).shape) == shape and w.dtype == torch.int8, name
    before = TEK.fused_entry.launches
    out = TEK.fused_entry(torch.from_numpy(np.array(xb)), qs2d, res_scale)
    assert TEK.fused_entry.launches == before       # no kernel on the CPU
    assert tuple(out.shape) == (2, DIM // 4, DIM // 4, 128)
