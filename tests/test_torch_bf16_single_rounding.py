"""The bf16 stem and stride-2 downs of the port's folded forward round once,
as the reference's ``_conv_bias_leaky`` does: fp32 sums, the bias added and
leaky applied in fp32, one rounding to bf16.  Held against the JAX function
on the same bf16 inputs and weights, at Darknet-53's channel widths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_v3_tpu.models import darknet as JD
from yolo_v3_tpu_torch.models import darknet as TD
from yolo_v3_tpu_torch.models import weights as TW

# (name, cin, cout, stride, input H = W)
CONVS = [("stem", 3, 32, 1, 48), ("down0", 32, 64, 2, 48), ("down1", 64, 128, 2, 32),
         ("down2", 128, 256, 2, 24), ("down3", 256, 512, 2, 16),
         ("down4", 512, 1024, 2, 12)]
# The share of elements allowed to differ from the reference at all: the
# two fp32 summation orders move a rounding point now and then (the parent's
# double rounding put ~12% of outputs one step off).
MAX_OFF_SHARE = 1e-3
# Near zero a bf16 step is finer than fp32 summation-order noise (sums of up
# to 4608 products), so a difference may reach one step of the value plus
# this floor.
ABS_FLOOR = 2.0 ** -12


def ordered_bf16(a: np.ndarray) -> np.ndarray:
    """bf16 values (held in float32) as integers whose difference counts
    bf16 steps across zero too."""
    bits = (a.astype(np.float32).view(np.uint32) >> 16).astype(np.int64)
    return np.where(bits & 0x8000, -(bits & 0x7FFF), bits)


def bf16_steps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return np.abs(ordered_bf16(got) - ordered_bf16(want))


def check_single_rounding(name, got: np.ndarray, want: np.ndarray):
    """At most one bf16 step (plus the summation-order floor) from the
    reference anywhere, and any difference on under MAX_OFF_SHARE of it."""
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
    over = np.abs(got - want) - (step + ABS_FLOOR)
    assert over.max() <= 0, f"{name}: {over.max()} beyond one bf16 step"
    share = float((bf16_steps(got, want) > 0).mean())
    assert share < MAX_OFF_SHARE, (
        f"{name}: {share:.3%} of outputs differ from the reference")
    return share


@pytest.mark.parametrize("name,cin,cout,stride,hw", CONVS, ids=[c[0] for c in CONVS])
def test_bf16_stem_and_downs_round_once(name, cin, cout, stride, hw):
    rng = np.random.default_rng(cin)
    w = rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin)
    b = rng.normal(size=(cout,)) * 0.3
    x = rng.normal(size=(2, hw, hw, cin))
    w, b, x = (np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (w, b, x))

    want = JD._conv_bias_leaky({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                               jnp.asarray(x), stride)
    want = np.asarray(want.astype(jnp.float32))

    p = TW.params_from_numpy({"w": w.astype(np.float32), "b": b.astype(np.float32)},
                             dtype=torch.bfloat16)
    conv = TD._ConvBias(p, stride=stride)
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        got = conv(xt.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last))
    assert got.dtype == torch.bfloat16
    got = got.permute(0, 2, 3, 1).float().numpy()
    assert got.shape == want.shape

    check_single_rounding(name, got, want)


def test_bf16_folded_forward_runs_stem_and_downs_through_the_single_rounding_conv():
    """The folded bf16 model's stem and downs are the module tested above,
    and its stem output equals that module's on the same input."""
    jp, js = JD.init_yolonet(jax.random.PRNGKey(0), num_classes=2, blocks=(1, 1, 1, 1, 1))
    p = TW.params_from_numpy(jax.tree.map(np.asarray, jp))
    s = TW.params_from_numpy(jax.tree.map(np.asarray, js))
    model = TD.YoloNetFolded(TD.cast_params(TD.fold_batchnorm(p, s), torch.bfloat16))
    assert isinstance(model.stem, TD._ConvBias)
    assert all(isinstance(d, TD._ConvBias) for d in model.downs)
    x = torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    folded = TD.fold_batchnorm(p, s)["backbone"]["stem"]
    want = JD._conv_bias_leaky(
        {"w": jnp.asarray(folded["w"].numpy(), jnp.bfloat16),
         "b": jnp.asarray(folded["b"].numpy(), jnp.bfloat16)},
        jnp.asarray(x.permute(0, 2, 3, 1).float().numpy(), jnp.bfloat16))
    with torch.no_grad():
        got = model.stem(x).permute(0, 2, 3, 1).float().numpy()
    check_single_rounding("stem", got, np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("inference", [False, True], ids=["no_grad", "inference_mode"])
def test_bf16_conv_weight_chunks_follow_in_place_writes(inference):
    """The bf16 conv keeps its fp32 weight chunks between calls, and a
    write to the weight in place shows in the next call's output, also
    under ``torch.inference_mode()``."""
    rng = np.random.default_rng(5)
    w = (rng.normal(size=(3, 3, 96, 16)) / np.sqrt(9 * 96)).astype(np.float32)
    b = (rng.normal(size=(16,)) * 0.3).astype(np.float32)
    with torch.inference_mode(inference):
        conv = TD._ConvBias(TW.params_from_numpy({"w": w, "b": b}, dtype=torch.bfloat16),
                            stride=2)
        x = torch.from_numpy(rng.normal(size=(1, 96, 12, 12)).astype(np.float32))
        x = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            before = conv(x)
            assert torch.equal(conv(x), before)
            conv.weight.mul_(-1)
            after = conv(x)
            fresh = TD._ConvBias(TW.params_from_numpy({"w": -w, "b": b},
                                                      dtype=torch.bfloat16), stride=2)
            assert torch.equal(after, fresh(x))
            assert not torch.equal(after, before)
