"""The port's training forward (BatchNorm in train and eval mode), its
``YoloNet`` module and ``recalibrate_bn`` against the JAX package's
``apply_yolonet`` / ``recalibrate_bn`` on the same params (JAX
``init_yolonet``, carried over by ``params_from_numpy``) and images."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolo_v3_tpu.models import darknet as JD
from yolo_v3_tpu_torch.models import darknet as TD
from yolo_v3_tpu_torch.models import weights as TW

BLOCKS = (1, 1, 1, 1, 1)
DIM = 64


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and a
    CPU training step at full width oversubscribes the cores with more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    jp, js = JD.init_yolonet(jax.random.PRNGKey(0), num_classes=2, blocks=BLOCKS)
    p, s = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    # non-trivial running statistics, so eval mode differs from train mode
    rng = np.random.default_rng(3)

    def walk(pp, ss):
        if "bn" in pp:
            c = pp["bn"]["scale"].shape[0]
            ss["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            ss["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        elif "b" not in pp:
            for k in pp:
                walk(pp[k], ss.get(k, {}))

    walk(p, s)
    return p, s


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(0).uniform(0, 1, (2, DIM, DIM, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_runs(nets, images):
    """The JAX forward in train and eval mode, fp32 and bf16 (the whole
    param tree cast, as the JAX training step does)."""
    p, s = nets
    fwd = jax.jit(JD.apply_yolonet, static_argnames=("training",))
    out = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        pc = jax.tree.map(lambda a: jnp.asarray(a, dtype), p)
        for training in (True, False):
            raws, state = fwd(pc, jax.tree.map(jnp.asarray, s),
                              jnp.asarray(images, dtype), training=training)
            out[dtype, training] = ([np.asarray(r.astype(jnp.float32)) for r in raws],
                                    jax.tree.map(np.asarray, state))
    return out


def _flat(tree):
    return {k: np.asarray(v) for k, v in TW._flatten_with_names(tree).items()}


def _check_state(got, want):
    got, want = _flat(got), _flat(TW.params_from_numpy(want))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_fp32_forward_matches_jax(nets, images, jax_runs, training):
    p, s = nets
    with torch.no_grad():
        raws, state = TD.apply_yolonet(TW.params_from_numpy(p), TW.params_from_numpy(s),
                                       torch.from_numpy(images), training=training)
    want_raws, want_state = jax_runs[jnp.float32, training]
    for g, w in zip(raws, want_raws):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
    _check_state(state, want_state)


def conv_operand_dtypes(monkeypatch):
    """Record the (input, weight) dtypes of every ``F.conv2d`` call."""
    seen = []
    conv2d = F.conv2d

    def spy(x, w, *args, **kw):
        seen.append((x.dtype, w.dtype))
        return conv2d(x, w, *args, **kw)

    monkeypatch.setattr(F, "conv2d", spy)
    return seen


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_bf16_forward_matches_jax_cast_tree(nets, images, jax_runs, training, monkeypatch):
    """bf16 convs (every conv's operands bf16), BN math in fp32, fp32
    state.  Eval mode rounds at the same points as JAX: within 1e-2 *
    max|head| (two bf16 steps).  In train mode every BN normalizes with
    statistics of bf16-rounded conv outputs, so one rounding point that
    moves shifts every output of the next layer: at this size JAX's own
    bf16 heads sit 11-22% of max|head| from its fp32 heads (2-4% on
    average), and the port's bf16 heads sit as far from JAX's bf16 heads as
    from its fp32 heads (0.85-1.5 times that distance), so the whole net
    cannot tell bf16 from fp32 in train mode: each layer can, and
    ``test_bf16_train_mode_layers_match_jax`` holds them.  Here the port's
    bf16 heads must sit no further from JAX's bf16 heads than twice that
    distance, in max and in mean, and its BN state no further from JAX's
    bf16 state than twice JAX's bf16 state from its fp32 state."""
    p, s = nets
    pc = TD.cast_params(TW.params_from_numpy(p), torch.bfloat16)
    seen = conv_operand_dtypes(monkeypatch)
    with torch.no_grad():
        raws, state = TD.apply_yolonet(pc, TW.params_from_numpy(s),
                                       torch.from_numpy(images).to(torch.bfloat16),
                                       training=training)
    assert seen == [(torch.bfloat16, torch.bfloat16)] * len(TD.conv_layer_paths(blocks=BLOCKS))
    want_raws, want_state = jax_runs[jnp.bfloat16, training]
    for g, w, w32 in zip(raws, want_raws, jax_runs[jnp.float32, training][0]):
        assert g.dtype == torch.bfloat16
        err = np.abs(g.float().numpy() - w)
        if training:
            noise = np.abs(w - w32)
            assert err.max() <= 2 * noise.max() and err.mean() <= 2 * noise.mean()
        else:
            assert err.max() <= 1e-2 * np.abs(w).max()
    if not training:
        _check_state(state, want_state)
        return
    got, want = _flat(state), _flat(TW.params_from_numpy(want_state))
    want32 = _flat(TW.params_from_numpy(jax_runs[jnp.float32, True][1]))
    for k in got:
        assert np.abs(got[k] - want[k]).max() <= 2 * np.abs(want[k] - want32[k]).max() + 1e-6, k


# (name, path in the backbone, input channels, stride, input H = W)
LAYERS = [("stem", ("stem",), 3, 1, 64), ("down0", ("stage0", "down"), 32, 2, 64),
          ("down2", ("stage2", "down"), 128, 2, 16)]


@pytest.mark.parametrize("name,path,cin,stride,hw", LAYERS, ids=[c[0] for c in LAYERS])
def test_bf16_train_mode_layers_match_jax(nets, name, path, cin, stride, hw):
    """One train-mode ``conv_bn_leaky`` in bf16 against the JAX one on the
    same bf16 input, params cast to bf16: the conv's result rounded to bf16,
    then BN on its batch statistics in fp32, then one rounding.  Under
    0.1% of the outputs may differ from JAX's at all (measured: 0.008% to
    0.015%; an fp32 conv before the same BN differs on 48%), and the new
    state is within rtol 1e-4."""
    p, s = nets
    pp, ss = p["backbone"], s["backbone"]
    for k in path:
        pp, ss = pp[k], ss[k]
    rng = np.random.default_rng(cin)
    x = np.array(jnp.asarray(rng.normal(size=(2, hw, hw, cin)), jnp.bfloat16)
                 .astype(jnp.float32))
    want, want_s = JD.conv_bn_leaky(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), pp),
                                    jax.tree.map(jnp.asarray, ss),
                                    jnp.asarray(x, jnp.bfloat16), stride, training=True)
    with torch.no_grad():
        got, got_s = TD.conv_bn_leaky(
            TD.cast_params(TW.params_from_numpy(pp), torch.bfloat16), TW.params_from_numpy(ss),
            torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2), stride, training=True)
    assert got.dtype == torch.bfloat16
    got = got.permute(0, 2, 3, 1).float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    share = float((got != want).mean())
    print(f"{name}: {share:.5%} of outputs differ from JAX's")
    assert share < 1e-3, f"{name}: {share:.4%} of outputs differ from JAX's"
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(want_s[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_yolonet_module_trains_and_evaluates_like_the_functions(nets, images, jax_runs):
    p, s = nets
    model = TD.YoloNet(TW.params_from_numpy(p), TW.params_from_numpy(s))
    assert all(isinstance(t, torch.nn.Parameter) for t in model.parameters())
    n_bn = sum(1 for k, _ in model.named_buffers() if k.endswith(".mean"))
    assert n_bn == len(TD.conv_layer_paths(blocks=BLOCKS)) - 3      # every conv but the dets
    x = torch.from_numpy(images)

    model.eval()
    with torch.no_grad():
        eval_raws = model(x)
    for g, w in zip(eval_raws, jax_runs[jnp.float32, False][0]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
    model.train()
    raws = model(x)
    assert raws[0].requires_grad
    for g, w in zip(raws, jax_runs[jnp.float32, True][0]):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    params, state = model.trees()
    _check_state(state, jax_runs[jnp.float32, True][1])
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(v, _flat(TW.params_from_numpy(p))[k])


def test_recalibrate_bn_matches_jax(nets):
    p, s = nets
    rng = np.random.default_rng(5)
    batches = [rng.uniform(0, 1, (2, DIM, DIM, 3)).astype(np.float32) for _ in range(3)]
    want = JD.recalibrate_bn(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s),
                             [jnp.asarray(b) for b in batches])
    got = TD.recalibrate_bn(TW.params_from_numpy(p), TW.params_from_numpy(s),
                            [torch.from_numpy(b) for b in batches])
    _check_state(got, jax.tree.map(np.asarray, want))
    # a single batch: its own biased statistics; mixed shapes refused
    one = TD.recalibrate_bn(TW.params_from_numpy(p), TW.params_from_numpy(s),
                            torch.from_numpy(batches[0]))
    stem = TD.conv_bn_leaky(TW.params_from_numpy(p)["backbone"]["stem"],
                            TW.params_from_numpy(s)["backbone"]["stem"],
                            torch.from_numpy(batches[0]).permute(0, 3, 1, 2), 1,
                            training=True, measure=True)[1]
    torch.testing.assert_close(one["backbone"]["stem"]["var"], stem["var"])
    with pytest.raises(ValueError, match="one shape"):
        TD.recalibrate_bn(TW.params_from_numpy(p), TW.params_from_numpy(s),
                          [torch.from_numpy(batches[0]), torch.zeros(1, DIM, DIM, 3)])
