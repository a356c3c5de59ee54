"""How far float32 training trajectories part on the CPU test fixture.

    JAX_PLATFORMS=cpu python3 scripts/train_trajectory_noise.py [LR ...]

Runs five S = 2 net-batches on the repeated net-batch of
``tests/test_torch_train_step.py`` (small YOLOv3, 2 classes, 64 px, JAX
``init_yolonet`` params) through the JAX ``make_train_step`` in float32,
the same JAX code evaluated in float64 (the test's ``jax.numpy`` proxy), the
port's float32 step and the port's step evaluated in float64 (the test's
``port_in_float64``), at each rate (default: 1e-3, the tests', and 2e-4),
with the ignore mask at its default IoU 0.7 and off (1.0).  Prints the JAX
float64 losses and, per step, the relative distance of the other three
runs' losses from them.  Each run takes about a minute.
"""

import contextlib
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_train_step as T  # noqa: E402

STEPS = 5


def trajectories(lr, ignore_thres):
    jp, js = T.JD.init_yolonet(jax.random.PRNGKey(0), num_classes=2, blocks=T.BLOCKS)
    p, s = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    imgs, labels = T.tiny_batch(0)
    train = dict(lr=lr, backbone_lr=lr / 10)
    out = {}
    for name, wide in (("jax32", False), ("jax64", True)):
        with T.reference_in_float64() if wide else contextlib.nullcontext():
            tx = T.JO.make_optimizer(p, T.JC.TrainConfig(**train))
            step = T.JS.make_train_step(
                T.JC.YoloConfig(num_classes=2, img_dim=T.DIM, ignore_thres=ignore_thres), tx)
            to = functools.partial(jax.tree.map,
                                   lambda a: jnp.asarray(a, jnp.float64 if wide else a.dtype))
            carry, x, y = (to(p), to(s), tx.init(to(p))), to(imgs), to(labels)
            losses = []
            for _ in range(STEPS):
                res = step(*carry, x, y)
                carry = res[:3]
                losses.append(float(res[3]["loss"]))
        out[name] = np.array(losses)
    opt = T.TO.make_optimizer(T.TC.TrainConfig(**train))
    step = T.TS.make_train_step(
        T.TC.YoloConfig(num_classes=2, img_dim=T.DIM, ignore_thres=ignore_thres), opt)
    tp, ts = T._torch(p), T._torch(s)
    to = opt.init(tp)
    losses = []
    for _ in range(STEPS):
        tp, ts, to, stats = step(tp, ts, to, torch.from_numpy(imgs), torch.from_numpy(labels))
        losses.append(float(stats["loss"]))
    out["port32"] = np.array(losses)
    out["port64"] = T.port_float64_run(
        p, s, imgs, labels, STEPS,
        T.TC.YoloConfig(num_classes=2, img_dim=T.DIM, ignore_thres=ignore_thres), **train)[1]
    return out


def main():
    rates = [float(a) for a in sys.argv[1:]] or [1e-3, 2e-4]
    np.set_printoptions(precision=3)
    for lr in rates:
        for ignore_thres in (0.7, 1.0):
            t = trajectories(lr, ignore_thres)
            ref = t["jax64"]
            print(f"lr {lr:g} ignore_thres {ignore_thres}: float64 loss {ref}", flush=True)
            for name in ("jax32", "port32", "port64"):
                print(f"  {name} relative distance per step "
                      f"{np.abs(t[name] / ref - 1)}", flush=True)


if __name__ == "__main__":
    main()
