"""bf16 detection rows of the port against the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/bf16_jax_agreement.py

Runs the fixture of ``tests/test_torch_detector_options.py`` (small YOLOv3,
2 classes, 128 px, spread BN statistics, two seeded images) through the JAX
bf16 ``Detector`` and the port's for every preprocess option that test
gates, and prints per image the share of JAX's rows matched one to one by a
port row of the same class at IoU > 0.5 (the test holds it at >= 80%), and
the two row counts.  Then, per head, the distance of the port's bf16 folded
forward from JAX ``apply_yolonet_folded`` in bf16 on one seeded 128 px
batch: max |port - JAX| / max |JAX| and mean |port - JAX| / mean |JAX|.

A share moves by one row of about 24 when a score near the threshold
crosses it, and the CPU's bf16 convs sum in an order that follows the
number of threads, so the shares are printed beside torch's thread count
(``OMP_NUM_THREADS=n`` sets it); the head distances move less.  Needs JAX
and OpenCV (the host-resize options).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_detector_options as T  # noqa: E402
from yolo_v3_tpu.models import darknet as JD  # noqa: E402
from yolo_v3_tpu_torch.models import darknet as TD  # noqa: E402
from yolo_v3_tpu_torch.models import weights as TW  # noqa: E402


def head_distances(p, s):
    """(max ratio, mean ratio) per head, coarse head first."""
    x = np.random.default_rng(2).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    jf = JD.cast_params(JD.fold_batchnorm(jax.tree.map(jnp.asarray, p),
                                          jax.tree.map(jnp.asarray, s)), jnp.bfloat16)
    want = JD.apply_yolonet_folded(jf, jnp.asarray(x, jnp.bfloat16))
    model = TD.YoloNetFolded(TD.cast_params(
        TD.fold_batchnorm(TW.params_from_numpy(p), TW.params_from_numpy(s)), torch.bfloat16))
    with torch.no_grad():
        got = model(torch.from_numpy(x).bfloat16(), plain=True)
    out = []
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        d = np.abs(g.float().numpy() - w)
        out.append((float(d.max() / np.abs(w).max()), float(d.mean() / np.abs(w).mean())))
    return out


def main():
    print(f"torch threads: {torch.get_num_threads()}", flush=True)
    trees, images = T.trees.__wrapped__(), T.images.__wrapped__()
    for letterbox, resize_on_device in T.OPTIONS + [(True, True)]:
        jdet, det = T._pair(trees, "bf16", letterbox, resize_on_device)
        want = jdet.detect(images, conf_thr=0.7)
        got = det.detect(images, conf_thr=0.7)
        shares = [f"{T._agreement(w, g):.4f} ({len(g)} rows vs {len(w)})"
                  for g, w in zip(got, want)]
        print(f"letterbox={letterbox} resize_on_device={resize_on_device}: "
              + ", ".join(shares), flush=True)
    print("bf16 heads, (max, mean) |port - jax| / |jax|: "
          + ", ".join(f"({a:.3e}, {b:.3e})" for a, b in head_distances(*trees)), flush=True)


if __name__ == "__main__":
    main()
