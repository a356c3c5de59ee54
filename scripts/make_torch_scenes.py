"""Write the committed eval and training scenes of the port's tests and
``chip_smoke.py``: ``tests/data/torch_scenes/``.

    JAX_PLATFORMS=cpu python3 scripts/make_torch_scenes.py

Needs OpenCV (the JPEG encoder) and the JAX package (the expected labels),
so it runs where both import.  It writes

* ``images/scene_0000NN.jpg``: 24 synthetic scenes of 256-640 px a side, a
  smooth background with 1-6 filled rectangles, each in its class's colour
  (classes 0-79);
* ``labels/scene_0000NN.txt``: their boxes as rows ``cls cx cy w h``
  (relative), at the path the ``images/`` -> ``labels/`` contract gives;
* ``scenes.names``: the 80 class names (``data/coco.names``);
* ``expected_labels.npz``: the labels of ``SCHEDULE``'s batches (the
  training schedule ``chip_smoke.py`` runs), made by the JAX package's
  Python path (``yolo_v3_tpu.data.loader.DataHelper`` with
  ``native_threads=0``): ``labels`` [batches, batch, 90, 5], ``dims``
  [batches] and ``paths`` (file names in batch order).

List files hold absolute paths, so the tests and ``chip_smoke.py`` write
them at run time (:func:`write_list`, sorted file names).  The labels
depend only on the seed, the draws and each image's decoded size, so any
decoder gives them bit for bit.
"""

from __future__ import annotations

import functools
import os
import os.path as osp
import sys

import numpy as np

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)
ROOT = osp.join(REPO, "tests", "data", "torch_scenes")
N_SCENES = 24
SEED = 2024
# chip_smoke.py phase 8's training schedule: 3 net-batches of 8 x 2,
# multi-scale (a dim in 320-608 held for 16 samples: one per net-batch, as
# train() requires)
SCHEDULE = dict(batch_size=8, seed=12, rand_dim_interval=16, net_batches=3, subdivisions=2)


def write_list(root: str, out_path: str) -> str:
    """Write the list file of the scenes under ``root`` (absolute paths,
    sorted) to ``out_path``; return ``out_path``."""
    img_dir = osp.join(osp.abspath(root), "images")
    names = sorted(n for n in os.listdir(img_dir) if n.endswith(".jpg"))
    with open(out_path, "w") as f:
        f.write("\n".join(osp.join(img_dir, n) for n in names) + "\n")
    return out_path


def make_scenes(root: str) -> None:
    import cv2

    rng = np.random.default_rng(SEED)
    colours = rng.integers(20, 236, (80, 3))
    os.makedirs(osp.join(root, "images"), exist_ok=True)
    os.makedirs(osp.join(root, "labels"), exist_ok=True)
    for i in range(N_SCENES):
        h, w = (int(v) for v in rng.integers(256, 641, 2))
        # a smooth background: a coarse field upsampled
        coarse = rng.integers(70, 190, (4, 4, 3)).astype(np.uint8)
        img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
        rows = []
        for _ in range(int(rng.integers(1, 7))):
            c = int(rng.integers(0, 80))
            bw, bh = rng.uniform(0.1, 0.5, 2)
            cx, cy = rng.uniform(bw / 2, 1 - bw / 2), rng.uniform(bh / 2, 1 - bh / 2)
            x0, x1 = int(round((cx - bw / 2) * w)), int(round((cx + bw / 2) * w))
            y0, y1 = int(round((cy - bh / 2) * h)), int(round((cy + bh / 2) * h))
            img[y0:y1, x0:x1] = colours[c]
            rows.append((c, (x0 + x1) / 2 / w, (y0 + y1) / 2 / h, (x1 - x0) / w,
                         (y1 - y0) / h))
        stem = f"scene_{i + 1:06d}"
        cv2.imwrite(osp.join(root, "images", stem + ".jpg"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR), [cv2.IMWRITE_JPEG_QUALITY, 85])
        np.savetxt(osp.join(root, "labels", stem + ".txt"), np.array(rows), fmt="%.6f")
    with open(osp.join(REPO, "data", "coco.names")) as f, open(osp.join(root, "scenes.names"), "w") as g:
        g.write(f.read())


def expected_labels(root: str, list_path: str) -> dict:
    """The labels of SCHEDULE's batches through the JAX Python path."""
    from yolo_v3_tpu.data import transforms as JT
    from yolo_v3_tpu.data.datasets import ListDataset
    from yolo_v3_tpu.data.loader import DataHelper
    from yolo_v3_tpu.data.sampler import CyclicSampler

    s = SCHEDULE
    ds = ListDataset(list_path, trans_fn=functools.partial(JT.training_transform, feed_u8=True))
    sampler = CyclicSampler(len(ds), s["batch_size"], seed=s["seed"],
                            rand_dim_interval=s["rand_dim_interval"])
    helper = DataHelper(ds, sampler, max_net_batches=s["net_batches"],
                        net_subdivisions=s["subdivisions"], prefetch=0)
    labels, dims, paths = [], [], []
    try:
        for batch in helper:
            labels.append(batch["label"])
            dims.append(batch["img"].shape[1])
            paths.append([osp.basename(p) for p in batch["img_path"]])
    finally:
        helper.close()
    return dict(labels=np.stack(labels), dims=np.array(dims), paths=np.array(paths))


def main():
    import tempfile

    make_scenes(ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        list_path = write_list(ROOT, osp.join(tmp, "scenes.txt"))
        np.savez_compressed(osp.join(ROOT, "expected_labels.npz"),
                            **expected_labels(ROOT, list_path))
    total = sum(osp.getsize(osp.join(d, f)) for d, _, fs in os.walk(ROOT) for f in fs)
    print(f"{N_SCENES} scenes under {ROOT}: {total} bytes")


if __name__ == "__main__":
    main()
