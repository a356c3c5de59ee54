"""The PyTorch port's config and weight I/O against the JAX package: same
config fields and defaults, and bit-equal weights through darknet
``.weights`` and npz pytrees in both directions."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from yolo_v3_tpu.models import darknet as JD
from yolo_v3_tpu.models import weights as JW
from yolo_v3_tpu.utils import config as JC
from yolo_v3_tpu_torch.models import darknet as TD
from yolo_v3_tpu_torch.models import weights as TW
from yolo_v3_tpu_torch.utils import config as TC

BLOCKS = (1, 1, 1, 1, 1)


@pytest.fixture(scope="module")
def jax_tree():
    params, state = JD.init_yolonet(jax.random.PRNGKey(3), num_classes=2,
                                    blocks=BLOCKS)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree.numpy() if torch.is_tensor(tree) else tree)}


def _assert_bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


@pytest.mark.parametrize("name", ["YoloConfig", "TrainConfig"])
def test_config_fields_and_defaults_match(name):
    j, t = getattr(JC, name)(), getattr(TC, name)()
    assert [f.name for f in dataclasses.fields(j)] == \
        [f.name for f in dataclasses.fields(t)]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_config_json_crosses_packages():
    cfg = JC.YoloConfig(num_classes=7, img_dim=320, conf_thr=0.3)
    assert dataclasses.asdict(TC.YoloConfig.from_json(cfg.to_json())) == \
        dataclasses.asdict(cfg)
    assert TC.YoloConfig.from_json(TC.YoloConfig().to_json()) == TC.YoloConfig()


def test_conv_layer_paths_match():
    assert TD.conv_layer_paths() == JD.conv_layer_paths()
    assert TD.conv_layer_paths(blocks=BLOCKS) == JD.conv_layer_paths(blocks=BLOCKS)


def test_init_tree_matches_jax_structure(jax_tree):
    params, state = TD.init_yolonet(torch.Generator().manual_seed(0),
                                    num_classes=2, blocks=BLOCKS)
    for jt, tt in ((jax_tree[0], params), (jax_tree[1], state)):
        lj, lt = _leaves(jt), _leaves(tt)
        assert lj.keys() == lt.keys()
        assert all(lj[k].shape == lt[k].shape for k in lj)


def test_jax_darknet_file_loads_bit_equal(jax_tree, tmp_path):
    path = str(tmp_path / "j.weights")
    JW.save_darknet_weights(*jax_tree, path, seen=12345)
    tmpl = TD.init_yolonet(torch.Generator().manual_seed(1), 2, blocks=BLOCKS)
    params, state, n, header = TW.load_darknet_weights(*tmpl, path)
    _assert_bit_equal(params, jax_tree[0])
    _assert_bit_equal(state, jax_tree[1])
    assert header[3] == 12345 and n > 0


def test_port_darknet_file_loads_bit_equal_in_jax(tmp_path):
    params, state = TD.init_yolonet(torch.Generator().manual_seed(5), 2,
                                    blocks=BLOCKS)
    path = str(tmp_path / "t.weights")
    TW.save_darknet_weights(params, state, path)
    jp, js = JD.init_yolonet(jax.random.PRNGKey(0), num_classes=2, blocks=BLOCKS)
    jp, js, _, _ = JW.load_darknet_weights(jp, js, path)
    _assert_bit_equal(jax.tree.map(np.asarray, jp), params)
    _assert_bit_equal(jax.tree.map(np.asarray, js), state)


def test_pytree_npz_crosses_packages(jax_tree, tmp_path):
    path = str(tmp_path / "tree.npz")
    JW.save_pytree({"params": jax_tree[0], "state": jax_tree[1]}, path,
                   meta={"num_classes": 2})
    tree, meta = TW.load_pytree(path)
    assert meta == {"num_classes": 2}
    _assert_bit_equal(tree["params"], jax_tree[0])
    # and back: the port's npz loads in the JAX package
    path2 = str(tmp_path / "tree2.npz")
    TW.save_pytree(tree, path2)
    jtree, _ = JW.load_pytree(path2)
    _assert_bit_equal(jax.tree.map(np.asarray, jtree), tree)


def test_params_from_numpy_is_bit_equal(jax_tree):
    _assert_bit_equal(TW.params_from_numpy(jax_tree[0]), jax_tree[0])
    cast = TW.params_from_numpy(jax_tree[0], dtype=torch.bfloat16)
    assert cast["backbone"]["stem"]["w"].dtype == torch.bfloat16


def test_port_imports_without_jax():
    """Every module of the port imports, in a fresh interpreter, without
    pulling in JAX, optax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys, yolo_v3_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(yolo_v3_tpu_torch.__path__,\n"
        "                                             'yolo_v3_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for want in ('yolo_v3_tpu_torch.train.loop', 'yolo_v3_tpu_torch.data.loader',\n"
        "             'yolo_v3_tpu_torch.models.loss', 'yolo_v3_tpu_torch.detector'):\n"
        "    assert want in names, want\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'yolo_v3_tpu')]\n"
        "assert not bad, bad\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=repo)
