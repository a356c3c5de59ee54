"""Weight I/O: darknet ``.weights`` codec, npz pytree checkpoints, and the
bridge from the JAX package's parameter trees.

Port of ``yolo_v3_tpu/models/weights.py``.  Darknet ``.weights``: 5 int32
header values (``seen`` at index 3), then one float32 blob; per conv+BN block
bn.bias, bn.scale, running_mean, running_var, kernel; per bias conv bias,
kernel.  Kernels are serialized OIHW and held here as HWIO, as in the JAX
package.  Layer order is :func:`~yolo_v3_tpu_torch.models.darknet.
conv_layer_paths`.

The npz checkpoint stores one array per leaf under its '/'-joined tree path,
the JAX package's format, so files written by either package load in the
other.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from yolo_v3_tpu_torch.models.darknet import backbone_conv_paths, conv_layer_paths, map_tree

HEADER_LEN = 5


def params_from_numpy(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """Nested dicts of numpy arrays (e.g. a JAX ``{params, state}`` tree
    passed through ``np.asarray``) -> the same nesting of torch tensors.
    Values are copied bit for bit unless ``dtype`` asks for a cast."""
    return map_tree(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(
            device=device, dtype=dtype), tree)


def _get_path(tree, path):
    node = tree
    for k in path:
        node = node[k]
    return node


def _set_path(tree, path, value):
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def infer_blocks(params) -> tuple:
    """Per-stage residual-block counts read off the params tree."""
    bk = params["backbone"]
    stages = sorted(k for k in bk if k.startswith("stage"))
    return tuple(sum(1 for k in bk[s] if k.startswith("res")) for s in stages)


def load_darknet_weights(
    params,
    state,
    path: str,
    paths: Optional[Sequence[Tuple[str, ...]]] = None,
    allow_partial: bool = False,
):
    """Read a darknet ``.weights`` file into copies of the (params, state)
    templates.  Returns (params, state, n_floats_consumed, header); with
    ``allow_partial`` the read stops cleanly at end of file."""
    with open(path, "rb") as fp:
        header = np.fromfile(fp, dtype=np.int32, count=HEADER_LEN)
        blob = np.fromfile(fp, dtype=np.float32)
    params = map_tree(lambda t: t, params)
    state = map_tree(lambda t: t, state)
    if paths is None:
        paths = conv_layer_paths(blocks=infer_blocks(params))

    ptr = 0

    def take(n, shape, like):
        nonlocal ptr
        if ptr + n > blob.size:
            raise EOFError
        out = blob[ptr:ptr + n].reshape(shape)
        ptr += n
        return torch.from_numpy(out.copy()).to(like.device)

    for p in paths:
        pp = _get_path(params, p)
        kh, kw, cin, cout = pp["w"].shape
        w_like = pp["w"]
        try:
            if "bn" in pp:
                bias = take(cout, (cout,), w_like)
                scale = take(cout, (cout,), w_like)
                mean = take(cout, (cout,), w_like)
                var = take(cout, (cout,), w_like)
                w = take(cout * cin * kh * kw, (cout, cin, kh, kw), w_like)
                _set_path(params, p, {"w": w.permute(2, 3, 1, 0).contiguous(),
                                      "bn": {"scale": scale, "bias": bias}})
                _set_path(state, p, {"mean": mean, "var": var})
            else:
                b = take(cout, (cout,), w_like)
                w = take(cout * cin * kh * kw, (cout, cin, kh, kw), w_like)
                _set_path(params, p, {"w": w.permute(2, 3, 1, 0).contiguous(),
                                      "b": b})
        except EOFError:
            if allow_partial:
                break
            raise ValueError(
                f"weights file exhausted at layer {'/'.join(p)} "
                f"(consumed {ptr} of {blob.size} floats)") from None
    return params, state, ptr, header


def load_backbone_darknet_weights(params, state, path: str):
    """darknet53.conv.74-style backbone init for fine-tuning: the backbone's
    convs from the file's prefix, the rest of the tree as given.  Returns
    (params, state, n_floats_consumed, header)."""
    return load_darknet_weights(params, state, path, paths=backbone_conv_paths(),
                                allow_partial=True)


def save_darknet_weights(params, state, path: str, paths=None, seen: int = 0,
                         version=(0, 2, 0)):
    """Write params/state as a darknet ``.weights`` file (codec inverse)."""
    if paths is None:
        paths = conv_layer_paths(blocks=infer_blocks(params))

    def f32(t):
        return t.detach().to("cpu", torch.float32).numpy()

    chunks: List[np.ndarray] = []
    for p in paths:
        pp = _get_path(params, p)
        if "bn" in pp:
            sp = _get_path(state, p)
            chunks += [f32(pp["bn"]["bias"]).ravel(), f32(pp["bn"]["scale"]).ravel(),
                       f32(sp["mean"]).ravel(), f32(sp["var"]).ravel()]
        else:
            chunks.append(f32(pp["b"]).ravel())
        chunks.append(f32(pp["w"]).transpose(3, 2, 0, 1).ravel())   # -> OIHW
    header = np.array([version[0], version[1], version[2], seen, 0], np.int32)
    with open(path, "wb") as fp:
        header.tofile(fp)
        np.concatenate(chunks).tofile(fp)


def _flatten_with_names(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten_with_names(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    return out


def save_pytree(tree, path: str, meta: Optional[Dict[str, Any]] = None):
    """Save a tree of tensors as npz (one array per '/'-joined leaf path)."""
    flat = _flatten_with_names(tree)
    if meta is not None:
        flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def read_npz(path: str):
    """An npz pytree's arrays by '/'-joined leaf path and its JSON
    ``__meta__`` (or None).  A pickled ``__meta__`` (a JAX composite
    training checkpoint) is skipped, never unpickled: that would run
    whatever it names (optax's state classes, so JAX)."""
    with np.load(path if path.endswith(".npz") else path + ".npz",
                 allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    meta = None
    if "__meta__" in flat:
        raw = bytes(flat.pop("__meta__").tolist())
        if raw[:1] != b"\x80":              # the pickle protocol marker
            meta = json.loads(raw.decode())
    return flat, meta


def tree_from_flat(flat: Dict[str, np.ndarray], device="cpu"):
    tree: Dict[str, Any] = {}
    for name, arr in flat.items():
        _set_path(tree, name.split("/"), torch.from_numpy(arr).to(device))
    return tree


def load_pytree(path: str, device="cpu"):
    """Load an npz pytree (this package's or the JAX package's, a composite
    training checkpoint of either included) -> (tree of tensors, JSON meta
    dict or None).  A composite checkpoint gives its ``params``, ``state``
    (and the port's ``opt``) subtrees; a pickled ``__meta__`` is skipped,
    not read."""
    flat, meta = read_npz(path)
    return tree_from_flat(flat, device), meta
