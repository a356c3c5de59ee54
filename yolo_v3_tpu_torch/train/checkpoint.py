"""Composite training checkpoints: {data, params, BN state, optimizer,
recorder}.

Port of ``yolo_v3_tpu/train/checkpoint.py``: the same
``yolov3_{model_id}_checkpoint_{net_batch:06d}.npz`` naming, latest
discovery and retention GC, and the same ``params/...`` and ``state/...``
key layout.  The optimizer's momentum buffers are arrays under ``opt/...``,
and the rest (the data pipeline's state, the recorder, the optimizer's
schedule count) is JSON in ``__meta__``, so the file holds no pickle: the
JAX ``Detector.from_checkpoint`` reads it as a plain ``{params, state}``
pytree.  The data pipeline's state (scheduler queues and RNG state) makes
pause/resume bit-identical to one run.

A JAX composite checkpoint loads too, without unpickling its ``__meta__``
(that would need optax): its params and state come back, and its optimizer
and data state are None.  Resuming such a run raises.  Its ``mesh_shape``
sits in that pickle too, so it loads as None.

``mesh_shape`` records the data-parallel mesh of the writing run, which a
resume checks (``parallel/distributed.py::assert_mesh_compatible``).  In a
data-parallel run (``mesh``) rank 0 alone writes and every rank waits at a
barrier until the file is complete.
"""

from __future__ import annotations

import glob
import json
import os
import os.path as osp
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

from yolo_v3_tpu_torch.models.weights import _flatten_with_names, read_npz, tree_from_flat

_FMT = "yolov3_{model_id}_checkpoint_{net_batch:06d}.npz"
_PATTERN = r"yolov3_(.+?)_checkpoint_(\d+)\.npz$"
FORMAT = "yolo_v3_tpu_torch/train-checkpoint-v1"


def save_checkpoint(data_helper, params, state, opt_state, recorder, model_id: str,
                    weight_dir: str, mesh_shape=None, mesh=None) -> str:
    """Write the composite checkpoint of the current net-batch; returns its
    path.  With ``mesh``, rank 0 writes (``mesh_shape`` defaults to the
    mesh's) and every rank returns once the file is complete."""
    model_dir = osp.join(weight_dir, model_id)
    path = osp.join(model_dir, _FMT.format(model_id=model_id,
                                           net_batch=data_helper.get_net_batch()))
    if mesh is not None:
        if mesh.rank == 0:
            save_checkpoint(data_helper, params, state, opt_state, recorder, model_id,
                            weight_dir, mesh_shape if mesh_shape is not None else mesh.shape)
        mesh.barrier()
        return path
    os.makedirs(model_dir, exist_ok=True)
    flat = {}
    flat.update({f"params/{k}": v for k, v in _flatten_with_names(params).items()})
    flat.update({f"state/{k}": v for k, v in _flatten_with_names(state).items()})
    flat.update({f"opt/{k}": v for k, v in _flatten_with_names(opt_state["trace"]).items()})
    meta = {
        "format": FORMAT,
        "data": data_helper.state_dict(),
        "recorder": recorder.state_dict() if recorder is not None else None,
        "opt_count": int(opt_state["count"]),
        "mesh_shape": list(mesh_shape) if mesh_shape is not None else None,
    }
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(path, **flat)
    return path


def load_checkpoint(path: str, device="cpu") -> Dict[str, Any]:
    """Read a composite checkpoint (the port's or the JAX package's) ->
    {params, state, opt_state, data, recorder, mesh_shape} with tensors on
    ``device``.  For a JAX composite checkpoint (or a bare {params, state}
    pytree) ``opt_state``, ``data``, ``recorder`` and ``mesh_shape`` are
    None."""
    flat, meta = read_npz(path)
    tree = tree_from_flat(flat, device)
    if "params" not in tree or "state" not in tree:
        raise ValueError(f"{path}: not a training checkpoint (top-level keys "
                         f"{sorted(tree)[:8]})")
    if meta is None or meta.get("format") != FORMAT:
        return {"params": tree["params"], "state": tree["state"], "opt_state": None,
                "data": None, "recorder": None, "mesh_shape": None}
    return {
        "params": tree["params"],
        "state": tree["state"],
        "opt_state": {"count": meta["opt_count"], "trace": tree.get("opt", {})},
        "data": meta["data"],
        "recorder": meta["recorder"],
        "mesh_shape": (tuple(meta["mesh_shape"]) if meta.get("mesh_shape") is not None
                       else None),
    }


def get_checkpoint_list(model_id: str, weight_dir: str):
    return sorted(glob.glob(osp.join(weight_dir, model_id, "yolov3_*_checkpoint_*.npz")))


def get_latest_checkpoint(model_id: str, weight_dir: str) -> Tuple[Optional[str], int]:
    """Latest checkpoint by the net-batch number in its file name."""
    latest_path, latest_iter = None, 0
    for f in get_checkpoint_list(model_id, weight_dir):
        m = re.search(_PATTERN, f)
        if not m or m.group(1) != model_id:
            continue
        it = int(m.group(2))
        if it >= latest_iter:
            latest_path, latest_iter = f, it
    return latest_path, latest_iter


def remove_checkpoints(
    model_id: str,
    weight_dir: str,
    num_remove: int = 20,
    num_keep: int = 10,
    remove_all: bool = False,
    debug: bool = False,
) -> None:
    """Retention GC: once more than num_keep + num_remove exist, delete the
    oldest down to num_keep."""
    ckpts = get_checkpoint_list(model_id, weight_dir)
    if remove_all:
        doomed = ckpts
    else:
        excess = len(ckpts) - num_keep
        doomed = ckpts[:excess] if excess >= num_remove else []
    for f in doomed:
        if not debug:
            os.remove(f)
