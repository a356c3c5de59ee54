"""High-level detection API: images in, boxes out.

Port of ``yolo_v3_tpu/detector.py`` for bf16, fp32 and int8 serving of
YOLOv3, and bf16 serving of YOLOv4 (``arch="yolov4"``, ``models/yolov4.py``;
its heads decode with their ``scale_x_y``).  On
the device: letterbox or plain resize (cubic) of the whole batch, staged as
one upload (``ops/letterbox.py::stage_batch``, ``letterbox_batch``), the forward
(BN-folded float with every residual block on the fused kernel, or int8 on
the int8 kernels), the display or eval postprocess with class-wise greedy
NMS, and the mapping of boxes back to original-image pixels.  Only the
compact [B, M, 8] result returns to the host.  With ``resize_on_device=False``
the host resizes with OpenCV (imported only there) and int8 takes the
uint8 images as they are (the uint8 feed).  Over a mesh of processes a
batch is split over the ``data`` axis and each image's rows over the
``space`` axis (every precision, both int8 feeds), and every rank returns
the whole batch's rows.

Output rows per image: [cls, x, y, w, h, prob, obj], xywh in original-image
pixels.

Under a recording ``torch.profiler`` a call marks its stages as spans
(``utils/profiling.py::span``): ``yolo.detect`` holds ``yolo.preprocess``,
``yolo.forward``, ``yolo.postprocess`` and ``yolo.readback``; ``yolo.h2d``
marks each blocking host-to-device copy (the postprocess's: 6 anchor
tensors and the net size's two values; the device preprocess uploads with
one non-blocking copy, the host one with a blocking copy of the sizes and
one of the batch) and ``yolo.nms.round`` each NMS round.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from yolo_v3_tpu_torch.models import darknet as D
from yolo_v3_tpu_torch.models import quantized as Q
from yolo_v3_tpu_torch.models import weights as W
from yolo_v3_tpu_torch.models import yolov4 as Y4
from yolo_v3_tpu_torch.ops import boxes as B
from yolo_v3_tpu_torch.ops.letterbox import (letterbox_batch, letterbox_host,
                                             letterbox_host_u8, stage_batch)
from yolo_v3_tpu_torch.ops.postprocess import detections_to_lists, postprocess_from_raws
from yolo_v3_tpu_torch.parallel import mesh as M
from yolo_v3_tpu_torch.parallel.halo import gather_batch
from yolo_v3_tpu_torch.parallel.mesh import STRIPE_ROWS
from yolo_v3_tpu_torch.utils.config import YoloConfig
from yolo_v3_tpu_torch.utils.profiling import span

_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def detect_fn(
    model,
    x: torch.Tensor,
    org_dims: torch.Tensor,
    config: YoloConfig,
    conf_thr: float,
    nms_thr: float,
    is_eval: bool = False,
    use_nms: bool = True,
    is_letterbox: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    plain: bool = False,
    mesh=None,
    scale_x_y=None,
) -> torch.Tensor:
    """Device pipeline on a :class:`~yolo_v3_tpu_torch.models.darknet.
    YoloNetFolded` or :class:`~yolo_v3_tpu_torch.models.quantized.
    YoloNetQuantized`.

    ``x``: [B, H, W, 3] float, letterboxed or resized to the net input, or
    uint8 for the int8 model's uint8 feed (passed on unconverted);
    ``org_dims``: [B, 2] (org_w, org_h).  ``is_letterbox`` says how ``x``
    was made, so how boxes map back.  ``plain`` runs the kernels' plain
    versions.  Returns [B, M, 8]: x, y, w, h (original-image pixels), obj,
    prob, cls, valid.

    ``mesh`` (a ``(data, space)`` mesh, ``parallel/mesh.py``): ``x`` and
    ``org_dims`` are this rank's data shard of the batch (``data_shard``),
    ``x`` cut to this rank's stripe of rows under ``space`` > 1 (``stripe``),
    and every rank returns the rows of the whole batch, as JAX's
    ``detect_fn`` jitted over a mesh does.  ``scale_x_y``: the heads' decode
    scales (YOLOv4's), or None.
    """
    space = mesh is not None and mesh.space_size > 1
    xa = x if x.dtype == torch.uint8 else x.to(compute_dtype)
    with span("forward"):
        raws = model(xa, plain=plain, mesh=mesh) if space else model(xa, plain=plain)
    # the gathered heads are whole: the coarse one has a row per 32 input rows
    img_dim = raws[0].shape[1] * STRIPE_ROWS if space else x.shape[1]
    with span("postprocess"):
        res = postprocess_from_raws(raws, config, img_dim, conf_thr=conf_thr,
                                    nms_thr=nms_thr, is_eval=is_eval, use_nms=use_nms,
                                    scale_x_y=scale_x_y)
        org = org_dims.to(torch.float32)
        xywh = B.correct_yolo_boxes(res[..., :4], org[:, 0:1], org[:, 1:2],
                                    img_dim, img_dim, is_letterbox=is_letterbox)
        out = torch.cat([xywh, res[..., 4:]], dim=-1)
    return gather_batch(out, mesh) if mesh is not None else out


class Detector:
    """Holds the model on one device.

    ``precision``: "bf16" (default), "fp32" or "int8".  ``device``: where
    the model and the whole pipeline run, the card by default ("cuda"), where
    the residual blocks (float) or the convs (int8) run on the hand-written
    kernels.  Without a card the default fails with PyTorch's own error;
    ``device="cpu"`` runs the kernels' plain versions instead.

    ``letterbox``: letterbox the images (True) or resize them to the square
    net input; ``resize_on_device``: resize on the device (True) or on the
    host with OpenCV.  int8 with ``resize_on_device=False`` takes the host's
    uint8 images as they are (the uint8 feed).

    int8 calibrates its activation scales on ``calib_images`` (HWC uint8)
    when given, preprocessed as float images, else on the JAX package's
    synthetic batch (uniform noise from ``np.random.default_rng(0)``, 8
    images).  A quantized tree (``quantized_tree``, :meth:`from_quantized`)
    skips calibration.

    ``mesh`` (a ``(data, space)`` mesh, ``parallel/mesh.py``): the detector
    serves on the mesh's card, :meth:`detect` preprocesses only this rank's
    data shard of the images (cut to its stripe of rows under ``space`` >
    1; the uint8 feed stripes uint8 rows) and returns the rows of every
    image on every rank.  Every rank gets the same images.  int8 calibrates on each rank,
    on the same images; a quantized artifact serves every rank the same
    tree without that.

    ``arch``: "yolov3" (the default) or "yolov4", whose trees are
    ``models/yolov4.py``'s, served in bf16 only (its Mish kernels are bf16),
    on one device, with ``config`` giving its anchors and sizes; its heads
    decode with ``models/yolov4.py::SCALE_X_Y`` (``self.scale_x_y``; None
    for YOLOv3).
    """

    def __init__(
        self,
        params,
        state,
        config: YoloConfig = YoloConfig(),
        precision: str = "bf16",
        device="cuda",
        letterbox: bool = True,
        resize_on_device: bool = True,
        calib_images=None,
        quantized_tree=None,
        mesh=None,
        arch: str = "yolov3",
    ):
        if quantized_tree is not None:
            precision = "int8"
        if arch not in ("yolov3", "yolov4"):
            raise ValueError(f"arch must be 'yolov3' or 'yolov4', got {arch!r}")
        if arch == "yolov4" and (precision != "bf16" or mesh is not None):
            raise ValueError("YOLOv4 serves in bf16 on one device (no fp32, no int8, no mesh)")
        self.arch = arch
        self.scale_x_y = Y4.SCALE_X_Y if arch == "yolov4" else None
        if precision not in ("int8", *_DTYPES):
            raise ValueError(
                f"precision must be 'bf16', 'fp32' or 'int8', got {precision!r}")
        self.config = config
        self.precision = precision
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        self.letterbox = letterbox
        self.resize_on_device = resize_on_device
        self._u8_feed = False
        if precision == "int8":
            if quantized_tree is None:
                # calibrate on float images: the uint8 feed is switched on
                # only below, as the JAX Detector does
                if calib_images is not None:
                    calib, _ = self.preprocess(calib_images)
                else:
                    rng = np.random.default_rng(0)
                    calib = torch.from_numpy(rng.uniform(
                        0, 1, (8, config.img_dim, config.img_dim, 3)).astype(np.float32))
                quantized_tree = Q.build_quantized(params, state, calib.to(self.device))
            self.qtree = quantized_tree
            self.compute_dtype = torch.float32      # the image is quantized inside
            self.model = Q.YoloNetQuantized(quantized_tree).to(self.device).eval()
            # the host keeps images in uint8 and the net takes them as they are
            self._u8_feed = not resize_on_device
            return
        self.compute_dtype = _DTYPES[precision]
        folded = D.fold_batchnorm(D.cast_params(params, torch.float32, self.device),
                                  D.cast_params(state, torch.float32, self.device))
        net = Y4.YoloV4Folded if arch == "yolov4" else D.YoloNetFolded
        self.model = net(D.cast_params(folded, self.compute_dtype)).eval()

    # -- constructors -----------------------------------------------------

    @classmethod
    def from_darknet_weights(cls, path: str, config: YoloConfig = YoloConfig(),
                             **kw) -> "Detector":
        params, state = D.init_yolonet(torch.Generator().manual_seed(0),
                                       config.num_classes)
        params, state, _, _ = W.load_darknet_weights(params, state, path)
        return cls(params, state, config, **kw)

    @classmethod
    def from_checkpoint(cls, path: str, config: YoloConfig = YoloConfig(),
                        **kw) -> "Detector":
        """Load a plain {params, state} npz pytree or a composite training
        checkpoint (either package's; a JAX checkpoint's pickled metadata is
        skipped, not read)."""
        tree, _ = W.load_pytree(path)
        if "params" not in tree or "state" not in tree:
            raise ValueError(
                f"{path}: not a {{params, state}} pytree npz or training checkpoint "
                f"(top-level keys {sorted(tree)[:8]})")
        return cls(tree["params"], tree["state"], config, **kw)

    @classmethod
    def from_quantized(cls, path: str, config: YoloConfig = YoloConfig(),
                       **kw) -> "Detector":
        """Load an int8 serving artifact (either package's
        ``save_quantized``): no float weights, no calibration."""
        return cls(None, None, config, quantized_tree=Q.load_quantized(path), **kw)

    def save_quantized(self, path: str) -> None:
        """Write this detector's int8 tree as a ``quantized-v1`` artifact."""
        if self.precision != "int8":
            raise ValueError(
                f"save_quantized requires precision='int8' (got {self.precision!r})")
        Q.save_quantized(self.qtree, path, meta={"num_classes": self.config.num_classes,
                                                  "img_dim": self.config.img_dim})

    # -- inference --------------------------------------------------------

    def preprocess(self, images: Sequence[np.ndarray], dim: Optional[int] = None):
        """HWC uint8 RGB images -> ([B, dim, dim, 3] float32 in [0, 1], or
        uint8 for the uint8 feed; org_dims [B, 2]), both on the detector's
        device.  Letterbox or plain cubic resize per ``letterbox``, on the
        device (the batch staged as one non-blocking upload, one kernel
        launch on a card) or on the host (OpenCV) per ``resize_on_device``."""
        with span("preprocess"):
            dim = dim or self.config.img_dim
            if self.resize_on_device:
                src, desc, org = stage_batch(images, dim, self.letterbox, self.device)
                return letterbox_batch(src, desc, dim), org
            with span("h2d"):
                org = torch.tensor([[im.shape[1], im.shape[0]] for im in images],
                                   dtype=torch.float32, device=self.device)
            if self.letterbox:
                host = letterbox_host_u8 if self._u8_feed else letterbox_host
                batch = np.stack([host(im, (dim, dim)) for im in images])
            else:
                import cv2

                batch = np.stack([cv2.resize(im, (dim, dim), interpolation=cv2.INTER_CUBIC)
                                  for im in images])
                if not self._u8_feed:
                    batch = batch.astype(np.float32) / 255.0
            with span("h2d"):
                return torch.from_numpy(batch).to(self.device), org

    @torch.inference_mode()
    def detect(
        self,
        images: Sequence[np.ndarray],
        conf_thr: Optional[float] = None,
        nms_thr: Optional[float] = None,
        is_eval: bool = False,
        use_nms: bool = True,
        dim: Optional[int] = None,
        plain: bool = False,
    ) -> List[np.ndarray]:
        """Detect objects in HWC uint8 RGB images.

        Returns, per image, a [n, 7] array of rows
        [cls, x, y, w, h, prob, obj] in original-image pixels.  ``is_eval``
        proposes every (box, class) pair, with the eval thresholds
        (``config.eval_conf_thr`` / ``eval_nms_thr``) by default.  ``plain``
        runs the forward's kernels' plain PyTorch versions instead of the
        kernels; the preprocess is the same on both paths (its letterbox
        kernel against its plain version: ``letterbox_batch_ref``).
        """
        with span("detect"):
            if conf_thr is None:
                conf_thr = self.config.eval_conf_thr if is_eval else self.config.conf_thr
            if nms_thr is None:
                nms_thr = self.config.eval_nms_thr if is_eval else self.config.nms_thr
            if self.mesh is not None:
                images = M.data_shard(self.mesh, images)
            x, org = self.preprocess(images, dim)
            if self.mesh is not None:
                x = M.stripe(self.mesh, x, 1).contiguous()
            res = detect_fn(self.model, x, org, self.config, conf_thr, nms_thr,
                            is_eval=is_eval, use_nms=use_nms, is_letterbox=self.letterbox,
                            compute_dtype=self.compute_dtype, plain=plain, mesh=self.mesh,
                            scale_x_y=self.scale_x_y)
            with span("readback"):
                # reorder [x y w h obj prob cls] -> [cls x y w h prob obj]
                return [rows[:, [6, 0, 1, 2, 3, 5, 4]] for rows in detections_to_lists(res)]
