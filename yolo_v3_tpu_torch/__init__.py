"""yolo_v3_tpu_torch: the PyTorch + CUDA port of ``yolo_v3_tpu``.

Module names mirror the JAX package (``models/darknet.py``,
``ops/postprocess.py``, ``detector.py``, ...).  Public functions keep the
JAX layouts (NHWC images and raw heads, HWIO conv weights) so the two
packages compare like with like; the JAX package stays the reference.

The convolutions run on hand-written Hopper kernels (``csrc/*.cu``: the
bf16/fp32 residual block, the int8 entry and the int8 padded-2D convs),
built with ``nvcc`` at first CUDA use.  Nothing is compiled at import, so
the package imports on a CPU-only host.
"""

__version__ = "0.1.0"
