"""Deterministic, resumable, cyclic sample scheduling.

The port's own copy of ``yolo_v3_tpu/data/sampler.py``.

Re-implementation of the reference's ``RandomCyclicDataset`` queue machinery
(reference dataset.py:34-157) — its most original subsystem — on counter-free
explicit RNG state (``numpy.random.Generator``) instead of the global torch
RNG:

* three queues (sample indices, multi-scale dims, per-sample RNG seeds) are
  pre-drawn so every sample's identity and augmentation randomness is fixed
  ahead of time,
* **cyclic** mode sizes an epoch to whole batches and carries leftover
  indices into the next epoch so every batch is always full
  (dataset.py:70-77),
* multi-scale dims are drawn as ``randint(lo, hi) * 32`` and held for
  ``rand_dim_interval`` consecutive samples (dataset.py:79-93) — keep the
  interval a multiple of the batch size so a batch is always one dim,
* ``state_dict``/``load_state_dict`` + ``trimm`` give O(1) fast-forward
  resume with no replay (dataset.py:114-150),
* the RNG state snapshot taken at each ``randomize`` makes
  pause/resume/one-go runs produce byte-identical schedules (the
  Deterministic_data_loading contract, reference README.md:58-65).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class CyclicSampler:
    """Schedules (base_index, dim, seed) triples for every sample."""

    def __init__(
        self,
        base_length: int,
        batch_size: int,
        shuffle: bool = True,
        cyclic: bool = True,
        dim: Optional[Tuple[int, int]] = None,
        rand_dim_interval: Optional[int] = None,
        seed: int = 0,
        dim_mult_range: Tuple[int, int] = (10, 20),
    ):
        self.base_length = base_length
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.cyclic = cyclic
        self.dim = dim
        self.rand_dim_interval = rand_dim_interval or 8
        self.dim_mult_range = dim_mult_range

        if cyclic:
            self.indices_batch = base_length // batch_size
            self.indices_size = self.indices_batch * batch_size
        else:
            self.indices_batch = math.ceil(base_length / batch_size)
            self.indices_size = base_length

        self.rng = np.random.default_rng(seed)
        self.rng_state: Optional[Dict[str, Any]] = None

        self.indices_queue: List[int] = []
        self.dims_queue: List[int] = []
        self.rands_queue: List[int] = []
        self.indices: List[int] = []
        self.dims: List[Tuple[int, int]] = []
        self.rands: List[int] = []
        self.randomize()

    # -- queue generation (dataset.py:64-100) -----------------------------

    def _generate_indices(self) -> List[int]:
        if self.shuffle:
            new = self.rng.permutation(self.base_length).tolist()
        else:
            new = list(range(self.base_length))
        if self.cyclic:
            if len(self.indices_queue) < self.indices_size:
                self.indices_queue = self.indices_queue + new
            out = self.indices_queue[: self.indices_size]
            self.indices_queue = self.indices_queue[self.indices_size:]
            return out
        self.indices_queue = []
        return new

    def _generate_dims(self) -> List[Tuple[int, int]]:
        if self.dim is not None:
            return [tuple(self.dim)] * self.indices_size
        interval = self.rand_dim_interval
        n_dim = 1 if self.base_length <= interval else math.ceil(
            self.base_length / interval
        )
        if len(self.dims_queue) < self.indices_size:
            lo, hi = self.dim_mult_range
            new = (self.rng.integers(lo, hi, size=n_dim) * 32)
            new = np.repeat(new, interval).tolist()
            self.dims_queue = self.dims_queue + new
        out = self.dims_queue[: self.indices_size]
        self.dims_queue = self.dims_queue[self.indices_size:]
        return [(s, s) for s in out]

    def _generate_rands(self) -> List[int]:
        if len(self.rands_queue) < self.indices_size:
            new = self.rng.integers(0, 2**32, size=self.base_length).tolist()
            self.rands_queue = self.rands_queue + new
        out = self.rands_queue[: self.indices_size]
        self.rands_queue = self.rands_queue[self.indices_size:]
        return out

    def randomize(self, rng_state: Optional[Dict[str, Any]] = None) -> None:
        """Roll the next epoch's schedule (reference randomize,
        dataset.py:102-112)."""
        if rng_state is not None:
            self.rng.bit_generator.state = rng_state
        elif self.rng_state is not None:
            self.rng.bit_generator.state = self.rng_state
        self.indices = self._generate_indices()
        self.dims = self._generate_dims()
        self.rands = self._generate_rands()
        self.rng_state = self.rng.bit_generator.state

    # -- resume (dataset.py:114-150) --------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "indices": list(self.indices),
            "dims": list(self.dims),
            "rands": list(self.rands),
            "indices_queue": list(self.indices_queue),
            "dims_queue": list(self.dims_queue),
            "rands_queue": list(self.rands_queue),
            "rng_state": self.rng_state,
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.indices = list(sd["indices"])
        self.dims = [tuple(d) for d in sd["dims"]]
        self.rands = list(sd["rands"])
        self.indices_queue = list(sd["indices_queue"])
        self.dims_queue = list(sd["dims_queue"])
        self.rands_queue = list(sd["rands_queue"])
        self.rng_state = sd["rng_state"]

    def trimm(self, batch_idx: int) -> None:
        """Drop already-consumed samples so resume starts exactly where the
        run stopped (reference trimm, dataset.py:135-150)."""
        offset_batch = batch_idx % self.indices_batch
        if offset_batch == 0:
            self.indices, self.dims, self.rands = [], [], []
        else:
            offset = self.indices_size - len(self.indices)
            idx = offset_batch * self.batch_size - offset
            self.indices = self.indices[idx:]
            self.dims = self.dims[idx:]
            self.rands = self.rands[idx:]

    # -- access ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.indices)

    def schedule(self, idx: int) -> Tuple[int, Tuple[int, int], int]:
        """(base_index, (w, h) dim, per-sample seed) for position ``idx``."""
        return self.indices[idx], self.dims[idx], self.rands[idx]
