"""DataHelper: resumable batch iteration over scheduler + dataset.

The port's own copy of ``yolo_v3_tpu/data/loader.py`` (reference
dataset.py:326-400).  It wraps a :class:`CyclicSampler` and a dataset into a
batch iterator that

* counts ``current_batch`` (mini-batches) with ``max_net_batches *
  net_subdivisions = max_batches`` semantics,
* re-``randomize``s the schedule at epoch boundaries,
* checkpoints as {current_batch, sampler state} and fast-forwards on
  restore via ``trimm``, with no replay,
* exposes batch/net-batch/epoch accessors.

A dataset is any object with ``get(base_index, (w, h) dim, seed) -> sample
dict`` and ``__len__``.  Batches are numpy arrays: imgs [B, H, W, 3] (all
samples of a batch share one multi-scale dim by construction) and labels
[B, max_labels, 5].  A background thread prefetches batches, and
``num_workers`` > 0 assembles samples in a pool of worker processes (started
with ``spawn``, so the dataset must pickle).  The native C++ decode and
augment pool of the JAX package (``native_threads``) comes with the port's
data-engine slice; until then asking for it raises.  The JAX package's
per-host batch sharding comes with the port's multi-card (DDP) slice.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from yolo_v3_tpu_torch.data.sampler import CyclicSampler

# --- multiprocess sample assembly -------------------------------------------
# The per-sample work is determined by (base_idx, dim, seed), so it
# parallelizes across processes without any loss of determinism: seeds ride
# in the schedule, and workers need no reseeding.

_WORKER_DS = None
_WORKER_DROP: tuple = ()


def _pool_init(dataset, drop_keys):
    global _WORKER_DS, _WORKER_DROP
    _WORKER_DS = dataset
    _WORKER_DROP = drop_keys


def _pool_get(task):
    base_idx, dim, seed = task
    s = _WORKER_DS.get(base_idx, dim, seed)
    for k in _WORKER_DROP:
        s.pop(k, None)
    return s


def collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack same-shaped fields, keep ragged ones as lists, all-None -> None
    (the reference's variable_shape_collate_fn contract)."""
    out: Dict[str, Any] = {}
    keys = samples[0].keys()
    for k in keys:
        vals = [s.get(k) for s in samples]
        if all(v is None for v in vals):
            out[k] = None
        elif all(isinstance(v, np.ndarray) for v in vals):
            same = all(v.shape == vals[0].shape for v in vals)
            out[k] = np.stack(vals) if same else vals
        else:
            out[k] = vals
    return out


class DataHelper:
    def __init__(
        self,
        dataset,
        sampler: CyclicSampler,
        current_batch: int = 0,
        max_net_batches: Optional[int] = None,
        max_batches: Optional[int] = None,
        net_subdivisions: int = 1,
        prefetch: int = 2,
        drop_keys: tuple = ("rng",),
        num_workers: int = 0,
        native_threads: int = 0,
    ):
        if native_threads > 0:
            raise NotImplementedError(
                "native_threads: the native decode and augment pool is not ported "
                "yet (ROADMAP queue A, the data engine); use num_workers")
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = sampler.batch_size
        self.current_batch = current_batch
        self.net_subdivisions = net_subdivisions
        self.prefetch = prefetch
        self.drop_keys = drop_keys
        self.num_workers = num_workers
        self._pool = None

        if max_net_batches is not None:
            self.max_net_batches = max_net_batches
            self.max_batches = max_net_batches * net_subdivisions
        elif max_batches is not None:
            self.max_batches = max_batches
        else:
            self.max_batches = sampler.indices_batch
        self._iterator: Optional[Iterator] = None

    # -- iteration ---------------------------------------------------------

    def _get_pool(self):
        if self._pool is None and self.num_workers > 0:
            import multiprocessing

            ctx = multiprocessing.get_context("spawn")
            self._pool = ctx.Pool(
                self.num_workers,
                initializer=_pool_init,
                initargs=(self.dataset, tuple(self.drop_keys)),
            )
        return self._pool

    def close(self) -> None:
        """Shut down the worker pool (idempotent)."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _assemble(self, positions: List[int]) -> Dict[str, Any]:
        tasks = [self.sampler.schedule(pos) for pos in positions]
        pool = self._get_pool()
        if pool is not None:
            samples = pool.map(_pool_get, tasks, chunksize=1)
        else:
            samples = []
            for base_idx, dim, seed in tasks:
                s = self.dataset.get(base_idx, dim, seed)
                for k in self.drop_keys:
                    s.pop(k, None)
                samples.append(s)
        return collate(samples)

    def _epoch_batches(self) -> Iterator[Dict[str, Any]]:
        n = len(self.sampler) // self.batch_size
        for b in range(n):
            start = b * self.batch_size
            yield self._assemble(list(range(start, start + self.batch_size)))

    def _gen(self) -> Iterator[Dict[str, Any]]:
        while self.current_batch < self.max_batches:
            produced = False
            for batch in self._prefetched(self._epoch_batches()):
                produced = True
                yield batch
                self.current_batch += 1
                if self.current_batch >= self.max_batches:
                    return
            self.sampler.randomize()
            if not produced and len(self.sampler) < self.batch_size:
                raise RuntimeError("sampler cannot fill a single batch")

    def _prefetched(self, it: Iterator) -> Iterator:
        if self.prefetch <= 0:
            yield from it
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        done = object()
        err: List[BaseException] = []

        def worker():
            try:
                for item in it:
                    q.put(item)
            except BaseException as e:  # surfaced to the consumer below
                err.append(e)
            finally:
                q.put(done)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is done:
                if err:
                    raise err[0]
                return
            yield item

    def __iter__(self):
        if self._iterator is None:
            self._iterator = iter(self._gen())
        return self._iterator

    def reset(self) -> "DataHelper":
        self._iterator = None
        self.current_batch = 0
        return self

    # -- resume ------------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "current_batch": self.current_batch,
            "sampler": self.sampler.state_dict(),
        }

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self._iterator = None
        self.current_batch = sd["current_batch"] + 1
        self.sampler.load_state_dict(sd["sampler"])
        self.sampler.trimm(batch_idx=self.current_batch)

    # -- accessors ---------------------------------------------------------

    def get_batch(self) -> int:
        return self.current_batch

    def get_net_batch(self) -> int:
        return self.current_batch // self.net_subdivisions

    def get_epoch_num_batches(self) -> int:
        return self.sampler.indices_batch

    def get_epoch(self) -> int:
        return self.current_batch // self.get_epoch_num_batches()

    def get_epoch_batch(self) -> int:
        return self.current_batch % self.get_epoch_num_batches()

    def is_start_of_epoch(self) -> bool:
        return self.current_batch % self.get_epoch_num_batches() == 0

    def is_end_of_epoch(self) -> bool:
        return (self.current_batch + 1) % self.get_epoch_num_batches() == 0
