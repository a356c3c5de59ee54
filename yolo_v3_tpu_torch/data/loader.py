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
with ``spawn``, so the dataset must pickle).  ``native_threads`` > 0
assembles each batch on the native C++ decode and augment pool
(:mod:`yolo_v3_tpu_torch.data.native_aug`), with the same labels and draws as
the Python path; a sample that is not a decodable JPEG takes the Python path
alone, and ``native_stats`` counts the samples of each path.  Unlike the JAX
package, the native path never turns itself off: without the library, or
with a dataset or transform it cannot take, it raises.

``host_id`` / ``n_hosts`` shard every batch over the ranks of a
data-parallel run (:mod:`yolo_v3_tpu_torch.parallel.distributed`): each
rank runs the same seed and schedule and assembles contiguous slice
``host_id`` of each global batch, on whichever assembly route, so the ranks'
shards concatenate to the single-process batch.
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
        host_id: int = 0,
        n_hosts: int = 1,
    ):
        if sampler.batch_size % n_hosts:
            raise ValueError(
                f"batch_size {sampler.batch_size} not divisible by {n_hosts} hosts")
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = sampler.batch_size
        self.current_batch = current_batch
        self.net_subdivisions = net_subdivisions
        self.prefetch = prefetch
        self.drop_keys = drop_keys
        self.num_workers = num_workers
        self.native_threads = native_threads
        self.native_stats = {"native": 0, "fallback": 0}
        self._pool = None
        self._prefetcher = None          # (stop event, thread) while prefetching
        self._native = None
        self._spec_cache: Dict[Any, Any] = {}
        if native_threads > 0:
            from yolo_v3_tpu_torch.data import native_loader

            if not hasattr(dataset, "raw_entry") or getattr(dataset, "trans_fn", None) is None:
                raise ValueError(
                    "native_threads needs a dataset with raw_entry() and a trans_fn "
                    f"(ListDataset); {type(dataset).__name__} lacks them")
            native_loader.load_library()        # raises with the build's error

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
        """Stop the prefetch thread, then shut down the worker pool and the
        native pool (idempotent)."""
        self._stop_prefetch()
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
        if self._native is not None:
            self._native.close()
            self._native = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def _native_assemble(self, tasks) -> Dict[str, Any]:
        """Assemble a batch on the C++ decode+augment pool
        (data/native_aug.py), with labels and randomness bit-identical to
        the Python path.  Non-JPEG samples, and a batch of mixed dims (not
        made by a sampler whose ``rand_dim_interval`` is a multiple of the
        batch), take the Python path; ``native_stats`` counts them."""
        from yolo_v3_tpu_torch.data import native_aug as NA

        ds = self.dataset
        keep = ("img", "label", "lb_reverter", "img_path")
        dims = {t[1] for t in tasks}
        dim = tasks[0][1]
        if len(dims) == 1:
            if dim not in self._spec_cache:
                self._spec_cache[dim] = NA.compile_transform(ds.trans_fn(dim))
            spec = self._spec_cache[dim]
            if spec is None:
                raise ValueError(
                    "native_threads takes only the darknet training chain "
                    "(transforms.training_transform without extra_aug); this "
                    "trans_fn is another (native_aug.compile_transform)")
            if self._native is None:
                self._native = NA.NativeAugLoader(self.native_threads)
            entries = [ds.raw_entry(t[0]) for t in tasks]
            samples, ok = self._native.load_batch(
                [e[0] for e in entries], [e[1] for e in entries],
                [t[2] for t in tasks], dim, spec,
            )
        else:
            samples, ok = [None] * len(tasks), [False] * len(tasks)
        for i, (base_idx, d, seed) in enumerate(tasks):
            if not ok[i]:
                s = ds.get(base_idx, d, seed)
                samples[i] = {k: s.get(k) for k in keep}
        n_native = sum(ok)
        self.native_stats["native"] += n_native
        self.native_stats["fallback"] += len(tasks) - n_native
        return collate(samples)

    def _assemble(self, positions: List[int]) -> Dict[str, Any]:
        tasks = [self.sampler.schedule(pos) for pos in positions]
        if self.native_threads > 0:
            return self._native_assemble(tasks)
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
        shard = self.batch_size // self.n_hosts
        for b in range(n):
            start = b * self.batch_size + self.host_id * shard
            yield self._assemble(list(range(start, start + shard)))

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
        stop = threading.Event()

        def put(item) -> bool:
            """Queue ``item``, unless the consumer has gone first."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in it:
                    if not put(item):
                        return
            except BaseException as e:  # surfaced to the consumer below
                err.append(e)
            finally:
                put(done)

        t = threading.Thread(target=worker, daemon=True)
        self._prefetcher = (stop, t)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            self._stop_prefetch()

    def _stop_prefetch(self) -> None:
        """Stop the prefetch thread and wait for it: it may be assembling a
        batch ahead on the native pool or the worker pool, which ``close``
        releases only after."""
        if self._prefetcher is not None:
            stop, t = self._prefetcher
            stop.set()
            if t is not threading.current_thread():
                t.join()
            self._prefetcher = None

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
