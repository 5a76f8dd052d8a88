"""Threaded prefetching batch loader (a copy of ``dpc_tpu/data/loader.py``).

The reference keeps chips fed with 32 DataLoader *processes* serialising
tensors through pipes (``dpc/main.py:307-321``).  Here decode + augment run
in a thread pool (numpy releases the GIL for the hot work), batches are
assembled into pinned numpy arrays, and a bounded queue keeps
``prefetch_batches`` of them ready ahead of the training loop, which
copies each batch to the device as it is consumed.

Determinism: one root seed → per-(epoch, position) sample RNGs, so a run
is reproducible regardless of worker count — unlike the reference, whose
global-``random`` augmentation draws depend on worker scheduling.
"""

from __future__ import annotations

import multiprocessing
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Iterator

import numpy as np

# Worker-process state: the dataset is shipped ONCE per worker via the pool
# initializer (not per task), so the per-task payload is just
# (dataset_index, rng_seed_tuple).
_WORKER_DATASET = None


def _proc_init(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _proc_sample(task):
    index, seed = task
    return _WORKER_DATASET.sample(index, np.random.default_rng(seed))


class ClipLoader:
    """Iterate minibatches of a clip dataset.

    dataset: anything with ``__len__`` and
    ``sample(index, rng) -> clip | (clip, label)``.
    Yields float32 ``[B, N, SL, H, W, C]`` batches (plus int32 labels when
    the dataset returns them).
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 8,
                 prefetch_batches: int = 4, seed: int = 0,
                 shard_id: int = 0, num_shards: int = 1,
                 worker_mode: str = "thread"):
        """``batch_size`` is PER SHARD (per host).  ``shard_id/num_shards``
        give each host a disjoint slice of the same seeded permutation —
        the multi-host ingest contract (every host must draw the same
        order for the epoch to partition cleanly).

        ``worker_mode``: 'thread' (default — numpy work releases the GIL)
        or 'process' — a persistent
        spawn-based pool for transform chains that hold the GIL (the
        reference's 32-DataLoader-process strategy, ``dpc/main.py:311``).
        Determinism is identical in both modes: the per-(epoch, position)
        sample RNG travels with the task, not the worker.
        """
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = prefetch_batches
        self.seed = seed
        self.epoch = 0
        assert 0 <= shard_id < num_shards
        self.shard_id = shard_id
        self.num_shards = num_shards
        assert worker_mode in ("thread", "process"), worker_mode
        self.worker_mode = worker_mode
        self._proc_pool: ProcessPoolExecutor | None = None

    def _process_pool(self) -> ProcessPoolExecutor:
        """Lazily create ONE persistent worker pool (spawn, not fork: the
        parent may hold live CUDA or loader threads that do not survive a
        fork).  Reused across epochs; shut down via :meth:`close`."""
        if self._proc_pool is None:
            self._proc_pool = ProcessPoolExecutor(
                self.num_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_proc_init, initargs=(self.dataset,))
        return self._proc_pool

    def close(self) -> None:
        if self._proc_pool is not None:
            self._proc_pool.shutdown(wait=False, cancel_futures=True)
            self._proc_pool = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass

    def __len__(self) -> int:
        n = len(self.dataset) // self.num_shards
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        if self.num_shards > 1:
            per = n // self.num_shards
            order = order[self.shard_id * per:(self.shard_id + 1) * per]
        return order

    def __iter__(self) -> Iterator:
        return self.iterate(0)

    def iterate(self, start_batch: int = 0) -> Iterator:
        """Iterate from ``start_batch`` of this epoch's deterministic order
        (mid-epoch resume support: no data is loaded for skipped batches).
        """
        order = self._order()
        n = len(order)
        nb = len(self)
        # floor at 1: Queue(maxsize=0) means UNBOUNDED in the stdlib —
        # "--prefetch 0" would decode the whole epoch into host RAM
        out_q: queue.Queue = queue.Queue(
            maxsize=max(1, self.prefetch_batches))
        stop = threading.Event()

        def load_one(pos: int):
            rng = np.random.default_rng((self.seed, self.epoch, pos))
            return self.dataset.sample(int(order[pos]), rng)

        def produce_batches(load_batch):
            for b in range(start_batch, nb):
                lo = b * self.batch_size
                hi = min(lo + self.batch_size, n)
                items = load_batch(lo, hi)
                if stop.is_set():
                    return
                if isinstance(items[0], tuple):
                    clips = np.stack([it[0] for it in items])
                    labels = np.asarray([it[1] for it in items], np.int32)
                    out_q.put((clips, labels))
                else:
                    out_q.put(np.stack(items))

        def producer():
            try:
                if self.worker_mode == "process":
                    pool = self._process_pool()

                    def load_batch(lo, hi):
                        tasks = [(int(order[p]),
                                  (self.seed, self.epoch, p))
                                 for p in range(lo, hi)]
                        return list(pool.map(_proc_sample, tasks))

                    produce_batches(load_batch)
                else:
                    with ThreadPoolExecutor(self.num_workers) as pool:
                        produce_batches(
                            lambda lo, hi:
                            list(pool.map(load_one, range(lo, hi))))
            except Exception as e:  # surface worker errors to the consumer
                out_q.put(e)
            finally:
                out_q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can finish putting and exit
            while t.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)
