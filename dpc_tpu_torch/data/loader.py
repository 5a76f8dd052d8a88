"""Threaded prefetching batch loader (a copy of ``dpc_tpu/data/loader.py``).

The reference keeps chips fed with 32 DataLoader *processes* serialising
tensors through pipes (``dpc/main.py:307-321``).  Here decode + augment run
in a thread pool (numpy releases the GIL for the hot work), each worker
copies its sample into the batch's buffer (pinned host memory when the
batches go to a card), and a bounded queue keeps ``prefetch_batches`` of
them ready ahead of the training loop, which copies each batch to the
device as it is consumed.

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
    """``(sample, fallbacks)``: the sample and the planned-decode fallbacks
    it caused, which the worker's copy of the dataset logged (the loader
    adds them to the parent's, so the parent counts them all)."""
    index, seed = task
    log = getattr(_WORKER_DATASET, "fallbacks", [])
    seen = len(log)
    item = _WORKER_DATASET.sample(index, np.random.default_rng(seed))
    return item, log[seen:]


class _Batch:
    """One batch being filled in place, sample by sample; the buffer is
    made at the first sample's shape (in pinned memory with ``pin``)."""

    def __init__(self, size: int, pin: bool):
        self.size = size
        self.pin = pin
        self.clips = None
        self.labels = np.zeros(size, np.int32)
        self.has_labels = False
        self._lock = threading.Lock()

    def put(self, slot: int, item) -> None:
        clip = item[0] if isinstance(item, tuple) else item
        with self._lock:
            if self.clips is None:
                shape = (self.size, *clip.shape)
                if self.pin:
                    import torch  # only a card's feed pins

                    self.clips = torch.empty(
                        shape, dtype=torch.from_numpy(clip[:0]).dtype,
                        pin_memory=True)
                else:
                    self.clips = np.empty(shape, clip.dtype)
        # the copies of several workers run at once (numpy drops the
        # interpreter lock while it copies)
        target = self.clips.numpy() if self.pin else self.clips
        target[slot] = clip
        if isinstance(item, tuple):
            self.labels[slot] = item[1]
            self.has_labels = True

    def result(self):
        return (self.clips, self.labels) if self.has_labels else self.clips


class ClipLoader:
    """Iterate minibatches of a clip dataset.

    dataset: anything with ``__len__`` and
    ``sample(index, rng) -> clip | (clip, label)``.
    Yields ``[B, N, SL, H, W, C]`` batches in the dataset's dtype (plus
    int32 labels when the dataset returns them): numpy arrays, or torch
    tensors in pinned host memory with ``pin_memory``, which a card then
    copies without a host sync.
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 8,
                 prefetch_batches: int = 4, seed: int = 0,
                 shard_id: int = 0, num_shards: int = 1,
                 worker_mode: str = "thread", pin_memory: bool = False):
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
        self.pin_memory = pin_memory
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

    def close(self, wait: bool = False) -> None:
        """Shut the process pool down; ``wait`` also waits for the clips
        its workers are still making (a measurement that follows wants
        the cores back)."""
        if self._proc_pool is not None:
            self._proc_pool.shutdown(wait=wait, cancel_futures=True)
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

        Each sample is copied into its batch's buffer by the worker that
        made it (in thread mode; the producer does it for process
        workers), and the next batch's samples are queued before this
        batch is waited for, so the workers never idle while a batch is
        assembled.
        """
        order = self._order()
        n = len(order)
        nb = len(self)
        # floor at 1: Queue(maxsize=0) means UNBOUNDED in the stdlib —
        # "--prefetch 0" would decode the whole epoch into host RAM
        out_q: queue.Queue = queue.Queue(
            maxsize=max(1, self.prefetch_batches))
        stop = threading.Event()
        in_flight: list = []  # the futures of the batches being made

        def load_one(pos: int):
            rng = np.random.default_rng((self.seed, self.epoch, pos))
            return self.dataset.sample(int(order[pos]), rng)

        def fill(batch: _Batch, slot: int, pos: int) -> None:
            batch.put(slot, load_one(pos))

        def produce_batches(submit):
            """``submit(batch, slot, pos)`` queues one sample and returns
            its future, whose result is the item or None once in place."""
            def start(b):
                lo = b * self.batch_size
                hi = min(lo + self.batch_size, n)
                batch = _Batch(hi - lo, self.pin_memory)
                return batch, [submit(batch, slot, pos)
                               for slot, pos in enumerate(range(lo, hi))]

            nxt = start(start_batch) if start_batch < nb else None
            for b in range(start_batch, nb):
                batch, futures = nxt
                nxt = start(b + 1) if b + 1 < nb else None
                in_flight[:] = futures + (nxt[1] if nxt else [])
                if stop.is_set():
                    # the consumer stopped early (a capped epoch,
                    # preemption): it never waits for these batches
                    for f in in_flight:
                        f.cancel()
                for slot, f in enumerate(futures):
                    item = f.result()
                    if item is not None:  # a process worker's sample
                        item, fell = item
                        batch.put(slot, item)
                        if fell:
                            self.dataset.fallbacks.extend(fell)
                if stop.is_set():
                    return
                out_q.put(batch.result())

        def producer():
            try:
                if self.worker_mode == "process":
                    pool = self._process_pool()
                    produce_batches(lambda batch, slot, pos: pool.submit(
                        _proc_sample, (int(order[pos]),
                                       (self.seed, self.epoch, pos))))
                else:
                    with ThreadPoolExecutor(self.num_workers) as pool:
                        produce_batches(lambda batch, slot, pos: pool.submit(
                            fill, batch, slot, pos))
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
            for f in list(in_flight):
                f.cancel()
            # drain so the producer can finish putting and exit
            while t.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)
