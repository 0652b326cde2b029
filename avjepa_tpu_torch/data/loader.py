"""Host-side batching without JAX: a sharded index sampler and a batch
loader over a pool of threads or processes.

Counterpart of ``avjepa_tpu/data/loader.py``. The sampler keeps that
module's semantics; the number of shards and this process's shard are given
explicitly (one process drives one GPU). The loader decodes samples in a
thread pool, or with ``use_processes`` in a process pool (``forkserver``, as
the JAX loader: a forked copy of a process that holds a CUDA context and
torch's threads is unsafe), retries a failed decode on a resampled index,
calls the mask collator once per batch in batch order on its producer thread
in this process (as ``JepaLoader._assemble`` does), and keeps a bounded queue
of batches ahead of the consumer. A process worker holds its own copy of the
dataset, shipped once by the pool's initializer, so each task carries the
loader's epoch and the resample flag; a script that builds a process loader
needs an ``if __name__ == "__main__":`` guard, since ``forkserver`` imports
the main module.

The evals' exact-validation path is the JAX module's too: with
``retry_resample=False`` a failed sample is retried on its own index and then
becomes a ``FetchFailure``; ``exact_val_collate`` replaces it with a good
sample of the batch and appends a per-row ``ok`` mask, and
``ShardedSampler.batch_valid_masks`` marks the wrap-padded duplicate rows, so
top-1 counts each sample once and leaves a failed one out.
"""

from __future__ import annotations

import logging
import multiprocessing
import queue
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np


class FetchFailure:
    """A sample that failed to decode after its retries
    (``retry_resample=False`` only): the collate leaves its slot out of the
    metric instead of scoring a substitute."""

    __slots__ = ("idx",)

    def __init__(self, idx: int):
        self.idx = int(idx)


class ShardedSampler:
    """Epoch-shuffled (or weighted), sharded index sampler (DistributedSampler
    semantics: equal shards, wrap-around padding, set_epoch reshuffle)."""

    def __init__(
        self,
        dataset_len: int,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_shards: int = 1,
        shard_index: int = 0,
        drop_last: bool = True,
        weights: Optional[np.ndarray] = None,
    ):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")
        self.dataset_len = dataset_len
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.drop_last = drop_last
        self.weights = weights
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[np.ndarray]:
        rng = np.random.default_rng([self.seed, self.epoch])
        if self.weights is not None:
            # multi-dataset weighted draws (reference DistributedWeightedSampler)
            w = np.asarray(self.weights, np.float64)
            order = rng.choice(self.dataset_len, size=self.dataset_len, p=w / w.sum())
        elif self.shuffle:
            order = rng.permutation(self.dataset_len)
        else:
            order = np.arange(self.dataset_len)
        # pad to a multiple of shards (DistributedSampler wrap-around)
        total = int(np.ceil(self.dataset_len / self.num_shards)) * self.num_shards
        if total > len(order):
            order = np.concatenate([order, order[: total - len(order)]])
        shard = order[self.shard_index :: self.num_shards]
        if not self.drop_last and len(shard) % self.batch_size:
            # wrap-pad the final partial batch to full size; np.resize wraps
            # cyclically, so a shard smaller than half a batch still fills it
            pad = self.batch_size - len(shard) % self.batch_size
            shard = np.resize(shard, len(shard) + pad)
        for i in range(len(shard) // self.batch_size):
            yield shard[i * self.batch_size : (i + 1) * self.batch_size]

    def batch_valid_masks(self) -> Iterator[np.ndarray]:
        """Per-batch bool masks, False on the rows that shard-level and
        batch-level wrap padding repeat (in ``__iter__``'s layout: shard
        element k sits at padded position shard_index + num_shards * k, and
        positions >= dataset_len are pads). Zip them with the batches so that
        exact counts score each sample once. Undefined for weighted draws."""
        if self.weights is not None:
            raise ValueError("validity is undefined for weighted draws")
        total = int(np.ceil(self.dataset_len / self.num_shards)) * self.num_shards
        shard_len = total // self.num_shards
        valid = (self.shard_index + self.num_shards * np.arange(shard_len)) < self.dataset_len
        if not self.drop_last and shard_len % self.batch_size:
            pad = self.batch_size - shard_len % self.batch_size
            valid = np.concatenate([valid, np.zeros(pad, bool)])
        for i in range(len(valid) // self.batch_size):
            yield valid[i * self.batch_size : (i + 1) * self.batch_size]


def fetch_with_retry(dataset, idx: int, resample: bool = True):
    """dataset[idx]; a failed decode is retried (10 tries) on a resampled
    index, as the JAX loader does (the sample then reports that other index).
    With ``resample=False`` it is retried 3 times on the same index, then
    returned as a ``FetchFailure``."""
    for attempt in range(10 if resample else 3):
        try:
            return dataset[int(idx)]
        except Exception:  # noqa: BLE001 - any decode failure resamples
            if resample:
                idx = np.random.default_rng([int(idx), attempt]).integers(0, len(dataset))
    if not resample:
        return FetchFailure(idx)
    raise RuntimeError("persistent decode failure")


# a process worker's copy of the dataset, set once by the pool initializer (a
# bound method as the task would drag the loader's pool and locks along)
_WORKER_DATASET = None


def _init_worker(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _fetch_worker(idx: int, epoch: int, resample: bool):
    # the parent's set_epoch never reaches this copy: the epoch rides in with
    # each task, so that every epoch draws its own crops
    if hasattr(_WORKER_DATASET, "set_epoch"):
        _WORKER_DATASET.set_epoch(epoch)
    return fetch_with_retry(_WORKER_DATASET, idx, resample)


def exact_val_collate(collate):
    """Wrap ``collate`` for a ``retry_resample=False`` loader: FetchFailure
    slots get a copy of a good sample of the batch (the shapes stay fixed)
    and a per-row ``ok`` mask is appended to the collate's outputs. A batch
    that failed whole is filled from the last good sample seen, all rows not
    ok; only a first batch that failed whole raises (no sample to copy)."""
    last_good = []

    def wrapped(samples):
        ok = np.asarray([not isinstance(s, FetchFailure) for s in samples], bool)
        if not ok.all():
            failed = [s.idx for s in samples if isinstance(s, FetchFailure)]
            logging.getLogger("avjepa_tpu_torch").warning(
                f"val decode failure: sample indices {failed} excluded from the metric")
            if not ok.any():
                if not last_good:
                    raise RuntimeError("entire first val batch failed to decode (no shape "
                                       "donor for an all-False batch); dataset unreadable?")
                samples = [last_good[0]] * len(samples)
            else:
                good = samples[int(np.argmax(ok))]
                samples = [s if o else good for s, o in zip(samples, ok)]
        if ok.any():
            last_good[:] = [samples[int(np.argmax(ok))]]
        out = collate(samples)
        if not isinstance(out, tuple):
            out = (out,)
        return (*out, ok)

    return wrapped


def collate_av(samples) -> tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """(video [B, T, H, W, 3], audio [B, Hs, Ws, 1] or None, labels [B])."""
    video = np.stack([s[0] for s in samples])
    audio = None
    if samples[0][1] is not None:
        audio = np.stack([s[1] for s in samples])[..., None]
    labels = np.asarray([s[2] for s in samples])
    return video, audio, labels


class BatchLoader:
    """Iterates collated batches (``collate``'s output; by default ``(video,
    audio, labels)``), plus the mask sets ``mask_collator(batch_size)`` when
    one is given, decoding ahead in ``num_workers`` threads (or, with
    ``use_processes``, worker processes) with at most ``prefetch`` batches
    waiting. ``retry_resample=False`` hands failed samples to ``collate`` as
    ``FetchFailure`` (see ``exact_val_collate``). ``stats`` sums the
    producer's seconds in fetch, collate and masks over the batches it made.
    ``close()`` stops the pool."""

    def __init__(self, dataset, sampler: ShardedSampler, num_workers: int = 4,
                 prefetch: int = 2, mask_collator=None, collate=collate_av,
                 retry_resample: bool = True, use_processes: bool = False):
        self.dataset = dataset
        self.sampler = sampler
        self.prefetch = prefetch
        self.mask_collator = mask_collator
        self.collate = collate
        self.retry_resample = retry_resample
        self.use_processes = use_processes
        self.epoch = 0
        self.stats = {"batches": 0, "fetch_s": 0.0, "collate_s": 0.0, "masks_s": 0.0}
        if use_processes:
            self._pool = ProcessPoolExecutor(
                max_workers=max(1, num_workers),
                mp_context=multiprocessing.get_context("forkserver"),
                initializer=_init_worker, initargs=(dataset,))
        else:
            self._pool = ThreadPoolExecutor(max_workers=max(1, num_workers))

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle, and salt the dataset's per-sample augmentation (a
        process worker's copy gets the epoch with each task)."""
        self.epoch = epoch
        self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def close(self) -> None:
        """Cancel what is queued and join the workers."""
        self._pool.shutdown(wait=True, cancel_futures=True)

    def _assemble(self, indices: np.ndarray):
        t0 = time.perf_counter()
        if self.use_processes:
            n = len(indices)
            samples = list(self._pool.map(_fetch_worker, [int(i) for i in indices],
                                          [self.epoch] * n, [self.retry_resample] * n))
        else:
            samples = list(self._pool.map(
                lambda i: fetch_with_retry(self.dataset, i, self.retry_resample), indices))
        t1 = time.perf_counter()
        batch = self.collate(samples)
        t2 = time.perf_counter()
        if self.mask_collator is not None:
            batch = (*batch, self.mask_collator(len(indices)))
        stats = self.stats
        stats["batches"] += 1
        stats["fetch_s"] += t1 - t0
        stats["collate_s"] += t2 - t1
        stats["masks_s"] += time.perf_counter() - t2
        return batch

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        error: list = []

        def put_or_stop(item) -> bool:
            # a plain put would block forever once the consumer stops reading
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for indices in self.sampler:
                    if stop.is_set() or not put_or_stop(self._assemble(indices)):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
                error.append(e)
            finally:
                put_or_stop(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()
            thread.join(timeout=10)
