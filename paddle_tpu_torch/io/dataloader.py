"""DataLoader with a prefetching worker thread (counterpart of
``paddle_tpu/io/dataloader.py``).

Batches are collated on a worker thread into a bounded queue, as in the
reference (its ``use_buffer_reader`` queue); they stay on the host: the
consumer (``hapi.Model``, a training loop) moves them to its device.
The reference's worker PROCESSES (``num_workers > 0``, ``io/worker.py``)
are not ported yet (ROADMAP A12): asking for them raises.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..profiler import metrics as _metrics_mod
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

_REG = _metrics_mod.default_registry()
_M_DL_WAIT = _REG.counter(
    "dataloader_wait_seconds_total",
    "time the consumer spent blocked waiting for the next batch")
_M_DL_BATCHES = _REG.counter("dataloader_batches_total",
                             "batches delivered to the consumer")
_M_DL_WAIT_HIST = _REG.histogram(
    "dataloader_wait_seconds", "per-batch consumer wait time")


def _record_fetch_wait(wait_s: float):
    if _metrics_mod.enabled():
        _M_DL_WAIT.inc(wait_s)
        _M_DL_BATCHES.inc()
        _M_DL_WAIT_HIST.observe(wait_s)


def default_collate_fn(batch):
    """Stack a list of samples into one batch: arrays, tensors and numbers
    become CPU tensors (the reference makes Tensors); lists, tuples and
    dicts are collated field by field."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, float, np.integer, np.floating)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(sample, (list, tuple)):
        transposed = list(zip(*batch))
        return type(sample)(default_collate_fn(list(f)) for f in transposed)
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


class _Abandoned(BaseException):
    """Internal: consumer stopped iterating; unwind the producer thread."""


def _producer(loader, q: "queue.Queue", stop: threading.Event):
    """Worker body. Deliberately NOT a bound method of the iterator: the
    thread must not keep the iterator alive, so that an abandoned epoch
    (consumer broke out early) lets the iterator's __del__ set `stop`."""

    def put(batch):
        while not stop.is_set():
            try:
                q.put(batch, timeout=0.1)
                return
            except queue.Full:
                continue
        raise _Abandoned()

    try:
        if isinstance(loader.dataset, IterableDataset):
            buf = []
            for sample in loader.dataset:
                buf.append(sample)
                if len(buf) == loader.batch_size:
                    put(loader.collate_fn(buf))
                    buf = []
                if stop.is_set():
                    return
            if buf and not loader.drop_last:
                put(loader.collate_fn(buf))
        else:
            for idx_batch in iter(loader.batch_sampler):
                if stop.is_set():
                    return
                put(loader.collate_fn([loader.dataset[i] for i in idx_batch]))
        put(None)
    except _Abandoned:
        pass
    except BaseException as e:  # propagate to consumer
        try:
            q.put(e, timeout=1.0)
        except queue.Full:
            pass


class _PrefetchIter:
    """Pull batches through a worker thread."""

    def __init__(self, loader):
        self._q: "queue.Queue" = queue.Queue(
            maxsize=max(2, loader.prefetch_factor))
        self._stop = threading.Event()
        self._worker = threading.Thread(
            target=_producer, args=(loader, self._q, self._stop), daemon=True)
        self._worker.start()
        self._done = False

    def __next__(self):
        if self._done:
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        if item is None:
            self._done = True
            raise StopIteration
        if isinstance(item, BaseException):
            self._done = True
            raise item
        _record_fetch_wait(time.perf_counter() - t0)
        return item

    def __iter__(self):
        return self

    def __del__(self):
        self._stop.set()


class DataLoader:
    def __init__(self, dataset: Dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False,
                 collate_fn: Optional[Callable] = None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, worker_max_restarts=2):
        if num_workers and num_workers > 0:
            raise NotImplementedError(
                "DataLoader(num_workers > 0): the worker processes "
                "(paddle_tpu/io/worker.py) are not ported yet (ROADMAP A12); "
                "use num_workers=0 (a prefetching thread)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate_fn
        self.prefetch_factor = prefetch_factor
        self.num_workers = 0
        self.timeout = timeout
        if isinstance(dataset, IterableDataset):
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def __iter__(self):
        return _PrefetchIter(self)

    def __len__(self):
        if self.batch_sampler is None:
            raise TypeError("IterableDataset has no len()")
        return len(self.batch_sampler)

    def __call__(self):
        return self.__iter__()
