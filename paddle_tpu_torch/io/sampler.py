"""Samplers (counterpart of ``paddle_tpu/io/sampler.py``; its reference is
``python/paddle/fluid/dataloader/sampler.py`` and ``batch_sampler.py``).

The shuffling samplers draw from numpy's global generator, as the
reference's do, so ``np.random.seed`` fixes an epoch's order in both
packages alike."""
from __future__ import annotations

import math

import numpy as np


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices):
        self.indices = list(indices)

    def __iter__(self):
        return iter(np.random.permutation(self.indices).tolist())

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards the index stream across data-parallel ranks.

    Reference: `python/paddle/fluid/dataloader/batch_sampler.py`
    DistributedBatchSampler (pads to even division like the original).
    """

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            import torch.distributed as dist
            up = dist.is_available() and dist.is_initialized()
            if num_replicas is None:
                num_replicas = dist.get_world_size() if up else 1
            if rank is None:
                rank = dist.get_rank() if up else 0
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            indices = rng.permutation(n).tolist()
            self.epoch += 1
        else:
            indices = list(range(n))
        indices += indices[: (self.total_size - len(indices))]
        indices = indices[self.local_rank: self.total_size: self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
