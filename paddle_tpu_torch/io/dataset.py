"""Dataset abstractions (counterpart of ``paddle_tpu/io/dataset.py``; its
reference is ``python/paddle/fluid/dataloader/dataset.py``). A sample is
whatever ``__getitem__`` returns: numpy arrays, torch tensors or numbers."""
from __future__ import annotations

import bisect

import numpy as np


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        assert all(t.shape[0] == tensors[0].shape[0] for t in tensors)
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        assert all(len(d) == len(self.datasets[0]) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            out.extend(sample if isinstance(sample, (list, tuple)) else [sample])
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    if all(isinstance(l, float) for l in lengths):
        lengths = [int(round(l * total)) for l in lengths]
        lengths[-1] = total - sum(lengths[:-1])
    assert sum(lengths) == total
    perm = np.random.permutation(total).tolist()
    out, off = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[off:off + l]))
        off += l
    return out
