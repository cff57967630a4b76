"""paddle_tpu_torch.io — datasets, samplers and the DataLoader (counterpart
of ``paddle_tpu/io``). The worker processes (``io/worker.py``) are not
ported yet: ``DataLoader(num_workers > 0)`` raises (ROADMAP A12)."""
from .dataset import (  # noqa: F401
    ChainDataset, ComposeDataset, ConcatDataset, Dataset, IterableDataset,
    Subset, TensorDataset, random_split,
)
from .sampler import (  # noqa: F401
    BatchSampler, DistributedBatchSampler, RandomSampler, Sampler,
    SequenceSampler, SubsetRandomSampler, WeightedRandomSampler,
)
from .dataloader import DataLoader, default_collate_fn  # noqa: F401
