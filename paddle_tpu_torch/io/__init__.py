"""paddle_tpu_torch.io: datasets, samplers and the DataLoader (port of
``paddle_tpu/io``).  Workers batch numpy on the host; the consumer side
turns each batch into torch tensors on the loader's device (the CUDA
card unless ``places="cpu"``)."""

from .dataset import (Dataset, IterableDataset, TensorDataset, ComposeDataset,
                      ChainDataset, Subset, ConcatDataset, random_split)
from .sampler import (Sampler, SequenceSampler, RandomSampler, BatchSampler,
                      DistributedBatchSampler, WeightedRandomSampler,
                      SubsetRandomSampler)
from .dataloader import DataLoader, default_collate_fn, get_worker_info

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "Subset", "ConcatDataset", "random_split", "Sampler",
    "SequenceSampler", "RandomSampler", "BatchSampler",
    "DistributedBatchSampler", "WeightedRandomSampler", "SubsetRandomSampler",
    "DataLoader", "default_collate_fn", "get_worker_info",
]
