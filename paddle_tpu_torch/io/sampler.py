"""Samplers: a copy of ``paddle_tpu/io/sampler.py``.

The draws are the reference's: ``RandomSampler``, ``SubsetRandomSampler``
and ``WeightedRandomSampler`` draw from ``np.random.default_rng()`` with
OS entropy and do not read ``generator`` (a shuffled epoch is therefore
not reproducible in either package); ``DistributedBatchSampler`` shuffles
by ``np.random.default_rng(epoch)`` and reads the rank and world size of
``distributed`` (the process group's, else the launcher's environment).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["Sampler", "SequenceSampler", "RandomSampler", "BatchSampler",
           "DistributedBatchSampler", "WeightedRandomSampler",
           "SubsetRandomSampler"]


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
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = np.random.default_rng()
        if self.replacement:
            return iter(rng.integers(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices, generator=None):
        super().__init__(indices)
        self.indices = list(indices)

    def __iter__(self):
        rng = np.random.default_rng()
        return iter(rng.permutation(len(self.indices)).tolist())

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        rng = np.random.default_rng()
        return iter(rng.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False, batch_size=1,
                 drop_last=False):
        if sampler is None:
            sampler = RandomSampler(dataset) if shuffle \
                else SequenceSampler(dataset)
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

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
    """Rank-sharded batch sampler (reference:
    python/paddle/io/dataloader/dataloader_iter.py DistributedBatchSampler)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..distributed import get_rank, get_world_size
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None \
            else get_world_size()
        self.local_rank = rank if rank is not None else get_rank()
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.epoch)
            indices = rng.permutation(n)
        indices = np.concatenate(
            [indices, indices[:self.total_size - n]])  # pad to even
        indices = indices[self.local_rank::self.nranks].tolist()
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
