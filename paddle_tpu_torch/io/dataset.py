"""Datasets: port of ``paddle_tpu/io/dataset.py``.

The classes are the reference's host code.  ``random_split`` (:97) takes
its key from one draw of the default generator (``core.generator``):
the draw's threefry part is the reference's ``next_key()``, bit for
bit.  The permutation is ``jax.random.permutation(key, n)``'s rule
(``_shuffle``): ``ceil(3 ln n / ln(2**32 - 1))`` rounds, each splitting
the key, drawing 32-bit sort keys (``inference.threefry``'s ``split``
and ``random_bits``) and sorting by them, stably.  So the subsets are
the reference's, index for index.
"""

from __future__ import annotations

import bisect
import math

import numpy as np
import torch

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "ConcatDataset", "random_split"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not indexable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        lengths = {t.shape[0] for t in tensors}
        assert len(lengths) == 1, "tensors must share dim-0 length"
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for ds in self.datasets:
            item = ds[idx]
            out.extend(item if isinstance(item, tuple) else (item,))
        return tuple(out)

    def __len__(self):
        return min(len(ds) for ds in self.datasets)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for ds in self.datasets:
            yield from ds


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum(
            [len(d) for d in self.datasets]).tolist()

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


def permutation(key, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)`` for a threefry key ``(k0, k1)``
    (two 32-bit words) and an integer ``n``."""
    from ..inference import threefry
    rounds = int(math.ceil(3 * math.log(max(1, n))
                           / math.log(np.iinfo(np.uint32).max)))
    k = torch.tensor([int(key[0]), int(key[1])], dtype=torch.int64)
    x = torch.arange(n, dtype=torch.int64)
    for _ in range(rounds):
        k, sub = threefry.split(k, 2)
        bits = threefry.random_bits(sub, (n,))
        x = x[torch.sort(bits, stable=True).indices]
    return x.numpy()


def random_split(dataset, lengths, generator=None):
    from ..core.generator import default_generator
    total = len(dataset)
    if all(isinstance(l, float) for l in lengths):
        lengths = [int(round(l * total)) for l in lengths]
        lengths[-1] = total - sum(lengths[:-1])
    assert sum(lengths) == total
    key = (generator or default_generator()).draw().tf
    perm = permutation(key, total)
    out, offset = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[offset:offset + l].tolist()))
        offset += l
    return out
