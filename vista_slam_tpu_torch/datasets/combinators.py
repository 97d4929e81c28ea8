"""Composable dataset algebra + constrained batch sampler (a copy of
vista_slam_tpu/datasets/combinators.py; reference: vista_slam/datasets/
base/easy_dataset.py, base/batched_sampler.py):
  2 * ds      duplicate every element
  1000 @ ds   resize to 1000 elements (random re-sampling per epoch)
  ds1 + ds2   concatenation
The sampler keeps one aspect-ratio index constant within each batch and
shards aligned batch slices across data-parallel processes.
"""

from __future__ import annotations

import numpy as np


class ComposableDataset:
    """Mixin providing the combinator operators."""

    def __add__(self, other):
        return CatDataset([self, other])

    def __rmul__(self, factor):
        return MulDataset(int(factor), self)

    def __rmatmul__(self, size):
        return ResizedDataset(int(size), self)

    def set_epoch(self, epoch: int):
        pass

    @property
    def num_resolutions(self) -> int:
        return len(getattr(self, "_resolutions", [0]))

    def make_sampler(self, batch_size, world_size=1, rank=0, drop_last=True):
        return BatchedRandomSampler(self, batch_size, self.num_resolutions,
                                    world_size=world_size, rank=rank,
                                    drop_last=drop_last)


class CatDataset(ComposableDataset):
    def __init__(self, datasets):
        flat = []
        for d in datasets:
            flat.extend(d.datasets if isinstance(d, CatDataset) else [d])
        self.datasets = flat
        self._offsets = np.cumsum([0] + [len(d) for d in flat])

    def __len__(self):
        return int(self._offsets[-1])

    def set_epoch(self, epoch):
        for d in self.datasets:
            d.set_epoch(epoch)

    @property
    def num_resolutions(self):
        n = {d.num_resolutions for d in self.datasets}
        if len(n) != 1:
            raise ValueError("all concatenated datasets need the same resolutions")
        return n.pop()

    def __getitem__(self, idx):
        idx, ar = idx if isinstance(idx, tuple) else (idx, 0)
        k = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self.datasets[k][(idx - int(self._offsets[k]), ar)]


class MulDataset(ComposableDataset):
    def __init__(self, factor, dataset):
        if factor < 1:
            raise ValueError(f"factor must be >= 1, got {factor}")
        self.factor = factor
        self.dataset = dataset

    def __len__(self):
        return self.factor * len(self.dataset)

    def set_epoch(self, epoch):
        self.dataset.set_epoch(epoch)

    @property
    def num_resolutions(self):
        return self.dataset.num_resolutions

    def __getitem__(self, idx):
        idx, ar = idx if isinstance(idx, tuple) else (idx, 0)
        return self.dataset[(idx // self.factor, ar)]


class ResizedDataset(ComposableDataset):
    """Epoch-dependent random re-indexing to a fixed virtual size."""

    def __init__(self, size, dataset):
        if size < 1:
            raise ValueError(f"size must be >= 1, got {size}")
        self.size = size
        self.dataset = dataset
        self._idxs = None
        self.set_epoch(0)

    def __len__(self):
        return self.size

    def set_epoch(self, epoch):
        rng = np.random.default_rng(epoch + 111)
        reps = -(-self.size // len(self.dataset))
        pool = np.concatenate(
            [rng.permutation(len(self.dataset)) for _ in range(reps)])
        self._idxs = pool[: self.size]
        self.dataset.set_epoch(epoch)

    @property
    def num_resolutions(self):
        return self.dataset.num_resolutions

    def __getitem__(self, idx):
        idx, ar = idx if isinstance(idx, tuple) else (idx, 0)
        return self.dataset[(int(self._idxs[idx]), ar)]


def _round_by(total, multiple):
    return (total // multiple) * multiple


class BatchedRandomSampler:
    """Yields (sample_idx, resolution_idx) tuples; the resolution index is
    constant within each batch; batch-aligned shards per process."""

    def __init__(self, dataset, batch_size, pool_size, world_size=1, rank=0,
                 drop_last=True):
        self.batch_size = batch_size
        self.pool_size = max(pool_size, 1)
        self.len_dataset = n = len(dataset)
        self.total_size = _round_by(n, batch_size * world_size) if drop_last else n
        if world_size > 1 and not drop_last:
            raise ValueError("sharding over processes needs drop_last")
        self.world_size = world_size
        self.rank = rank
        self.epoch = 0

    def __len__(self):
        return self.total_size // self.world_size

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.default_rng(self.epoch + 777)
        sample_idxs = rng.permutation(self.total_size) % self.len_dataset
        n_batches = -(-self.total_size // self.batch_size)
        feat = rng.integers(self.pool_size, size=n_batches)
        feat = np.broadcast_to(feat[:, None], (n_batches, self.batch_size))
        feat = feat.ravel()[: self.total_size]
        idxs = np.stack([sample_idxs, feat], axis=1)
        per_proc = self.batch_size * (
            -(-self.total_size // (self.world_size * self.batch_size)))
        shard = idxs[self.rank * per_proc: (self.rank + 1) * per_proc]
        yield from (tuple(int(v) for v in row) for row in shard)
