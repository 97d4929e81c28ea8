"""The constrained batch sampler of the training loader (a copy of
``BatchedRandomSampler`` in vista_slam_tpu/datasets/combinators.py;
reference: vista_slam/datasets/base/batched_sampler.py): one aspect-ratio
index constant within each batch, batch-aligned shards per data-parallel
process. The dataset algebra (``+``, ``*``, ``@``) is not ported yet.
"""

from __future__ import annotations

import numpy as np


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
        assert world_size == 1 or drop_last
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
