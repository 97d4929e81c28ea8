"""Training data pipeline: host batching of sampled view graphs.

Copies of ``collate_graphs`` and ``TrainLoader`` from
vista_slam_tpu/train/data.py (the loader without its data-parallel shards
and reader threads, which wait for DDP). ``build_dataset`` (the
dataset-spec parser) waits for the real-data view-graph datasets
(ROADMAP.md, Queue 1); the loader runs on any dataset with the view-graph
item layout, such as datasets/synthetic_scene.py::SyntheticSceneDataset.
"""

from __future__ import annotations

import numpy as np

from ..datasets.combinators import BatchedRandomSampler


GT_KEYS = ("pts3d_cam", "valid_mask", "camera_pose", "camera_intrinsics")


def collate_graphs(graphs: list[dict], n_support: int) -> dict:
    """Stack sampled view graphs into the train-step batch layout:
      main: {img [B,...], gt keys [B,...]}
      supports: {gt keys [S,B,...]}, support_imgs [S,B,H,W,3]."""
    def stack_views(views, key):
        return np.stack([np.asarray(v[key]) for v in views])

    mains = [g["main_view"] for g in graphs]
    batch = {"main": {"img": stack_views(mains, "img")}}
    for k in GT_KEYS:
        batch["main"][k] = stack_views(mains, k)

    supports = {k: [] for k in GT_KEYS}
    imgs = []
    for s in range(n_support):
        views = [(g["neighbor_views"] + g["loop_views"])[s] for g in graphs]
        imgs.append(stack_views(views, "img"))
        for k in GT_KEYS:
            supports[k].append(stack_views(views, k))
    batch["support_imgs"] = np.stack(imgs)
    batch["supports"] = {k: np.stack(v) for k, v in supports.items()}
    return batch


class TrainLoader:
    """Host-side loader: constrained batch sampler -> collated numpy batches
    (the JAX package's loader with one process and no worker threads)."""

    def __init__(self, dataset, batch_size: int, n_support: int):
        self.dataset = dataset
        self.batch_size = batch_size
        self.n_support = n_support
        self.sampler = BatchedRandomSampler(dataset, batch_size, dataset.num_resolutions)

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)
        self.dataset.set_epoch(epoch)

    def __len__(self):
        return len(self.sampler) // self.batch_size

    def __iter__(self):
        buf = []
        for idx in self.sampler:
            buf.append(self.dataset[idx])
            if len(buf) == self.batch_size:
                yield collate_graphs(buf, self.n_support)
                buf = []
