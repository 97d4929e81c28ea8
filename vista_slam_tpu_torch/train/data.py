"""Training data pipeline: spec-string dataset construction + host batching
(a copy of vista_slam_tpu/train/data.py).

The reference passes dataset expressions through eval() (reference:
sta_model/train.py:70-134,363-371 — e.g. "10000 @ ScanNet(...) + 3000 @
Replica(...)"); here the same composable syntax is parsed with a registry +
ast.literal_eval so arbitrary code never executes. The loader runs on any
dataset with the view-graph item layout: the readers of
datasets/view_graph.py, or datasets/synthetic_scene.py::SyntheticSceneDataset.
"""

from __future__ import annotations

import ast
import re

import numpy as np

from ..datasets import view_graph
from ..datasets.combinators import BatchedRandomSampler

REGISTRY = {
    name: getattr(view_graph, name)
    for name in ["ScanNet", "ScanNetpp", "SevenScenes", "ARKitScenes",
                 "Replica", "Co3d", "AriaSynthetic"]
}

_TERM = re.compile(r"^\s*(?:(\d+)\s*([@*])\s*)?([A-Za-z_]\w*)\s*\((.*)\)\s*$",
                   re.S)


def _parse_kwargs(arg_str: str) -> dict:
    if not arg_str.strip():
        return {}
    node = ast.parse(f"f({arg_str})", mode="eval").body
    if not isinstance(node, ast.Call) or node.args:
        raise ValueError("dataset specs take keyword arguments only")
    return {kw.arg: ast.literal_eval(kw.value) for kw in node.keywords}


def build_dataset(spec: str):
    """Parse 'N @ Name(k=v, ...) + M * Name2(...) + ...' into a dataset."""
    parts = _split_top_level(spec, "+")
    datasets = []
    for part in parts:
        m = _TERM.match(part)
        if not m:
            raise ValueError(f"cannot parse dataset term: {part!r}")
        count, op, name, args = m.groups()
        if name not in REGISTRY:
            raise ValueError(f"unknown dataset {name!r}; known: {sorted(REGISTRY)}")
        ds = REGISTRY[name](**_parse_kwargs(args))
        if count is not None:
            ds = (int(count) @ ds) if op == "@" else (int(count) * ds)
        datasets.append(ds)
    out = datasets[0]
    for ds in datasets[1:]:
        out = out + ds
    return out


def _split_top_level(s: str, sep: str) -> list[str]:
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch == sep and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return [p for p in (p.strip() for p in parts) if p]


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
    """Host-side loader: constrained batch sampler -> collated numpy batches.

    ``num_workers > 0`` reads views on a thread pool and keeps ``prefetch``
    collated batches ready ahead of the consumer, overlapping image decode
    with device steps (the reference gets this from torch DataLoader
    workers, datasets/__init__.py:36-55; cv2 decode releases the GIL, so
    threads parallelize for real). Sampling draws are per-(epoch, index)
    seeded in the view-graph datasets, so worker count never changes their
    data stream; ``world_size``/``rank`` take this process's batch-aligned
    shard of the sampler.
    """

    def __init__(self, dataset, batch_size: int, n_support: int,
                 world_size: int = 1, rank: int = 0, num_workers: int = 0,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.n_support = n_support
        self.num_workers = int(num_workers)
        self.prefetch = max(int(prefetch), 1)
        self.sampler = BatchedRandomSampler(
            dataset, batch_size, dataset.num_resolutions,
            world_size=world_size, rank=rank)

    def set_epoch(self, epoch: int):
        self.sampler.set_epoch(epoch)
        self.dataset.set_epoch(epoch)

    def __len__(self):
        return len(self.sampler) // self.batch_size

    def __iter__(self):
        if self.num_workers <= 0:
            buf = []
            for idx in self.sampler:
                buf.append(self.dataset[idx])
                if len(buf) == self.batch_size:
                    yield collate_graphs(buf, self.n_support)
                    buf = []
            return

        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        idxs = iter(list(self.sampler))
        max_outstanding = self.batch_size * (self.prefetch + 1)
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending: deque = deque()
            for idx in idxs:
                pending.append(pool.submit(self.dataset.__getitem__, idx))
                if len(pending) >= max_outstanding:
                    break
            buf = []
            while pending:
                buf.append(pending.popleft().result())  # ordered
                nxt = next(idxs, None)
                if nxt is not None:
                    pending.append(pool.submit(self.dataset.__getitem__, nxt))
                if len(buf) == self.batch_size:
                    yield collate_graphs(buf, self.n_support)
                    buf = []
