"""Device-resident per-node pointmap store, as in
vista_slam_tpu/slam/pointmap_store.py.

Every node's (depth, conf) maps live on the device in fp16
[max_nodes, H, W] buffers, written in place; the per-node reductions that
consume them (relative scale between two nodes of one view, reference:
slam.py:218-232, slam_utils.py:168-190) run on the device and return
scalars. Dense maps leave the device only at save/eval time.
"""

from __future__ import annotations

import numpy as np
import torch


def pair_scales(depth: torch.Tensor, conf: torch.Tensor, new_idx: torch.Tensor,
                first_idx: torch.Tensor):
    """Batched least-squares scale and scale confidence between node pairs."""
    d_new = depth[new_idx].float()
    d_first = depth[first_idx].float()
    c_new = conf[new_idx].float()
    c_first = conf[first_idx].float()
    w = torch.clamp_min(c_new * c_first, 1e-6)
    s = ((w * d_new * d_first).sum((1, 2))
         / torch.clamp_min((w * d_new * d_new).sum((1, 2)), 1e-12))
    return s, torch.sqrt(c_new * c_first).mean((1, 2))


class DevicePointmapStore:
    def __init__(self, max_nodes: int, hw=(224, 224), device="cpu",
                 dtype=torch.float16):
        self.max_nodes = max_nodes
        self.hw = tuple(hw)
        self.device = torch.device(device)
        self.depth = torch.zeros((max_nodes,) + self.hw, dtype=dtype, device=self.device)
        self.conf = torch.zeros_like(self.depth)
        self.intri = np.zeros((max_nodes, 3, 3), np.float32)  # tiny: host

    def _index(self, idxs) -> torch.Tensor:
        return torch.as_tensor(np.asarray(idxs, np.int64), device=self.device)

    def reset(self):
        self.depth.zero_()
        self.conf.zero_()
        self.intri[:] = 0

    def write_batch(self, idxs, depths, confs, intris=None):
        """idxs [M]; depths/confs [M, H, W] tensors or arrays; intris
        [M, 3, 3] host (or later via set_intri). Writes in place."""
        idx = self._index(idxs)
        self.depth.index_copy_(0, idx, torch.as_tensor(depths).to(self.device, self.depth.dtype))
        self.conf.index_copy_(0, idx, torch.as_tensor(confs).to(self.device, self.conf.dtype))
        if intris is not None:
            self.set_intri(idxs, intris)

    def set_intri(self, idxs, intris):
        self.intri[np.asarray(idxs)] = np.asarray(intris, np.float32)

    def scales_batch_async(self, new_idxs, first_idxs):
        """The batched scale reduction; returns device (s, conf) tensors."""
        return pair_scales(self.depth, self.conf, self._index(new_idxs),
                           self._index(first_idxs))

    def scales_batch(self, new_idxs, first_idxs):
        s, c = self.scales_batch_async(new_idxs, first_idxs)
        return s.cpu().numpy(), c.cpu().numpy()

    def fetch(self, idx: int):
        """One node's (depth fp32, conf fp32, intri) on the host."""
        return (self.depth[idx].float().cpu().numpy(),
                self.conf[idx].float().cpu().numpy(), self.intri[idx])

    def fetch_many(self, idxs):
        idx = self._index(idxs)
        return (self.depth[idx].float().cpu().numpy(),
                self.conf[idx].float().cpu().numpy(),
                self.intri[np.asarray(idxs)])
