"""STA frontend engine for online SLAM: bucketed, pair-batched, eager.

Same protocol as vista_slam_tpu/slam/frontend.py. All candidate pairs of a
keyframe are decoded in one forward whose batch axis is the pair set (both
decode directions ride the same batch; the reference decodes one pair at a
time, vista_slam/slam.py:263-277). Pair batches are padded to the buckets
(1, 2, 4, 8), padded pairs writing to the store's scrap slot. The fused edge
step computes pointmaps, confidences, relative poses, shared intrinsics,
mean confidences, the in-place fp16 store scatter and the per-node scale
reductions on the device, and brings the small outputs back as one packed
fp32 vector: one device-to-host copy per keyframe. ``decode_pairs`` is the
plain step: decode and heads only, the dense maps left on the device for
the caller to store (OnlineSLAM's path for frontends without the fused
step), the small outputs fetched in one copy or left on the device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models.sta import STA, STAConfig
from ..utils.geometry import estimate_intrinsics_shared
from .host_math import from_matrix as sim3_from_matrix_np
from .pointmap_store import DevicePointmapStore, pair_scales

_BUCKETS = (1, 2, 4, 8)
_F16_MAX = 6.0e4  # dense maps are clipped into the fp16 range before storing


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"pair batch {n} exceeds the largest bucket {_BUCKETS[-1]}")


# Per-pair host outputs of the fused edge step, in packing order (the same
# 45 floats per pair as the JAX package's frontend).
_HOST_SPEC = (("pose_ij", 16), ("pose_conf_ij", 1), ("pose_ji", 16),
              ("pose_conf_ji", 1), ("mean_conf_i", 1), ("mean_conf_j", 1),
              ("K", 9))
_HOST_SHAPES = {"pose_ij": (4, 4), "pose_ji": (4, 4), "K": (3, 3)}
_PAIR_FLOATS = sum(w for _, w in _HOST_SPEC)  # 45


def _pack_host(host: dict, b: int) -> torch.Tensor:
    """[b*45 + 2*j_max] fp32: the per-pair block, then the scale and
    scale-confidence job rows where ``host`` has them. Inverse of
    _unpack_host."""
    pair = torch.cat([torch.as_tensor(host[k]).reshape(b, w).float()
                      for k, w in _HOST_SPEC], dim=1)
    rows = [torch.as_tensor(host[k]).float() for k in ("scale", "scale_conf") if k in host]
    return torch.cat([pair.reshape(-1)] + rows)


def fetch_host(host: dict, b: int, scales=None) -> dict:
    """The per-pair outputs of ``b`` pairs and the (scale, scale_conf) job
    rows of ``scales`` (none: empty), brought to the host as numpy in one
    device-to-host copy."""
    if scales is not None:
        host = dict(host, scale=scales[0], scale_conf=scales[1])
    return _unpack_host(_pack_host(host, b).cpu().numpy(), b)


def _unpack_host(flat: np.ndarray, b: int) -> dict:
    pair = flat[: b * _PAIR_FLOATS].reshape(b, _PAIR_FLOATS)
    out, off = {}, 0
    for k, w in _HOST_SPEC:
        col = pair[:, off: off + w]
        out[k] = col.reshape((b,) + _HOST_SHAPES[k]) if k in _HOST_SHAPES else col.reshape(b)
        off += w
    rest = flat[b * _PAIR_FLOATS:]
    j_max = rest.shape[0] // 2
    out["scale"], out["scale_conf"] = rest[:j_max], rest[j_max:]
    return out


class FrontendEngine:
    """Owns the STA model (on its device) and the encode / pair-decode
    steps. Features are cached as [1, N, enc_dim] device tensors."""

    def __init__(self, cfg: STAConfig, model: STA):
        self.cfg = cfg
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.time_encode = 0.0
        self.time_decode = 0.0
        self.fetch_count = 0  # device->host copies (one per edge step)

    # ------------------------------------------------------------------
    def _images(self, imgs_np) -> torch.Tensor:
        return torch.as_tensor(np.asarray(imgs_np, np.float32)).to(self.device)

    @torch.inference_mode()
    def encode(self, img_np: np.ndarray) -> torch.Tensor:
        """img_np [H, W, 3] float32 in [-1, 1] -> tokens [1, N, enc_dim]
        left on the device (no synchronisation)."""
        t0 = time.time()
        feat = self.model.encode(self._images(img_np)[None])
        self.time_encode += time.time() - t0
        return feat

    @torch.inference_mode()
    def encode_batch(self, imgs_np: np.ndarray) -> list[torch.Tensor]:
        """Encode B frames in one bucketed forward (offline prefetch);
        returns B token caches [1, N, enc_dim] on the device."""
        n = int(imgs_np.shape[0])
        t0 = time.time()
        imgs = self._images(imgs_np)
        pad = _bucket(n) - n
        if pad:
            imgs = torch.cat([imgs, imgs[-1:].expand(pad, *imgs.shape[1:])])
        feats = self.model.encode(imgs)
        out = [feats[k: k + 1] for k in range(n)]
        self.time_encode += time.time() - t0
        return out

    # ------------------------------------------------------------------
    def _decode(self, f1, f2) -> tuple[dict, torch.Tensor, torch.Tensor]:
        """Decode + heads + shared intrinsics of a padded pair batch: the
        per-pair host outputs (device tensors) and the fp16 dense depth and
        confidence [2b, H, W], rows [dir-i of every pair; dir-j of every
        pair], clipped into the fp16 range (unbounded exp heads)."""
        out = self.model.decode_and_heads(f1, f2)
        b = f1.shape[0]
        pts, conf = out["pts3d"], out["conf"]
        # shared intrinsics per pair over both of its views
        # (reference: slam.py:182-184 with shared_intrinsic=True)
        K = estimate_intrinsics_shared(torch.stack([pts[:b], pts[b:]], dim=1),
                                       torch.stack([conf[:b], conf[b:]], dim=1))
        host = {
            "pose_ij": out["pose"][:b], "pose_conf_ij": out["pose_conf"][:b],
            "pose_ji": out["pose"][b:], "pose_conf_ji": out["pose_conf"][b:],
            "mean_conf_i": conf[:b].mean((1, 2)), "mean_conf_j": conf[b:].mean((1, 2)),
            "K": K,
        }
        depth = torch.clamp(pts[..., 2], -_F16_MAX, _F16_MAX).to(torch.float16)
        return host, depth, torch.clamp(conf, 0.0, _F16_MAX).to(torch.float16)

    def _decode_store_scales(self, f1, f2, store: DevicePointmapStore, node_idx,
                             job_new, job_first) -> torch.Tensor:
        """Decode + heads + intrinsics + store scatter + scale reductions;
        returns the packed host vector (still on the device)."""
        host, depth, conf16 = self._decode(f1, f2)
        b = f1.shape[0]
        # rows in pair order (dir-i of pair k, then its dir-j), written in
        # place into the store
        perm = torch.stack([torch.arange(b), b + torch.arange(b)], 1).reshape(-1)
        perm = perm.to(self.device)
        store.depth.index_copy_(0, node_idx, depth[perm].to(store.depth.dtype))
        store.conf.index_copy_(0, node_idx, conf16[perm].to(store.conf.dtype))
        host["scale"], host["scale_conf"] = pair_scales(store.depth, store.conf,
                                                        job_new, job_first)
        return _pack_host(host, b)

    def _fused_paddings(self, n: int, b: int, store, node_idxs, jobs):
        """Per-bucket paddings: padded pairs write to the scrap slot (the
        store's last row, never registered in the graph); padded jobs read
        slot 0 and are trimmed away."""
        scrap = store.max_nodes - 1
        idx = np.full(2 * b, scrap, np.int64)
        idx[: 2 * n] = node_idxs
        j_max = 2 * b + b * (b - 1) // 2
        jn = np.zeros(j_max, np.int64)
        jf = np.zeros(j_max, np.int64)
        jn[: len(jobs)] = [a for a, _ in jobs]
        jf[: len(jobs)] = [f for _, f in jobs]
        return tuple(torch.from_numpy(a).to(self.device) for a in (idx, jn, jf))

    def _fetch_packed(self, packed: torch.Tensor, n: int, b: int, n_jobs: int) -> dict:
        """The keyframe's one device->host copy, unpacked and trimmed."""
        host = _unpack_host(packed.cpu().numpy(), b)
        self.fetch_count += 1
        return {k: (v[:n] if k not in ("scale", "scale_conf") else v[:n_jobs])
                for k, v in host.items()}

    def _pad_feats(self, feats: list, b: int) -> torch.Tensor:
        return torch.cat(feats + [feats[-1]] * (b - len(feats)), dim=0).float()

    @torch.inference_mode()
    def decode_pairs(self, feats_i: list, feats_j: list, fetch: bool = True) -> dict:
        """Decode len(feats_i) pairs in one bucketed forward.

        Returns the per-pair outputs (poses, confidences, intrinsics)
        trimmed to the true pair count, plus 'depth_dev' / 'conf_dev' fp16
        [2*bucket, H, W] on the device (row k = direction i of pair k, row
        bucket+k = its direction j) and 'bucket'. With fetch=True the
        per-pair outputs come to the host as numpy in one copy; with
        fetch=False they stay on the device and nothing waits for it."""
        n = len(feats_i)
        t0 = time.time()
        b = _bucket(n)
        host, depth, conf = self._decode(self._pad_feats(feats_i, b),
                                         self._pad_feats(feats_j, b))
        if fetch:
            host = fetch_host(host, b)
            del host["scale"], host["scale_conf"]
            self.fetch_count += 1
        out = {k: v[:n] for k, v in host.items()}
        out.update(depth_dev=depth, conf_dev=conf, bucket=b)
        self.time_decode += time.time() - t0
        return out

    @torch.inference_mode()
    def decode_pairs_fused(self, feats_i, feats_j, store, node_idxs, jobs) -> dict:
        """One edge step: decode + store write + scale reductions.

        feats: lists of cached [1,N,C] tokens; node_idxs: [2n] speculative
        slots in (n_i(k), n_j(k)) order; jobs: (new_slot, first_slot) pairs.
        Returns the host dict trimmed to n pairs, 'scale'/'scale_conf'
        aligned to jobs."""
        n = len(feats_i)
        t0 = time.time()
        b = _bucket(n)
        idx, jn, jf = self._fused_paddings(n, b, store, node_idxs, jobs)
        packed = self._decode_store_scales(self._pad_feats(feats_i, b),
                                           self._pad_feats(feats_j, b),
                                           store, idx, jn, jf)
        out = self._fetch_packed(packed, n, b, len(jobs))
        self.time_decode += time.time() - t0
        return out

    @torch.inference_mode()
    def encode_decode_pairs_fused(self, img_np, feats_j, store, node_idxs,
                                  jobs) -> tuple[dict, torch.Tensor]:
        """decode_pairs_fused with the new frame's encode in the same step:
        the i-side of every pair is the frame just ingested, encoded once
        and broadcast over the pair batch. Returns (host dict, the frame's
        token cache [1, N, enc_dim])."""
        n = len(feats_j)
        t0 = time.time()
        b = _bucket(n)
        feat = self.model.encode(self._images(img_np)[None])
        f1 = feat.expand(b, *feat.shape[1:])
        idx, jn, jf = self._fused_paddings(n, b, store, node_idxs, jobs)
        packed = self._decode_store_scales(f1, self._pad_feats(feats_j, b),
                                           store, idx, jn, jf)
        out = self._fetch_packed(packed, n, b, len(jobs))
        self.time_decode += time.time() - t0
        return out, feat

    # ------------------------------------------------------------------
    @staticmethod
    def pose_to_sim3(pose_4x4: np.ndarray, scale: float = 1.0) -> np.ndarray:
        """A pose-head 4x4 output as a host Sim(3) vector [8] with ``scale``."""
        return sim3_from_matrix_np(pose_4x4, scale)
