"""Image resampling helpers with the NHWC interface of
vista_slam_tpu/utils/image_ops.py."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = True) -> torch.Tensor:
    """Bilinear resize of NHWC (or HWC) tensors to ``out_hw`` (reference
    DPT fusion blocks use align_corners=True, dpt_block.py:213-216,320)."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw), mode="bilinear",
                      align_corners=align_corners).permute(0, 2, 3, 1)
    return y[0] if squeeze else y


def pixel_grid(h: int, w: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Homogeneous pixel coordinates [(x, y, 1)] of shape [H, W, 3]."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
