"""Downstream heads of the STA frontend: the DPT pointmap head and the
relative-pose head, in fp32, as in vista_slam_tpu/models/heads.py.

Module and parameter names follow the reference's torch state dict
(reference: vista_slam/sta_model/heads/dpt_head.py:98-117,
heads/dpt_block.py:264-450, heads/pose_head.py), which is the layout
vista_slam_tpu/models/convert.py reads. Heads work NCHW inside; their
outputs are NHWC like the JAX package's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.linalg import adjugate_inv3


def _resize(x: torch.Tensor, hw) -> torch.Tensor:
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    """relu -> conv3x3 -> relu -> conv3x3, residual add."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """Optional skip refinement, refinement, 2x upsample, 1x1 conv.
    (``resConfUnit1`` exists in every block, as in the reference state dict;
    the deepest block has no skip and never calls it.)"""

    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = _resize(x, (2 * x.shape[2], 2 * x.shape[3]))
        return self.out_conv(x)


class DPTHead(nn.Module):
    """Dense prediction over 4 hooked token levels [B, N, C_l] (pose token
    stripped) with dims (enc_dim, dec_dim, dec_dim, dec_dim) -> [B, H, W, 4]."""

    def __init__(self, dims, patch_size: int = 16,
                 layer_dims=(96, 192, 384, 768), feature_dim: int = 256,
                 last_dim: int = 128, out_channels: int = 4):
        super().__init__()
        self.patch_size = patch_size
        ld = layer_dims
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(nn.Conv2d(dims[0], ld[0], 1),
                          nn.ConvTranspose2d(ld[0], ld[0], 4, stride=4)),
            nn.Sequential(nn.Conv2d(dims[1], ld[1], 1),
                          nn.ConvTranspose2d(ld[1], ld[1], 2, stride=2)),
            nn.Sequential(nn.Conv2d(dims[2], ld[2], 1)),
            nn.Sequential(nn.Conv2d(dims[3], ld[3], 1),
                          nn.Conv2d(ld[3], ld[3], 3, stride=2, padding=1)),
        ])
        self.scratch = nn.Module()
        for n, d in enumerate(ld):
            setattr(self.scratch, f"layer{n + 1}_rn",
                    nn.Conv2d(d, feature_dim, 3, padding=1, bias=False))
        for n in range(1, 5):
            setattr(self.scratch, f"refinenet{n}", FeatureFusionBlock(feature_dim))
        # indices 0/2/4 hold the reference's parameters; 1 is its upsample
        # (done explicitly in forward, to the exact image size) and 3 its ReLU
        self.head = nn.ModuleList([
            nn.Conv2d(feature_dim, feature_dim // 2, 3, padding=1),
            nn.Identity(),
            nn.Conv2d(feature_dim // 2, last_dim, 3, padding=1),
            nn.ReLU(),
            nn.Conv2d(last_dim, out_channels, 1),
        ])

    def forward(self, hooks, img_hw) -> torch.Tensor:
        H, W = img_hw
        nh, nw = H // self.patch_size, W // self.patch_size
        maps = [t.float().transpose(1, 2).reshape(t.shape[0], t.shape[2], nh, nw)
                for t in hooks]
        levels = [self.act_postprocess[i](m) for i, m in enumerate(maps)]
        rn = [getattr(self.scratch, f"layer{i + 1}_rn")(x) for i, x in enumerate(levels)]
        s = self.scratch
        p4 = s.refinenet4(rn[3])[:, :, : rn[2].shape[2], : rn[2].shape[3]]
        p3 = s.refinenet3(p4, rn[2])
        p2 = s.refinenet2(p3, rn[1])
        p1 = s.refinenet1(p2, rn[0])
        x = _resize(self.head[0](p1), (H, W))
        x = self.head[4](F.relu(self.head[2](x)))
        return x.permute(0, 2, 3, 1)  # [B, H, W, out_channels]


def postprocess_pts3d(raw: torch.Tensor, conf_offset: float = 1.0):
    """pts3d = xyz/|xyz| * expm1(|xyz|), conf = offset + exp(x)
    (reference: heads/postprocess.py:22-62)."""
    xyz = raw[..., 0:3]
    d = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    pts = xyz / torch.clamp_min(d, 1e-8) * torch.expm1(d)
    return pts, conf_offset + torch.exp(raw[..., 3])


def svd_orthogonalize(m: torch.Tensor) -> torch.Tensor:
    """9D -> SO(3): row normalisation, SVD projection, reflection fix
    (reference: heads/pose_head.py:38-57)."""
    m = m.reshape(m.shape[:-1] + (3, 3)) if m.shape[-1] == 9 else m
    m = m / torch.clamp_min(torch.linalg.vector_norm(m, dim=-1, keepdim=True), 1e-8)
    u, _, vh = torch.linalg.svd(m.transpose(-1, -2).float(), full_matrices=False)
    v = vh.transpose(-1, -2)
    det = torch.linalg.det(v @ u.transpose(-1, -2))
    v = torch.cat([v[..., :, :-1], v[..., :, -1:] * det[..., None, None]], dim=-1)
    return v @ u.transpose(-1, -2)


def svd_orthogonalize_stable(m: torch.Tensor, n_iter: int = 100) -> torch.Tensor:
    """SVD-free projection by the Newton iteration O <- (O + O^-T)/2 with a
    reflection fix (reference: heads/pose_head.py:60-70); n_iter and the
    degenerate-input behaviour follow the JAX package."""
    m = m.reshape(m.shape[:-1] + (3, 3)) if m.shape[-1] == 9 else m
    o = m / (torch.linalg.matrix_norm(m, keepdim=True) + 1e-8)
    o = o.float()
    for _ in range(n_iter):
        o = 0.5 * (o + adjugate_inv3(o.transpose(-1, -2)))
    sign = torch.sign(torch.linalg.det(o))
    return torch.cat([o[..., :, :-1], o[..., :, -1:] * sign[..., None, None]], dim=-1)


# fc_rot bias at init: a sheared near-identity with distinct singular values
# after row normalisation (an exact identity gives repeated singular values,
# where the SVD derivative blows up) — see vista_slam_tpu/models/heads.py
_ROT9_INIT_BIAS = (1.0, 0.1, -0.05, 0.05, 1.0, 0.15, -0.1, 0.05, 1.0)


class PoseHead(nn.Module):
    """Relative pose from the decoder's pose token: 3-layer ReLU MLP ->
    translation, 9D rotation ('9D' SVD or '9D_stable' Newton projection),
    sigmoid confidence (reference: heads/pose_head.py:7-119)."""

    def __init__(self, dim: int, hidden: int = 512, rot_representation: str = "9D"):
        super().__init__()
        if rot_representation not in ("9D", "9D_stable"):
            raise ValueError(f"rot_representation {rot_representation!r}: the port "
                             "has '9D' and '9D_stable'")
        self.rot_representation = rot_representation
        self.mlp = nn.Sequential(nn.Linear(dim, hidden), nn.ReLU(),
                                 nn.Linear(hidden, hidden), nn.ReLU(),
                                 nn.Linear(hidden, hidden), nn.ReLU())
        self.fc_t = nn.Linear(hidden, 3)
        self.fc_rot = nn.Linear(hidden, 9)
        self.fc_conf = nn.Sequential(nn.Linear(hidden, 1), nn.Sigmoid())

    @torch.no_grad()
    def reset_rotation_(self) -> None:
        """The zero-kernel / sheared-bias init of the rotation regressor."""
        self.fc_rot.weight.zero_()
        self.fc_rot.bias.copy_(torch.tensor(_ROT9_INIT_BIAS))

    def forward(self, token: torch.Tensor) -> dict:
        x = self.mlp(token.float())
        t = self.fc_t(x)
        conf = self.fc_conf(x)[..., 0]
        r9 = self.fc_rot(x)
        R = (svd_orthogonalize_stable(r9) if self.rot_representation == "9D_stable"
             else svd_orthogonalize(r9))
        b = token.shape[0]
        pose = torch.zeros((b, 4, 4), dtype=torch.float32, device=token.device)
        pose[:, :3, :3] = R
        pose[:, :3, 3] = t
        pose[:, 3, 3] = 1.0
        return {"pose": pose, "conf": conf}
