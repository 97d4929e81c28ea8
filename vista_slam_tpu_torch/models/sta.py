"""Symmetric Two-view Association (STA) frontend as torch modules.

Same architecture and numerics as vista_slam_tpu/models/sta.py (reference:
vista_slam/sta_model/sta_model.py:26-291):
  * 16x16 patch embedding -> ViT encoder with RoPE2D on q/k;
  * symmetric cross-attention decoder over two views, both directions
    stacked on the batch axis, with the streams swapped before every layer
    and a learned pose token at RoPE position (-1, -1);
  * DPT pointmap head over hooks [enc, dec mid, dec mid, dec final] and a
    pose head over the final pose token.
Mixed precision as in the JAX package: trunk matmuls in ``compute_dtype``
(bf16 by default), LayerNorm and softmax in fp32, heads in fp32. Trunk
weights are held in ``param_dtype`` (by default the compute dtype, for
inference; fp32 for training, cast to the compute dtype in every matmul as
the JAX package's Dense layers cast its fp32 params). Parameter names are
the reference's torch state-dict keys.
Images are NHWC in [-1, 1].
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import mha
from ..ops.rope2d import apply_rope2d, rope2d_tables
from .heads import DPTHead, PoseHead, postprocess_pts3d


@dataclasses.dataclass(frozen=True)
class STAConfig:
    img_size: tuple[int, int] = (224, 224)
    patch_size: int = 16
    enc_dim: int = 1024
    enc_depth: int = 24
    enc_heads: int = 16
    dec_dim: int = 768
    dec_depth: int = 12
    dec_heads: int = 12
    mlp_ratio: int = 4
    rope_base: float = 100.0
    conf_offset: float = 1.0
    compute_dtype: torch.dtype = torch.bfloat16
    use_flash: bool | None = None  # None = by sequence length (ops/attention.mha)
    # the fused short-sequence training attention (kernels K3a/K3b) for
    # every attention below the flash threshold with N_q == N_kv <= 1024
    attn_fused_train: bool = False
    # tanh-approximate GELU instead of the reference's exact erf GELU
    gelu_approx: bool = False
    # dtype the trunk weights are held in; None = compute_dtype
    param_dtype: torch.dtype | None = None

    @property
    def grid(self) -> tuple[int, int]:
        return (self.img_size[0] // self.patch_size, self.img_size[1] // self.patch_size)

    @property
    def num_patches(self) -> int:
        gh, gw = self.grid
        return gh * gw

    # DPT hook positions into [enc] + [embed, blk1..blkD]
    # (reference: heads/dpt_head.py:112)
    @property
    def hooks(self) -> tuple[int, ...]:
        d = self.dec_depth
        return (0, d * 2 // 4 + 1, d * 3 // 4 + 1, d + 1)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in fp32 (fp32 parameters) whatever the input."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class Linear(nn.Linear):
    """nn.Linear computing in ``dtype`` whatever dtype its weights are held
    in (``param_dtype``): input, weight and bias are cast to ``dtype``."""

    def __init__(self, din, dout, dtype, param_dtype=None):
        super().__init__(din, dout, dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Mlp(nn.Module):
    def __init__(self, dim, hidden, dtype, gelu_approx=False, param_dtype=None):
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype, param_dtype)
        self.fc2 = Linear(hidden, dim, dtype, param_dtype)
        self.approximate = "tanh" if gelu_approx else "none"

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=self.approximate))


class Attention(nn.Module):
    def __init__(self, dim, heads, dtype, use_flash, param_dtype=None, fused_train=False):
        super().__init__()
        self.heads = heads
        self.use_flash = use_flash
        self.fused_train = fused_train
        self.qkv = Linear(dim, 3 * dim, dtype, param_dtype)
        self.proj = Linear(dim, dim, dtype, param_dtype)

    def forward(self, x, rope):
        B, N, C = x.shape
        hd = C // self.heads
        q, k, v = self.qkv(x).reshape(B, N, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k = apply_rope2d(q, *rope), apply_rope2d(k, *rope)
        out = mha(q, k, v, hd ** -0.5, self.use_flash, self.fused_train)
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class CrossAttention(nn.Module):
    def __init__(self, dim, heads, dtype, use_flash, param_dtype=None, fused_train=False):
        super().__init__()
        self.heads = heads
        self.use_flash = use_flash
        self.fused_train = fused_train
        self.projq = Linear(dim, dim, dtype, param_dtype)
        self.projk = Linear(dim, dim, dtype, param_dtype)
        self.projv = Linear(dim, dim, dtype, param_dtype)
        self.proj = Linear(dim, dim, dtype, param_dtype)

    def forward(self, x, y, rope_q, rope_k):
        B, Nq, C = x.shape
        Nk = y.shape[1]
        h, hd = self.heads, C // self.heads
        q = self.projq(x).reshape(B, Nq, h, hd).transpose(1, 2)
        k = self.projk(y).reshape(B, Nk, h, hd).transpose(1, 2)
        v = self.projv(y).reshape(B, Nk, h, hd).transpose(1, 2)
        q, k = apply_rope2d(q, *rope_q), apply_rope2d(k, *rope_k)
        out = mha(q, k, v, hd ** -0.5, self.use_flash, self.fused_train)
        return self.proj(out.transpose(1, 2).reshape(B, Nq, C))


class EncoderBlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio, dtype, use_flash, gelu_approx,
                 param_dtype=None, fused_train=False):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm32(dim)
        self.attn = Attention(dim, heads, dtype, use_flash, param_dtype, fused_train)
        self.norm2 = LayerNorm32(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio, dtype, gelu_approx, param_dtype)

    def forward(self, x, rope):
        x = x + self.attn(self.norm1(x).to(self.dtype), rope)
        return x + self.mlp(self.norm2(x).to(self.dtype))


class DecoderBlock(nn.Module):
    """Self-attention, cross-attention on the layernormed other stream, MLP;
    pre-LN (reference: blocks/sta_blocks.py:210-231)."""

    def __init__(self, dim, heads, mlp_ratio, dtype, use_flash, gelu_approx,
                 param_dtype=None, fused_train=False):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm32(dim)
        self.attn = Attention(dim, heads, dtype, use_flash, param_dtype, fused_train)
        self.norm_y = LayerNorm32(dim)
        self.norm2 = LayerNorm32(dim)
        self.cross_attn = CrossAttention(dim, heads, dtype, use_flash, param_dtype,
                                         fused_train)
        self.norm3 = LayerNorm32(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio, dtype, gelu_approx, param_dtype)

    def forward(self, x, y, rope):
        dt = self.dtype
        x = x + self.attn(self.norm1(x).to(dt), rope)
        x = x + self.cross_attn(self.norm2(x).to(dt), self.norm_y(y).to(dt), rope, rope)
        return x + self.mlp(self.norm3(x).to(dt))


class PatchEmbed(nn.Module):
    """The reference's Conv2d(k=16, s=16) patch projection, computed as
    space-to-depth + one matmul in the compute dtype (the same contraction;
    the weight keeps the conv layout [D, 3, P, P])."""

    def __init__(self, dim, patch, dtype, param_dtype=None):
        super().__init__()
        self.patch = patch
        self.dtype = dtype
        self.proj = nn.Conv2d(3, dim, patch, patch, dtype=param_dtype or dtype)

    def forward(self, img):  # [B, H, W, C] -> [B, gh, gw, D]
        p = self.patch
        b, h, w, c = img.shape
        x = img.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, h // p, w // p, p * p * c)
        wt = self.proj.weight.permute(0, 2, 3, 1).reshape(self.proj.out_channels, -1)
        dt = self.dtype
        return F.linear(x.to(dt), wt.to(dt), self.proj.bias.to(dt))


class STA(nn.Module):
    """The two-view frontend.

      encode(img)                 -> encoder tokens [B, N, enc_dim] fp32
      decode_pair(f1, f2)         -> (h_mid1, h_mid2, final) hook states
      pair_heads(f1, f2, ...)     -> pointmaps / confidences / poses
      decode_and_heads(f1, f2)    -> both of the above
      forward(img1, img2)         -> full two-view forward
      train_forward(main, supps)  -> the training forward over S supports
    """

    def __init__(self, cfg: STAConfig):
        super().__init__()
        self.cfg = c = cfg
        dt, pdt = c.compute_dtype, c.param_dtype
        self.patch_embed = PatchEmbed(c.enc_dim, c.patch_size, dt, pdt)
        self.enc_blocks = nn.ModuleList([
            EncoderBlock(c.enc_dim, c.enc_heads, c.mlp_ratio, dt, c.use_flash,
                         c.gelu_approx, pdt, c.attn_fused_train)
            for _ in range(c.enc_depth)])
        self.decoder_embed = Linear(c.enc_dim, c.dec_dim, dt, pdt)
        self.dec_block = nn.ModuleList([
            DecoderBlock(c.dec_dim, c.dec_heads, c.mlp_ratio, dt, c.use_flash,
                         c.gelu_approx, pdt, c.attn_fused_train)
            for _ in range(c.dec_depth)])
        self.dec_norm = LayerNorm32(c.dec_dim)
        self.init_pose_token = nn.Parameter(torch.zeros(1, 1, c.dec_dim))
        self.downstream_head_pts = nn.Module()
        self.downstream_head_pts.dpt = DPTHead(
            (c.enc_dim, c.dec_dim, c.dec_dim, c.dec_dim), patch_size=c.patch_size)
        self.head_pose_s = PoseHead(c.dec_dim)

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> "STA":
        """Random init from ``generator`` (on the parameters' device):
        LeCun-normal weights and zero biases for linear and conv layers,
        LayerNorm at identity, pose token N(0, 0.02^2), and the rotation
        regressor's zero-kernel / sheared-bias init."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                w = mod.weight
                fan_in = w[0].numel() if not isinstance(mod, nn.ConvTranspose2d) \
                    else w.shape[0]
                w.copy_(torch.randn(w.shape, generator=generator, device=w.device)
                        * fan_in ** -0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        self.init_pose_token.copy_(torch.randn(
            self.init_pose_token.shape, generator=generator,
            device=self.init_pose_token.device) * 0.02)
        self.head_pose_s.reset_rotation_()
        return self

    def _rope(self, dim_head: int, n_special: int, grid, device):
        gh, gw = grid
        return rope2d_tables(gh, gw, dim_head, self.cfg.rope_base, n_special, device)

    def encode(self, img: torch.Tensor) -> torch.Tensor:
        """img [B, H, W, 3] -> un-layernormed encoder tokens [B, N, enc_dim]
        fp32 (the reference feeds unnormalised features on, sta_model.py:144)."""
        c = self.cfg
        x = self.patch_embed(img.to(c.compute_dtype))
        b, gh, gw, d = x.shape
        x = x.reshape(b, gh * gw, d)
        rope = self._rope(c.enc_dim // c.enc_heads, 0, (gh, gw), x.device)
        for blk in self.enc_blocks:
            x = blk(x, rope)
        return x.float()

    def decode_pair(self, f1: torch.Tensor, f2: torch.Tensor, grid=None):
        """f1, f2 [B, N, enc_dim] -> (h_mid1, h_mid2, final), each
        [2B, 1+N, dec_dim] fp32 with the pose token at index 0; rows [:B]
        are direction 1 (view-i queries), rows [B:] direction 2. ``final``
        is layernormed."""
        c = self.cfg
        B = f1.shape[0]
        rope = self._rope(c.dec_dim // c.dec_heads, 1, grid or c.grid, f1.device)
        x = self.decoder_embed(torch.cat([f1, f2], dim=0).to(c.compute_dtype))
        pose_tok = self.init_pose_token.to(c.compute_dtype).expand(2 * B, 1, c.dec_dim)
        x = torch.cat([pose_tok, x], dim=1)
        hook_after = (c.hooks[1] - 1, c.hooks[2] - 1)
        mids = {}
        for i, blk in enumerate(self.dec_block):
            y = torch.cat([x[B:], x[:B]], dim=0)  # swap streams
            x = blk(x, y, rope)
            if i + 1 in hook_after:
                mids[i + 1] = x.float()
        return mids[hook_after[0]], mids[hook_after[1]], self.dec_norm(x)

    def pair_heads(self, f1, f2, h_mid1, h_mid2, final, grid=None) -> dict:
        """fp32 outputs with leading axis 2B = [dir1; dir2]: pts3d
        [2B,H,W,3], conf [2B,H,W], pose [2B,4,4], pose_conf [2B]."""
        c = self.cfg
        gh, gw = grid or c.grid
        enc = torch.cat([f1, f2], dim=0).float()
        hooks = [enc, h_mid1[:, 1:], h_mid2[:, 1:], final[:, 1:]]
        raw = self.downstream_head_pts.dpt(hooks, (gh * c.patch_size, gw * c.patch_size))
        pts3d, conf = postprocess_pts3d(raw, c.conf_offset)
        pose = self.head_pose_s(final[:, 0])
        return {"pts3d": pts3d, "conf": conf, "pose": pose["pose"],
                "pose_conf": pose["conf"]}

    def decode_and_heads(self, f1, f2, grid=None) -> dict:
        return self.pair_heads(f1, f2, *self.decode_pair(f1, f2, grid), grid)

    def forward(self, img1, img2) -> dict:
        p = self.cfg.patch_size
        grid = (img1.shape[1] // p, img1.shape[2] // p)
        return self.decode_and_heads(self.encode(img1), self.encode(img2), grid)

    def train_forward(self, main_img: torch.Tensor, support_imgs: torch.Tensor) -> dict:
        """Training forward over one main view and S support views
        (reference: sta_model.py:247-291), as the JAX package batches it:
        main_img [B,H,W,3] encoded once, support_imgs [S,B,H,W,3] encoded in
        one call, the main features tiled S times and all S pair-decodes run
        as one batch of S*B pairs. Outputs have a leading 2*S*B axis: the
        first S*B rows are the main view's predictions per support pairing,
        the last S*B the support views'."""
        S, B = support_imgs.shape[:2]
        p = self.cfg.patch_size
        grid = (main_img.shape[1] // p, main_img.shape[2] // p)
        f_main = self.encode(main_img)
        f_supp = self.encode(support_imgs.reshape((S * B,) + tuple(support_imgs.shape[2:])))
        return self.decode_and_heads(f_main.repeat(S, 1, 1), f_supp, grid)
