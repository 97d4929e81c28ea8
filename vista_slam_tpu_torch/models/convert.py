"""JAX parameter tree -> the port's torch state dict.

The inverse of vista_slam_tpu/models/convert.py::convert_state_dict: the
input is the ``{'params': ...}`` numpy tree that ``load_params_npz`` (a
copy of the JAX package's, reading its flat ``.npz`` format) returns (or a
JAX-initialised tree after ``jax.device_get``), the output a state dict in
the reference's key layout, which is the port's ``STA.state_dict()``
layout.

Layout transforms (inverse of convert_state_dict):
  Dense kernel [in, out]          -> Linear weight [out, in]
  Conv kernel  [kh, kw, in, out]  -> Conv2d weight [out, in, kh, kw]
  StridedUpsample proj kernel [in, k*k*out] -> ConvTranspose2d weight
                                     [in, out, k, k]; bias = first `out`
  LayerNorm scale/bias            -> weight/bias
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def unflatten_params(flat: Mapping[str, np.ndarray]) -> dict:
    """``{'a/b/c': leaf}`` -> nested ``{'a': {'b': {'c': leaf}}}``."""
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_params_npz(path: str) -> dict:
    """A parameter tree saved by the JAX package's ``save_params_npz``."""
    z = np.load(path)
    return unflatten_params({k: z[k] for k in z.files})


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def _linear(sd, dst, p):
    sd[f"{dst}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{dst}.bias"] = _t(p["bias"])


def _conv(sd, dst, p):
    sd[f"{dst}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{dst}.bias"] = _t(p["bias"])


def _conv_t(sd, dst, p, k):
    kernel = np.asarray(p["proj"]["kernel"])  # [in, k*k*out]
    cin, cout = kernel.shape[0], kernel.shape[1] // (k * k)
    sd[f"{dst}.weight"] = _t(kernel.reshape(cin, k, k, cout).transpose(0, 3, 1, 2))
    if "bias" in p["proj"]:
        sd[f"{dst}.bias"] = _t(np.asarray(p["proj"]["bias"])[:cout])


def _ln(sd, dst, p):
    sd[f"{dst}.weight"] = _t(p["scale"])
    sd[f"{dst}.bias"] = _t(p["bias"])


def _rcu(sd, dst, p):
    _conv(sd, f"{dst}.conv1", p["conv1"])
    _conv(sd, f"{dst}.conv2", p["conv2"])


def _dpt(sd, p):
    d = "downstream_head_pts.dpt"
    _conv(sd, f"{d}.act_postprocess.0.0", p["act0_proj"])
    _conv_t(sd, f"{d}.act_postprocess.0.1", p["act0_up"], 4)
    _conv(sd, f"{d}.act_postprocess.1.0", p["act1_proj"])
    _conv_t(sd, f"{d}.act_postprocess.1.1", p["act1_up"], 2)
    _conv(sd, f"{d}.act_postprocess.2.0", p["act2_proj"])
    _conv(sd, f"{d}.act_postprocess.3.0", p["act3_proj"])
    _conv(sd, f"{d}.act_postprocess.3.1", p["act3_down"])
    for i in (0, 2, 4):
        _conv(sd, f"{d}.head.{i}", p[f"head{i}"])
    for n in range(1, 5):
        _conv(sd, f"{d}.scratch.layer{n}_rn", p[f"layer{n}_rn"])
        rf, src = f"{d}.scratch.refinenet{n}", p[f"refinenet{n}"]
        _rcu(sd, f"{rf}.resConfUnit2", src["res_conv_unit2"])
        _conv(sd, f"{rf}.out_conv", src["out_conv"])
        if "res_conv_unit1" in src:
            _rcu(sd, f"{rf}.resConfUnit1", src["res_conv_unit1"])
        else:
            # the deepest fusion block has no skip input, so a JAX-initialised
            # tree has no unit for it; the reference layout keeps one (unused)
            f = np.asarray(src["out_conv"]["kernel"]).shape[-1]
            zero = {"kernel": np.zeros((3, 3, f, f), np.float32),
                    "bias": np.zeros((f,), np.float32)}
            _rcu(sd, f"{rf}.resConfUnit1", {"conv1": zero, "conv2": zero})


def state_dict_from_jax(params: Mapping) -> dict[str, torch.Tensor]:
    """``{'params': {...}}`` (numpy leaves) -> torch state dict (fp32)."""
    p = params["params"] if "params" in params else params
    sd: dict[str, torch.Tensor] = {}
    _conv(sd, "patch_embed.proj", p["patch_embed"])
    _linear(sd, "decoder_embed", p["decoder_embed"])
    sd["init_pose_token"] = _t(p["pose_token"])
    _ln(sd, "dec_norm", p["dec_norm"])
    enc = sorted(int(k[len("enc_block"):]) for k in p if k.startswith("enc_block"))
    dec = sorted(int(k[len("dec_block"):]) for k in p if k.startswith("dec_block"))
    for i in enc:
        src, dst = p[f"enc_block{i}"], f"enc_blocks.{i}"
        _ln(sd, f"{dst}.norm1", src["norm1"])
        _linear(sd, f"{dst}.attn.qkv", src["attn"]["qkv"])
        _linear(sd, f"{dst}.attn.proj", src["attn"]["proj"])
        _ln(sd, f"{dst}.norm2", src["norm2"])
        _linear(sd, f"{dst}.mlp.fc1", src["mlp"]["fc1"])
        _linear(sd, f"{dst}.mlp.fc2", src["mlp"]["fc2"])
    for i in dec:
        src, dst = p[f"dec_block{i}"], f"dec_block.{i}"
        for n in ("norm1", "norm_y", "norm2", "norm3"):
            _ln(sd, f"{dst}.{n}", src[n])
        _linear(sd, f"{dst}.attn.qkv", src["attn"]["qkv"])
        _linear(sd, f"{dst}.attn.proj", src["attn"]["proj"])
        for n in ("projq", "projk", "projv", "proj"):
            _linear(sd, f"{dst}.cross_attn.{n}", src["cross_attn"][n])
        _linear(sd, f"{dst}.mlp.fc1", src["mlp"]["fc1"])
        _linear(sd, f"{dst}.mlp.fc2", src["mlp"]["fc2"])
    _dpt(sd, p["head_pts"])
    hp = p["head_pose"]
    for i, n in enumerate(("mlp0", "mlp1", "mlp2")):
        _linear(sd, f"head_pose_s.mlp.{2 * i}", hp[n])
    _linear(sd, "head_pose_s.fc_t", hp["fc_t"])
    _linear(sd, "head_pose_s.fc_rot", hp["fc_rot"])
    _linear(sd, "head_pose_s.fc_conf.0", hp["fc_conf"])
    return sd


def jax_layouts(model: torch.nn.Module) -> dict[str, tuple[int, ...]]:
    """For each parameter, the permutation ``perm`` such that
    ``p.permute(perm)`` flattens, row-major, exactly as its counterpart in
    the JAX package's layout flattens (``p.reshape(-1)`` there). The
    inverses of the transforms listed above:
      Linear weight [out, in]                -> [in, out]            (1, 0)
      Conv2d weight [out, in, kh, kw]        -> [kh, kw, in, out]    (2, 3, 1, 0)
      ConvTranspose2d weight [in, out, k, k] -> [in, k, k, out]      (0, 2, 3, 1),
          the JAX package's [in, k*k*out] dense kernel up to a reshape
      anything else (biases, LayerNorm, the pose token) -> itself.
    The strided-upsample bias is the one parameter whose JAX leaf holds
    more elements (k*k untied copies of it); no layout maps the two."""
    layout = {torch.nn.Linear: (1, 0), torch.nn.Conv2d: (2, 3, 1, 0),
              torch.nn.ConvTranspose2d: (0, 2, 3, 1)}
    perms = {}
    for mod_name, mod in model.named_modules():
        perm = next((v for t, v in layout.items() if isinstance(mod, t)), None)
        for name, p in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            perms[full] = perm if perm is not None and name == "weight" else tuple(range(p.dim()))
    return perms


def jax_param_ndims(model: torch.nn.Module) -> dict[str, int]:
    """The rank of each parameter's counterpart in the JAX package's layout
    (``jax_layouts``; the ConvTranspose2d weight's is the 2-D dense kernel,
    biases and LayerNorm scales are 1-D, the pose token is [1, 1, D] in
    both). The JAX package decays exactly the leaves with rank > 1."""
    ndims = {}
    convt = {f"{n}.weight" for n, m in model.named_modules()
             if isinstance(m, torch.nn.ConvTranspose2d)}
    for name, perm in jax_layouts(model).items():
        ndims[name] = 2 if name in convt else len(perm)
    return ndims
