"""Between the JAX package's parameter tree and the port's torch state dict.

``state_dict_from_jax``: the ``{'params': ...}`` numpy tree that
``load_params_npz`` (reading the JAX package's flat ``.npz`` format)
returns, or a JAX-initialised tree after ``jax.device_get``, -> a state
dict in the reference's key layout, which is the port's
``STA.state_dict()`` layout.
``convert_state_dict``: the way back, as vista_slam_tpu/models/convert.py
does it from a reference ``.pth`` (``load_torch_checkpoint``);
``save_params_npz`` writes a port model as the JAX package's ``.npz``, and
``convert_checkpoint_file`` turns a reference ``.pth`` into one.

Layout transforms (JAX -> torch; the way back inverts them):
  Dense kernel [in, out]          -> Linear weight [out, in]
  Conv kernel  [kh, kw, in, out]  -> Conv2d weight [out, in, kh, kw]
  StridedUpsample proj kernel [in, k*k*out] -> ConvTranspose2d weight
                                     [in, out, k, k]; bias = first `out`
                                     (the way back tiles it k*k times)
  LinearPtsHead proj kernel [in, p*p*c] (row, column, channel)
                                  -> Linear weight [c*p*p, in] (channel, row,
                                     column: pixel_shuffle's order)
  LayerNorm scale/bias            -> weight/bias
"""

from __future__ import annotations

import re
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


def flatten_params(tree, prefix: str = "") -> dict:
    """Nested ``{'a': {'b': leaf}}`` -> ``{'a/b': leaf}`` (numpy leaves)."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            flat.update(flatten_params(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def load_params_npz(path: str) -> dict:
    """A parameter tree saved by the JAX package's ``save_params_npz``."""
    z = np.load(path)
    return unflatten_params({k: z[k] for k in z.files})


def save_params_npz(path: str, params) -> None:
    """Write ``params`` as the JAX package's flat ``.npz`` (its
    ``load_params_npz`` reads it): a ``{'params': ...}`` tree, or a port
    model or state dict, converted by ``convert_state_dict`` first."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    if "params" not in params:
        params = convert_state_dict(params)
    np.savez(path, **flatten_params(params))


def load_torch_checkpoint(path: str) -> dict[str, np.ndarray]:
    """A ``.pth`` checkpoint (a state dict, or one under ``'model'``) as
    numpy arrays."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt)
    return {k: v.detach().float().cpu().numpy() for k, v in sd.items()}


def convert_checkpoint_file(src_pth: str, dst_npz: str, enc_depth: int | None = None,
                            dec_depth: int | None = None) -> dict:
    """A reference-layout ``.pth`` -> the JAX package's ``.npz``; returns
    the tree."""
    params = convert_state_dict(load_torch_checkpoint(src_pth), enc_depth, dec_depth)
    np.savez(dst_npz, **flatten_params(params))
    return params


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


def _linear_pts(sd, dst, p):
    kernel = np.asarray(p["kernel"])  # [in, p*p*c], columns (row, column, channel)
    cin, c = kernel.shape[0], 4
    pp = kernel.shape[1] // c
    sd[f"{dst}.weight"] = _t(kernel.reshape(cin, pp, c).transpose(2, 1, 0).reshape(c * pp, cin))
    sd[f"{dst}.bias"] = _t(np.asarray(p["bias"]).reshape(pp, c).T.reshape(-1))


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
    if "proj" in p["head_pts"]:  # LinearPtsHead
        _linear_pts(sd, "downstream_head_pts.proj", p["head_pts"]["proj"])
    else:
        _dpt(sd, p["head_pts"])
    hp = p["head_pose"]
    for i, n in enumerate(("mlp0", "mlp1", "mlp2")):
        _linear(sd, f"head_pose_s.mlp.{2 * i}", hp[n])
    _linear(sd, "head_pose_s.fc_t", hp["fc_t"])
    _linear(sd, "head_pose_s.fc_rot", hp["fc_rot"])
    _linear(sd, "head_pose_s.fc_conf.0", hp["fc_conf"])
    return sd


# -- torch state dict -> JAX tree (vista_slam_tpu/models/convert.py) ----------

def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _j_linear(sd, src):
    out = {"kernel": np.ascontiguousarray(sd[f"{src}.weight"].T)}
    if f"{src}.bias" in sd:
        out["bias"] = sd[f"{src}.bias"]
    return out


def _j_conv(sd, src):
    out = {"kernel": np.ascontiguousarray(sd[f"{src}.weight"].transpose(2, 3, 1, 0))}
    if f"{src}.bias" in sd:
        out["bias"] = sd[f"{src}.bias"]
    return out


def _j_conv_t(sd, src, k):
    w = sd[f"{src}.weight"]  # [in, out, k, k]
    out = {"proj": {"kernel": np.ascontiguousarray(
        w.transpose(0, 2, 3, 1).reshape(w.shape[0], k * k * w.shape[1]))}}
    if f"{src}.bias" in sd:
        out["proj"]["bias"] = np.tile(sd[f"{src}.bias"], k * k)
    return out


def _j_ln(sd, src):
    return {"scale": sd[f"{src}.weight"], "bias": sd[f"{src}.bias"]}


def _j_dpt(sd):
    d = "downstream_head_pts.dpt"
    out = {"act0_proj": _j_conv(sd, f"{d}.act_postprocess.0.0"),
           "act0_up": _j_conv_t(sd, f"{d}.act_postprocess.0.1", 4),
           "act1_proj": _j_conv(sd, f"{d}.act_postprocess.1.0"),
           "act1_up": _j_conv_t(sd, f"{d}.act_postprocess.1.1", 2),
           "act2_proj": _j_conv(sd, f"{d}.act_postprocess.2.0"),
           "act3_proj": _j_conv(sd, f"{d}.act_postprocess.3.0"),
           "act3_down": _j_conv(sd, f"{d}.act_postprocess.3.1"),
           **{f"head{i}": _j_conv(sd, f"{d}.head.{i}") for i in (0, 2, 4)}}
    for n in range(1, 5):
        # the port's (and newer reference checkpoints') name, or the older list
        src = (f"{d}.scratch.layer{n}_rn" if f"{d}.scratch.layer{n}_rn.weight" in sd
               else f"{d}.scratch.layer_rn.{n - 1}")
        out[f"layer{n}_rn"] = _j_conv(sd, src)
        rf = f"{d}.scratch.refinenet{n}"
        out[f"refinenet{n}"] = {
            f"res_conv_unit{u}": {c: _j_conv(sd, f"{rf}.resConfUnit{u}.{c}")
                                  for c in ("conv1", "conv2")} for u in (1, 2)}
        out[f"refinenet{n}"]["out_conv"] = _j_conv(sd, f"{rf}.out_conv")
    return out


def _j_linear_pts(sd, src):
    w = sd[f"{src}.weight"]  # [c*p*p, in], rows (channel, row, column)
    c, cin = 4, w.shape[1]
    pp = w.shape[0] // c
    return {"proj": {"kernel": np.ascontiguousarray(
        w.reshape(c, pp, cin).transpose(2, 1, 0).reshape(cin, pp * c)),
        "bias": sd[f"{src}.bias"].reshape(c, pp).T.reshape(-1)}}


def _infer_depth(sd: Mapping, prefix: str) -> int:
    pat = re.compile(rf"^{re.escape(prefix)}\.(\d+)\.")
    idxs = {int(m.group(1)) for k in sd if (m := pat.match(k))}
    if not idxs:
        raise KeyError(f"no '{prefix}.<i>.*' keys in the state dict: not a "
                       "reference-layout STA checkpoint?")
    return max(idxs) + 1


def convert_state_dict(sd: Mapping, enc_depth: int | None = None,
                       dec_depth: int | None = None) -> dict:
    """A reference-layout state dict (the port's ``STA.state_dict()``, torch
    or numpy values) -> the JAX package's ``{'params': ...}`` numpy tree,
    as vista_slam_tpu/models/convert.py::convert_state_dict makes it, and
    also for the linear pointmap head. Depths default to the state dict's."""
    sd = {k: _np(v) for k, v in sd.items()}
    enc_depth = _infer_depth(sd, "enc_blocks") if enc_depth is None else enc_depth
    dec_depth = _infer_depth(sd, "dec_block") if dec_depth is None else dec_depth
    head_pts = (_j_linear_pts(sd, "downstream_head_pts.proj")
                if "downstream_head_pts.proj.weight" in sd else _j_dpt(sd))
    params = {
        "patch_embed": _j_conv(sd, "patch_embed.proj"),
        "decoder_embed": _j_linear(sd, "decoder_embed"),
        "pose_token": sd["init_pose_token"],
        "dec_norm": _j_ln(sd, "dec_norm"),
        "head_pts": head_pts,
        "head_pose": {"mlp0": _j_linear(sd, "head_pose_s.mlp.0"),
                      "mlp1": _j_linear(sd, "head_pose_s.mlp.2"),
                      "mlp2": _j_linear(sd, "head_pose_s.mlp.4"),
                      "fc_t": _j_linear(sd, "head_pose_s.fc_t"),
                      "fc_rot": _j_linear(sd, "head_pose_s.fc_rot"),
                      "fc_conf": _j_linear(sd, "head_pose_s.fc_conf.0")},
    }
    for i in range(enc_depth):
        p = f"enc_blocks.{i}"
        params[f"enc_block{i}"] = {
            "norm1": _j_ln(sd, f"{p}.norm1"), "norm2": _j_ln(sd, f"{p}.norm2"),
            "attn": {n: _j_linear(sd, f"{p}.attn.{n}") for n in ("qkv", "proj")},
            "mlp": {n: _j_linear(sd, f"{p}.mlp.{n}") for n in ("fc1", "fc2")}}
    for i in range(dec_depth):
        p = f"dec_block.{i}"
        params[f"dec_block{i}"] = {
            **{n: _j_ln(sd, f"{p}.{n}") for n in ("norm1", "norm_y", "norm2", "norm3")},
            "attn": {n: _j_linear(sd, f"{p}.attn.{n}") for n in ("qkv", "proj")},
            "cross_attn": {n: _j_linear(sd, f"{p}.cross_attn.{n}")
                           for n in ("projq", "projk", "projv", "proj")},
            "mlp": {n: _j_linear(sd, f"{p}.mlp.{n}") for n in ("fc1", "fc2")}}
    return {"params": params}


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
    more elements (k*k untied copies of it); no layout maps the two. The
    linear pointmap head's weight takes (1, 0): its JAX rows, up to the
    order of the columns within each row."""
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


if __name__ == "__main__":
    import sys

    convert_checkpoint_file(sys.argv[1], sys.argv[2])
    print(f"converted {sys.argv[1]} -> {sys.argv[2]}")
