"""Build the port's SLAM system from a config (the counterpart of
vista_slam_tpu/cli/common.py)."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models.sta import STA, STAConfig
from ..utils.config import Config
from ..utils.logging import Channel, log

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(cfg: Config) -> STAConfig:
    overrides = dict(cfg.get("model", {}) or {})
    if "img_size" in overrides:
        overrides["img_size"] = tuple(overrides["img_size"])
    dtype = _DTYPES[str(cfg.get("compute_dtype", "bfloat16"))]
    return STAConfig(compute_dtype=dtype, **overrides)


def build_frontend(cfg: Config):
    """The STA model on ``cfg.device`` with converted
    JAX weights (``sta_weights`` .npz), reference torch weights
    (``sta_torch_weights`` .pth, already in the port's layout) or, with
    neither, random weights from a torch.Generator seeded by
    ``random_seed``."""
    from ..slam.frontend import FrontendEngine

    device = torch.device(cfg.get("device", "cuda"))
    mcfg = model_config(cfg)
    model = STA(mcfg).to(device)
    if cfg.get("sta_weights") and os.path.exists(cfg.sta_weights):
        from ..models.convert import load_params_npz, state_dict_from_jax

        log(f"loading converted weights from {cfg.sta_weights}")
        model.load_state_dict(state_dict_from_jax(load_params_npz(cfg.sta_weights)))
    elif cfg.get("sta_torch_weights") and os.path.exists(cfg.sta_torch_weights):
        log(f"loading torch checkpoint {cfg.sta_torch_weights}")
        ckpt = torch.load(cfg.sta_torch_weights, map_location="cpu", weights_only=False)
        # the reference checkpoint also holds modules the port does not use
        # (e.g. its enc_norm); every port parameter must be in it
        missing, _ = model.load_state_dict(ckpt.get("model", ckpt), strict=False)
        if missing:
            raise KeyError(f"{cfg.sta_torch_weights} lacks {len(missing)} STA "
                           f"parameters, e.g. {missing[:3]}")
    else:
        log("no STA weights configured — using RANDOM weights (smoke-test mode)",
            Channel.WARNING)
        gen = torch.Generator(device=device).manual_seed(int(cfg.get("random_seed", 0)))
        model.init_weights_(gen)
    return FrontendEngine(mcfg, model)


def build_loop_detector(cfg: Config):
    path = cfg.get("vocab_path")
    if not path or not os.path.exists(path):
        log("no BoW vocabulary configured — loop closure disabled", Channel.WARNING)
        return None
    from ..native.bow import Vocabulary
    from ..slam.loop_detector import LoopDetector

    vocab = Vocabulary()
    vocab.load(path)
    return LoopDetector(vocab, cfg.loop_dist_min, cfg.loop_nms,
                        cfg.loop_cand_thresh_neighbor)


def build_pgo_config(cfg: Config):
    """An optional ``pgo:`` mapping overrides PGOConfig fields; unknown keys
    (including the JAX package's TPU-only solver knobs) fail loudly."""
    from ..slam.pgo import PGOConfig

    overrides = cfg.get("pgo") or {}
    bad = set(overrides) - set(PGOConfig._fields)
    if bad:
        raise ValueError(f"unknown pgo config keys: {sorted(bad)} "
                         f"(valid: {list(PGOConfig._fields)})")
    return PGOConfig(**overrides) if overrides else None


def build_slam(cfg: Config, live_mode: bool = False):
    from ..slam.online_slam import OnlineSLAM

    frontend = build_frontend(cfg)
    return OnlineSLAM(
        frontend, loop_detector=build_loop_detector(cfg),
        verbose=bool(cfg.get("verbose", False)),
        max_view_num=cfg.max_view_num, neighbor_edge_num=cfg.neighbor_edge_num,
        loop_edge_num=cfg.loop_edge_num, conf_thres=cfg.point_conf_thres,
        rel_pose_thres=cfg.rel_pose_thres, flow_thres=cfg.flow_thres,
        pgo_every=cfg.pgo_every, live_mode=live_mode,
        combine_loop_batch=bool(cfg.get("combine_loop_batch", False)),
        pgo_config=build_pgo_config(cfg))


def select_stride_indices(n_frames: int, stride: int, max_view_num: int):
    idxs = list(range(1, n_frames, stride))
    if len(idxs) > max_view_num:
        log(f"too many keyframes ({len(idxs)}); sampling {max_view_num} evenly",
            Channel.WARNING)
        idxs = list(np.linspace(0, n_frames - 1, max_view_num).astype(int))
    return set(int(i) for i in idxs)
