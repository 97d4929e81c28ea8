"""Config with attribute access and the JAX package's defaults, without a
module-level yaml import (the card's path runs without PyYAML; reading a
YAML file imports it inside ``load_config``)."""

from __future__ import annotations

from typing import Any


class Config(dict):
    """dict with attribute access, recursively."""

    def __getattr__(self, k: str) -> Any:
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) else v

    def __setattr__(self, k: str, v: Any) -> None:
        self[k] = v


# the defaults of vista_slam_tpu/utils/config.py, on a CUDA device
DEFAULTS = dict(
    device="cuda",
    verbose=False,
    rerun_vis=False,
    rerun_save=False,
    output_dir="output/test",
    sta_weights=None,          # converted .npz of the JAX package
    sta_torch_weights=None,    # reference-layout PyTorch .pth
    vocab_path=None,
    random_seed=43,
    max_view_num=400,
    neighbor_edge_num=3,
    loop_edge_num=3,
    loop_dist_min=40,
    loop_nms=40,
    loop_cand_thresh_neighbor=5,
    point_conf_thres=4.2,
    rel_pose_thres=0.75,
    keyframe_detection="flow_stride",
    stride=25,
    flow_thres=5.0,
    pgo_every=500,
    compute_dtype="bfloat16",
)


def make_config(data: dict | None = None, **overrides) -> Config:
    """DEFAULTS, updated by ``data`` and then by the non-None overrides."""
    cfg = Config(DEFAULTS)
    cfg.update(data or {})
    cfg.update({k: v for k, v in overrides.items() if v is not None})
    return cfg


def load_config(path: str | None = None, **overrides) -> Config:
    data = None
    if path is not None:
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
    return make_config(data, **overrides)
