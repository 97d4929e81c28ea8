"""Online monocular dense SLAM without jax.

``OnlineSLAM`` here is the JAX package's orchestrator
(vista_slam_tpu/slam/online_slam.py: keyframe ingest, batched edge
regression, Sim(3) pose graph, loop closure, windowed PGO) with the parts
that touch jax replaced: the pointmap store is the torch one, the edge-batch
replay reads the frontend's already-fetched host outputs, PGO is the torch
solver, and the OpenCV flow tracker is built only when flow keyframing
first asks for it (stride keyframing runs on hosts without OpenCV).
State checkpointing (save_state / load_state) is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from vista_slam_tpu.slam import host_math as hm
from vista_slam_tpu.slam import online_slam as _ref
from vista_slam_tpu.slam.flow_tracker import FlowTracker
from vista_slam_tpu.slam.pose_graph import ID_POSE_CONF, PoseGraph
from vista_slam_tpu.utils.logging import Channel, log

from .pgo import PGOConfig, optimize_pose_graph
from .pointmap_store import DevicePointmapStore


class LazyFlowTracker:
    """A FlowTracker that is built at its first keyframe decision."""

    def __init__(self, min_disparity: float):
        self.min_disparity = min_disparity
        self._tracker: FlowTracker | None = None

    def reset(self):
        if self._tracker is not None:
            self._tracker.reset()

    def is_new_keyframe(self, gray: np.ndarray) -> bool:
        if self._tracker is None:
            self._tracker = FlowTracker(self.min_disparity)
        return self._tracker.is_new_keyframe(gray)


class OnlineSLAM(_ref.OnlineSLAM):
    def __init__(self, frontend, *, loop_detector=None, verbose: bool = False,
                 max_view_num: int = 400, neighbor_edge_num: int = 3,
                 loop_edge_num: int = 3, conf_thres: float = 4.2,
                 rel_pose_thres: float = 0.75, flow_thres: float = 5.0,
                 pgo_every: int = 500, live_mode: bool = False,
                 image_resolution=(224, 224),
                 combine_loop_batch: bool = False, pgo_config=None,
                 fuse_encode: bool = True):
        # the parameters and state of the JAX package's __init__, with the
        # flow tracker made lazy (its constructor needs OpenCV)
        self.frontend = frontend
        self.lc_detector = loop_detector
        self.verbose = verbose
        self.max_view_num = max_view_num
        self.neighbor_edge_num = neighbor_edge_num
        self.loop_edge_num = loop_edge_num
        self.conf_thres = conf_thres
        self.rel_pose_thres = rel_pose_thres
        self.pgo_every = pgo_every
        self.pgo_config = pgo_config  # None -> PGOConfig() defaults
        self.live_mode = live_mode
        self.image_resolution = image_resolution
        self.combine_loop_batch = combine_loop_batch
        self.fuse_encode = fuse_encode

        per_view = 2 * neighbor_edge_num + loop_edge_num
        max_nodes = max_view_num * 2 * (neighbor_edge_num + loop_edge_num)
        max_edges = max_view_num * ((per_view - 1) + (per_view // 2 + 1))
        self.graph = PoseGraph(max_nodes, max_edges)

        self.flow_tracker = LazyFlowTracker(flow_thres)
        self.pointmaps = None  # device store, created at the first decode
        self.enc_feats: list = []
        self.imgs: list[np.ndarray] = []
        self.view_names: list[str] = []
        self.view_num = 0
        self.loop_related_views: set[int] = set()
        self.pgo_window_size = 2 * pgo_every
        self.time_dict = dict.fromkeys(
            ["prepare_data", "encoder", "decoder", "lc", "pgo", "graph_construction"], 0.0)

    # ------------------------------------------------------------------
    def _store(self, hw) -> DevicePointmapStore:
        if self.pointmaps is None:
            # +1 scrap row: padded pairs of the fused step scatter there
            self.pointmaps = DevicePointmapStore(self.graph.max_nodes + 1, tuple(hw),
                                                 device=self.frontend.device)
        return self.pointmaps

    def _finish_edge_batch(self, i: int, js: list[int], pending):
        """Replay the graph updates of one fetched edge batch in the
        reference's per-edge order (slam.py:153-241)."""
        plan, payload = pending
        spec_ni, spec_nj, node_idxs, jobs, prior_first_i = plan
        if payload[0] != "fused":
            raise TypeError("the port's OnlineSLAM needs a frontend with "
                            "decode_pairs_fused")
        g = self.graph
        store = self.pointmaps
        host = payload[1]  # already fetched and trimmed by the engine
        scale_of = {(n, f): (float(s), float(c))
                    for (n, f), s, c in zip(jobs, host["scale"], host["scale_conf"])}

        first_accepted_ni = prior_first_i
        for k, j in enumerate(js):
            pose_conf = float(host["pose_conf_ij"][k])
            if pose_conf < self.rel_pose_thres and i - j != 1:
                if self.verbose:
                    log(f"rejecting edge ({i} -- {j}) with conf {pose_conf:.3f}",
                        Channel.EDGE_REJECT)
                continue
            if i - j > self.neighbor_edge_num:
                if self.verbose:
                    log(f"adding loop edge ({i} -- {j}) with conf {pose_conf:.3f}",
                        Channel.LOOP_CLOSURE)
                self.loop_related_views.add(i)
                self.loop_related_views.add(j)

            n_i, n_j = spec_ni[k], spec_nj[k]
            K = np.asarray(host["K"][k], np.float32)
            g.add_node_at(n_i, i, float(host["mean_conf_i"][k]), j)
            g.add_node_at(n_j, j, float(host["mean_conf_j"][k]), i)
            store.set_intri([n_i, n_j], [K, K])

            se3_ij = hm.from_matrix(np.asarray(host["pose_ij"][k], np.float64), 1.0)
            for n, first in ((n_i, first_accepted_ni),
                             (n_j, (g.view_to_nodes[j] or [None])[0])):
                if first is None or first == n:
                    continue
                s, scale_conf = scale_of[(n, first)]
                z = hm.identity()
                z[7] = s
                weight = np.asarray([ID_POSE_CONF] * 6 + [scale_conf], np.float32)
                g.add_edge(n, first, z, weight)
                g.node_poses[n] = hm.mul(g.node_poses[first], z)
            if first_accepted_ni is None:
                first_accepted_ni = n_i
                g.node_poses[n_i] = hm.mul(g.node_poses[n_j], se3_ij)
            g.add_edge(n_i, n_j, se3_ij, pose_conf)

    # ------------------------------------------------------------------
    def pose_graph_optimize(self):
        log(f"pose graph optimization (at keyframe {self.view_num}) ...", Channel.PGO)
        if self.live_mode:
            log("this may add latency in live mode", Channel.PGO)
        g = self.graph
        dev = self.frontend.device
        start_view = max(0, self.view_num - self.pgo_window_size)
        opt_mask = g.opt_mask_for_window(start_view, self.view_num - 1,
                                         self.loop_related_views)

        def t(a):
            return torch.as_tensor(np.asarray(a)).to(dev)

        new_nodes, info = optimize_pose_graph(
            t(g.node_poses), t(g.edges), t(g.edge_poses), t(g.edge_confs),
            t(g.edge_valid_mask()), t(opt_mask), self.pgo_config or PGOConfig())
        g.node_poses = new_nodes.cpu().numpy()
        self.loop_related_views = set()
        log(f"pose graph optimization done ({info['steps']} steps, "
            f"loss {info['loss0']:.4g} -> {info['loss']:.4g})", Channel.PGO)
        return info

    # ------------------------------------------------------------------
    def save_state(self, path: str, **extra):
        raise NotImplementedError("SLAM state checkpointing is not ported yet "
                                  "(queued in ROADMAP.md)")

    def load_state(self, path: str) -> dict:
        raise NotImplementedError("SLAM state checkpointing is not ported yet "
                                  "(queued in ROADMAP.md)")
