"""Online monocular dense SLAM without jax.

``OnlineSLAM`` is the JAX package's orchestrator
(vista_slam_tpu/slam/online_slam.py: keyframe ingest, batched edge
regression, Sim(3) pose graph, loop closure, windowed PGO; reference:
vista_slam/slam.py:20-447), copied with the parts that touch jax replaced:
the pointmap store is the torch one, every edge batch goes through the
frontend's fused decode (one device program and one fetch per batch), the
edge-batch replay reads the frontend's already-fetched host outputs, PGO is
the torch solver, and the OpenCV flow tracker is built only when flow
keyframing first asks for it (stride keyframing runs on hosts without
OpenCV). State checkpointing (save_state / load_state) is not ported yet.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..utils.logging import Channel, log
from . import host_math as hm
from .flow_tracker import FlowTracker
from .pgo import PGOConfig, optimize_pose_graph
from .pointmap_store import DevicePointmapStore
from .pose_graph import ID_POSE_CONF, PoseGraph

MAX_PAIR_BATCH = 8  # largest frontend decode bucket (slam/frontend.py)


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


class OnlineSLAM:
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
    def reset(self):
        self.graph.reset()
        if self.pointmaps is not None:
            self.pointmaps.reset()
        self.flow_tracker.reset()
        if self.lc_detector is not None:
            self.lc_detector.reset()
        self.enc_feats.clear()
        self.imgs.clear()
        self.view_names.clear()
        self.view_num = 0
        self.loop_related_views.clear()
        for k in self.time_dict:
            self.time_dict[k] = 0.0

    # ------------------------------------------------------------------
    def step(self, value: dict, force_pgo: bool = False) -> bool:
        """Ingest one keyframe. value: {'rgb': HWC float32 [-1,1],
        'gray': uint8 HW, 'view_name': str, 'enc_feat': optional
        pre-encoded token cache from FrontendEngine.encode_batch (offline
        prefetch)}. Returns True if PGO ran."""
        t0 = time.time()
        rgb = value["rgb"]
        gray = value.get("gray")
        i = self.view_num
        self.time_dict["prepare_data"] += time.time() - t0

        t0 = time.time()
        feat = value.get("enc_feat")
        farthest = max(0, i - self.neighbor_edge_num)
        njs = list(range(farthest, i))
        # fused encode: the new frame's encoder forward rides the first
        # edge-batch dispatch as ONE device program (frontend.
        # encode_decode_pairs_fused) — no separate encode dispatch per
        # keyframe. Falls back to a plain encode when there is no edge batch
        # to ride (first frame), features were prefetched, or the frontend
        # doesn't support it (synthetic test frontends).
        fuse_encode = (self.fuse_encode and feat is None and bool(njs)
                       and hasattr(self.frontend, "encode_decode_pairs_fused"))
        if feat is None and not fuse_encode:
            feat = self.frontend.encode(rgb)
        self.enc_feats.append(feat)  # None placeholder when fused: filled
        # by _dispatch_edge_batch before anything consumes it
        self.imgs.append(np.asarray(rgb))
        self.view_names.append(value.get("view_name", f"view_{i}"))
        self.view_num += 1
        self.time_dict["encoder"] += time.time() - t0

        # --- neighbor + loop edges (the reference is fully serial here,
        # slam.py:262-277). Two schedules:
        #   split (default): dispatch the neighbor batch, run host BoW
        #     retrieval WHILE the device computes, then a second
        #     dispatch+fetch for the loop candidates;
        #   combined: BoW first, then neighbors+loops as ONE dispatch and
        #     ONE fetch — half the round trips, for high-latency links.
        if self.combine_loop_batch:
            t0 = time.time()
            loop_cands = (self.lc_detector.detect(gray, farthest)
                          if self.lc_detector is not None and gray is not None
                          else [])
            self.time_dict["lc"] += time.time() - t0
            loop_js = [j for j, _ in loop_cands[: self.loop_edge_num]]

            t0 = time.time()
            js = njs + loop_js  # reference order: neighbors, then loops
            img = rgb if fuse_encode else None
            if js and len(js) <= MAX_PAIR_BATCH:
                self._finish_edge_batch(i, js,
                                        self._dispatch_edge_batch(i, js, img))
            else:  # bucket overflow: fall back to two batches
                if njs:
                    self._finish_edge_batch(
                        i, njs, self._dispatch_edge_batch(i, njs, img))
                if loop_js:
                    self._finish_edge_batch(
                        i, loop_js, self._dispatch_edge_batch(i, loop_js))
            self.time_dict["graph_construction"] += time.time() - t0
        else:
            t0 = time.time()
            pending = (self._dispatch_edge_batch(
                i, njs, rgb if fuse_encode else None) if njs else None)
            t_dispatch = time.time() - t0

            t0 = time.time()
            loop_cands = (self.lc_detector.detect(gray, farthest)
                          if self.lc_detector is not None and gray is not None
                          else [])
            self.time_dict["lc"] += time.time() - t0

            t0 = time.time()
            if pending is not None:
                self._finish_edge_batch(i, njs, pending)
            t_neighbor = t_dispatch + (time.time() - t0)

            t0 = time.time()
            loop_js = [j for j, _ in loop_cands[: self.loop_edge_num]]
            if loop_js:
                self._finish_edge_batch(i, loop_js,
                                        self._dispatch_edge_batch(i, loop_js))
            self.time_dict["graph_construction"] += t_neighbor + (time.time() - t0)

        # --- windowed PGO ---------------------------------------------------
        if self.view_num % self.pgo_every == 0 or force_pgo:
            t0 = time.time()
            self.pose_graph_optimize()
            self.time_dict["pgo"] += time.time() - t0
            return True
        return False

    # ------------------------------------------------------------------
    def _store(self, hw) -> DevicePointmapStore:
        if self.pointmaps is None:
            # +1 scrap row: padded pairs of the fused step scatter there
            self.pointmaps = DevicePointmapStore(self.graph.max_nodes + 1, tuple(hw),
                                                 device=self.frontend.device)
        return self.pointmaps

    def _plan_edge_batch(self, i: int, js: list[int]):
        """Speculative slot assignment + scale-job enumeration BEFORE any
        device result is known: pair k gets slots (base+2k, base+2k+1)
        (rejected pairs leave gaps outside the optimization window), and
        every (new node, possible first node) scale reduction the replay
        might need is listed up front."""
        g = self.graph
        B = len(js)
        base = g.num_nodes
        spec_ni = [base + 2 * k for k in range(B)]
        spec_nj = [base + 2 * k + 1 for k in range(B)]
        node_idxs = [n for k in range(B) for n in (spec_ni[k], spec_nj[k])]
        prior_first_i = (g.view_to_nodes.get(i) or [None])[0]
        jobs: list[tuple[int, int]] = []
        for k in range(B):
            if prior_first_i is not None:
                jobs.append((spec_ni[k], prior_first_i))
            else:
                jobs += [(spec_ni[k], spec_ni[m]) for m in range(k)]
            fj = (g.view_to_nodes.get(js[k]) or [None])[0]
            if fj is not None:
                jobs.append((spec_nj[k], fj))
        return spec_ni, spec_nj, node_idxs, jobs, prior_first_i

    def _dispatch_edge_batch(self, i: int, js: list[int], img=None):
        """Dispatch all device work for an edge batch without synchronizing:
        decode + store scatter + scale reductions run as one program, and
        with ``img`` given frame i's encoder forward rides the same call;
        its token cache is filled into ``enc_feats[i]`` here."""
        plan = self._plan_edge_batch(i, js)
        _, _, node_idxs, jobs, _ = plan
        f_j = [self.enc_feats[j] for j in js]
        store = self._store(self.frontend.cfg.img_size)
        if img is not None:
            host, feat = self.frontend.encode_decode_pairs_fused(
                img, f_j, store, node_idxs, jobs)
            self.enc_feats[i] = feat
            return plan, ("fused", host)
        f_i = [self.enc_feats[i]] * len(js)
        host = self.frontend.decode_pairs_fused(f_i, f_j, store, node_idxs, jobs)
        return plan, ("fused", host)

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
    def get_view(self, v: int, filter_outlier: bool = True):
        """Pose (4x4), filtered scaled depth and intrinsics of view v's best
        node (reference: slam.py:299-326)."""
        n = self.graph.best_node(v)
        pose, scale = self.graph.view_pose_scale(v)
        depth, conf, intri = self.pointmaps.fetch(n)
        depth = depth * scale
        if filter_outlier:
            depth = np.where(conf < self.conf_thres, 0.0, depth)
        return {"pose": pose, "depth": depth, "conf": conf, "intri": intri,
                "scale": scale}

    def get_pointmap_vis(self, v: int):
        """Color-coded local pointmap of view v (reference: slam.py:423-432).
        Returns (uint8 HWx3 visualization, pointcloud [H,W,3])."""
        from ..utils.pointcloud import unproject_views

        view = self.get_view(v, filter_outlier=False)
        pcl = unproject_views(view["depth"][None], view["intri"][None],
                              np.eye(4, dtype=np.float32)[None])[0]
        lo = pcl.min(axis=(0, 1), keepdims=True)
        hi = pcl.max(axis=(0, 1), keepdims=True)
        img = ((pcl - lo) / (hi - lo + 1e-8) * 255).astype(np.uint8)
        return img, pcl

    def save_pointmap(self, v: int, output_folder: str):
        os.makedirs(output_folder, exist_ok=True)
        img, pcl = self.get_pointmap_vis(v)
        np.save(os.path.join(output_folder, f"pointmap_cam_{v}.npy"), pcl)
        try:
            import cv2

            cv2.imwrite(os.path.join(output_folder, f"pointmap_cam_{v}.png"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        except ImportError:
            pass

    def get_view_graph(self) -> dict[int, list[int]]:
        g = self.graph
        return {
            v: [int(g.node_connected_view[n]) for n in g.view_to_nodes.get(v, [])]
            for v in range(self.view_num)
        }

    def get_time_dict(self) -> dict[str, float]:
        td = dict(self.time_dict)
        td["decoder"] = getattr(self.frontend, "time_decode", 0.0)
        td["encoder"] = getattr(self.frontend, "time_encode", td["encoder"])
        td["graph_construction"] = max(td["graph_construction"] - td["decoder"], 0.0)
        td["total"] = sum(td.values())
        return td

    # ------------------------------------------------------------------
    def save_state(self, path: str, **extra):
        raise NotImplementedError("SLAM state checkpointing is not ported yet "
                                  "(queued in ROADMAP.md)")

    def load_state(self, path: str) -> dict:
        raise NotImplementedError("SLAM state checkpointing is not ported yet "
                                  "(queued in ROADMAP.md)")

    # ------------------------------------------------------------------
    def save_data_all(self, output_folder: str, *, save_view_graph=True,
                      traj_name_postfix=None, save_poses=True, save_images=True,
                      save_scales=True, save_depths=True, save_intrinsics=True,
                      save_confs=True, save_ply=True, gt_poses=None,
                      gt_depths=None, gt_intrinsics=None):
        """Dump the artifact set consumed by the eval/vis tools (reference:
        slam.py:338-421).

        Artifact schema (all plain arrays, no pickled objects):
          trajectory.npy  [V,4,4]  cam->world per view (best node)
          scales.npy      [V,1]    per-view depth scale
          images.npy      [V,H,W,3] float32 in [0,1] (SLAM input resolution)
          depths.npy      [V,h,w]  unscaled model depths
          confs.npz       confs [V,h,w] + thres scalar
          intrinsics.npy  [V,3,3]
          pointcloud.ply  binary PLY, colored whenever images are available
                          (resized to the depth resolution if they differ)
          view_graph.npz  edges [E,2] int32 (view i connected to view j),
                          loop_min_dist scalar, view_names [V] str
          gt_*.npy        optional ground truth passthrough
        """
        os.makedirs(output_folder, exist_ok=True)
        if save_view_graph:
            vg = self.get_view_graph()
            vg_edges = np.asarray(
                [(v, j) for v, js in vg.items() for j in js],
                np.int32).reshape(-1, 2)
            loop_min = (self.lc_detector.loop_dist_min
                        if self.lc_detector is not None else 0)
            np.savez(os.path.join(output_folder, "view_graph.npz"),
                     edges=vg_edges, loop_min_dist=loop_min,
                     view_names=np.asarray(self.view_names))

        best = [self.graph.best_node(v) for v in range(self.view_num)]
        poses, scales = [], []
        for v in range(self.view_num):
            pose, scale = self.graph.view_pose_scale(v)
            poses.append(pose)
            scales.append([scale])
        poses = np.stack(poses)
        scales = np.asarray(scales, np.float32)
        # one bulk fetch of every exported pointmap from the device store
        depths, confs, intris = self.pointmaps.fetch_many(best)
        images = (np.stack(self.imgs) + 1.0) / 2.0

        sfx = f"_{traj_name_postfix}" if traj_name_postfix is not None else ""
        if save_poses:
            np.save(os.path.join(output_folder, f"trajectory{sfx}.npy"), poses)
        if save_scales:
            np.save(os.path.join(output_folder, f"scales{sfx}.npy"), scales)
        if save_images:
            np.save(os.path.join(output_folder, "images.npy"), images)
        if save_depths:
            np.save(os.path.join(output_folder, "depths.npy"), depths)
        if save_confs:
            np.savez(os.path.join(output_folder, "confs.npz"), confs=confs,
                     thres=self.conf_thres)
        if save_intrinsics:
            np.save(os.path.join(output_folder, "intrinsics.npy"), intris)
        if save_ply:
            from ..utils.pointcloud import unproject_views, write_ply

            masks = confs > self.conf_thres
            world_pts = unproject_views(depths * scales[..., None], intris, poses)
            colors = images
            if images.shape[:3] != masks.shape:
                # stored RGB resolution differs from the SLAM pointmap
                # resolution: resize instead of silently dropping colors
                # (cv2 is optional — degrade to an uncolored PLY without it)
                try:
                    import cv2

                    h, w = masks.shape[1:3]
                    colors = np.stack([cv2.resize(im, (w, h)) for im in images])
                except ImportError:
                    colors = None
            write_ply(os.path.join(output_folder, "pointcloud.ply"),
                      world_pts[masks],
                      colors[masks] if colors is not None else None)
        if gt_poses is not None:
            np.save(os.path.join(output_folder, "gt_poses.npy"),
                    np.asarray(gt_poses, np.float32))
        if gt_depths is not None:
            np.save(os.path.join(output_folder, "gt_depths.npy"),
                    np.asarray(gt_depths, np.float32))
        if gt_intrinsics is not None:
            np.save(os.path.join(output_folder, "gt_intrinsics.npy"),
                    np.asarray(gt_intrinsics))
