"""Host-side pose-graph state: preallocated node/edge buffers + view maps.

Mirrors the capability of the reference's PoseGraphNodes/PoseGraphEdges
(reference: vista_slam/pose_graph.py:5-54): each accepted two-view regression
adds one node per endpoint view (a node = one pointmap prediction of that
view), scale edges tie the multiple nodes of a view together, and pose edges
carry the regressed relative Sim(3).

Buffers are numpy (padded to static maxima) so a PGO call is a single
host->device transfer into the jit-compiled solver. Per-node pointmaps
(depth, conf, intrinsics) stay on host exactly like the reference parks them
on CPU (pose_graph.py:37).
"""

from __future__ import annotations

import numpy as np

from . import host_math as hm

ID_POSE_CONF = 2.0  # confidence of same-view scale edges (pose_graph.py:11)


class PoseGraph:
    def __init__(self, max_nodes: int, max_edges: int):
        self.max_nodes = max_nodes
        self.max_edges = max_edges
        self.reset()

    def reset(self):
        self.node_poses = hm.identity(self.max_nodes)          # [N, 8]
        self.node_view = np.full(self.max_nodes, -1, np.int32)
        self.node_connected_view = np.full(self.max_nodes, -1, np.int32)
        self.view_to_nodes: dict[int, list[int]] = {}
        self.view_best_node: dict[int, tuple[int, float]] = {}
        self.num_nodes = 0

        self.edges = np.zeros((self.max_edges, 2), np.int32)
        self.edge_poses = hm.identity(self.max_edges)          # [E, 8]
        self.edge_confs = np.ones((self.max_edges, 7), np.float32)
        self.num_edges = 0

    # ------------------------------------------------------------------
    def add_node(self, view_id: int, mean_conf: float, connected_view: int) -> int:
        """Register node metadata; the dense pointmap lives in the device
        store (slam/pointmap_store.py) under the returned index."""
        return self.add_node_at(self.num_nodes, view_id, mean_conf, connected_view)

    def add_node_at(self, n: int, view_id: int, mean_conf: float,
                    connected_view: int) -> int:
        """Register a node at a preassigned index. Indices may leave gaps
        (speculative batch assignment where some edges were rejected); gap
        slots keep identity poses and never enter the optimization window."""
        assert n < self.max_nodes, "node buffer full"
        self.node_view[n] = view_id
        self.node_connected_view[n] = connected_view
        self.view_to_nodes.setdefault(view_id, []).append(n)
        # every view with a node must have a best node, even if mean_conf is
        # non-finite (NaN comparisons are always False)
        best = self.view_best_node.get(view_id)
        if best is None or mean_conf > best[1]:
            self.view_best_node[view_id] = (n, float(mean_conf))
        self.num_nodes = max(self.num_nodes, n + 1)
        return n

    def add_edge(self, i: int, j: int, pose: np.ndarray, conf) -> int:
        e = self.num_edges
        assert e < self.max_edges, "edge buffer full"
        self.edges[e] = (i, j)
        self.edge_poses[e] = pose
        self.edge_confs[e] = np.broadcast_to(np.asarray(conf, np.float32), (7,))
        self.num_edges += 1
        return e

    # ------------------------------------------------------------------
    def opt_mask_for_window(self, view_start: int, view_end: int,
                            extra_views=()) -> np.ndarray:
        """Boolean [max_nodes] over nodes whose view is inside
        [view_start, view_end] or in extra_views (loop-touched views),
        matching the reference window (slam.py:115-121)."""
        mask = np.zeros(self.max_nodes, bool)
        views = set(range(view_start, view_end + 1)) | set(int(v) for v in extra_views)
        for v in views:
            for n in self.view_to_nodes.get(v, ()):  # may be absent if rejected
                mask[n] = True
        return mask

    def edge_valid_mask(self) -> np.ndarray:
        m = np.zeros(self.max_edges, bool)
        m[: self.num_edges] = True
        return m

    def best_node(self, view_id: int) -> int:
        return self.view_best_node[view_id][0]

    def view_pose_scale(self, view_id: int):
        """Camera pose (4x4, rigid) and scale of the view's best node."""
        n = self.best_node(view_id)
        g = self.node_poses[n]
        return hm.to_pose_matrix(g), float(g[7])
