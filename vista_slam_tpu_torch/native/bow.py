"""Hierarchical bag-of-binary-words vocabulary (DBoW-compatible).

Host-side replacement for the reference's DBoW3 C++ submodule (reference:
vista_slam/loop_detector.py:6-33 uses Vocabulary.load / transform / score).
Capabilities:
  * load the DBoW2/DBoW3 text format (e.g. ORBvoc.txt: header `k L scoring
    weighting`, then one node per line `parent is_leaf 32-bytes weight`),
  * load/save a compact .npz format,
  * train a vocabulary from ORB descriptors (hierarchical k-majority
    clustering on binary descriptors) so the pipeline is self-contained even
    without the upstream vocabulary file,
  * transform descriptor sets to TF-IDF weighted, L1-normalized BoW vectors
    and score vector pairs with the DBoW L1 similarity
    s = 0.5 * sum_{i in both} (|v_i| + |w_i| - |v_i - w_i|).

The numpy implementation vectorizes the tree descent over all descriptors of
an image at once (one gather + popcount per level). A ctypes-loaded C++
helper (native/src/bow.cpp), built at first use, serves descent and scoring
where g++ is present.
"""

from __future__ import annotations

import io
import subprocess
import warnings

import numpy as np

from . import bow_native

_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.uint16)

_NATIVE: bool | None = None  # None: the C++ helper not tried yet


def _native() -> bool:
    """Whether the C++ helper serves descent and scoring: it is built with
    g++ at first use; where that fails, one warning, then numpy."""
    global _NATIVE
    if _NATIVE is None:
        try:
            bow_native.load()
            _NATIVE = True
        except (OSError, subprocess.CalledProcessError) as e:
            warnings.warn(f"BoW C++ helper unavailable ({e}); using numpy")
            _NATIVE = False
    return _NATIVE


def hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise Hamming distance between uint8 descriptor arrays
    a[..., 32] and b[..., 32] (broadcasting)."""
    x = np.bitwise_xor(a, b)
    return _POPCOUNT[x].sum(axis=-1)


class BowVector:
    """Sparse L1-normalized BoW vector: sorted word ids + values."""

    __slots__ = ("ids", "vals")

    def __init__(self, ids: np.ndarray, vals: np.ndarray):
        self.ids = ids
        self.vals = vals


def l1_score(a: BowVector, b: BowVector) -> float:
    """DBoW L1 scoring over the intersection of word ids."""
    ia = np.searchsorted(a.ids, b.ids)
    ia = np.clip(ia, 0, len(a.ids) - 1) if len(a.ids) else ia
    if len(a.ids) == 0 or len(b.ids) == 0:
        return 0.0
    match = a.ids[ia] == b.ids
    va = a.vals[ia[match]]
    vb = b.vals[match]
    return float(0.5 * np.sum(np.abs(va) + np.abs(vb) - np.abs(va - vb)))


class Vocabulary:
    """k-ary tree over binary descriptors; leaves are weighted words."""

    def __init__(self):
        self.k = 0
        self.levels = 0
        # padded-children layout: [num_nodes, k]
        self.child_idx: np.ndarray | None = None     # int32, -1 = none
        self.child_desc: np.ndarray | None = None    # uint8 [num_nodes, k, 32]
        self.node_word: np.ndarray | None = None     # int32, -1 = internal node
        self.node_weight: np.ndarray | None = None   # float32
        self.num_words = 0

    # -- queries --------------------------------------------------------
    @property
    def empty(self) -> bool:
        return self.child_idx is None or self.num_words == 0

    def descend(self, descriptors: np.ndarray) -> np.ndarray:
        """Map each descriptor [M, 32] uint8 to its leaf word id [M]."""
        d = np.ascontiguousarray(descriptors, dtype=np.uint8)
        if _native():
            return bow_native.descend_native(self, d)
        m = d.shape[0]
        cur = np.zeros(m, np.int32)  # root = node 0
        for _ in range(self.levels + 1):
            kids = self.child_idx[cur]                      # [M, k]
            has_kids = kids[:, 0] >= 0
            if not has_kids.any():
                break
            cd = self.child_desc[cur]                       # [M, k, 32]
            dist = hamming(d[:, None, :], cd).astype(np.int32)
            dist = np.where(kids >= 0, dist, np.iinfo(np.int32).max)
            best = kids[np.arange(m), np.argmin(dist, axis=1)]
            cur = np.where(has_kids, best, cur).astype(np.int32)
        return self.node_word[cur]

    def transform(self, descriptors: np.ndarray) -> BowVector | None:
        """ORB descriptors [M, 32] -> TF-IDF weighted L1-normalized vector."""
        if descriptors is None or len(descriptors) == 0 or self.empty:
            return None
        words = self.descend(descriptors)
        valid = words >= 0
        words = words[valid]
        if len(words) == 0:
            return None
        w = self.node_weight_by_word[words]
        ids, inverse = np.unique(words, return_inverse=True)
        vals = np.zeros(len(ids), np.float64)
        np.add.at(vals, inverse, w)
        total = vals.sum()
        if total <= 0:
            return None
        return BowVector(ids.astype(np.int32), (vals / total).astype(np.float32))

    def score(self, a: BowVector, b: BowVector) -> float:
        if _native():
            return bow_native.l1_score_native(a, b)
        return l1_score(a, b)

    # -- construction ---------------------------------------------------
    def _finalize(self):
        """Precompute word-indexed weights."""
        self.node_weight_by_word = np.zeros(self.num_words, np.float32)
        word_nodes = np.nonzero(self.node_word >= 0)[0]
        self.node_weight_by_word[self.node_word[word_nodes]] = self.node_weight[word_nodes]

    @staticmethod
    def _from_tree(k, levels, parents, descs, weights, is_leaf):
        """Build padded-children arrays from a parent-pointer tree.
        Node 0 is the root (no descriptor). Rejects trees outside the DBoW
        envelope (a parent with more than k children) instead of silently
        truncating: dropped children would silently change word assignment
        and so loop-candidate rankings."""
        v = Vocabulary()
        v.k = k
        v.levels = levels
        n = len(parents)
        v.child_idx = np.full((n, k), -1, np.int32)
        v.child_desc = np.zeros((n, k, 32), np.uint8)
        if n > 1:
            # group children by parent; stable sort keeps ascending node-id
            # order within each parent (same slot order as sequential insert)
            order = np.argsort(parents[1:], kind="stable").astype(np.int64) + 1
            p_sorted = parents[order]
            slot = np.arange(len(order)) - np.searchsorted(p_sorted, p_sorted)
            if (slot >= k).any():
                bad = int(p_sorted[slot >= k][0])
                raise ValueError(
                    f"malformed DBoW tree: node {bad} has more than k={k} "
                    "children")
            v.child_idx[p_sorted, slot] = order
            v.child_desc[p_sorted, slot] = descs[order]
        v.node_word = np.full(n, -1, np.int32)
        v.node_weight = np.asarray(weights, np.float32)
        leaves = np.flatnonzero(is_leaf)  # word ids in node-id order
        v.node_word[leaves] = np.arange(len(leaves), dtype=np.int32)
        v.num_words = int(len(leaves))
        v._finalize()
        return v

    # -- io ---------------------------------------------------------------
    def load(self, path: str) -> "Vocabulary":
        if path.endswith(".npz"):
            return self.load_npz(path)
        return self.load_dbow_text(path)

    def load_dbow_text(self, path: str) -> "Vocabulary":
        """Parse the DBoW2/DBoW3 plain-text vocabulary format.

        Supported envelope (everything else raises ValueError; fuzzed in
        tests/test_bow_text.py):
          * header `k L [scoring weighting]` with scoring 0 = L1_NORM and
            weighting 0 = TF_IDF — the ORBvoc.txt configuration. Any other
            type id would silently change similarity semantics.
          * one node per line, `parent is_leaf d0..d31 weight` (35 numbers;
            line n creates node n, root = 0, word ids in leaf-line order —
            DBoW3 loadFromTextFile's conventions). Node lines may appear in
            any order (children need not be contiguous or follow their
            parent). Descend tie-breaking follows child order — ascending
            node id, matching DBoW3's sequential insert for files DBoW3
            itself writes — so word assignment (and every score) is
            invariant to relabelings that preserve each parent's child
            order, up to a word-id bijection.
          * parent ids in [0, num_nodes), at most k children per node,
            integral descriptor bytes in [0, 255], finite weights.
        The DBoW3 binary `.dbow3`/`.gz` formats are NOT parsed (no
        published artifact to validate against in this environment); convert
        with DBoW3's own save-to-text first."""
        with open(path) as f:
            header = f.readline().split()
            k, levels = int(header[0]), int(header[1])
            if len(header) >= 4 and (int(header[2]), int(header[3])) != (0, 0):
                raise ValueError(
                    f"unsupported DBoW vocabulary types in {path}: header "
                    f"{header[2:4]} — only L1_NORM scoring (0) with TF_IDF "
                    "weighting (0), the ORBvoc.txt configuration, is "
                    "implemented")
            body = f.read()
        # node ids: root = 0, line n creates node n; the parent field
        # references those ids directly. Bulk-parse: each node line is 35
        # numbers (parent is_leaf d0..d31 weight) — ORBvoc-scale files have
        # ~1M lines, a per-line Python loop takes ~12 s on this box.
        try:  # bulk text parse; np.fromstring(sep=' ') is the fast path but
            # is deprecated-for-removal — fall back if a future NumPy drops it
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", DeprecationWarning)
                flat = np.fromstring(body, dtype=np.float64, sep=" ")
        except (AttributeError, ValueError):
            flat = np.loadtxt(io.StringIO(body), dtype=np.float64).ravel()
        if flat.size % 35:
            raise ValueError(f"malformed DBoW text file {path}: "
                             f"{flat.size} values is not a multiple of 35")
        rows = flat.reshape(-1, 35)
        n = len(rows) + 1
        # validate the envelope LOUDLY (fuzzed in tests/test_bow_text.py):
        # a silently-wrapped descriptor byte or clipped parent id would
        # corrupt word assignment — and thereby loop topology — downstream
        if not np.isfinite(rows).all():
            raise ValueError(f"malformed DBoW text file {path}: "
                             "non-finite value in a node line")
        raw_parents = rows[:, 0]
        if ((raw_parents < 0) | (raw_parents >= n)
                | (raw_parents != np.floor(raw_parents))).any():
            raise ValueError(f"malformed DBoW text file {path}: parent id "
                             "outside [0, num_nodes) on some node line")
        raw_desc = rows[:, 2:34]
        if ((raw_desc < 0) | (raw_desc > 255)
                | (raw_desc != np.floor(raw_desc))).any():
            raise ValueError(f"malformed DBoW text file {path}: descriptor "
                             "byte outside [0, 255] on some node line")
        parents = np.zeros(n, np.int32)
        parents[1:] = raw_parents.astype(np.int32)
        is_leaf = np.zeros(n, bool)
        is_leaf[1:] = rows[:, 1] != 0
        descs = np.zeros((n, 32), np.uint8)
        descs[1:] = raw_desc.astype(np.uint8)
        weights = np.zeros(n, np.float32)
        weights[1:] = rows[:, 34].astype(np.float32)
        new = Vocabulary._from_tree(k, levels, parents, descs, weights, is_leaf)
        self.__dict__.update(new.__dict__)
        return self

    def save_dbow_text(self, path: str, scoring: int = 0, weighting: int = 0):
        """Write the DBoW2/DBoW3 plain-text vocabulary layout: header
        ``k L scoring weighting`` then one line per non-root node in node-id
        order: ``parent is_leaf d0..d31 weight``. Node/word-id conventions
        match DBoW's loadFromTextFile (line n creates node n, root = 0; word
        ids assigned in the order leaf lines appear), so a vocabulary
        round-tripped through this format preserves transform/score results
        bit-for-bit (reference consumer: vista_slam/loop_detector.py:6-7)."""
        n = len(self.node_word)
        parent = np.full(n, -1, np.int64)
        desc = np.zeros((n, 32), np.uint8)
        for p in range(n):
            for slot in range(self.k):
                c = self.child_idx[p, slot]
                if c >= 0:
                    parent[c] = p
                    desc[c] = self.child_desc[p, slot]
        with open(path, "w") as f:
            f.write(f"{self.k} {self.levels} {scoring} {weighting}\n")
            for node in range(1, n):
                is_leaf = int(self.node_word[node] >= 0)
                d = " ".join(str(int(x)) for x in desc[node])
                f.write(f"{parent[node]} {is_leaf} {d} "
                        f"{float(self.node_weight[node]):.9g}\n")

    def save_npz(self, path: str):
        np.savez_compressed(
            path, k=self.k, levels=self.levels, child_idx=self.child_idx,
            child_desc=self.child_desc, node_word=self.node_word,
            node_weight=self.node_weight, num_words=self.num_words)

    def load_npz(self, path: str) -> "Vocabulary":
        z = np.load(path)
        self.k = int(z["k"])
        self.levels = int(z["levels"])
        self.child_idx = z["child_idx"]
        self.child_desc = z["child_desc"]
        self.node_word = z["node_word"]
        self.node_weight = z["node_weight"]
        self.num_words = int(z["num_words"])
        self._finalize()
        return self


# ---------------------------------------------------------------------------
# training: hierarchical k-majority clustering of binary descriptors
# ---------------------------------------------------------------------------

def _kmajority(desc: np.ndarray, k: int, rng: np.random.Generator, iters: int = 8):
    """Cluster binary descriptors into <= k groups; returns (centroids, labels)."""
    m = len(desc)
    k = min(k, m)
    centroids = desc[rng.choice(m, size=k, replace=False)].copy()
    labels = np.full(m, -1, np.int64)  # -1: never equals a real assignment,
    # so the convergence check cannot fire before the first centroid update
    for _ in range(iters):
        dist = hamming(desc[:, None, :], centroids[None, :, :])
        new_labels = dist.argmin(axis=1)
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
        bits = np.unpackbits(desc, axis=1)  # [m, 256]
        for c in range(k):
            sel = labels == c
            if not sel.any():
                centroids[c] = desc[rng.integers(m)]
                continue
            maj = (bits[sel].mean(axis=0) >= 0.5).astype(np.uint8)
            centroids[c] = np.packbits(maj)
    return centroids, labels


def train_vocabulary(descriptors: np.ndarray, k: int = 10, levels: int = 3,
                     seed: int = 0, weighting: str = "tf_idf",
                     n_images: int | None = None,
                     image_ids: np.ndarray | None = None) -> Vocabulary:
    """Build a vocabulary tree from a descriptor corpus [M, 32] uint8.

    IDF weights need per-image statistics; pass image_ids [M] (which image
    each descriptor came from) for true IDF, otherwise uniform weights.
    """
    rng = np.random.default_rng(seed)
    parents = [0]
    descs = [np.zeros(32, np.uint8)]
    is_leaf = [False]
    node_members: list[np.ndarray | None] = [None]

    frontier = [(0, np.arange(len(descriptors)))]
    for level in range(levels):
        nxt = []
        for parent, idxs in frontier:
            if len(idxs) == 0:
                continue
            cents, labels = _kmajority(descriptors[idxs], k, rng)
            for c in range(len(cents)):
                members = idxs[labels == c]
                if len(members) == 0:
                    continue
                node = len(parents)
                parents.append(parent)
                descs.append(cents[c])
                leaf = level == levels - 1 or len(members) == 1
                is_leaf.append(leaf)
                node_members.append(members if leaf else None)
                if not leaf:
                    nxt.append((node, members))
        frontier = nxt

    weights = np.ones(len(parents), np.float32)
    weights[0] = 0.0  # root carries no weight (matches the text format)
    if weighting == "tf_idf" and image_ids is not None:
        n_img = n_images or (int(image_ids.max()) + 1)
        for node, members in enumerate(node_members):
            if members is not None and is_leaf[node]:
                ni = len(np.unique(image_ids[members]))
                weights[node] = np.log(max(n_img, 1) / max(ni, 1)) if ni else 0.0
        # DBoW keeps zero-idf words with tiny weight
        leaf_mask = np.asarray(is_leaf, bool)
        weights[leaf_mask & (weights <= 0)] = 1e-3

    return Vocabulary._from_tree(
        k, levels, np.asarray(parents, np.int32), np.stack(descs),
        weights, np.asarray(is_leaf, bool))
