"""The port's plain decode path: FrontendEngine.decode_pairs against the JAX
package's, and OnlineSLAM driven through a frontend without the fused
steps against the same OnlineSLAM on the fused ones."""

import numpy as np
import pytest
import torch

from chip_smoke import PlainFrontend  # the card check's wrapper, one copy
from vista_slam_tpu_torch.cli.common import build_frontend
from vista_slam_tpu_torch.slam.online_slam import OnlineSLAM
from vista_slam_tpu_torch.utils.config import make_config
from test_torch_slam import frames, trajectory
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

# 64x64, 16 tokens: plain attention on both sides
MODEL = dict(img_size=[64, 64], enc_dim=64, enc_depth=1, enc_heads=1, dec_dim=64,
             dec_depth=2, dec_heads=1, mlp_ratio=2)
CFG = dict(device="cpu", compute_dtype="float32", model=MODEL)
HOST_KEYS = ("pose_ij", "pose_conf_ij", "pose_ji", "pose_conf_ji", "mean_conf_i",
             "mean_conf_j", "K")


@pytest.fixture(scope="module")
def frontend():
    return build_frontend(make_config(CFG))


def test_decode_pairs_matches_jax(frontend):
    """3 pairs (bucket 4), the same weights and images: the JAX package's
    keys, bucket and dense layout; poses atol 2e-3, confidences and K within
    1e-3 relative; the fetched and the unfetched call agree exactly."""
    import jax.numpy as jnp

    from vista_slam_tpu.models.convert import convert_state_dict
    from vista_slam_tpu.models.sta import STAConfig as JSTAConfig
    from vista_slam_tpu.slam.frontend import FrontendEngine as JFrontend

    sd = {k: v.numpy() for k, v in frontend.model.state_dict().items()}
    jfe = JFrontend(JSTAConfig(compute_dtype=jnp.float32, **dict(MODEL, img_size=(64, 64))),
                    convert_state_dict(sd))
    seq = frames(4)
    feats = [frontend.encode(f["rgb"]) for f in seq]
    jfeats = [jfe.encode(f["rgb"]) for f in seq]
    pairs_i, pairs_j = [3, 3, 2], [2, 1, 0]

    fetches = frontend.fetch_count
    got = frontend.decode_pairs([feats[i] for i in pairs_i], [feats[j] for j in pairs_j])
    lazy = frontend.decode_pairs([feats[i] for i in pairs_i], [feats[j] for j in pairs_j],
                                 fetch=False)
    assert frontend.fetch_count == fetches + 1
    want = jfe.decode_pairs([jfeats[i] for i in pairs_i], [jfeats[j] for j in pairs_j])

    assert set(got) == set(lazy) == set(want)
    assert got["bucket"] == lazy["bucket"] == want["bucket"] == 4
    for k in HOST_KEYS:
        g, w = got[k], np.asarray(want[k])
        assert isinstance(g, np.ndarray) and isinstance(lazy[k], torch.Tensor)
        assert g.shape == w.shape == ((3, 4, 4) if "pose_ij" in k or "pose_ji" in k
                                      else (3, 3, 3) if k == "K" else (3,)), k
        assert np.isfinite(g).all() and np.isfinite(w).all(), k
        np.testing.assert_array_equal(lazy[k].numpy(), g, err_msg=k)
        tol = dict(atol=2e-3, rtol=0) if k.startswith("pose_") and "conf" not in k \
            else dict(atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(g, w, err_msg=k, **tol)
    for k in ("depth_dev", "conf_dev"):
        g, w = got[k], np.asarray(want[k])
        assert g.dtype == torch.float16 and g.shape == w.shape == (8, 64, 64)
        assert torch.isfinite(g).all() and np.isfinite(w).all()
        np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32),
                                   rtol=2e-3, atol=2e-3)
    assert np.allclose(frontend.pose_to_sim3(got["pose_ij"][0]),
                       jfe.pose_to_sim3(np.asarray(want["pose_ij"][0])), atol=2e-3)


def _run(slam, seq):
    for k, f in enumerate(seq):
        slam.step({"rgb": f["rgb"], "gray": f["gray"], "view_name": f["img_name"]},
                  force_pgo=k == len(seq) - 1)
    return slam


def test_online_slam_plain_path_matches_fused(frontend):
    """Six frames, every frame a keyframe, two neighbour edges each: the
    plain path (decode_pairs without fetch, store write, scale reductions,
    one fetch) gives the fused path's view graph and stored maps, and its
    trajectory within 1e-4 after the final PGO."""
    seq = frames(6)
    kw = dict(max_view_num=10, neighbor_edge_num=2, loop_edge_num=2, rel_pose_thres=-1.0)
    fused = _run(OnlineSLAM(frontend, **kw), seq)
    fetches = frontend.fetch_count
    plain = _run(OnlineSLAM(PlainFrontend(frontend), **kw), seq)
    assert frontend.fetch_count == fetches  # the plain path fetches in OnlineSLAM

    assert plain.view_num == fused.view_num == 6
    assert plain.get_view_graph() == fused.get_view_graph()
    n = fused.graph.num_nodes
    assert plain.graph.num_nodes == n
    np.testing.assert_array_equal(plain.pointmaps.depth[:n].numpy(),
                                  fused.pointmaps.depth[:n].numpy())
    np.testing.assert_array_equal(plain.pointmaps.intri[:n], fused.pointmaps.intri[:n])
    got, want = trajectory(plain), trajectory(fused)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
