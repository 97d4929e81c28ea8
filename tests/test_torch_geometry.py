"""The port's remaining Sim(3), geometry and consistency functions and its
profiling helpers against the JAX package, fp32. Inputs come from numpy
and go to both sides; values must be finite on both before they are held
close (atol 1e-5, 1e-4 where a chain of fp32 products feeds the value)."""

import json
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vista_slam_tpu.ops import sim3 as jsim3
from vista_slam_tpu.utils import consistency as jcons
from vista_slam_tpu.utils import geometry as jgeom
from vista_slam_tpu.utils import profiling as jprof
from vista_slam_tpu_torch.ops import sim3
from vista_slam_tpu_torch.utils import consistency, geometry, profiling
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _close(got, want, atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _sim3_batch(rng, n=16):
    t = rng.standard_normal((n, 3))
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s = np.exp(0.3 * rng.standard_normal(n))
    return np.concatenate([t, q, s[:, None]], -1).astype(np.float32)


def _rot(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.array(jsim3.quat_to_matrix(jnp.asarray(q, jnp.float32)))


def test_sim3_constructors_and_matrices_match_jax():
    rng = np.random.default_rng(0)
    g = _sim3_batch(rng)
    _close(sim3.identity((2, 3)), jsim3.identity((2, 3)), 0)
    _close(sim3.quat_identity((4,)), jsim3.quat_identity((4,)), 0)
    t, q, s = g[:, :3], g[:, 3:7], g[:, 7]
    for s_in in (s, s[:, None]):  # scale as [...] or [..., 1]
        _close(sim3.make(torch.from_numpy(t), torch.from_numpy(q), torch.from_numpy(s_in)),
               jsim3.make(jnp.asarray(t), jnp.asarray(q), jnp.asarray(s_in)), 0)
    pts = rng.standard_normal((16, 3)).astype(np.float32)
    _close(sim3.act(torch.from_numpy(g), torch.from_numpy(pts)),
           jsim3.act(jnp.asarray(g), jnp.asarray(pts)))
    for name in ("to_matrix", "to_pose_matrix"):
        _close(getattr(sim3, name)(torch.from_numpy(g)), getattr(jsim3, name)(jnp.asarray(g)))
    R, tv = _rot(rng, 5), rng.standard_normal((5, 3)).astype(np.float32)
    _close(sim3._rt_to_mat44(torch.from_numpy(R), torch.from_numpy(tv)),
           jsim3._rt_to_mat44(jnp.asarray(R), jnp.asarray(tv)), 0)
    m = np.array(jsim3._rt_to_mat44(jnp.asarray(R), jnp.asarray(tv)))
    _close(sim3.se3_from_matrix(torch.from_numpy(m)), jsim3.se3_from_matrix(jnp.asarray(m)))
    # to_matrix inverts from_matrix at scale 1
    _close(sim3.to_matrix(sim3.se3_from_matrix(torch.from_numpy(m))), m)


def _pointmaps(rng, b=3, h=12, w=16):
    K = np.array([[14.0, 0, w / 2], [0, 13.0, h / 2], [0, 0, 1]], np.float32)
    depth = (1.0 + rng.random((b, h, w))).astype(np.float32)
    pts = np.asarray(jgeom.depth_to_pointcloud(jnp.asarray(depth), jnp.asarray(K)))
    pts = pts + 0.01 * rng.standard_normal(pts.shape).astype(np.float32)
    conf = (1.0 + rng.random((b, h, w))).astype(np.float32)
    return K, depth, pts.astype(np.float32), conf


def test_intrinsics_and_depth_conversions_match_jax():
    rng = np.random.default_rng(1)
    K, depth, pts, conf = _pointmaps(rng)
    Kb = np.stack([K * [[1 + 0.1 * i], [1], [1]] for i in range(3)]).astype(np.float32)
    Kb[:, 2] = [0, 0, 1]
    _close(geometry.estimate_intrinsics_batched(torch.from_numpy(pts), torch.from_numpy(conf)),
           jgeom.estimate_intrinsics_batched(jnp.asarray(pts), jnp.asarray(conf)), 1e-4)
    for k in (K, Kb):  # shared [3,3] and per-view [N,3,3]
        _close(geometry._pixel_rays(torch.from_numpy(k), 3, 12, 16, torch.float32),
               jgeom._pixel_rays(jnp.asarray(k), 3, 12, 16, jnp.float32))
        _close(geometry.depth_to_pointcloud(torch.from_numpy(depth), torch.from_numpy(k)),
               jgeom.depth_to_pointcloud(jnp.asarray(depth), jnp.asarray(k)))
        _close(geometry.depth_from_pointcloud(torch.from_numpy(pts), torch.from_numpy(k)),
               jgeom.depth_from_pointcloud(jnp.asarray(pts), jnp.asarray(k)))
    # ray-length depth, not z-depth: larger than z away from the centre
    ray = geometry.depth_from_pointcloud(torch.from_numpy(pts), torch.from_numpy(K))
    assert (ray.numpy()[:, 0, 0] > pts[:, 0, 0, 2]).all()


def test_estimate_scale_matches_jax():
    rng = np.random.default_rng(2)
    d_i = (1 + rng.random((12, 16))).astype(np.float32)
    d_j = (2.5 * d_i + 0.01 * rng.standard_normal(d_i.shape)).astype(np.float32)
    c_i, c_j = (1 + rng.random((2, 12, 16))).astype(np.float32)
    args = [d_i, d_j, c_i, c_j]
    want = jgeom.estimate_scale(*map(jnp.asarray, args))
    _close(geometry.estimate_scale(*map(torch.from_numpy, args)), want, 1e-4)
    got_np = geometry.estimate_scale_np(*args)
    assert got_np == jgeom.estimate_scale_np(*args)
    assert abs(got_np - 2.5) < 1e-2


def _two_views(rng, h=12, w=16):
    K = np.array([[14.0, 0, w / 2], [0, 13.0, h / 2], [0, 0, 1]], np.float32)
    depths = (2.0 + 0.2 * rng.random((2, h, w))).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.02), np.sin(0.02)
    T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    T[:3, 3] = [0.05, -0.02, 0.01]
    return K, depths, T


def test_symmetric_geo_valid_mask_matches_jax():
    rng = np.random.default_rng(3)
    K, depths, T = _two_views(rng)
    got = consistency.symmetric_geo_valid_mask(*map(torch.from_numpy, (depths, K, T)))
    want = jax.jit(jcons.symmetric_geo_valid_mask)(*map(jnp.asarray, (depths, K, T)))
    assert got.dtype == torch.bool and got.shape == (2, 12, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < got.numel()


def test_view_consistency_count_matches_jax():
    rng = np.random.default_rng(4)
    N, h, w = 6, 10, 12
    K = np.array([[12.0, 0, w / 2], [0, 12.0, h / 2], [0, 0, 1]], np.float32)
    Ks = np.repeat(K[None], N, 0)
    poses = np.repeat(np.eye(4, dtype=np.float32)[None], N, 0)
    poses[:, 0, 3] = 0.01 * np.arange(N)
    depths = (2.0 + 0.01 * rng.standard_normal((N, h, w))).astype(np.float32)
    for window in (1, 4):  # 4 clips at both ends of the 6 views
        got = consistency.view_consistency_count(*map(torch.from_numpy, (depths, Ks, poses)),
                                                 threshold=0.05, window=window)
        want = jax.jit(jcons.view_consistency_count, static_argnames="window")(
            *map(jnp.asarray, (depths, Ks, poses)), threshold=0.05, window=window)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.max() > 0


def test_stage_timer_and_trace_helpers(tmp_path):
    """StageTimer keeps the JAX package's schema; trace_range and
    profile_to write a Chrome trace that holds the named range."""
    for mod in (profiling, jprof):
        timer = mod.StageTimer("encoder", "decoder")
        with timer("encoder"):
            time.sleep(0.01)
        with timer("pgo"):
            pass
        s = timer.summary()
        assert set(s) == {"encoder", "decoder", "pgo", "total"}
        assert s["encoder"] >= 0.01 and s["decoder"] == 0.0
        assert s["total"] == pytest.approx(s["encoder"] + s["pgo"])
    with profiling.profile_to(str(tmp_path / "trace")) as prof:
        with profiling.trace_range("vista_range"):
            torch.ones(8) @ torch.ones(8)
    assert prof.trace_path == os.path.join(str(tmp_path / "trace"), "trace.json")
    names = {e.get("name") for e in json.load(open(prof.trace_path))["traceEvents"]}
    assert "vista_range" in names
