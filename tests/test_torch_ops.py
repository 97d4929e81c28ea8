"""Per-function parity of the PyTorch port's ops against the JAX package
(fp32, atol 1e-5). Inputs come from numpy and go to both sides."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vista_slam_tpu.ops import linalg as jlinalg
from vista_slam_tpu.ops import rope2d as jrope
from vista_slam_tpu.ops import sim3 as jsim3
from vista_slam_tpu.utils import geometry as jgeom
from vista_slam_tpu.utils import image_ops as jimg
from vista_slam_tpu_torch.ops import linalg, rope2d, sim3
from vista_slam_tpu_torch.utils import geometry, image_ops
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


ATOL = 1e-5


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("n_h,n_w,hd,n_special", [(4, 6, 64, 0), (3, 5, 64, 1),
                                                  (24, 32, 64, 1)])
def test_rope2d_tables_and_apply(n_h, n_w, hd, n_special):
    cos, sin = rope2d.rope2d_tables(n_h, n_w, hd, 100.0, n_special)
    jcos, jsin = jrope.rope2d_tables(n_h, n_w, hd, 100.0, n_special)
    _close(cos, jcos, 0)
    _close(sin, jsin, 0)
    x = np.random.default_rng(0).standard_normal(
        (2, 3, n_special + n_h * n_w, hd)).astype(np.float32)
    _close(rope2d.apply_rope2d(torch.from_numpy(x), cos, sin),
           jrope.apply_rope2d(jnp.asarray(x), jcos, jsin))


@pytest.mark.parametrize("hw,out_hw", [((6, 8), (12, 16)), ((5, 7), (64, 48)),
                                       ((3, 4), (3, 4))])
def test_resize_bilinear_align_corners(hw, out_hw):
    x = np.random.default_rng(1).standard_normal((2,) + hw + (5,)).astype(np.float32)
    _close(image_ops.resize_bilinear(torch.from_numpy(x), out_hw),
           jimg.resize_bilinear(jnp.asarray(x), out_hw, align_corners=True))
    _close(image_ops.pixel_grid(*hw), jimg.pixel_grid(*hw))


def _well_conditioned(rng, n, d):
    return (np.eye(d) + 0.3 * rng.standard_normal((n, d, d))).astype(np.float32)


def test_small_linalg():
    rng = np.random.default_rng(2)
    a3 = _well_conditioned(rng, 64, 3)
    b3 = rng.standard_normal((64, 3)).astype(np.float32)
    _close(linalg.adjugate_inv3(torch.from_numpy(a3)), jlinalg.adjugate_inv3(jnp.asarray(a3)))
    _close(linalg.cramer_solve3(torch.from_numpy(a3), torch.from_numpy(b3)),
           jlinalg.cramer_solve3(jnp.asarray(a3), jnp.asarray(b3)))
    m = rng.standard_normal((32, 7, 7)).astype(np.float32)
    spd = (m @ m.transpose(0, 2, 1) + 7 * np.eye(7)).astype(np.float32)
    _close(linalg.gauss_jordan_inv(torch.from_numpy(spd)),
           jlinalg.gauss_jordan_inv(jnp.asarray(spd)))


def test_estimate_intrinsics_shared():
    rng = np.random.default_rng(3)
    h, w, f = 8, 10, 1.5
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    z = rng.uniform(1.0, 3.0, (3, 2, h, w))
    pts = np.stack([(xs - w / 2) * z / f, (ys - h / 2) * z / (f + 0.2), z], -1)
    pts = (pts + 0.01 * rng.standard_normal(pts.shape)).astype(np.float32)
    conf = rng.uniform(1.0, 3.0, (3, 2, h, w)).astype(np.float32)
    pts[0, 0, 0, 0, 2] = 0.0  # a zero depth: the guarded division drops it
    got = geometry.estimate_intrinsics_shared(torch.from_numpy(pts), torch.from_numpy(conf))
    for s in range(3):  # the port batches independent view sets
        _close(got[s], jgeom.estimate_intrinsics_shared(jnp.asarray(pts[s]),
                                                        jnp.asarray(conf[s])))


def _xi(rng, n, rot=0.5, trans=1.0, sig=0.3):
    return np.concatenate([trans * rng.standard_normal((n, 3)),
                           rot * rng.standard_normal((n, 3)),
                           sig * rng.standard_normal((n, 1))], -1).astype(np.float32)


def _sim3_cases():
    rng = np.random.default_rng(4)
    axis = rng.standard_normal((8, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    near_pi = np.concatenate([rng.standard_normal((8, 3)), np.pi * axis,
                              0.2 * rng.standard_normal((8, 1))], -1)
    return {
        "generic": _xi(rng, 64),
        "near_zero": _xi(rng, 16, rot=1e-6, trans=1e-6, sig=1e-7),
        "small_rot_big_scale": _xi(rng, 16, rot=1e-3, sig=1.0),
        "near_pi": near_pi.astype(np.float32),
    }


@pytest.mark.parametrize("case", ["generic", "near_zero", "small_rot_big_scale", "near_pi"])
def test_sim3_exp_log(case):
    xi = _sim3_cases()[case]
    g = jsim3.exp(jnp.asarray(xi))
    _close(sim3.exp(torch.from_numpy(xi)), g)
    g = np.array(g)  # the same group elements go into both logs
    _close(sim3.log(torch.from_numpy(g)), jsim3.log(jnp.asarray(g)))


def test_sim3_mul_inv_from_matrix():
    rng = np.random.default_rng(5)
    a = np.asarray(jsim3.exp(jnp.asarray(_xi(rng, 32))))
    b = np.asarray(jsim3.exp(jnp.asarray(_xi(rng, 32))))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _close(sim3.mul(ta, tb), jsim3.mul(jnp.asarray(a), jnp.asarray(b)))
    _close(sim3.inv(ta), jsim3.inv(jnp.asarray(a)))
    _close(sim3.retract(ta, torch.from_numpy(_xi(rng, 32))[:, :7] * 0),
           jsim3.normalize(jnp.asarray(a)))
    m = np.asarray(jsim3.to_pose_matrix(jnp.asarray(a)))
    _close(sim3.from_matrix(torch.from_numpy(m), 2.0),
           jsim3.from_matrix(jnp.asarray(m), 2.0))
