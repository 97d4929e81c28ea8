"""The port's any-aspect model paths and head variants against the JAX
package: mixed_forward over landscape, portrait and mixed batches,
predict_pair_any_aspect on portrait pairs, predict_pair_mixed_aspect with
its portrait mask, the linear pointmap head, the 6D rotation, the bf16 DPT
head, and the .npz round trip from the port to the JAX package.

Weights are a seeded random JAX tree (the flax shapes, no init compile)
carried to the port by ``state_dict_from_jax``. Both sides run fp32 with
plain attention at these 24-token sizes. Bars as in
tests/test_torch_model.py: pts3d and pose atol 2e-3, conf rtol/atol 1e-3;
the bf16 head's are stated at its test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vista_slam_tpu.models import heads as jheads
from vista_slam_tpu.models.convert import load_params_npz as jload_params_npz
from vista_slam_tpu.models.sta import STA as JSTA
from vista_slam_tpu.models.sta import STAConfig as JSTAConfig
from vista_slam_tpu.models.sta import predict_pair_any_aspect as jany
from vista_slam_tpu.models.sta import param_count as jparam_count
from vista_slam_tpu.models.sta import predict_pair_mixed_aspect as jmixed
from vista_slam_tpu_torch.models import heads
from vista_slam_tpu_torch.models.convert import (convert_state_dict, flatten_params,
                                                 save_params_npz, state_dict_from_jax)
from vista_slam_tpu_torch.models.sta import (STA, STAConfig, param_count,
                                             predict_pair_any_aspect,
                                             predict_pair_mixed_aspect)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

# the 64x96 model of tests/test_any_aspect.py
ARCH = dict(img_size=(64, 96), patch_size=16, enc_dim=64, enc_depth=1, enc_heads=4,
            dec_dim=48, dec_depth=4, dec_heads=4, mlp_ratio=2)
TOL = {"pts3d": dict(atol=2e-3, rtol=0), "pose": dict(atol=2e-3, rtol=0),
       "conf": dict(atol=1e-3, rtol=1e-3), "pose_conf": dict(atol=1e-3, rtol=0)}


def random_tree(jcfg: JSTAConfig, seed: int) -> dict:
    """A seeded tree of the flax model's shapes (eval_shape: no compile):
    kernels N(0, 0.7^2 / fan_in), LayerNorm scales near 1, small biases, the
    strided upsamples' biases tied over their k*k taps as the reference
    layout holds them."""
    h, w = jcfg.img_size
    dummy = jnp.zeros((1, h, w, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JSTA(jcfg).init(jax.random.PRNGKey(0), dummy, dummy))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            v = 0.7 * rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            v = 1 + 0.1 * rng.standard_normal(s.shape)
        else:
            v = 0.05 * rng.standard_normal(s.shape)
        return v.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    if jcfg.head_type == "dpt":
        for name, k in (("act0_up", 4), ("act1_up", 2)):
            proj = tree["params"]["head_pts"][name]["proj"]
            proj["bias"] = np.tile(proj["bias"][: proj["bias"].size // (k * k)], k * k)
    return tree


def make_pair(**over):
    """(JAX model, tree, port model) for ARCH with ``over``, same weights."""
    jcfg = JSTAConfig(compute_dtype=jnp.float32, **ARCH, **over)
    tree = random_tree(jcfg, seed=0)
    model = STA(STAConfig(compute_dtype=torch.float32, **ARCH, **over)).eval()
    model.load_state_dict(state_dict_from_jax(tree))
    return JSTA(jcfg), tree, model


@pytest.fixture(scope="module")
def dpt(tmp_path_factory):
    """The DPT model of ARCH: the JAX model, its tree, the tree the JAX
    package's load_params_npz reads back from the port model's
    save_params_npz file (every JAX forward of this file runs on it), the
    port model and the two jitted JAX predictors."""
    jm, tree, model = make_pair()
    path = str(tmp_path_factory.mktemp("npz") / "port.npz")
    save_params_npz(path, model)
    loaded = jload_params_npz(path)
    any_aspect = jax.jit(lambda p, a, b: jany(jm, p, a, b))
    mixed = jax.jit(lambda p, a, b, t1, t2: jmixed(jm, p, a, b, t1, t2))
    return jm, tree, loaded, model, any_aspect, mixed


def _imgs(seed, b, h, w):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (b, h, w, 3)).astype(np.float32) for _ in range(2)]


def _check(got: dict, want: dict, keys=TOL, tol=None):
    for k in keys:
        g = got[k].detach().numpy()
        wv = np.asarray(want[k])
        assert g.shape == wv.shape, (k, g.shape, wv.shape)
        assert np.isfinite(g).all() and np.isfinite(wv).all(), k
        np.testing.assert_allclose(g, wv, err_msg=k, **(tol or TOL)[k])


@pytest.mark.parametrize("kind", ["landscape", "portrait", "mixed"])
def test_mixed_aspect_batches_match_jax(dpt, kind):
    """predict_pair_mixed_aspect (mixed_forward and the portrait mask) on a
    batch of 2 pairs in the 64x96 landscape buffer: all landscape, all
    portrait (96x64 stored transposed), and mixed within and across pairs."""
    _, _, loaded, model, _, jmix = dpt
    img1, img2 = _imgs(1, 2, 64, 96)
    land, port = [64, 96], [96, 64]
    ts1, ts2 = {"landscape": ([land, land], [land, land]),
                "portrait": ([port, port], [port, port]),
                "mixed": ([land, port], [port, port])}[kind]
    want = jax.device_get(jmix(loaded, img1, img2, np.asarray(ts1), np.asarray(ts2)))
    with torch.no_grad():
        got = predict_pair_mixed_aspect(model, torch.from_numpy(img1), torch.from_numpy(img2),
                                        ts1, ts2)
    _check(got, want)
    np.testing.assert_array_equal(got["portrait_mask"].numpy(), np.asarray(want["portrait_mask"]))
    assert got["portrait_mask"].tolist() == [t[0] > t[1] for t in ts1 + ts2]


def test_mixed_forward_all_landscape_equals_forward(dpt):
    model = dpt[3]
    img1, img2 = (torch.from_numpy(x) for x in _imgs(2, 2, 64, 96))
    mask = torch.zeros(2, dtype=torch.bool)
    with torch.no_grad():
        plain, mixed = model(img1, img2), model.mixed_forward(img1, img2, mask, mask)
    for k in TOL:
        torch.testing.assert_close(mixed[k], plain[k], atol=1e-5, rtol=0)


def test_predict_pair_any_aspect_portrait_matches_jax(dpt):
    _, _, loaded, model, jany_jit, _ = dpt
    img1, img2 = _imgs(3, 1, 96, 64)
    want = jax.device_get(jany_jit(loaded, img1, img2))
    with torch.no_grad():
        got = predict_pair_any_aspect(model, torch.from_numpy(img1), torch.from_numpy(img2))
    assert got["pts3d"].shape == (2, 96, 64, 3) and got["conf"].shape == (2, 96, 64)
    _check(got, want)


def test_npz_round_trip_into_the_jax_package(dpt):
    """A port model written by save_params_npz is read by the JAX package's
    load_params_npz (in the fixture): the same tree as the one the port was
    loaded from. The JAX forwards of the tests above run on it and give
    the port's outputs."""
    _, tree, loaded, model, _, _ = dpt
    flat, want_flat = flatten_params(loaded), flatten_params(tree)
    # the reference layout's unused skip unit of the deepest fusion block
    # rides along (zeros), as the JAX package's own conversion keeps it
    extra = set(flat) - set(want_flat)
    assert extra and all("refinenet4/res_conv_unit1" in k for k in extra)
    assert not any(flat[k].any() for k in extra)
    for k, v in want_flat.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    # the JAX tree holds each strided upsample's bias once per tap (act0: 4x4
    # taps of 96 channels, act1: 2x2 of 192), the port once
    assert param_count(model) == (jparam_count(tree) + sum(flat[k].size for k in extra)
                                  - 15 * 96 - 3 * 192)


def test_linear_head_matches_jax():
    """head_type 'linear': the reference's downstream_head_pts.proj, carried
    from the JAX package's head_pts/proj (its columns permuted to
    pixel_shuffle's order), on a mixed-aspect batch; and back to the JAX
    tree unchanged."""
    jm, tree, model = make_pair(head_type="linear")
    assert set(k for k in model.state_dict() if "head_pts" in k) == {
        "downstream_head_pts.proj.weight", "downstream_head_pts.proj.bias"}
    flat, back = flatten_params(tree), flatten_params(convert_state_dict(model.state_dict()))
    assert set(flat) == set(back)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    img1, img2 = _imgs(5, 2, 64, 96)
    ts = np.asarray([[64, 96], [96, 64]])
    want = jax.device_get(jax.jit(lambda p, a, b: jmixed(jm, p, a, b, ts, ts))(tree, img1, img2))
    with torch.no_grad():
        got = predict_pair_mixed_aspect(model, torch.from_numpy(img1), torch.from_numpy(img2),
                                        ts, ts)
    _check(got, want)


def test_rotation_6d_and_pose_head_match_jax():
    rng = np.random.default_rng(6)
    d6 = rng.standard_normal((64, 6)).astype(np.float32)
    R = heads.rotation_6d_to_matrix(torch.from_numpy(d6))
    want = jheads.rotation_6d_to_matrix(jnp.asarray(d6))
    np.testing.assert_allclose(R.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    eye = np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(R.numpy() @ R.transpose(1, 2).numpy(),
                               np.broadcast_to(eye, R.shape), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(R.numpy()), 1.0, atol=1e-5)

    # the head: the JAX init (zero kernel, identity bias) gives R = I; then a
    # random fc_rot through both
    tok = rng.standard_normal((5, 48)).astype(np.float32)
    jhead = jheads.PoseHead(rot_representation="6D")
    jp = jax.device_get(jhead.init(jax.random.PRNGKey(0), jnp.asarray(tok)))
    assert (np.asarray(jp["params"]["fc_rot"]["kernel"]) == 0).all()
    head = heads.PoseHead(48, rot_representation="6D")
    head.reset_rotation_()
    np.testing.assert_array_equal(head.fc_rot.bias.detach().numpy(),
                                  np.asarray(jp["params"]["fc_rot"]["bias"]))
    jp["params"]["fc_rot"]["kernel"] = (0.1 * rng.standard_normal((512, 6))).astype(np.float32)
    sd = {}
    for dst, src in (("mlp.0", "mlp0"), ("mlp.2", "mlp1"), ("mlp.4", "mlp2"),
                     ("fc_t", "fc_t"), ("fc_rot", "fc_rot"), ("fc_conf.0", "fc_conf")):
        sd[f"{dst}.weight"] = torch.tensor(np.asarray(jp["params"][src]["kernel"]).T)
        sd[f"{dst}.bias"] = torch.tensor(np.asarray(jp["params"][src]["bias"]))
    head.load_state_dict(sd)
    want = jax.device_get(jhead.apply(jp, jnp.asarray(tok)))
    with torch.no_grad():
        got = head(torch.from_numpy(tok))
    _check(got, {"pose": want["pose"], "pose_conf": want["conf"]}, keys=("pose",))
    np.testing.assert_allclose(got["conf"].numpy(), want["conf"], atol=1e-5)
    assert not np.allclose(got["pose"][:, :3, :3].numpy(), eye, atol=1e-3)


def test_bf16_head_matches_jax_head_bf16(dpt):
    """head_bf16: the DPT conv pyramid in bf16 over fp32 parameters, fp32
    out, against the JAX package's head_bf16=True on the same weights and
    inputs. bf16 rounding in both pyramids, done in different orders
    (cuDNN-style fp32 accumulation here, XLA's there), is the bar: pts3d
    atol 3e-2 with rtol 3e-2 and conf rtol 3e-2; poses do not pass
    through the head (atol 2e-3). The bf16 head must also differ from the
    fp32 head by more than the fp32 bar (it ran in bf16) and agree with it
    within the same loose bar."""
    _, tree, _, fp32_model, _, _ = dpt  # the fp32 model's weights, as JAX's tree holds them
    jm = JSTA(JSTAConfig(compute_dtype=jnp.float32, head_bf16=True, **ARCH))
    model = STA(STAConfig(compute_dtype=torch.float32, head_bf16=True, **ARCH)).eval()
    model.load_state_dict(fp32_model.state_dict())
    assert model.downstream_head_pts.dpt.dtype == torch.bfloat16
    img1, img2 = _imgs(7, 2, 64, 96)
    want = jax.device_get(jax.jit(lambda p, a, b: jm.apply(p, a, b))(tree, img1, img2))
    with torch.no_grad():
        got = model(torch.from_numpy(img1), torch.from_numpy(img2))
        fp32 = fp32_model(torch.from_numpy(img1), torch.from_numpy(img2))
    bf16_tol = {"pts3d": dict(atol=3e-2, rtol=3e-2), "conf": dict(atol=1e-3, rtol=3e-2),
                "pose": TOL["pose"], "pose_conf": TOL["pose_conf"]}
    assert got["pts3d"].dtype == torch.float32
    _check(got, want, tol=bf16_tol)
    gap = (got["pts3d"] - fp32["pts3d"]).abs().max().item()
    assert 2e-3 < gap, gap
    _check(got, {k: v.numpy() for k, v in fp32.items()}, tol=bf16_tol)
