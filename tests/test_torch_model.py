"""The PyTorch port's STA model and weight conversion against the JAX package.

Weights are drawn with numpy in the reference state-dict layout (the port's
``state_dict`` layout), go to the port directly and to JAX through
vista_slam_tpu/models/convert.py::convert_state_dict. The JAX forward runs
its Pallas flash kernel in interpret mode. Bars as in
tests/test_reference_parity.py: pts3d and pose atol 2e-3, conf rtol/atol 1e-3.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vista_slam_tpu.models.convert import convert_state_dict, flatten_params
from vista_slam_tpu.models.heads import svd_orthogonalize as jsvd_orth
from vista_slam_tpu.models.heads import svd_orthogonalize_stable as jsvd_stable
from vista_slam_tpu.models.sta import STA as JSTA
from vista_slam_tpu.models.sta import STAConfig as JSTAConfig
from vista_slam_tpu_torch.models.convert import state_dict_from_jax
from vista_slam_tpu_torch.models.heads import (PoseHead, svd_orthogonalize,
                                               svd_orthogonalize_stable)
from vista_slam_tpu_torch.models.sta import STA, STAConfig
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


TINY = dict(img_size=(64, 64), enc_dim=64, enc_depth=2, enc_heads=1,
            dec_dim=128, dec_depth=4, dec_heads=2, mlp_ratio=2, use_flash=True)


def random_state_dict(model: torch.nn.Module, rng, gain: float = 0.7) -> dict:
    """Reference-layout weights: scaled-normal kernels (gain 0.7 keeps the
    heads' outputs O(1)), LayerNorm scales near 1, small random biases."""
    sd = {}
    for k, v in model.state_dict().items():
        owner = model.get_submodule(k.rsplit(".", 1)[0]) if "." in k else None
        if v.dim() > 1 and k != "init_pose_token":
            fan = v.shape[0] if isinstance(owner, torch.nn.ConvTranspose2d) else v[0].numel()
            sd[k] = gain * rng.standard_normal(v.shape) / np.sqrt(fan)
        elif isinstance(owner, torch.nn.LayerNorm) and k.endswith("weight"):
            sd[k] = 1 + 0.1 * rng.standard_normal(v.shape)
        else:
            sd[k] = 0.05 * rng.standard_normal(v.shape)
    return {k: v.astype(np.float32) for k, v in sd.items()}


def _finite_close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, **tol)


@pytest.fixture(scope="module")
def tiny_pair():
    model = STA(STAConfig(compute_dtype=torch.float32, **TINY)).eval()
    rng = np.random.default_rng(0)
    sd = random_state_dict(model, rng)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model, sd, rng


def test_state_dict_from_jax_round_trips_convert_state_dict(tiny_pair):
    model, sd, _ = tiny_pair
    params = convert_state_dict(sd)
    back = state_dict_from_jax(params)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k], err_msg=k)
    again = flatten_params(convert_state_dict({k: v.numpy() for k, v in back.items()}))
    flat = flatten_params(params)
    assert set(again) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(again[k], flat[k], err_msg=k)


def test_state_dict_covers_a_jax_initialised_tree():
    """Every leaf of a flax-initialised tree maps into the port (shapes via
    eval_shape, no compile); the deepest DPT fusion block's unused skip unit,
    absent from a flax tree, comes back as zeros."""
    cfg = JSTAConfig(compute_dtype=jnp.float32, **TINY)
    dummy = jnp.zeros((1, 64, 64, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: JSTA(cfg).init(jax.random.PRNGKey(0), dummy, dummy))
    rng = np.random.default_rng(1)
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    # the reference layout ties a strided upsample's bias across its k*k taps
    for name, k in (("act0_up", 4), ("act1_up", 2)):
        proj = tree["params"]["head_pts"][name]["proj"]
        proj["bias"] = np.tile(proj["bias"][: proj["bias"].size // (k * k)], k * k)
    sd = state_dict_from_jax(tree)
    model = STA(STAConfig(compute_dtype=torch.float32, **TINY))
    model.load_state_dict(sd, strict=True)
    assert not sd["downstream_head_pts.dpt.scratch.refinenet4.resConfUnit1.conv1.weight"].any()
    back = flatten_params(convert_state_dict({k: v.numpy() for k, v in sd.items()}))
    for k, v in flatten_params(tree).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_sta_forward_matches_jax(tiny_pair):
    from jax.experimental.pallas import tpu as pltpu

    model, sd, rng = tiny_pair
    img1 = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    img2 = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jm = JSTA(JSTAConfig(compute_dtype=jnp.float32, **TINY))
    params = convert_state_dict(sd)

    def jax_fwd(p, a, b):
        f1 = jm.apply(p, a, method=JSTA.encode)
        f2 = jm.apply(p, b, method=JSTA.encode)
        return f1, jm.apply(p, f1, f2, method=JSTA.decode_and_heads)

    with pltpu.force_tpu_interpret_mode():
        jf1, jout = jax.device_get(jax.jit(jax_fwd)(params, img1, img2))
    with torch.no_grad():
        f1 = model.encode(torch.from_numpy(img1))
        f2 = model.encode(torch.from_numpy(img2))
        out = model.decode_and_heads(f1, f2)
    _finite_close(f1, jf1, atol=1e-4, rtol=1e-4)
    _finite_close(out["pts3d"], jout["pts3d"], atol=2e-3)
    _finite_close(out["conf"], jout["conf"], rtol=1e-3, atol=1e-3)
    _finite_close(out["pose"], jout["pose"], atol=2e-3)
    _finite_close(out["pose_conf"], jout["pose_conf"], atol=1e-3)


def test_pose_head_rotations_match_jax_and_newton_variant():
    rng = np.random.default_rng(2)
    m = rng.standard_normal((64, 9)).astype(np.float32)
    _finite_close(svd_orthogonalize(torch.from_numpy(m)), jsvd_orth(jnp.asarray(m)), atol=1e-5)
    _finite_close(svd_orthogonalize_stable(torch.from_numpy(m)),
                  jsvd_stable(jnp.asarray(m)), atol=1e-5)
    # near a rotation (well conditioned, equal row norms) 9D_stable == 9D
    phi = rng.standard_normal((64, 3))
    rots = np.stack([_rodrigues(p) for p in phi])
    noisy = torch.from_numpy((rots + 0.01 * rng.standard_normal(rots.shape)).astype(np.float32))
    _finite_close(svd_orthogonalize_stable(noisy), svd_orthogonalize(noisy).numpy(), atol=5e-3)


def _rodrigues(phi):
    th = np.linalg.norm(phi)
    k = phi / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def test_pose_head_init_is_near_identity():
    """The zero-kernel / sheared-bias fc_rot init puts R a few degrees from
    the identity, for both rotation representations, which agree there."""
    model = STA(STAConfig(compute_dtype=torch.float32, **TINY))
    model.init_weights_(torch.Generator().manual_seed(0))
    stable = PoseHead(TINY["dec_dim"], rot_representation="9D_stable")
    stable.load_state_dict(model.head_pose_s.state_dict())
    tok = torch.randn(4, TINY["dec_dim"], generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        out, out_stable = model.head_pose_s(tok), stable(tok)
    R = out["pose"][:, :3, :3]
    angle = torch.arccos(((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2).clamp(-1, 1))
    assert torch.isfinite(R).all()
    assert (angle > 1e-3).all() and (angle < np.deg2rad(10)).all()
    _finite_close(out_stable["pose"], out["pose"].numpy(), atol=5e-3)
    _finite_close(out_stable["conf"], out["conf"].numpy(), atol=0)


def test_bf16_forward_tracks_fp32(tiny_pair):
    """compute_dtype=bfloat16 keeps LayerNorm, softmax and heads in fp32:
    its output stays within bf16 rounding of the fp32 model."""
    _, sd, rng = tiny_pair
    img = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))
    outs = {}
    for dt in (torch.float32, torch.bfloat16):
        m = STA(STAConfig(compute_dtype=dt, **TINY)).eval()
        m.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        assert m.enc_blocks[0].attn.qkv.weight.dtype == dt
        assert m.enc_blocks[0].norm1.weight.dtype == torch.float32
        with torch.no_grad():
            outs[dt] = m(img, img.flip(0))
    for k in ("pts3d", "conf"):
        a, b = outs[torch.bfloat16][k], outs[torch.float32][k]
        assert a.dtype == torch.float32 and torch.isfinite(a).all()
        assert ((a - b).abs().max() / b.abs().max()) < 5e-2
