"""The port's int8-moment optimizers against the JAX package's, on the CPU.

K4's plain version (kernels/adamw.py::fused_adamw_int8_plain) against the
JAX package's Pallas kernel (ops/pallas/adam8.py::fused_adamw_int8,
``interpret=True``) on single leaves; K4's multi-leaf entry on the CPU
against the plain version leaf by leaf, and the layout descriptors K4
addresses each leaf by (kernels/adamw.py::int8_layout) against the views'
own flatten; the ``int8_fused`` optimizer over 3
steps on a tree whose leaves have torch layouts other than their JAX ones
(its blocks must follow the JAX layout); the ``bf16`` and ``int8``
carriers against the JAX package's ``adamw_q`` chain; and the JAX-layout
view of every parameter of a tiny STA (models/convert.py::jax_layouts).
Inputs are made with numpy from a seed and handed to both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vista_slam_tpu_torch.kernels import adamw
from vista_slam_tpu_torch.train import step
from vista_slam_tpu_torch.train.quantized_opt import ChainAdamW, FusedInt8Leaf, QMoment
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

HP = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.05)
# share of int8 codes allowed one step apart: XLA's and torch's exp/log on
# the CPU differ in the last ulp, so a code whose real value sits within an
# ulp of a half-integer can round the other way
CODE_FRACTION = 1e-3


def _finite(*arrays):
    for a in arrays:
        assert np.isfinite(np.asarray(a, np.float64)).all()


def _codes_close(got, want, what):
    """int8 codes equal, but for at most CODE_FRACTION of them one apart;
    returns the mask of those that differ."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max(initial=0) <= 1, what
    assert (d > 0).mean() <= CODE_FRACTION, (what, (d > 0).mean())
    return d > 0


def _scales_close(got, want, what, rtol=1e-6):
    """fp32 scales within 1e-6 relative: a row maximum of moments whose
    last bits differ (FMA contraction on the XLA side) is itself an ulp or
    two apart. Through a whole optimizer step the clip coefficient joins in:
    it comes from a global norm that the two sides sum in other orders (a
    few 1e-7 apart), mu scales with it and nu with its square, so there the
    bar is 1e-5."""
    _finite(got, want)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=0,
                               err_msg=what)


def _p_close(got, want, what):
    """p within 1e-6 relative plus 1e-6 absolute: the two sides contract
    products into FMAs at other points (XLA on the CPU does, the plain
    version does not), so the moments differ in their last bits, and with
    them u (|u| < 10 here) and the update lr * u (lr <= 1e-2) by ~1e-7;
    1e-6 relative is a few ulps of p itself."""
    _finite(got, want)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=what)


@pytest.mark.parametrize("rows", [8, 256])
def test_int8_leaf_matches_jax_kernel(rows):
    """One step of K4's plain version against the JAX kernel from random
    codes and scales (nu codes 0 included): a ragged leaf of 8 rows (the
    JAX kernel's grid step takes 256) and one of 256 rows."""
    from vista_slam_tpu.ops.pallas.adam8 import fused_adamw_int8 as jax_int8

    rng = np.random.default_rng(rows)
    n = rows * adamw.QBLOCK
    p = rng.standard_normal(n).astype(np.float32)
    g = (rng.standard_normal(n) * np.exp(rng.uniform(-4, 1, n))).astype(np.float32)
    mu_q = rng.integers(-127, 128, (rows, 1024)).astype(np.int8)
    mu_s = (rng.uniform(0.1, 1, (rows, 1)) * 1e-2 / 127).astype(np.float32)
    nu_q = rng.integers(0, 128, (rows, 1024)).astype(np.int8)
    nu_s = (rng.uniform(0.1, 1, (rows, 1)) * 1e-3).astype(np.float32)
    scalars = np.array([0.7, 1e-2, 1 - 0.9 ** 3, 1 - 0.95 ** 3], np.float32)
    want = [np.asarray(x) for x in jax_int8(p, g, mu_q, mu_s, nu_q, nu_s, scalars,
                                            interpret=True, **HP)]
    mine = [torch.from_numpy(x.copy()) for x in (p, g, mu_q, mu_s, nu_q, nu_s, scalars)]
    adamw.fused_adamw_int8(*mine, **HP)  # CPU tensors: the plain version
    assert adamw.LAUNCHES_INT8 == 0
    _p_close(mine[0].numpy(), want[0], "p")
    _codes_close(mine[2].numpy(), want[1], "mu_q")
    _scales_close(mine[3].numpy(), want[2], "mu_s")
    _codes_close(mine[4].numpy(), want[3], "nu_q")
    _scales_close(mine[5].numpy(), want[4], "nu_s")
    assert (mine[4].numpy() >= 1).all()  # every code after a step is 1..127


# K4's multi-leaf entry: every layout the memory-knob model has, as (torch
# shape, JAX-layout permutation, weight decay)
MANY = (
    ((768, 256), (1, 0), 0.05),          # Linear out 768: rows straddle two inputs
    ((1024, 64), (1, 0), 0.05),          # Linear out 1024
    ((64, 16, 3, 3), (2, 3, 1, 0), 0.05),  # conv
    ((16, 32, 2, 2), (0, 2, 3, 1), 0.05),  # transposed conv
    ((3072,), (0,), 0.05),               # identity
    ((256, 32), (1, 0), 0.05),           # 8 rows (the JAX kernel's grid step takes 256)
    ((128, 64), (1, 0), 0.0),            # no weight decay
    ((3, 1024), (1, 0), 0.05),           # an output width K4 reads a byte at a time
    ((32, 64), (1, 0), 0.05),            # left out: no gradient
)


def _many_leaf(rng, shape):
    n = int(np.prod(shape))
    C = n // adamw.QBLOCK
    return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
            torch.from_numpy((rng.standard_normal(shape) * np.exp(rng.uniform(-4, 1, shape)))
                             .astype(np.float32)),
            torch.from_numpy(rng.integers(-127, 128, (C, 1024)).astype(np.int8)),
            torch.from_numpy((rng.uniform(0.1, 1, (C, 1)) * 1e-2 / 127).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 128, (C, 1024)).astype(np.int8)),
            torch.from_numpy((rng.uniform(0.1, 1, (C, 1)) * 1e-3).astype(np.float32)))


def test_int8_many_plain_path_matches_per_leaf_plain():
    """On CPU tensors the multi-leaf entry (one list with every layout, a
    ragged leaf, a leaf without weight decay, a leaf without a gradient)
    updates each leaf bit for bit as the per-leaf plain version does, the
    leaf left out not at all, and launches nothing."""
    rng = np.random.default_rng(21)
    scalars = torch.tensor([0.7, 1e-2, 1 - 0.9 ** 3, 1 - 0.95 ** 3])
    hp = {k: HP[k] for k in ("b1", "b2", "eps")}
    data = [(_many_leaf(rng, shape), perm, wd) for shape, perm, wd in MANY]
    mine = [[t.clone() for t in leaf] for leaf, _, _ in data]
    leaves = [(t[0].permute(perm), None if k == len(MANY) - 1 else t[1].permute(perm),
               *t[2:], wd) for k, (t, (_, perm, wd)) in enumerate(zip(mine, data))]
    launches = adamw.LAUNCHES_INT8
    adamw.fused_adamw_int8_many(leaves, scalars, **hp)
    assert adamw.LAUNCHES_INT8 == launches
    for k, ((leaf, perm, wd), got) in enumerate(zip(data, mine)):
        want = [t.clone() for t in leaf]
        if k < len(MANY) - 1:
            adamw.fused_adamw_int8_plain(want[0].permute(perm), want[1].permute(perm),
                                         *want[2:], scalars, wd=wd, **hp)
            assert not torch.equal(want[0], leaf[0]), k
        for a, b in zip(got, want):
            assert torch.equal(a, b), k


def test_int8_layouts_address_the_views():
    """K4's descriptor (B, O, R, KK) of each layout of MANY, and of the
    model's (1x1 convs, the 16x16 patch embedding, a multi-dim identity):
    the kernel's two maps, torch offset (b * O + o) * R + r and JAX index
    (b * R + (r % KK) * (R / KK) + r / KK) * O + o, pair every element of
    the view's flatten with its place in memory. A view outside those
    layouts raises."""
    shapes = [(s, perm) for s, perm, _ in MANY] + [
        ((96, 1024, 1, 1), (2, 3, 1, 0)), ((64, 3, 16, 16), (2, 3, 1, 0)),
        ((4, 2, 1024), (0, 1, 2))]
    for shape, perm in shapes:
        base = torch.arange(int(np.prod(shape))).reshape(shape)
        view = base.permute(perm)
        B, O, R, KK = adamw.int8_layout(view)
        assert B * O * R == base.numel(), shape
        b, o, r = np.meshgrid(np.arange(B), np.arange(O), np.arange(R), indexing="ij")
        torch_off = (b * O + o) * R + r
        jax_idx = (b * R + (r % KK) * (R // KK) + r // KK) * O + o
        assert np.array_equal(view.reshape(-1).numpy()[jax_idx], torch_off), shape
    base = torch.zeros(4, 2, 1024)
    for bad in (base.permute(1, 0, 2), base[:, :, :512], base.permute(2, 0, 1)[::2]):
        with pytest.raises(ValueError):
            adamw.int8_layout(bad)


# leaves of the optimizer test: JAX-layout shape and the permutation that
# takes the port's torch layout to it (models/convert.py::jax_layouts)
TREE = {
    "dense": ((96, 64), (1, 0)),              # Linear [out, in] -> Dense [in, out]
    "conv": ((3, 3, 32, 64), (2, 3, 1, 0)),   # Conv2d [out, in, kh, kw] -> HWIO
    "up": ((16, 2, 2, 32), (0, 2, 3, 1)),     # ConvTranspose2d [in, out, k, k]
    "long": ((4096,), (0,)),
    "small": ((16,), (0,)),
}
ELIGIBLE = {"dense", "conv", "up", "long"}


def _tree_and_grads(rng, steps=3):
    """JAX-layout params and gradients; each gradient's scale varies along
    the JAX layout's leading axis, so that blocks taken in torch order get
    other maxima."""
    tree = {k: rng.standard_normal(s).astype(np.float32) for k, (s, _) in TREE.items()}
    grads = []
    for _ in range(steps):
        g = {}
        for k, v in tree.items():
            lead = np.exp(rng.uniform(-3, 1, (v.shape[0],) + (1,) * (v.ndim - 1)))
            g[k] = (0.3 * lead * rng.standard_normal(v.shape)).astype(np.float32)
        grads.append(g)
    return tree, grads


def _to_torch(x, perm):
    """A JAX-layout array as the torch-layout tensor whose permute(perm) it is."""
    return torch.from_numpy(np.array(x.transpose(np.argsort(perm)), order="C"))


def _jax_layout(t, perm):
    return t.detach().permute(perm).numpy()


KW = dict(lr=1e-2, warmup_steps=2, total_steps=20, min_lr=1e-4, weight_decay=0.05, clip=1.0)


def _port_run(tree, grads, state_dtype, layouts=True, per_step=None):
    opt = step.make_optimizer(state_dtype=state_dtype, **KW)
    names = list(tree)
    params = [_to_torch(tree[k], TREE[k][1]).requires_grad_() for k in names]
    opt.init(params, [tree[k].ndim > 1 for k in names],
             [TREE[k][1] if layouts else tuple(range(tree[k].ndim)) for k in names])
    for i, g in enumerate(grads):
        for k, p in zip(names, params):
            p.grad = _to_torch(g[k], TREE[k][1])
        opt.step()
        if per_step is not None:
            per_step(i, opt)
    return opt, {k: _jax_layout(p, TREE[k][1]) for k, p in zip(names, params)}


def test_int8_fused_optimizer_matches_jax_over_3_steps():
    """3 steps of make_optimizer(state_dtype="int8_fused") on both sides,
    compared after every step: codes (CODE_FRACTION one apart), scales
    (1e-5 relative) and params. Step 1 has lr 0 (warm-up), so the codes of
    step 1 feed the updates of steps 2 and 3; where a code was one step
    apart, the dequantized moment of the next step differs by one code
    step (a nu code step is a factor e^(ln(1e6)/126) = 1.116), so those
    elements' params are held to 0.2 * the summed lr instead. The same
    steps with blocks taken in torch order disagree with the JAX package's
    scales: the layouts matter."""
    rng = np.random.default_rng(11)
    tree, grads = _tree_and_grads(rng)
    from vista_slam_tpu.train.step import make_optimizer as jmake

    tx = jmake(state_dtype="int8_fused", **KW)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    js = tx.init(jp)
    jaxs = []
    for g in grads:
        jp, js = tx.step(jp, g, js)
        jaxs.append((jax.device_get(jp), jax.device_get(js.moments)))

    names = list(tree)
    moved = {k: np.zeros(tree[k].size, bool) for k in names}

    def compare(i, opt):
        want_p, want_m = jaxs[i]
        for k, m in zip(names, opt.moments):
            assert isinstance(m, FusedInt8Leaf) == (k in ELIGIBLE), k
            if k not in ELIGIBLE:
                continue
            wm = want_m[k]
            for a, b, what in ((m.mu_q, wm.mu_q, "mu_q"), (m.nu_q, wm.nu_q, "nu_q")):
                moved[k] |= _codes_close(a.numpy(), b, f"{k} {what} step {i + 1}").reshape(-1)
            _scales_close(m.mu_s.numpy(), wm.mu_s, f"{k} mu_s step {i + 1}", 1e-5)
            _scales_close(m.nu_s.numpy(), wm.nu_s, f"{k} nu_s step {i + 1}", 1e-5)

    opt, got = _port_run(tree, grads, "int8_fused", per_step=compare)
    assert opt.count == 3
    final = jaxs[-1][0]
    for k in names:
        assert not np.array_equal(got[k], tree[k]), k  # moved by step 3
        ok = ~moved[k]
        _p_close(got[k].reshape(-1)[ok], np.asarray(final[k]).reshape(-1)[ok], k)
        far = np.abs(got[k].reshape(-1) - np.asarray(final[k]).reshape(-1))[~ok]
        assert (far <= 0.2 * (5e-3 + 1e-2)).all(), k

    # torch-order blocks: the same data, other row maxima (the upsample
    # kernel's permutation stays inside its rows, so its blocks do not move)
    opt_t, _ = _port_run(tree, grads, "int8_fused", layouts=False)
    want_m = jaxs[-1][1]
    for k, m in zip(names, opt_t.moments):
        if k in ("dense", "conv"):
            rel = np.abs(m.mu_s.numpy() / want_m[k].mu_s - 1).max()
            assert rel > 1e-2, (k, rel)


def test_int8_fused_step_refuses_a_parameter_moved_since_init():
    """K4's table holds each int8 leaf's storage from init: a parameter
    whose storage was replaced afterwards makes step raise, not update the
    old storage; init again binds the new one."""
    rng = np.random.default_rng(12)
    tree, grads = _tree_and_grads(rng, steps=1)
    opt, _ = _port_run(tree, grads, "int8_fused")
    names = list(tree)
    k = names.index("dense")
    params = opt.params
    params[k].data = params[k].data.clone()
    with pytest.raises(RuntimeError, match="replaced since init"):
        opt.step()
    opt.init(params, opt.decay, opt.layouts)
    before = params[k].detach().clone()
    opt.count = 3  # past the warm-up's lr 0
    opt.step()
    assert not torch.equal(params[k].detach(), before)


@pytest.mark.parametrize("state_dtype", ["bf16", "int8"])
def test_carrier_optimizer_matches_jax_over_3_steps(state_dtype):
    """The JAX package's XLA carriers (optax chain of clip_by_global_norm
    and adamw_q) against the port's ChainAdamW, 3 steps: fp32 (small)
    leaves' moments within 1e-5 normwise, bf16 moments within one bf16 ulp
    of their magnitude, int8 codes as above and scales within 1e-5. Params:
    a carried moment one storage step apart moves the next update u ~ 1 by
    up to a bf16 ulp (2^-7) or an int8 code step relative to its block's
    largest value (1/127 of mu, 2/255 of sqrt(nu)), so params are held to
    lr * 2^-5 = 3.2e-4 absolute (lr <= 1e-2)."""
    import optax

    from vista_slam_tpu.train.quantized_opt import QMoment as JQMoment
    from vista_slam_tpu.train.quantized_opt import ScaleByAdamQState
    from vista_slam_tpu.train.step import make_optimizer as jmake

    rng = np.random.default_rng(12)
    tree, grads = _tree_and_grads(rng)
    tx = jmake(state_dtype=state_dtype, **KW)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    js = tx.init(jp)
    for g in grads:
        upd, js = tx.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
    jp = jax.device_get(jp)
    adam = [s for s in jax.tree_util.tree_leaves(
        js, is_leaf=lambda x: isinstance(x, ScaleByAdamQState))
        if isinstance(s, ScaleByAdamQState)][0]

    opt, got = _port_run(tree, grads, state_dtype)
    assert isinstance(opt, ChainAdamW) and opt.count == 3
    for k, m in zip(tree, opt.moments):
        assert not np.array_equal(got[k], tree[k]), k
        _finite(got[k], jp[k])
        np.testing.assert_allclose(got[k], jp[k], rtol=0, atol=3.2e-4, err_msg=k)
        for mine, theirs, signed in ((m.mu, adam.mu[k], True), (m.nu, adam.nu[k], False)):
            if isinstance(theirs, JQMoment):
                assert isinstance(mine, QMoment), k
                _codes_close(mine.q.numpy(), theirs.q, k)
                assert mine.q.dtype == (torch.int8 if signed else torch.uint8)
                _scales_close(mine.scale.numpy(), theirs.scale, k, 1e-5)
                continue
            theirs = np.asarray(jnp.asarray(theirs, jnp.float32))
            mine = mine.float().numpy()
            assert mine.shape == theirs.shape, k
            tol = 2 ** -8 if k in ELIGIBLE else 1e-5
            assert (np.abs(mine - theirs).max() <= tol * np.abs(theirs).max()), k
        if k in ELIGIBLE:
            kind = QMoment if state_dtype == "int8" else torch.Tensor
            assert isinstance(m.mu, kind) and (kind is QMoment or m.mu.dtype == torch.bfloat16)


def test_jax_layouts_flatten_as_the_jax_leaves():
    """For every parameter of a tiny STA, the view p.permute(perm) given by
    jax_layouts flattens exactly as the matching leaf of the JAX package's
    convert_state_dict does (the strided-upsample biases, k*k untied copies
    in the JAX tree, aside), and jax_param_ndims is that leaf's rank."""
    from test_torch_model import random_state_dict
    from vista_slam_tpu.models.convert import convert_state_dict
    from vista_slam_tpu_torch.models.convert import (jax_layouts, jax_param_ndims,
                                                     state_dict_from_jax)
    from vista_slam_tpu_torch.models.sta import STA, STAConfig

    model = STA(STAConfig(img_size=(32, 32), patch_size=4, enc_dim=64, enc_depth=1,
                          enc_heads=1, dec_dim=64, dec_depth=2, dec_heads=1, mlp_ratio=2,
                          compute_dtype=torch.float32))
    sd = random_state_dict(model, np.random.default_rng(4))
    params = convert_state_dict(sd)
    # the port's name of every JAX leaf: tag each leaf with its index
    flat, treedef = jax.tree_util.tree_flatten(params)
    tags = treedef.unflatten([np.full(np.shape(x), i, np.float32) for i, x in enumerate(flat)])
    owner = {k: int(v.reshape(-1)[0]) for k, v in state_dict_from_jax(tags).items()
             if v.numel() and (v == v.reshape(-1)[0]).all()}
    layouts, ndims = jax_layouts(model), jax_param_ndims(model)
    assert set(layouts) == set(sd) == set(ndims)
    checked = 0
    for name, perm in layouts.items():
        if "refinenet4.resConfUnit1" in name:  # absent from a JAX tree
            continue
        leaf = np.asarray(flat[owner[name]])
        view = torch.from_numpy(sd[name]).permute(perm)
        if name.endswith(("act_postprocess.0.1.bias", "act_postprocess.1.1.bias")):
            assert leaf.size == view.numel() * (16 if ".0.1." in name else 4), name
            continue
        np.testing.assert_array_equal(view.reshape(-1).numpy(), leaf.reshape(-1), err_msg=name)
        assert ndims[name] == leaf.ndim, name
        checked += 1
    assert checked > 100
