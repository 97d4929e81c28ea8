"""The memory-knob training slice (configs/train_fast.yaml with
``model.attn_fused_train`` and ``opt_state_dtype: int8_fused``) against the
JAX package, on the CPU.

The tiny model of tests/test_torch_train.py with ``use_flash=False,
attn_fused_train=True``: every attention goes through the fused training
attention (the JAX package's Pallas kernel in interpret mode; the port's
plain versions of K3a/K3b), the loss and every gradient are compared, then
2 ``int8_fused`` steps (K4's plain version against the JAX kernel in
interpret mode) from the same gradients. One JAX jit, in a module fixture.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_model import random_state_dict
from test_torch_train import B, S, TIED_BIAS, TINY, _dataset, _finite, _normwise
from vista_slam_tpu.models.convert import convert_state_dict
from vista_slam_tpu.models.sta import STA as JSTA
from vista_slam_tpu.models.sta import STAConfig as JSTAConfig
from vista_slam_tpu_torch.kernels import adamw, attn_train
from vista_slam_tpu_torch.models.convert import (jax_layouts, jax_param_ndims,
                                                 state_dict_from_jax)
from vista_slam_tpu_torch.models.sta import STA, STAConfig
from vista_slam_tpu_torch.ops import attention
from vista_slam_tpu_torch.train import step
from vista_slam_tpu_torch.train.quantized_opt import FusedInt8Leaf
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

FUSED = dict(TINY, use_flash=False, attn_fused_train=True)
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=20, min_lr=1e-4, weight_decay=0.05,
           clip=1.0, state_dtype="int8_fused")


@pytest.fixture(scope="module")
def batch():
    from vista_slam_tpu_torch.datasets import synthetic_scene
    from vista_slam_tpu_torch.train.data import TrainLoader

    loader = TrainLoader(_dataset(synthetic_scene), B, S)
    loader.set_epoch(0)
    return next(iter(loader))


@pytest.fixture(scope="module")
def pair(batch):
    """The port's model, its state dict, the JAX params of the same weights,
    and the JAX loss, details and gradients on ``batch``."""
    from jax.experimental.pallas import tpu as pltpu

    from vista_slam_tpu.train.step import make_loss_fn as jmake_loss_fn

    model = STA(STAConfig(compute_dtype=torch.float32, param_dtype=torch.float32, **FUSED))
    sd = random_state_dict(model, np.random.default_rng(3))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    params = convert_state_dict(sd)
    jm = JSTA(JSTAConfig(compute_dtype=jnp.float32, **FUSED))
    loss_fn = jmake_loss_fn(jm, S, reproj_grad="f32")
    with pltpu.force_tpu_interpret_mode():
        (loss, details), grads = jax.device_get(jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params, batch, 0.4))
    return model, sd, params, (loss, details, grads)


def test_loss_and_every_gradient_match_jax(pair, batch):
    """Every attention of the step takes the fused path (none the plain or
    the flash one); the loss terms within 1e-4 relative and every gradient
    within 2e-3 normwise, the bars of tests/test_torch_train.py (fp32 both
    sides, sums in other orders through ~20 layers and the pose head's SVD
    backward)."""
    model, _, _, (jloss, jdetails, jgrads) = pair
    model.zero_grad(set_to_none=True)
    before = dict(attention.CALLS)
    loss, details = step.make_loss_fn(model, S)(step.batch_to(batch, "cpu"), 0.4)
    calls = {k: attention.CALLS[k] - before[k] for k in before}
    loss.backward()
    cfg = model.cfg
    # an encode of the main views and one of the support views, one batched
    # decode (self- and cross-attention) of every pair in both directions
    assert calls == {"flash": 0, "plain": 0, "fused": 2 * (cfg.enc_depth + cfg.dec_depth)}
    assert attn_train.LAUNCHES_FWD == attn_train.LAUNCHES_BWD == 0
    _finite(loss.item(), jloss)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-4)
    for k, v in details.items():
        np.testing.assert_allclose(v.item(), jdetails[k], rtol=1e-4, atol=1e-6, err_msg=k)

    want = state_dict_from_jax(jgrads)
    head = jgrads["params"]["head_pts"]
    for name, (src, k) in TIED_BIAS.items():
        want[name] = torch.from_numpy(head[src]["proj"]["bias"].reshape(k * k, -1).sum(0))
    n_checked = 0
    for name, p in model.named_parameters():
        if p.grad is None:  # the deepest fusion block's unused skip unit
            assert "refinenet4.resConfUnit1" in name and not want[name].any(), name
            continue
        _finite(p.grad, want[name])
        err = _normwise(p.grad.numpy(), want[name].numpy())
        assert err <= 2e-3, (name, err)
        n_checked += 1
    assert n_checked > 100


def test_int8_fused_steps_match_jax(pair):
    """2 int8_fused steps on both sides from the JAX gradients (mapped to the
    port's layout, so that the check of the optimizer is not blurred by the
    2e-3 of the gradients): K4 leaves in the JAX layout (Linear, Conv2d and
    1-D trunk leaves), fp32 small leaves, weight decay by JAX rank. The
    strided-upsample biases (tied across k*k taps in the port, untied in the
    JAX tree) get no gradient on either side, so both global norms run over
    the same values. Held after step 2: params within 1e-6 relative plus
    1e-6 absolute (tests/test_torch_quantized_opt.py), K4 scales within 1e-5
    relative, codes one apart on at most 1e-3 of them; step 1 has lr 0, so
    its codes feed step 2's update, and params where a code was one apart
    are held to 0.2 * lr (2e-3) instead."""
    from vista_slam_tpu.train.step import make_optimizer as jmake

    model, sd, params, (_, _, jgrads) = pair
    tied = {src for src, _ in TIED_BIAS.values()}
    head = jgrads["params"]["head_pts"]
    for src in tied:
        head[src]["proj"]["bias"] = np.zeros_like(head[src]["proj"]["bias"])
    # JAX side: 2 steps of the fused applier (interpret mode off a TPU)
    tx = jmake(**OPT)
    jp, js = params, tx.init(params)
    jstep = jax.jit(tx.step)  # one compile for every leaf's kernel call
    codes = []
    for _ in range(2):
        jp, js = jstep(jp, jgrads, js)
        codes.append(jax.device_get(js.moments))
    jp = jax.device_get(jp)

    # port side: the same weights and gradients, in the torch layout
    names = [n for n, _ in model.named_parameters()]
    tparams = [torch.from_numpy(sd[n].copy()).requires_grad_() for n in names]
    grads = state_dict_from_jax(jgrads)
    ndims, layouts = jax_param_ndims(model), jax_layouts(model)
    opt = step.make_optimizer(**OPT)
    opt.init(tparams, [ndims[n] > 1 for n in names], [layouts[n] for n in names])
    skip = set(TIED_BIAS) | {n for n in names if "refinenet4.resConfUnit1" in n}
    mine = []
    for _ in range(2):
        for n, p in zip(names, tparams):
            p.grad = None if n in skip else grads[n].clone()
        opt.step()
        mine.append([m._replace(**{f: t.clone() for f, t in m._asdict().items()})
                     for m in opt.moments])
    assert adamw.LAUNCHES_INT8 == 0

    # JAX leaf of each port name (tag every leaf with its index)
    flat, treedef = jax.tree_util.tree_flatten(params)
    tags = treedef.unflatten([np.full(np.shape(x), i, np.float32) for i, x in enumerate(flat)])
    owner = {k: int(v.reshape(-1)[0]) for k, v in state_dict_from_jax(tags).items()
             if v.numel() and (v == v.reshape(-1)[0]).all()}
    jflat = jax.tree_util.tree_leaves(jp)
    moments = [treedef.flatten_up_to(c) for c in codes]
    n_int8 = 0
    for i, (n, p) in enumerate(zip(names, tparams)):
        m = opt.moments[i]
        if n in skip:
            assert torch.equal(p.detach(), torch.from_numpy(sd[n])), n
            continue
        got = p.detach().permute(layouts[n]).reshape(-1).numpy()
        want = np.asarray(jflat[owner[n]]).reshape(-1)
        _finite(got, want)
        assert not np.array_equal(got, sd[n].reshape(-1)) or not grads[n].any(), n
        far = np.zeros(got.size, bool)
        jm = [mm[owner[n]] for mm in moments]
        assert isinstance(m, FusedInt8Leaf) == (type(jm[-1]).__name__ == "FusedInt8Leaf"), n
        if isinstance(m, FusedInt8Leaf):
            n_int8 += 1
            for t in range(2):
                mt, jt = mine[t][i], jm[t]
                d = np.abs(mt.mu_q.numpy().astype(int) - np.asarray(jt.mu_q, int))
                e = np.abs(mt.nu_q.numpy().astype(int) - np.asarray(jt.nu_q, int))
                assert max(d.max(), e.max()) <= 1, (n, t)
                assert (d > 0).mean() + (e > 0).mean() <= 1e-3, (n, t)
                np.testing.assert_allclose(mt.mu_s.numpy(), jt.mu_s, rtol=1e-5, err_msg=n)
                np.testing.assert_allclose(mt.nu_s.numpy(), jt.nu_s, rtol=1e-5, err_msg=n)
                if t == 0:  # step 1's codes feed step 2's update
                    far = (d > 0).reshape(-1) | (e > 0).reshape(-1)
        np.testing.assert_allclose(got[~far], want[~far], rtol=1e-6, atol=1e-6, err_msg=n)
        assert (np.abs(got[far] - want[far]) <= 2e-3).all(), n
    assert n_int8 > 10


def test_memory_knob_preset_is_train_fast_yaml():
    """The memory-knob preset chip_smoke.py drives (train/finetune.py):
    train_fast.yaml's batch size, its model (the JAX package's STAConfig
    defaults: 224x224, use_flash None) with gelu_approx, and the two memory
    knobs; 32 encoded views and 48 decoded directions of 196/197 tokens per
    step, all below the flash threshold. Without the knobs it is the YAML
    as written (plain attention, its own bf16 moments)."""
    import os

    import yaml

    from vista_slam_tpu_torch.train import finetune

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs", "train_fast.yaml")) as f:
        want = yaml.safe_load(f)
    preset = finetune.PRESETS["memory_knob"]
    assert preset.batch == want["batch_size"] == 8
    assert preset.state_dtype == "int8_fused"
    assert finetune.optimizer(preset="memory_knob", state_dtype=want["opt_state_dtype"]
                              ).state_dtype == "bf16"
    plain = finetune.model_config("memory_knob", attn_fused_train=False)
    assert not plain.attn_fused_train and plain.use_flash is None
    cfg = finetune.model_config("memory_knob")
    jdefault = JSTAConfig()
    assert cfg.img_size == tuple(jdefault.img_size) == (224, 224)
    assert cfg.use_flash is jdefault.use_flash is None
    assert cfg.attn_fused_train and cfg.gelu_approx == want["model"]["gelu_approx"]
    assert (cfg.enc_dim, cfg.enc_depth, cfg.dec_dim, cfg.dec_depth) == (1024, 24, 768, 12)
    assert cfg.num_patches == 196 < 512
    opt = finetune.optimizer(preset="memory_knob")
    assert opt.state_dtype == "int8_fused"
    # the peak lr after warmup_epochs of 64 / 8 = 8 steps
    assert opt.schedule(79) < opt.schedule(80) == pytest.approx(1.5e-5, rel=1e-6)
