"""The port's fused short-sequence training attention (kernels K3a/K3b)
against the JAX package's ``fused_attention`` (ops/pallas/attn_train.py),
run in interpret mode on the CPU as tests/test_attn_train.py runs it.

The port's CPU tensors go through the kernels' plain versions; the CUDA
kernels themselves are checked by the ``cuda``-marked tests in
tests/test_torch_cuda.py and by chip_smoke.py."""

import numpy as np
import pytest
import torch

from vista_slam_tpu_torch.kernels import attn_train
from vista_slam_tpu_torch.ops import attention
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _qkv(seed, b, h, n, d=64):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(3))


def _assert_close(got, want, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _jax_fused(q, k, v, scale, dtype="float32", w=None):
    """The JAX package's fused_attention in interpret mode: the output, and
    with ``w`` the gradients of sum(out * w)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vista_slam_tpu.ops.pallas.attn_train import fused_attention

    args = [jnp.asarray(x, jnp.dtype(dtype)) for x in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        out = fused_attention(*args, scale)
        grads = None
        if w is not None:
            def f(q_, k_, v_):
                return (fused_attention(q_, k_, v_, scale).astype(jnp.float32) * w).sum()
            grads = jax.grad(f, argnums=(0, 1, 2))(*args)
    as_np = lambda x: np.asarray(x.astype(jnp.float32))
    return as_np(out), None if grads is None else [as_np(g) for g in grads]


@pytest.mark.parametrize("n", [197, 130, 256])
def test_fused_forward_matches_jax(n):
    """out within 2e-5 (the bar of tests/test_attn_train.py); lse against
    the JAX kernel's own lse residual."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vista_slam_tpu.ops.pallas.attn_train import _fwd_impl

    q, k, v = _qkv(n, 2, 3, n)
    scale = 64 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want_out, want_lse = _fwd_impl(*(jnp.asarray(x) for x in (q, k, v)), scale)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    before = dict(attention.CALLS)
    out = attention.mha(tq, tk, tv, scale, use_flash=False, fused_train=True)
    assert attention.CALLS["fused"] == before["fused"] + 1
    assert attention.CALLS["plain"] == before["plain"]
    _assert_close(out, want_out, 2e-5)
    _, lse = attn_train.fused_attention_fwd(tq, tk, tv, scale)
    _assert_close(lse, np.asarray(want_lse)[:, :n, 0], 2e-5)
    assert attn_train.LAUNCHES_FWD == 0  # no kernel launch for CPU tensors


@pytest.mark.parametrize("n", [197, 130])
def test_fused_grads_match_jax(n):
    """dq, dk, dv of sum(out * w) through the port's FusedTrainAttention
    (the plain K3b on the CPU) against jax.grad through the JAX kernel:
    atol 5e-4, the bar of tests/test_attn_train.py's gradient test."""
    q, k, v = _qkv(n + 1, 2, 2, n)
    scale = 64 ** -0.5
    w = np.sin(np.arange(64, dtype=np.float32))
    _, want = _jax_fused(q, k, v, scale, w=w)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (attention.fused_attention(tq, tk, tv, scale) * torch.from_numpy(w)).sum().backward()
    for name, t, g in zip("qkv", (tq, tk, tv), want):
        _assert_close(t.grad, g, 5e-4)
    assert attn_train.LAUNCHES_BWD == 0


def test_fused_bf16_matches_jax_at_197():
    """bf16 inputs on both sides: the same rounding points (P to v's dtype
    before PV; P to dO's and dS to q's dtype in the backward). Normwise
    2e-2 (max abs error over the largest magnitude): a value on a bf16
    rounding boundary can land one bf16 ulp (2^-8 relative) apart after
    the two sides sum in other orders, and the products carry it on."""
    q, k, v = _qkv(7, 1, 2, 197)
    scale = 64 ** -0.5
    w = np.cos(np.arange(64, dtype=np.float32))
    want_out, want = _jax_fused(q, k, v, scale, dtype="bfloat16", w=w)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v))
    out = attention.fused_attention(tq, tk, tv, scale)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(w)).sum().backward()
    _assert_close(out.float().detach(), want_out, 2e-2 * np.abs(want_out).max())
    for t, g in zip((tq, tk, tv), want):
        assert t.grad.dtype == torch.bfloat16
        _assert_close(t.grad.float(), g, 2e-2 * np.abs(g).max())


def test_fused_autograd_gradcheck():
    """torch.autograd.gradcheck of FusedTrainAttention in float64 (the plain
    versions keep float64 throughout on the CPU)."""
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((1, 2, 5, 16), generator=gen, dtype=torch.float64,
                           requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: attention.FusedTrainAttention.apply(q_, k_, v_, 0.25), (q, k, v))


def test_fused_dispatch_and_caps():
    """The JAX package's dispatch order: use_flash wins; then the fused path
    for N_q == N_kv <= MAX_FUSED_TOKENS; N_q != N_kv and N > 1024 go to the
    plain path. Calling fused_attention itself outside its domain raises
    ValueError, as the JAX package's does."""
    rng = np.random.default_rng(0)
    small = torch.from_numpy(rng.standard_normal((1, 1, 40, 64)).astype(np.float32))
    other = torch.from_numpy(rng.standard_normal((1, 1, 60, 64)).astype(np.float32))
    big = torch.zeros((1, 1, attention.MAX_FUSED_TOKENS + 1, 64))
    cases = [  # (q, kv, use_flash, fused_train) -> path
        ((small, small, True, True), "flash"),
        ((small, small, None, True), "fused"),
        ((small, small, False, True), "fused"),
        ((small, small, False, False), "plain"),
        ((small, other, False, True), "plain"),
        ((big, big, False, True), "plain"),
    ]
    for (q, kv, use_flash, fused), path in cases:
        before = dict(attention.CALLS)
        attention.mha(q, kv, kv, 0.125, use_flash=use_flash, fused_train=fused)
        diff = {p: attention.CALLS[p] - before[p] for p in before}
        assert diff == {p: int(p == path) for p in before}, (q.shape, kv.shape, use_flash, fused)
    assert attention.MAX_FUSED_TOKENS == 1024
    with pytest.raises(ValueError, match="N_q == N_kv"):
        attention.fused_attention(small, other, other, 0.125)
    with pytest.raises(ValueError, match="capped"):
        attention.fused_attention(big, big, big, 0.125)
    # a tensor that is on neither the CPU nor a card goes to the kernel's
    # checks and raises, never to the plain version
    meta = torch.empty((1, 1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        attn_train.fused_attention_fwd(meta, meta, meta, 0.125)
