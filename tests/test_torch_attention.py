"""Attention in the PyTorch port against the JAX package's Pallas flash
kernels, forward and backward (run in interpret mode on the CPU, as
tests/test_flash.py runs them).

The port's CPU tensors go through the plain versions; the CUDA kernels
themselves are checked by the ``cuda``-marked tests (and by chip_smoke.py)."""

import numpy as np
import pytest
import torch

from vista_slam_tpu_torch.kernels import flash_attn
from vista_slam_tpu_torch.ops import attention
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _qkv(rng, b, h, nq, nk, d=64):
    return (rng.standard_normal((b, h, nq, d)).astype(np.float32),
            rng.standard_normal((b, h, nk, d)).astype(np.float32),
            rng.standard_normal((b, h, nk, d)).astype(np.float32))


def _assert_close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("b,h,nq,nk", [(2, 3, 197, 197), (2, 3, 130, 260),
                                       (1, 2, 769, 769)])
def test_attention_matches_jax_flash(b, h, nq, nk):
    from jax.experimental.pallas import tpu as pltpu

    from vista_slam_tpu.ops.pallas import flash

    q, k, v = _qkv(np.random.default_rng(nq + nk), b, h, nq, nk)
    scale = 64 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want_out, want_lse = flash._fwd_impl(q, k, v, scale, flash.DEFAULT_BLOCK_Q)
    want_out = np.asarray(want_out)
    want_lse = np.asarray(want_lse)[:, :nq, 0]

    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attn.flash_attention(tq, tk, tv, scale)  # CPU: plain version
    _assert_close(out, want_out, 2e-5)
    _assert_close(lse, want_lse, 2e-5)
    _assert_close(attention.mha_plain(tq, tk, tv, scale), want_out, 2e-5)
    assert flash_attn.LAUNCHES == 0  # no kernel launch for CPU tensors


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,nq,nk", [(1, 2, 197, 197), (1, 2, 130, 260)],
                         ids=["ragged", "nq_ne_nk"])
def test_flash_backward_matches_jax_vjp(b, h, nq, nk, dtype):
    """dq, dk, dv of the port's FlashAttention (the plain K2a/K2b on the
    CPU) against jax.vjp of the JAX package's flash_attention. Normwise
    tolerance (max abs error over the largest magnitude): 1e-5 in fp32;
    2e-2 in bf16, where both sides round P and dS to bf16 and a value on a
    rounding boundary can land one bf16 ulp apart."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from vista_slam_tpu.ops.pallas import flash

    rng = np.random.default_rng(nq + nk + len(dtype))
    q, k, v = _qkv(rng, b, h, nq, nk)
    do = rng.standard_normal(q.shape).astype(np.float32)
    scale = 64 ** -0.5
    jdt = jnp.dtype(dtype)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda q_, k_, v_: flash.flash_attention(q_, k_, v_, scale),
                         *(jnp.asarray(x, jdt) for x in (q, k, v)))
        want = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, jdt))]

    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v))
    out = attention.FlashAttention.apply(tq, tk, tv, scale)
    out.backward(torch.from_numpy(do).to(tdt))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        got = t.grad.float().numpy()
        assert t.grad.dtype == tdt
        _assert_close(got, w, tol * np.abs(w).max())
    assert flash_attn.LAUNCHES_DQ == flash_attn.LAUNCHES_DKV == 0


def test_flash_autograd_gradcheck():
    """torch.autograd.gradcheck of FlashAttention in float64 (the plain
    forward and backward keep float64 throughout and take any head dim on
    the CPU), Nq != Nk."""
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(s, generator=gen, dtype=torch.float64, requires_grad=True)
               for s in ((1, 2, 3, 16), (1, 2, 4, 16), (1, 2, 4, 16)))
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: attention.FlashAttention.apply(q_, k_, v_, 0.125), (q, k, v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,nq,nk", [(1, 2, 197, 197), (1, 2, 130, 260)],
                         ids=["ragged", "nq_ne_nk"])
def test_flash_bwd_dq_plain_delta_matches_jax_rowsum(b, h, nq, nk, dtype):
    """The plain K2a's delta is rowsum(dO * O) as the JAX package's
    _flash_bwd forms it (vista_slam_tpu/ops/pallas/flash.py:221: padded,
    cast to fp32, multiplied, summed), 1e-6 normwise (fp32 sums in another
    order)."""
    import jax.numpy as jnp

    from vista_slam_tpu.ops.pallas import flash

    rng = np.random.default_rng(nq + 7 * nk + len(dtype))
    q, k, v = _qkv(rng, b, h, nq, nk)
    out, do = (rng.standard_normal(q.shape).astype(np.float32) for _ in range(2))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    nq_pad = -(-nq // flash.DEFAULT_BLOCK_Q) * flash.DEFAULT_BLOCK_Q
    dof = flash._pad_to(jnp.asarray(do, jdt).reshape(b * h, nq, 64), nq_pad, 1)
    of = flash._pad_to(jnp.asarray(out, jdt).reshape(b * h, nq, 64), nq_pad, 1)
    want = np.asarray(jnp.sum(dof.astype(jnp.float32) * of.astype(jnp.float32),
                              axis=-1))[:, :nq]

    tq, tk, tv, tout, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, out, do))
    _, lse = flash_attn.flash_attention(tq, tk, tv, 0.125)
    dq, delta = flash_attn.flash_attention_bwd_dq(tq, tk, tv, tout, tdo, lse, 0.125)
    assert delta.dtype == torch.float32 and delta.shape == (b * h, nq)
    _assert_close(delta, want, 1e-6 * np.abs(want).max())
    assert dq.shape == tq.shape and dq.dtype == tdt
    assert flash_attn.LAUNCHES_DQ == 0


def test_mha_flash_path_is_differentiable_and_counts_once():
    """With grad on, mha(use_flash=True) goes through FlashAttention: one
    flash call counted, gradients equal to the plain path's."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(rng, 1, 2, 40, 40))
    before = attention.CALLS["flash"]
    attention.mha(q, k, v, 0.125, use_flash=True).square().sum().backward()
    assert attention.CALLS["flash"] == before + 1
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    attention.mha(q, k, v, 0.125, use_flash=False).square().sum().backward()
    for g, t in zip(got, (q, k, v)):
        _assert_close(g, t.grad.numpy(), 1e-5)


def test_mha_dispatch_counts_paths():
    rng = np.random.default_rng(0)
    tq, tk, tv = map(torch.from_numpy, _qkv(rng, 1, 2, 40, 40))
    before = dict(attention.CALLS)
    a = attention.mha(tq, tk, tv, 0.125, use_flash=True)
    b = attention.mha(tq, tk, tv, 0.125, use_flash=False)
    attention.mha(tq, tk, tv, 0.125)  # None: 40 < FLASH_MIN_TOKENS -> plain
    assert attention.CALLS["flash"] - before["flash"] == 1
    assert attention.CALLS["plain"] - before["plain"] == 2
    _assert_close(a, b.numpy(), 2e-6)


@pytest.mark.parametrize("n,fused_train,path", [
    (195, False, "plain"), (196, False, "flash"), (197, False, "flash"),
    (196, True, "fused"), (511, True, "fused"), (512, True, "flash")])
def test_mha_use_flash_none_takes_the_measured_threshold(n, fused_train, path):
    """use_flash=None: flash from FLASH_MIN_TOKENS (the H100's crossover
    against mha_plain) without the fused training path; with it, the JAX
    package's 512, so the memory-knob path keeps K3 below 512 tokens."""
    assert (attention.FLASH_MIN_TOKENS, attention.FUSED_FLASH_MIN_TOKENS) == (196, 512)
    q = torch.zeros((1, 1, n, 64))
    before = dict(attention.CALLS)
    attention.mha(q, q, q, 0.125, fused_train=fused_train)
    assert {p: attention.CALLS[p] - before[p] for p in before} == \
        {p: int(p == path) for p in before}


def test_flash_wrapper_refuses_non_cpu_non_cuda_tensors():
    """Only CPU tensors take the plain version: anything else goes to the
    kernel's checks and raises instead of falling back."""
    q = torch.empty((1, 1, 8, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attn.flash_attention(q, q, q, 0.125)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


_K1_CARD_SHAPES = (  # (b, h, nq, nk): the paths' decoder shape, and edges of the tiling
    [(2, 12, 769, 769), (2, 3, 130, 260)]
    + [(b, h, n, n) for b, h in ((1, 1), (16, 12)) for n in (1, 63, 64, 65, 129, 769)]
    + [(b, h, nq, nk) for b, h in ((1, 1), (16, 12)) for nq, nk in ((130, 260), (260, 130))])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,h,nq,nk", _K1_CARD_SHAPES)
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, tol, b, h, nq, nk):
    """K1 against its plain version, at unit scale and with q and k scaled
    x8 (large logits: the running max matters); two calls agree bit for
    bit (no atomics)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for qk_mul in (1.0, 8.0):
        q = (torch.randn((b, h, nq, 64), generator=gen, device=cuda_device) * qk_mul).to(dtype)
        k = (torch.randn((b, h, nk, 64), generator=gen, device=cuda_device) * qk_mul).to(dtype)
        v = torch.randn((b, h, nk, 64), generator=gen, device=cuda_device).to(dtype)
        launches = flash_attn.LAUNCHES
        out, lse = flash_attn.flash_attention(q, k, v, 0.125)
        again = flash_attn.flash_attention(q, k, v, 0.125)
        torch.cuda.synchronize()
        assert flash_attn.LAUNCHES == launches + 2
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        ref_out, ref_lse = flash_attn.flash_attention_plain(q, k, v, 0.125)
        _assert_close(out.float().cpu(), ref_out.float().cpu().numpy(), tol)
        _assert_close(lse.cpu(), ref_lse.cpu().numpy(), 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [-0.125, 0.0, 1.0])
def test_flash_kernel_takes_any_scale_on_card(cuda_device, scale):
    """K1 in bf16 takes any scale, as the TPU kernel does: zero, negative
    and large, against its plain version (masked tail included)."""
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    for (b, h, nq, nk) in [(1, 2, 129, 129), (2, 3, 130, 260)]:
        q, k, v = (torch.randn(s, generator=gen, device=cuda_device).to(torch.bfloat16)
                   for s in ((b, h, nq, 64), (b, h, nk, 64), (b, h, nk, 64)))
        out, lse = flash_attn.flash_attention(q, k, v, scale)
        ref_out, ref_lse = flash_attn.flash_attention_plain(q, k, v, scale)
        _assert_close(out.float().cpu(), ref_out.float().cpu().numpy(), 2e-2)
        _assert_close(lse.cpu(), ref_lse.cpu().numpy(), 1e-3)


# (b, h, nq, nk) of K2 on the training path (chip_smoke.K2_SHAPES): encoder
# main views, encoder supports, decoder pairs, and Nq != Nk
_K2_CARD_SHAPES = [(2, 16, 768, 768), (6, 16, 768, 768), (12, 12, 769, 769),
                   (2, 3, 130, 260)]


def _k2_inputs(gen, dtype, b, h, nq, nk, scale):
    device = gen.device
    q, k, v, do = (torch.randn(s, generator=gen, device=device).to(dtype)
                   for s in ((b, h, nq, 64), (b, h, nk, 64), (b, h, nk, 64),
                             (b, h, nq, 64)))
    out, lse = flash_attn.flash_attention(q, k, v, scale)
    return q, k, v, out, do, lse


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
def test_flash_backward_kernels_match_plain_on_card(cuda_device, dtype, tol):
    """K2a/K2b against their plain versions, normwise, at the training
    path's shapes; K2a's delta against the torch sum rowsum(dO * O) (1e-5
    normwise: both sum fp32 products, in another order)."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    for (b, h, nq, nk) in _K2_CARD_SHAPES:
        q, k, v, out, do, lse = _k2_inputs(gen, dtype, b, h, nq, nk, 0.125)
        launches = (flash_attn.LAUNCHES_DQ, flash_attn.LAUNCHES_DKV)
        dq, delta = flash_attn.flash_attention_bwd_dq(q, k, v, out, do, lse, 0.125)
        dk, dv = flash_attn.flash_attention_bwd_dkv(q, k, v, do, lse, delta, 0.125)
        torch.cuda.synchronize()
        assert (flash_attn.LAUNCHES_DQ, flash_attn.LAUNCHES_DKV) == (
            launches[0] + 1, launches[1] + 1)
        want_delta = flash_attn.delta_plain(do, out)
        _assert_close(delta.cpu(), want_delta.cpu().numpy(),
                      1e-5 * want_delta.abs().max().item())
        want = flash_attn.flash_attention_bwd_plain(q, k, v, out, do, lse, 0.125)
        for g, w in zip((dq, dk, dv), want):
            w = w.float().cpu().numpy()
            _assert_close(g.float().cpu(), w, tol * np.abs(w).max())


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [-0.125, 0.0, 1.0])
def test_flash_backward_takes_any_scale_on_card(cuda_device, scale):
    """K2a/K2b in bf16 take any scale, as the TPU kernels do: zero,
    negative and large (K1's lesson), against their plain versions on the
    same lse, with the 16-wide tails (769 tokens) and Nq != Nk."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for (b, h, nq, nk) in [(1, 2, 769, 769), (2, 3, 130, 260)]:
        args = _k2_inputs(gen, torch.bfloat16, b, h, nq, nk, scale)
        got = flash_attn.flash_attention_bwd(*args, scale)
        want = flash_attn.flash_attention_bwd_plain(*args, scale)
        for g, w in zip(got, want):
            w = w.float().cpu().numpy()
            assert np.isfinite(w).all()
            _assert_close(g.float().cpu(), w, 2e-2 * np.abs(w).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_backward_kernels_are_deterministic_on_card(cuda_device, dtype):
    """Two calls of K2a and K2b give bit-identical delta, dq, dk and dv:
    every output tile is written by one block, with no atomics."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    for (b, h, nq, nk) in [(12, 12, 769, 769), (2, 3, 130, 260)]:
        q, k, v, out, do, lse = _k2_inputs(gen, dtype, b, h, nq, nk, 0.125)
        runs = []
        for _ in range(2):
            dq, delta = flash_attn.flash_attention_bwd_dq(q, k, v, out, do, lse, 0.125)
            runs.append((dq, delta, *flash_attn.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, 0.125)))
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*runs))
