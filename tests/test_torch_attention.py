"""Attention in the PyTorch port against the JAX package's Pallas flash
kernel (run in interpret mode on the CPU, as tests/test_flash.py runs it).

The port's CPU tensors go through the plain versions; the CUDA kernel
itself is checked by the ``cuda``-marked test (and by chip_smoke.py)."""

import numpy as np
import pytest
import torch

from vista_slam_tpu_torch.kernels import flash_attn
from vista_slam_tpu_torch.ops import attention


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


def test_mha_dispatch_counts_paths():
    rng = np.random.default_rng(0)
    tq, tk, tv = map(torch.from_numpy, _qkv(rng, 1, 2, 40, 40))
    before = dict(attention.CALLS)
    a = attention.mha(tq, tk, tv, 0.125, use_flash=True)
    b = attention.mha(tq, tk, tv, 0.125, use_flash=False)
    attention.mha(tq, tk, tv, 0.125)  # None: 40 < 512 tokens -> plain
    assert attention.CALLS["flash"] - before["flash"] == 1
    assert attention.CALLS["plain"] - before["plain"] == 2
    _assert_close(a, b.numpy(), 2e-6)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, tol):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for (b, h, nq, nk) in [(2, 12, 769, 769), (2, 3, 130, 260)]:
        q = torch.randn((b, h, nq, 64), generator=gen, device=cuda_device).to(dtype)
        k = torch.randn((b, h, nk, 64), generator=gen, device=cuda_device).to(dtype)
        v = torch.randn((b, h, nk, 64), generator=gen, device=cuda_device).to(dtype)
        launches = flash_attn.LAUNCHES
        out, lse = flash_attn.flash_attention(q, k, v, 0.125)
        torch.cuda.synchronize()
        assert flash_attn.LAUNCHES == launches + 1
        ref_out, ref_lse = flash_attn.flash_attention_plain(q, k, v, 0.125)
        _assert_close(out.float().cpu(), ref_out.float().cpu().numpy(), tol)
        _assert_close(lse.cpu(), ref_lse.cpu().numpy(), 1e-3)
