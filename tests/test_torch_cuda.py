"""Card-only checks of the port's kernels that have no other test file
importable without jax (the GPU machine has no jax): they skip where torch
sees no CUDA device. Run there with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``."""

import pytest
import torch


@pytest.mark.cuda
def test_adamw_kernel_matches_plain_on_card():
    """K5 against its plain version on the card: the kernel rounds at the
    same points (no FMA contraction), so p, mu and nu agree exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from vista_slam_tpu_torch.kernels import adamw

    gen = torch.Generator(device="cuda").manual_seed(0)
    n = 1024 * 300
    p = torch.randn(n, generator=gen, device="cuda")
    g = torch.randn(n, generator=gen, device="cuda") * 1e-2
    mu = (torch.randn(n, generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
    nu = (torch.rand(n, generator=gen, device="cuda") * 1e-4).to(torch.bfloat16)
    scalars = torch.tensor([0.7, 1e-3, 0.19, 0.0975], device="cuda")
    mine, ref = [t.clone() for t in (p, mu, nu)], [t.clone() for t in (p, mu, nu)]
    hp = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.05)
    launches = adamw.LAUNCHES
    adamw.fused_adamw_bf16(*mine[:1], g, *mine[1:], scalars, **hp)
    torch.cuda.synchronize()
    assert adamw.LAUNCHES == launches + 1
    adamw.fused_adamw_bf16_plain(*ref[:1], g, *ref[1:], scalars, **hp)
    for a, b in zip(mine, ref):
        assert torch.equal(a, b)
