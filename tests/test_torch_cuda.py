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


K3_TOKENS = (1, 63, 64, 65, 130, 196, 197, 256, 257, 640, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
def test_fused_attention_kernels_match_plain_on_card(dtype, tol):
    """K3a and K3b against their plain versions on the card, at every tile
    edge from 1 to the 1024-token cap and at the decoder's 576 slices of 197
    tokens, for scales 0.125, -0.125 and 0: out and dq/dk/dv normwise, lse
    within 1e-3; two calls of each bit-identical; one launch each a call.
    At N = 1 dq and dk vanish in exact arithmetic (a softmax over one key
    has no gradient) and both sides return rounding residue, so there they
    are held against the size of the terms that cancel: the same gradient
    with delta = 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from vista_slam_tpu_torch.kernels import attn_train as at

    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = [(2, 3, n, 64) for n in K3_TOKENS] + [(48, 12, 197, 64)]
    for shape in shapes:
        for scale in (0.125, -0.125, 0.0):
            q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                           for _ in range(4))
            launches = (at.LAUNCHES_FWD, at.LAUNCHES_BWD)
            out, lse = at.fused_attention_fwd(q, k, v, scale)
            delta = (do.float() * out.float()).sum(-1).reshape(-1, shape[2])
            got = at.fused_attention_bwd(q, k, v, do, lse, delta, scale)
            again = (*at.fused_attention_fwd(q, k, v, scale),
                     *at.fused_attention_bwd(q, k, v, do, lse, delta, scale))
            torch.cuda.synchronize()
            assert (at.LAUNCHES_FWD, at.LAUNCHES_BWD) == (launches[0] + 2, launches[1] + 2)
            for a, b in zip((out, lse, *got), again):
                assert torch.equal(a, b), (shape, scale)
            ref_out, ref_lse = at.fused_attention_fwd_plain(q, k, v, scale)
            want = at.fused_attention_bwd_plain(q, k, v, do, lse, delta, scale)
            floors = [1e-6] * 3
            if shape[2] == 1:
                cancel = at.fused_attention_bwd_plain(q, k, v, do, lse,
                                                      torch.zeros_like(delta), scale)
                floors[:2] = [max(c.float().abs().max().item(), 1e-6) for c in cancel[:2]]
            assert (lse - ref_lse).abs().max().item() <= 1e-3, (shape, scale)
            for g, w, floor in ((out, ref_out, 1e-6), *zip(got, want, floors)):
                assert g.dtype == dtype and torch.isfinite(g).all()
                err = (g.float() - w.float()).abs().max().item() / max(
                    w.float().abs().max().item(), floor)
                assert err <= tol, (shape, scale, err)


@pytest.mark.cuda
def test_int8_adamw_kernel_matches_plain_on_card():
    """K4 against its plain version on the card on a transposed (Linear)
    JAX-layout view: the kernel divides and rounds where the plain version
    does, so p and the scales agree exactly and the codes but for a handful
    one step apart (torch's and the kernel's exp/log)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from vista_slam_tpu_torch.kernels import adamw

    gen = torch.Generator(device="cuda").manual_seed(2)
    p = torch.randn((768, 1024), generator=gen, device="cuda")
    g = torch.randn((768, 1024), generator=gen, device="cuda") * 1e-2
    C = p.numel() // adamw.QBLOCK
    state = (torch.randint(-127, 128, (C, 1024), generator=gen, device="cuda",
                           dtype=torch.int8),
             torch.rand((C, 1), generator=gen, device="cuda") * 1e-4,
             torch.randint(0, 128, (C, 1024), generator=gen, device="cuda",
                           dtype=torch.int8),
             torch.rand((C, 1), generator=gen, device="cuda") * 1e-3)
    scalars = torch.tensor([0.7, 1e-3, 0.19, 0.0975], device="cuda")
    hp = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.05)
    mine, ref = [t.clone() for t in (p, *state)], [t.clone() for t in (p, *state)]
    launches = adamw.LAUNCHES_INT8
    adamw.fused_adamw_int8(mine[0].t(), g.t(), *mine[1:], scalars, **hp)
    torch.cuda.synchronize()
    assert adamw.LAUNCHES_INT8 == launches + 1
    adamw.fused_adamw_int8_plain(ref[0].t(), g.t(), *ref[1:], scalars, **hp)
    assert torch.equal(mine[0], ref[0])
    assert torch.equal(mine[2], ref[2]) and torch.equal(mine[4], ref[4])
    for a, b in ((mine[1], ref[1]), (mine[3], ref[3])):
        d = (a.int() - b.int()).abs()
        assert d.max().item() <= 1 and (d > 0).sum().item() <= 1e-4 * d.numel()
