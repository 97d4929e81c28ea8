#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (vista_slam_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:
  1. device  — nvidia-smi name and power limit, torch / CUDA versions;
  2. build   — kernel K1 (csrc/flash_attn_fwd.cu) compiled with nvcc for sm_90a;
  3. K1      — the kernel against its plain PyTorch version at every shape
               of the main path, bf16 and fp32: finiteness, max errors,
               kernel and plain times (CUDA events, median after warm-up);
  4. SVD     — the pose head's 9D SVD projection on the card against a
               float64 host reference and the Newton ('9D_stable') variant;
  5. agree   — a small fp32 STA forward on the card (kernel path) against
               the same weights on the CPU (plain path);
  6. slice   — configs/highres.yaml's model and SLAM settings at full
               width (24x1024 encoder, 12x768 decoder, 384x512 input),
               random weights from a seeded torch.Generator, stride-1
               keyframing over frames rendered in memory from a synthetic
               box scene, through the port's run_sequence and its final
               PGO; checks the keyframe count, a finite [V,4,4]
               trajectory and that every attention launched K1.
The second-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}. Without CUDA, or without the port next to
this file, it fails and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

# configs/highres.yaml (model section and SLAM settings), inlined so that
# the run needs no YAML parser; tests/test_torch_slam.py holds the two equal
HIGHRES = {
    "max_view_num": 400, "neighbor_edge_num": 3, "loop_edge_num": 3,
    "loop_dist_min": 40, "loop_nms": 40, "loop_cand_thresh_neighbor": 5,
    "point_conf_thres": 4.2, "rel_pose_thres": 0.75, "pgo_every": 500,
    "compute_dtype": "bfloat16", "random_seed": 43,
    "model": {"img_size": [384, 512], "use_flash": True},
}
N_FRAMES = 11  # stride-1 keyframing starts at frame 1: 10 keyframes

K1_SHAPES = (  # (q shape, Nk) at the main path's calls
    ((1, 16, 768, 64), 768),    # encoder, one frame
    ((8, 16, 768, 64), 768),    # encoder, batch of 8 keyframes
    ((2, 12, 769, 64), 769),    # decoder self/cross, 1 pair (both directions)
    ((16, 12, 769, 64), 769),   # decoder self/cross, 8 pairs
    ((2, 3, 130, 64), 260),     # Nq != Nk
)
K1_TIMED_AT = (16, 12, 769, 64)
TOL = {"bf16_out": 2e-2, "fp32_out": 1e-4, "lse": 1e-3}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 5, reps: int = 20) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def check_k1(card: str) -> dict:
    import torch

    from vista_slam_tpu_torch.kernels import flash_attn as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst_bf16, timed = 0.0, None
    for dtype in (torch.bfloat16, torch.float32):
        for qshape, nk in K1_SHAPES:
            B, H, Nq, D = qshape

            def rnd(*shape):
                return torch.randn(shape, generator=gen, device="cuda").to(dtype)

            q, k, v = rnd(B, H, Nq, D), rnd(B, H, nk, D), rnd(B, H, nk, D)
            scale = D ** -0.5
            out, lse = fa.flash_attention(q, k, v, scale)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa.flash_attention_plain(q, k, v, scale)
            if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
                raise AssertionError(f"K1 {dtype} {qshape}: non-finite output")
            err = (out.float() - ref_out.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            tol = TOL["bf16_out"] if dtype == torch.bfloat16 else TOL["fp32_out"]
            ms = cuda_ms(lambda: fa.flash_attention(q, k, v, scale))
            plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, scale))
            log(f"K1 {str(dtype)[6:]} q{list(qshape)} nk={nk}: out err {err:.3e} "
                f"(tol {tol:g}), lse err {lse_err:.3e} (tol {TOL['lse']:g}); "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]")
            if err > tol or lse_err > TOL["lse"]:
                raise AssertionError(f"K1 {dtype} {qshape}: out err {err} / lse "
                                     f"err {lse_err} over tolerance")
            if dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, err)
                if qshape == K1_TIMED_AT:
                    timed = (ms, plain_ms)
    return {"max_abs_err": worst_bf16, "ms": timed[0], "plain_ms": timed[1]}


def check_svd() -> None:
    import torch

    from vista_slam_tpu_torch.models.heads import (svd_orthogonalize,
                                                   svd_orthogonalize_stable)
    from vista_slam_tpu_torch.ops.sim3 import quat_to_matrix, so3_exp_quat

    gen = torch.Generator(device="cpu").manual_seed(1)
    m = torch.randn(4096, 9, generator=gen)
    got = svd_orthogonalize(m.cuda()).cpu().double()
    want = svd_orthogonalize(m.double())
    err = (got - want).abs().max().item()
    eye = torch.eye(3, dtype=torch.float64)
    orth = (got @ got.transpose(-1, -2) - eye).abs().max().item()
    det = (torch.linalg.det(got) - 1).abs().max().item()
    # near rotations (the trained-network regime) the Newton projection
    # agrees with the SVD one; elsewhere they differ, because the SVD path
    # row-normalises first (the JAX package's bar: atol 5e-3 at noise 0.01)
    rot = quat_to_matrix(so3_exp_quat(torch.randn(256, 3, generator=gen)))
    near = (rot + 0.01 * torch.randn(rot.shape, generator=gen)).cuda()
    newton = (svd_orthogonalize_stable(near) - svd_orthogonalize(near)).abs().max().item()
    log(f"SVD 9D on the card vs float64 host: max err {err:.3e}, |RR^T - I| "
        f"{orth:.3e}, |det - 1| {det:.3e}; 9D_stable vs 9D near rotations {newton:.3e}")
    if not (err < 1e-4 and orth < 1e-4 and det < 1e-4 and newton < 5e-3):
        raise AssertionError("pose-head SVD on the card disagrees")


def check_small_agreement() -> None:
    import torch

    from vista_slam_tpu_torch.kernels import flash_attn as fa
    from vista_slam_tpu_torch.models.sta import STA, STAConfig

    cfg = STAConfig(img_size=(64, 96), enc_dim=64, enc_depth=2, enc_heads=1,
                    dec_dim=128, dec_depth=4, dec_heads=2, mlp_ratio=2,
                    compute_dtype=torch.float32, use_flash=True)
    cpu = STA(cfg).init_weights_(torch.Generator().manual_seed(2)).eval()
    gpu = STA(cfg).cuda().eval()
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(3)
    imgs = [torch.rand(2, 64, 96, 3, generator=gen) * 2 - 1 for _ in range(2)]
    launches = fa.LAUNCHES
    with torch.inference_mode():
        want = cpu(*imgs)
        got = gpu(*[x.cuda() for x in imgs])
    if fa.LAUNCHES - launches != 2 * 2 + 2 * 4:
        raise AssertionError("small forward on the card did not run K1 at every attention")
    errs = {}
    for k in ("pts3d", "conf", "pose", "pose_conf"):
        g = got[k].cpu()
        if not torch.isfinite(g).all():
            raise AssertionError(f"small forward {k}: non-finite on the card")
        # normwise: max abs error over the tensor's largest magnitude
        errs[k] = ((g - want[k]).abs().max() / want[k].abs().max().clamp_min(1e-6)).item()
    log("small fp32 STA forward, card (K1) vs CPU (plain): normwise rel err "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if max(errs.values()) > 1e-3:
        raise AssertionError(f"small forward disagrees: {errs}")


def run_slice(card: str) -> int:
    import numpy as np
    import torch

    from vista_slam_tpu_torch.utils.synthetic_scene import BoxScene, orbit_trajectory
    from vista_slam_tpu_torch.cli.common import build_slam, select_stride_indices
    from vista_slam_tpu_torch.cli.run import PREFETCH_CHUNK, run_sequence
    from vista_slam_tpu_torch.kernels import flash_attn as fa
    from vista_slam_tpu_torch.ops import attention
    from vista_slam_tpu_torch.utils.config import make_config

    cfg = make_config(HIGHRES, keyframe_detection="stride", stride=1, device="cuda")
    h, w = cfg.model["img_size"]
    K = np.array([[400.0, 0, w / 2], [0, 400.0, h / 2], [0, 0, 1]])
    scene = BoxScene()
    frames = []
    for t, pose in enumerate(orbit_trajectory(60, radius=1.5)[:N_FRAMES]):
        rgb, _ = scene.render(pose, K, (h, w))
        frames.append({"rgb": (rgb * 2 - 1).astype(np.float32),
                       "gray": (rgb.mean(-1) * 255).astype(np.uint8),
                       "img_name": f"frame_{t}"})

    t0 = time.perf_counter()
    slam = build_slam(cfg)
    torch.cuda.synchronize()
    log(f"slice: model built in {time.perf_counter() - t0:.2f} s "
        f"({sum(p.numel() for p in slam.frontend.model.parameters()) / 1e6:.1f} M params)")
    mc = slam.frontend.cfg
    n_kf = len(select_stride_indices(N_FRAMES, cfg.stride, cfg.max_view_num))
    # every encode call (batched ahead in stride mode) runs enc_depth self-
    # attentions; every pair-decode call (one per keyframe after the first,
    # no loop closure without a vocabulary) dec_depth self + cross
    expected = (mc.enc_depth * math.ceil(n_kf / PREFETCH_CHUNK)
                + 2 * mc.dec_depth * (n_kf - 1))

    fa.reset_launches()
    attention.CALLS.update(flash=0, plain=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_sequence(slam, frames, cfg, progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, calls = fa.LAUNCHES, dict(attention.CALLS)

    traj = np.stack([slam.graph.view_pose_scale(v)[0] for v in range(slam.view_num)])
    td = slam.get_time_dict()
    log(f"slice: {slam.view_num} keyframes in {wall:.3f} s = "
        f"{slam.view_num / wall:.3f} keyframes/s (first run, cold), peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
    log("slice stage times (s, host clock): "
        + ", ".join(f"{k} {v:.3f}" for k, v in td.items()) + f" [{card}]")
    log(f"slice: K1 launches {launches} (expected {expected}), attention "
        f"paths {calls}, trajectory {list(traj.shape)}")
    if slam.view_num != n_kf:
        raise AssertionError(f"view_num {slam.view_num} != {n_kf} keyframes")
    if traj.shape != (n_kf, 4, 4) or not np.isfinite(traj).all():
        raise AssertionError("trajectory is not a finite [V,4,4] array")
    if launches != expected or calls != {"flash": expected, "plain": 0}:
        raise AssertionError(f"K1 launches {launches} / paths {calls}, "
                             f"expected {expected} flash launches only")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU", file=sys.stderr)
        return 2
    try:
        from vista_slam_tpu_torch.kernels import flash_attn as fa
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2

    # full fp32 in fp32 matmuls and convolutions (the heads' numerics)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = smi()
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    built = fa.load()
    log(f"build: K1 {built.path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {built.seconds:.2f} s)")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    k1 = check_k1(card)
    check_svd()
    check_small_agreement()
    launches = run_slice(card)

    log(json.dumps({"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "vista_slam_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "vista_slam_tpu/ops/pallas/flash.py:76",
        "launches": launches, "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "timed_at": f"bf16 {list(K1_TIMED_AT)}"}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
