#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (vista_slam_tpu_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:
  1. device  — nvidia-smi name and power limit, torch / CUDA versions;
  2. build   — kernels K1 (csrc/flash_attn_fwd.cu), K2a/K2b
               (csrc/flash_attn_bwd.cu), K3a/K3b (csrc/attn_train.cu), K4
               (csrc/adamw_int8.cu) and K5 (csrc/adamw_bf16.cu), one nvcc
               each for sm_90a, all started together; ptxas register and
               spill lines;
  3. K1      — the kernel against its plain PyTorch version at every shape
               of the SLAM and training paths, bf16 and fp32: finiteness,
               max errors, kernel and plain times (CUDA events, median
               after warm-up);
  4. K2      — K2a (dq) and K2b (dk, dv) against their plain versions at
               the training path's shapes, bf16 and fp32, and their times;
  5. K5      — the fused bf16-moment AdamW against its plain version at the
               model's largest and smallest eligible leaves, and its times;
  5a. K3     — K3a (fused short-sequence attention forward) and K3b (its
               one-kernel backward) against their plain versions at the
               memory-knob training path's shapes and at N = 130, 256, 1024,
               bf16 and fp32, their times and bounds;
  5b. K4     — the int8-moment AdamW against its plain version on the
               memory-knob model's largest conv leaf, its largest Linear
               leaf (transposed JAX layout) and its smallest eligible leaf:
               p, codes and scales, differing codes counted; times, bound;
  6. SDPA    — torch's scaled_dot_product_attention forward and backward
               at the K1/K2/K3 timed shapes: a yardstick, never on the path;
  7. SVD     — the pose head's 9D SVD projection on the card against a
               float64 host reference and the Newton ('9D_stable') variant;
  8. agree   — a small fp32 STA forward on the card (kernel path) against
               the same weights on the CPU (plain path);
  9. train-agree — a small fp32 model trained 3 steps on the card (K1, K2a,
               K2b, K5) and on the CPU (plain versions) from the same
               weights and batches: losses, gradients, parameter updates;
               then the same for the memory-knob path (attn_fused_train and
               int8_fused: K3a, K3b, K4);
 10. slice   — configs/highres.yaml's model and SLAM settings at full
               width (24x1024 encoder, 12x768 decoder, 384x512 input),
               random weights from a seeded torch.Generator, stride-1
               keyframing over frames rendered in memory from a synthetic
               box scene, through the port's run_sequence and its final
               PGO; checks the keyframe count, a finite [V,4,4]
               trajectory and that every attention launched K1;
 11. train slice — the same model fine-tuned at 384x512 with
               configs/train_fast.yaml's hyper-parameters and the
               bf16_fused optimizer, batch 2 with 3 supports
               (vista_slam_tpu_torch/train/finetune.py), 4 steps
               through make_train_step: loss per step, ms per step, peak
               memory, finite loss and gradients, parameters moved by step
               3, and K1/K2a/K2b/K5 launch counts equal to those derived
               from the model, with no plain attention;
 12. memory-knob slice — configs/train_fast.yaml's 224x224 model at full
               width with its two memory knobs (attn_fused_train,
               int8_fused), batch 8 with 3 supports, 4 steps through
               make_train_step: the same readings, the optimizer state's
               bytes beside bf16 moments', and K3a/K3b/K4 launch counts
               equal to those derived from the model, with no K1/K2/K5 and
               no plain or flash attention.
Each launch count is set to 0 just before a path runs and read just after.
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

K1_SHAPES = (  # (q shape, Nk) at the main paths' calls
    ((1, 16, 768, 64), 768),    # SLAM encoder, one frame
    ((8, 16, 768, 64), 768),    # SLAM encoder, batch of 8 keyframes
    ((2, 12, 769, 64), 769),    # SLAM decoder self/cross, 1 pair (both directions)
    ((16, 12, 769, 64), 769),   # SLAM decoder self/cross, 8 pairs
    ((2, 16, 768, 64), 768),    # training encoder, the batch's main views
    ((6, 16, 768, 64), 768),    # training encoder, the batch's 3 x 2 supports
    ((12, 12, 769, 64), 769),   # training decoder, 6 pairs, both directions
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


TRAIN_STEPS = 4  # of the full-width fine-tune (vista_slam_tpu_torch/train/finetune.py)
K2_SHAPES = (  # (q shape, Nk) at the training slice's attention calls
    ((2, 16, 768, 64), 768),    # encoder, the batch's main views
    ((6, 16, 768, 64), 768),    # encoder, the batch's 3 x 2 support views
    ((12, 12, 769, 64), 769),   # decoder self/cross, 6 pairs, both directions
    ((2, 3, 130, 64), 260),     # Nq != Nk
)
K2_TIMED_AT = (12, 12, 769, 64)
# normwise: max abs error over the plain result's largest magnitude
K2_TOL = {"bf16": 2e-2, "fp32": 1e-4}
K5_TOL = {"p": 1e-6, "moments": 8e-3}  # normwise; bf16 moments: one ulp is 2^-8
H100 = {"bf16_flops": 989e12, "fp32_flops": 67e12, "bytes": 3.35e12}


def bound(flops: float, nbytes: float, peak: str = "bf16_flops") -> tuple[float, str]:
    """Least time on the card (ms) and what bounds it: the larger of the
    operations over the peak rate of their type and the bytes over the
    memory rate (H100 SXM data sheet, dense)."""
    t_ops, t_bytes = flops / H100[peak], nbytes / H100["bytes"]
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def attn_bounds(qshape, nk, itemsize: int) -> dict:
    """Bounds of K1, K2a and K2b at one shape: flops of the products,
    bytes of each input read once and each output written once."""
    B, H, Nq, D = qshape
    bh, qd, kd = B * H, B * H * Nq * D, B * H * nk * D
    rows = 4 * bh * Nq  # one fp32 per query row (lse, delta)
    return {
        "K1": bound(4 * bh * Nq * nk * D, itemsize * (2 * qd + 2 * kd) + rows),
        "K2a": bound(6 * bh * Nq * nk * D, itemsize * (3 * qd + 2 * kd) + 2 * rows),
        "K2b": bound(8 * bh * Nq * nk * D, itemsize * (2 * qd + 4 * kd) + 2 * rows),
    }


def check_k2(card: str) -> dict:
    import torch

    from vista_slam_tpu_torch.kernels import flash_attn as fa

    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {"K2a": 0.0, "K2b": 0.0}
    timed = {}
    for dtype, tname in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        for qshape, nk in K2_SHAPES:
            B, H, Nq, D = qshape

            def rnd(*shape):
                return torch.randn(shape, generator=gen, device="cuda").to(dtype)

            q, k, v, do = rnd(B, H, Nq, D), rnd(B, H, nk, D), rnd(B, H, nk, D), rnd(B, H, Nq, D)
            scale = D ** -0.5
            out, lse = fa.flash_attention(q, k, v, scale)
            delta = (do.float() * out.float()).sum(-1).reshape(B * H, Nq)
            args = (q, k, v, do, lse, delta, scale)
            dq = fa.flash_attention_bwd_dq(*args)
            dk, dv = fa.flash_attention_bwd_dkv(*args)
            torch.cuda.synchronize()
            ref = fa.flash_attention_bwd_plain(*args)
            errs, abs_errs = {}, {}
            for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
                if not torch.isfinite(got).all():
                    raise AssertionError(f"K2 {tname} {qshape} {name}: non-finite")
                e = (got.float() - want.float()).abs().max().item()
                abs_errs[name] = e
                errs[name] = e / max(want.float().abs().max().item(), 1e-6)
            ms_dq = cuda_ms(lambda: fa.flash_attention_bwd_dq(*args))
            ms_dkv = cuda_ms(lambda: fa.flash_attention_bwd_dkv(*args))
            plain_dq = cuda_ms(lambda: fa.flash_attention_bwd_dq_plain(*args))
            plain_dkv = cuda_ms(lambda: fa.flash_attention_bwd_dkv_plain(*args))
            tol = K2_TOL[tname]
            log(f"K2 {tname} q{list(qshape)} nk={nk}: normwise err "
                + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
                + f" (tol {tol:g}); K2a {ms_dq:.4f} ms vs plain {plain_dq:.4f} ms, "
                f"K2b {ms_dkv:.4f} ms vs plain {plain_dkv:.4f} ms [{card}]")
            if max(errs.values()) > tol:
                raise AssertionError(f"K2 {tname} {qshape}: errors {errs} over {tol}")
            if dtype == torch.bfloat16:
                worst["K2a"] = max(worst["K2a"], abs_errs["dq"])
                worst["K2b"] = max(worst["K2b"], abs_errs["dk"], abs_errs["dv"])
                if qshape == K2_TIMED_AT:
                    timed = {"K2a": (ms_dq, plain_dq), "K2b": (ms_dkv, plain_dkv)}
    return {name: {"max_abs_err": worst[name], "ms": timed[name][0],
                   "plain_ms": timed[name][1]} for name in worst}


def time_sdpa(card: str) -> dict:
    """Yardstick only, never on the port's path: one PyTorch
    scaled_dot_product_attention call forward, and its backward through
    autograd, at the K1, K2 and K3 timed shapes (bf16)."""
    import torch
    import torch.nn.functional as F

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(5)
    for tag, (qshape, nk) in (("fwd_K1", (K1_TIMED_AT, 769)), ("K2", (K2_TIMED_AT, 769)),
                              ("K3", (K3_TIMED_AT, K3_TIMED_AT[2]))):
        B, H, Nq, D = qshape
        q, k, v, do = (torch.randn(s, generator=gen, device="cuda").to(torch.bfloat16)
                       for s in ((B, H, Nq, D), (B, H, nk, D), (B, H, nk, D), (B, H, Nq, D)))
        fwd = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        o = F.scaled_dot_product_attention(qg, kg, vg)
        bwd = cuda_ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do, retain_graph=True))
        out[tag] = (fwd, bwd)
        log(f"SDPA (yardstick, not on the path) bf16 q{list(qshape)}: forward "
            f"{fwd:.4f} ms, backward {bwd:.4f} ms [{card}]")
    return {"K1": out["fwd_K1"][0], "K2_bwd": out["K2"][1], "K3a": out["K3"][0],
            "K3b": out["K3"][1]}


def k5_leaf_sizes() -> tuple[int, int]:
    """The largest and the smallest leaf of the training slice's model that
    K5 takes (numel >= 2048 and a multiple of 1024), from a meta-device
    build (shapes only)."""
    import torch

    from vista_slam_tpu_torch.models.sta import STA
    from vista_slam_tpu_torch.train import finetune
    from vista_slam_tpu_torch.train.quantized_opt import fused_eligible

    with torch.device("meta"):
        model = STA(finetune.model_config())
    sizes = [p.numel() for p in model.parameters() if fused_eligible(p)]
    return max(sizes), min(sizes)


def check_k5(card: str) -> dict:
    import torch

    from vista_slam_tpu_torch.kernels import adamw

    hp = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.05)
    gen = torch.Generator(device="cuda").manual_seed(6)
    result = {}
    for n in k5_leaf_sizes():
        p = torch.randn(n, generator=gen, device="cuda")
        g = torch.randn(n, generator=gen, device="cuda") * 1e-2
        mu = (torch.randn(n, generator=gen, device="cuda") * 1e-3).to(torch.bfloat16)
        nu = (torch.rand(n, generator=gen, device="cuda") * 1e-4).to(torch.bfloat16)
        scalars = torch.tensor([0.7, 1.5e-5, 1 - 0.9 ** 3, 1 - 0.95 ** 3], device="cuda")
        mine = [t.clone() for t in (p, mu, nu)]
        ref = [t.clone() for t in (p, mu, nu)]
        adamw.fused_adamw_bf16(mine[0], g, mine[1], mine[2], scalars, **hp)
        torch.cuda.synchronize()
        adamw.fused_adamw_bf16_plain(ref[0], g, ref[1], ref[2], scalars, **hp)
        errs, abs_err = {}, 0.0
        for name, got, want in zip(("p", "mu", "nu"), mine, ref):
            if not torch.isfinite(got).all():
                raise AssertionError(f"K5 n={n} {name}: non-finite")
            e = (got.float() - want.float()).abs().max().item()
            abs_err = max(abs_err, e)
            errs[name] = e / max(want.float().abs().max().item(), 1e-30)
        ms = cuda_ms(lambda: adamw.fused_adamw_bf16(p, g, mu, nu, scalars, **hp))
        plain_ms = cuda_ms(lambda: adamw.fused_adamw_bf16_plain(p, g, mu, nu, scalars, **hp))
        b_ms, b_by = bound(16 * n, 20 * n, "fp32_flops")
        log(f"K5 n={n}: normwise err " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
            + f" (tol p {K5_TOL['p']:g}, moments {K5_TOL['moments']:g}); kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) [{card}]")
        if errs["p"] > K5_TOL["p"] or max(errs["mu"], errs["nu"]) > K5_TOL["moments"]:
            raise AssertionError(f"K5 n={n}: errors {errs} over tolerance")
        if not result:  # the largest leaf is timed
            result = {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "n": n}
        result["max_abs_err"] = max(result["max_abs_err"], abs_err)
    return result


K3_SHAPES = (  # q = k = v shape at the memory-knob training path's calls, then other N
    (8, 16, 196, 64),    # encoder, the batch's 8 main views
    (24, 16, 196, 64),   # encoder, the batch's 3 x 8 support views
    (48, 12, 197, 64),   # decoder self/cross, 24 pairs, both directions
    (2, 4, 130, 64),     # ragged, one partial tile
    (2, 4, 256, 64),     # exactly four tiles
    (2, 4, 1024, 64),    # the fused path's cap
)
K3_TIMED_AT = (48, 12, 197, 64)
# forward: max abs error of out (as K1), lse; backward: normwise (as K2)
K3_TOL = {"bf16_out": 2e-2, "fp32_out": 1e-4, "lse": 1e-3, "bf16": 2e-2, "fp32": 1e-4}


def k3_bounds(shape, itemsize: int) -> dict:
    """Bounds of K3a and K3b at one shape: flops of the products (2 and 5
    N x N x D products), bytes of each input read once and each output
    written once (K3a: q, k, v -> out, lse; K3b: q, k, v, dO, lse, delta
    -> dq, dk, dv)."""
    B, H, N, D = shape
    panel, rows = itemsize * B * H * N * D, 4 * B * H * N
    return {"K3a": bound(4 * B * H * N * N * D, 4 * panel + rows),
            "K3b": bound(10 * B * H * N * N * D, 7 * panel + 2 * rows)}


def check_k3(card: str) -> dict:
    import torch

    from vista_slam_tpu_torch.kernels import attn_train as at

    gen = torch.Generator(device="cuda").manual_seed(9)
    worst = {"K3a": 0.0, "K3b": 0.0}
    timed = {}
    for dtype, tname in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        for shape in K3_SHAPES:
            B, H, N, D = shape
            q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                           for _ in range(4))
            scale = D ** -0.5
            out, lse = at.fused_attention_fwd(q, k, v, scale)
            delta = (do.float() * out.float()).sum(-1).reshape(B * H, N)
            args = (q, k, v, do, lse, delta, scale)
            grads = at.fused_attention_bwd(*args)
            torch.cuda.synchronize()
            ref_out, ref_lse = at.fused_attention_fwd_plain(q, k, v, scale)
            ref = at.fused_attention_bwd_plain(*args)
            for name, t in (("out", out), ("lse", lse), *zip(("dq", "dk", "dv"), grads)):
                if not torch.isfinite(t).all():
                    raise AssertionError(f"K3 {tname} {shape} {name}: non-finite")
            out_err = (out.float() - ref_out.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            errs, abs_err = {}, 0.0
            for name, got, want in zip(("dq", "dk", "dv"), grads, ref):
                e = (got.float() - want.float()).abs().max().item()
                abs_err = max(abs_err, e)
                errs[name] = e / max(want.float().abs().max().item(), 1e-6)
            line = (f"K3 {tname} q{list(shape)}: K3a out err {out_err:.3e} "
                    f"(tol {K3_TOL[tname + '_out']:g}), lse err {lse_err:.3e} (tol "
                    f"{K3_TOL['lse']:g}); K3b normwise "
                    + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
                    + f" (tol {K3_TOL[tname]:g})")
            if dtype == torch.bfloat16:  # the path's type is timed
                ms = (cuda_ms(lambda: at.fused_attention_fwd(q, k, v, scale)),
                      cuda_ms(lambda: at.fused_attention_fwd_plain(q, k, v, scale)),
                      cuda_ms(lambda: at.fused_attention_bwd(*args)),
                      cuda_ms(lambda: at.fused_attention_bwd_plain(*args)))
                b = k3_bounds(shape, 2)
                line += (f"; K3a {ms[0]:.4f} ms vs plain {ms[1]:.4f} (bound {b['K3a'][0]:.4f}),"
                         f" K3b {ms[2]:.4f} ms vs plain {ms[3]:.4f} (bound "
                         f"{b['K3b'][0]:.4f})")
                worst["K3a"] = max(worst["K3a"], out_err)
                worst["K3b"] = max(worst["K3b"], abs_err)
                if shape == K3_TIMED_AT:
                    timed = {"K3a": ms[:2], "K3b": ms[2:]}
            log(line + f" [{card}]")
            if (out_err > K3_TOL[tname + "_out"] or lse_err > K3_TOL["lse"]
                    or max(errs.values()) > K3_TOL[tname]):
                raise AssertionError(f"K3 {tname} {shape}: errors over tolerance")
    return {name: {"max_abs_err": worst[name], "ms": timed[name][0],
                   "plain_ms": timed[name][1]} for name in worst}


def k4_leaves() -> list:
    """(name, torch shape, JAX-layout permutation) of the memory-knob
    model's largest conv leaf, largest Linear leaf (a transposed layout) and
    smallest leaf that K4 takes, from a meta-device build (shapes only)."""
    import torch

    from vista_slam_tpu_torch.models.convert import jax_layouts
    from vista_slam_tpu_torch.models.sta import STA
    from vista_slam_tpu_torch.train import finetune
    from vista_slam_tpu_torch.train.quantized_opt import fused_eligible

    with torch.device("meta"):
        model = STA(finetune.model_config("memory_knob"))
    layouts = jax_layouts(model)
    leaves = [(n, tuple(p.shape), layouts[n]) for n, p in model.named_parameters()
              if fused_eligible(p)]
    size = lambda leaf: math.prod(leaf[1])
    conv = max((x for x in leaves if len(x[1]) == 4), key=size)
    linear = max((x for x in leaves if x[2] == (1, 0)), key=size)
    return [conv, linear, min(leaves, key=size)]


def check_k4(card: str) -> dict:
    """K4 against its plain version on the card. p and both scales must be
    bit-identical (the kernel rounds where the plain version rounds): at
    lr 1.5e-5 the whole update is ~3e-6 of max|p| and weight decay only a
    part of that, so a tolerance on p would let a wrong update through. A
    control run of the plain version without weight decay shows that this
    check sees that share. Codes that differ are counted, and more than one
    in 10^4, or any more than one step apart, fail."""
    import torch

    from vista_slam_tpu_torch.kernels import adamw

    hp = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.05)
    gen = torch.Generator(device="cuda").manual_seed(10)
    result = {}
    for name, shape, perm in k4_leaves():
        n = math.prod(shape)
        C = n // adamw.QBLOCK
        p = torch.randn(shape, generator=gen, device="cuda")
        g = torch.randn(shape, generator=gen, device="cuda") * torch.exp(
            torch.rand(shape, generator=gen, device="cuda") * 5 - 4)
        state = (torch.randint(-127, 128, (C, adamw.QBLOCK), generator=gen, device="cuda",
                               dtype=torch.int8),
                 torch.rand((C, 1), generator=gen, device="cuda") * 1e-4,
                 torch.randint(0, 128, (C, adamw.QBLOCK), generator=gen, device="cuda",
                               dtype=torch.int8),
                 torch.rand((C, 1), generator=gen, device="cuda") * 1e-3)
        scalars = torch.tensor([0.7, 1.5e-5, 1 - 0.9 ** 3, 1 - 0.95 ** 3], device="cuda")
        mine = [t.clone() for t in (p, *state)]
        ref = [t.clone() for t in (p, *state)]
        ctrl = [t.clone() for t in (p, *state)]
        adamw.fused_adamw_int8(mine[0].permute(perm), g.permute(perm), *mine[1:], scalars, **hp)
        torch.cuda.synchronize()
        adamw.fused_adamw_int8_plain(ref[0].permute(perm), g.permute(perm), *ref[1:], scalars,
                                     **hp)
        adamw.fused_adamw_int8_plain(ctrl[0].permute(perm), g.permute(perm), *ctrl[1:], scalars,
                                     **dict(hp, wd=0.0))
        if torch.equal(ctrl[0], ref[0]):
            raise AssertionError(f"K4 {name}: the p check cannot see weight decay")
        for t, what in zip(mine, ("p", "mu_q", "mu_s", "nu_q", "nu_s")):
            if not torch.isfinite(t.float()).all():
                raise AssertionError(f"K4 {name} {what}: non-finite")
        exact = {what: torch.equal(a, b)
                 for what, a, b in (("p", mine[0], ref[0]), ("mu_s", mine[2], ref[2]),
                                    ("nu_s", mine[4], ref[4]))}
        codes = {}
        for what, a, b in (("mu_q", mine[1], ref[1]), ("nu_q", mine[3], ref[3])):
            d = (a.int() - b.int()).abs()
            codes[what] = (int((d > 0).sum()), int(d.max()))
        args = (p.permute(perm), g.permute(perm), *state, scalars)
        ms = cuda_ms(lambda: adamw.fused_adamw_int8(*args, **hp))
        plain_ms = cuda_ms(lambda: adamw.fused_adamw_int8_plain(*args, **hp))
        # g, p read and p written (fp32), both codes read and written, four
        # fp32 scales a row; ~40 fp32 operations an element
        b_ms, b_by = bound(40 * n, 16 * n + 16 * C, "fp32_flops")
        p_err = (mine[0] - ref[0]).abs().max().item()
        log(f"K4 {name} {list(shape)} (JAX layout {list(perm)}, {n} params): "
            f"bit-identical {exact}, p max abs err {p_err:.3e}, codes differing "
            f"(count, max) {codes}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}) [{card}]")
        if (not all(exact.values()) or any(c[1] > 1 for c in codes.values())
                or sum(c[0] for c in codes.values()) > 1e-4 * n):
            raise AssertionError(f"K4 {name}: kernel and plain version disagree")
        if not result:  # the largest leaf is timed
            result = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "n": n}
        result["max_abs_err"] = max(result["max_abs_err"], p_err)
    return result


def check_svd(card: str) -> None:
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
        f"{orth:.3e}, |det - 1| {det:.3e}; 9D_stable vs 9D near rotations {newton:.3e} "
        f"[{card}]")
    if not (err < 1e-4 and orth < 1e-4 and det < 1e-4 and newton < 5e-3):
        raise AssertionError("pose-head SVD on the card disagrees")


def check_small_agreement(card: str) -> None:
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
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" [{card}]")
    if max(errs.values()) > 1e-3:
        raise AssertionError(f"small forward disagrees: {errs}")


def run_slice(card: str) -> int:
    import numpy as np
    import torch

    from vista_slam_tpu_torch.datasets.synthetic_scene import BoxScene, orbit_trajectory
    from vista_slam_tpu_torch.cli.common import build_slam, select_stride_indices
    from vista_slam_tpu_torch.cli.run import PREFETCH_CHUNK, run_sequence
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
        f"({sum(p.numel() for p in slam.frontend.model.parameters()) / 1e6:.1f} M params) "
        f"[{card}]")
    mc = slam.frontend.cfg
    n_kf = len(select_stride_indices(N_FRAMES, cfg.stride, cfg.max_view_num))
    # every encode call (batched ahead in stride mode) runs enc_depth self-
    # attentions; every pair-decode call (one per keyframe after the first,
    # no loop closure without a vocabulary) dec_depth self + cross
    expected = (mc.enc_depth * math.ceil(n_kf / PREFETCH_CHUNK)
                + 2 * mc.dec_depth * (n_kf - 1))

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run_sequence(slam, frames, cfg, progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, calls = launch_counts(), dict(attention.CALLS)
    launches = counts["K1"]

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
    if (counts != dict.fromkeys(counts, 0) | {"K1": expected}
            or calls != {"flash": expected, "plain": 0, "fused": 0}):
        raise AssertionError(f"launches {counts} / paths {calls}, "
                             f"expected {expected} flash launches only")
    return launches


def launch_counts() -> dict:
    """Every kernel's launch count so far."""
    from vista_slam_tpu_torch.kernels import adamw
    from vista_slam_tpu_torch.kernels import attn_train as at
    from vista_slam_tpu_torch.kernels import flash_attn as fa

    return {"K1": fa.LAUNCHES, "K2a": fa.LAUNCHES_DQ, "K2b": fa.LAUNCHES_DKV,
            "K3a": at.LAUNCHES_FWD, "K3b": at.LAUNCHES_BWD, "K4": adamw.LAUNCHES_INT8,
            "K5": adamw.LAUNCHES}


def reset_counts() -> None:
    """Every launch count and attention-path count to 0."""
    from vista_slam_tpu_torch.kernels import adamw
    from vista_slam_tpu_torch.kernels import attn_train as at
    from vista_slam_tpu_torch.kernels import flash_attn as fa
    from vista_slam_tpu_torch.ops import attention

    fa.reset_launches()
    at.reset_launches()
    adamw.reset_launches()
    attention.CALLS.update(flash=0, plain=0, fused=0)


# the kernels each training preset runs: attention forward, backward, optimizer
PATH_KERNELS = {"highres": ("K1", ("K2a", "K2b"), "K5"),
                "memory_knob": ("K3a", ("K3b",), "K4")}


def check_train_agree(card: str, preset: str) -> None:
    """A small fp32 train step of the preset's path on the card (highres:
    K1, K2a, K2b, K5; memory_knob: K3a, K3b, K4) against the same weights
    and batches on the CPU (plain versions), 3 steps. Held: the loss of
    every step (1e-4 relative); the step-1 gradients, taken at the same
    parameters on both sides, as one vector (1e-4 relative 2-norm) and per
    leaf (1e-2 normwise); and the parameter updates after 3 steps as one
    vector (1e-2 relative 2-norm: Adam moves an element by about lr
    whatever its gradient's size, so an element whose tiny gradient has the
    other sign on the card moves the other way; such elements are few, and
    so are int8 codes one step apart)."""
    import torch

    from vista_slam_tpu_torch.models.sta import STA
    from vista_slam_tpu_torch.train import finetune
    from vista_slam_tpu_torch.train.step import make_train_step

    cfg = finetune.model_config(preset, img_size=(64, 96), enc_dim=64, enc_depth=2,
                                enc_heads=1, dec_dim=128, dec_depth=2, dec_heads=2,
                                mlp_ratio=2, compute_dtype=torch.float32)
    batches = finetune.batches((64, 96), 3)
    runs = {}
    for dev in ("cpu", "cuda"):
        model = STA(cfg).init_weights_(torch.Generator().manual_seed(8))
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        # the lr reaches its peak 1e-4 at step 3 (warm-up 2 steps)
        step_fn = make_train_step(model, finetune.optimizer(1e-4, 2, 20, preset=preset),
                                  finetune.n_support(), device=dev)
        before = launch_counts()
        losses, grads = [], None
        for b in batches:
            losses.append(step_fn(b)[0].item())
            if grads is None:
                grads = {n: p.grad.cpu() for n, p in model.named_parameters()
                         if p.grad is not None}
        after = launch_counts()
        runs[dev] = (losses, grads,
                     {n: p.detach().cpu() - p0[n] for n, p in model.named_parameters()},
                     {k: after[k] - before[k] for k in after})
    (l_cpu, g_cpu, d_cpu, n_cpu), (l_gpu, g_gpu, d_gpu, n_gpu) = runs["cpu"], runs["cuda"]
    fwd, bwd, opt = PATH_KERNELS[preset]
    attn = 3 * 2 * (cfg.enc_depth + cfg.dec_depth)
    want = {k: attn if k in (fwd, *bwd) else 0 for k in n_gpu}
    if any(n_cpu.values()) or {k: v for k, v in n_gpu.items() if k != opt} != {
            k: v for k, v in want.items() if k != opt} or n_gpu[opt] == 0:
        raise AssertionError(f"train-agree {preset} launches: CPU {n_cpu}, card {n_gpu} "
                             f"(want none on the CPU; {attn} {fwd}/{'/'.join(bwd)}, some "
                             f"{opt} and nothing else on the card)")
    if set(g_gpu) != set(g_cpu) or not all(
            torch.isfinite(t).all() for d in (g_gpu, d_gpu) for t in d.values()):
        raise AssertionError(f"train-agree {preset}: gradients missing or non-finite "
                             "on the card")

    def rel2(got: dict, want: dict) -> float:
        num = sum(((got[n] - w) ** 2).sum() for n, w in want.items())
        return (num / sum((w ** 2).sum() for w in want.values())).sqrt().item()

    leaf = {n: ((g_gpu[n] - g).abs().max() / g.abs().max().clamp_min(1e-30)).item()
            for n, g in g_cpu.items()}
    worst = max(leaf, key=leaf.get)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    errs = {"loss": loss_err, "grads": rel2(g_gpu, g_cpu), "grad_leaf": leaf[worst],
            "updates": rel2(d_gpu, d_cpu)}
    log(f"train-agree {preset} (fp32, 3 steps, card kernels vs CPU plain): losses card "
        f"{[round(x, 6) for x in l_gpu]} cpu {[round(x, 6) for x in l_cpu]}, rel err "
        f"{loss_err:.2e} (tol 1e-4); step-1 grads rel 2-norm {errs['grads']:.2e} "
        f"(tol 1e-4), worst leaf {worst} normwise {leaf[worst]:.2e} (tol 1e-2); "
        f"updates after 3 steps rel 2-norm {errs['updates']:.2e} (tol 1e-2); "
        f"launches {n_gpu} [{card}]")
    tol = {"loss": 1e-4, "grads": 1e-4, "grad_leaf": 1e-2, "updates": 1e-2}
    if any(errs[k] > tol[k] for k in tol):
        raise AssertionError(f"train-agree {preset}: card and CPU disagree: {errs}")


def run_train_slice(card: str, preset: str) -> dict:
    """A training preset at full width (train/finetune.py), TRAIN_STEPS
    steps of the preset's batch through make_train_step: highres.yaml's
    384x512 model with bf16_fused AdamW, or train_fast.yaml's 224x224 model
    with attn_fused_train and int8_fused AdamW; train_fast's
    hyper-parameters."""
    import torch

    from vista_slam_tpu_torch.kernels.adamw import QBLOCK
    from vista_slam_tpu_torch.ops import attention
    from vista_slam_tpu_torch.train import finetune
    from vista_slam_tpu_torch.train.quantized_opt import FusedBf16Leaf, FusedInt8Leaf

    tag = f"train slice {preset}"
    cfg, S = finetune.model_config(preset), finetune.n_support()
    hw, batch = cfg.img_size, finetune.PRESETS[preset].batch
    t0 = time.perf_counter()
    batches = finetune.batches(hw, TRAIN_STEPS, batch=batch)
    log(f"{tag}: {TRAIN_STEPS} batches of {batch} x (1 main + {S} supports) at "
        f"{list(hw)} rendered in {time.perf_counter() - t0:.2f} s (host) [{card}]")
    t0 = time.perf_counter()
    model, opt, step_fn = finetune.build("cuda", preset=preset)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    fused = [(n, m) for (n, _), m in zip(model.named_parameters(), opt.moments)
             if isinstance(m, (FusedBf16Leaf, FusedInt8Leaf))]
    fwd, bwd, opt_k = PATH_KERNELS[preset]
    log(f"{tag}: model built in {time.perf_counter() - t0:.2f} s ({n_params / 1e6:.1f} M "
        f"fp32 params, {len(opt.moments)} leaves, {len(fused)} on {opt_k}) [{card}]")
    if preset == "memory_knob":
        # K4's state against bf16 moments for the same leaves (computed)
        n_fused = sum(m.mu_q.numel() for _, m in fused)
        int8 = sum(t.numel() * t.element_size() for _, m in fused for t in m)
        log(f"{tag}: optimizer state of the {n_fused} params on K4: {int8} bytes of int8 "
            f"codes + fp32 scales, against {4 * n_fused} bytes of bf16 moments "
            f"({int8 / (4 * n_fused):.4f} of them; {n_fused // QBLOCK} rows)")
    # the reference's unused skip unit gets no gradient and no update
    with_grad = sum("refinenet4.resConfUnit1" not in n for n, _ in fused)
    per_step = 2 * (cfg.enc_depth + cfg.dec_depth)  # attention calls per step
    expected = {k: 0 for k in launch_counts()}
    for k in (fwd, *bwd):
        expected[k] = per_step * TRAIN_STEPS
    expected[opt_k] = with_grad * TRAIN_STEPS
    route = "flash" if preset == "highres" else "fused"
    expected_calls = {"flash": 0, "plain": 0, "fused": 0, route: per_step * TRAIN_STEPS}
    first = {n: p.detach().clone() for n, p in model.named_parameters()}

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, times, moved = [], [], {}
    for k, b in enumerate(batches):
        t0 = time.perf_counter()
        loss, _ = step_fn(b, finetune.TRAIN["alpha_init"])
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss.item())
        grads_ok = torch.stack([torch.isfinite(p.grad).all() for p in model.parameters()
                                if p.grad is not None]).all().item()
        if not (math.isfinite(losses[-1]) and grads_ok):
            raise AssertionError(f"{tag} step {k + 1}: loss {losses[-1]}, finite "
                                 f"gradients {grads_ok}")
        moved[k + 1] = sum(not torch.equal(first[n], p) for n, p in model.named_parameters())
    launches, calls = launch_counts(), dict(attention.CALLS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = statistics.median(times[1:])
    log(f"{tag}: losses per step {losses}; ms per step {[round(t, 2) for t in times]} "
        f"(step 1 cold), median of steps 2-{TRAIN_STEPS} {ms:.2f} ms = "
        f"{batch * S / ms * 1e3:.2f} pairs/s; peak device memory {peak:.2f} GiB [{card}]")
    log(f"{tag}: params changed after each step {moved} (step 1 has lr 0); "
        f"launches {launches} (expected {expected}), attention paths {calls}")
    if moved[1] != 0 or moved[3] == 0:
        raise AssertionError(f"params changed per step {moved}: want none after "
                             "step 1 (lr 0) and some by step 3")
    if launches != expected or calls != expected_calls:
        raise AssertionError(f"{tag} launches {launches} / paths {calls}, expected "
                             f"{expected} / {expected_calls}")
    return {"launches": launches, "ms_per_step": ms, "peak_gib": peak}


KERNELS = {  # name, source, the TPU kernel it replaces
    "K1": ("flash_attn_fwd", "vista_slam_tpu_torch/csrc/flash_attn_fwd.cu",
           "vista_slam_tpu/ops/pallas/flash.py:76"),
    "K2a": ("flash_attn_bwd_dq", "vista_slam_tpu_torch/csrc/flash_attn_bwd.cu",
            "vista_slam_tpu/ops/pallas/flash.py:146"),
    "K2b": ("flash_attn_bwd_dkv", "vista_slam_tpu_torch/csrc/flash_attn_bwd.cu",
            "vista_slam_tpu/ops/pallas/flash.py:165"),
    "K3a": ("attn_train_fwd", "vista_slam_tpu_torch/csrc/attn_train.cu",
            "vista_slam_tpu/ops/pallas/attn_train.py:107"),
    "K3b": ("attn_train_bwd", "vista_slam_tpu_torch/csrc/attn_train.cu",
            "vista_slam_tpu/ops/pallas/attn_train.py:122"),
    "K4": ("adamw_int8", "vista_slam_tpu_torch/csrc/adamw_int8.cu",
           "vista_slam_tpu/ops/pallas/adam8.py:72"),
    "K5": ("adamw_bf16", "vista_slam_tpu_torch/csrc/adamw_bf16.cu",
           "vista_slam_tpu/ops/pallas/adam8.py:102"),
}


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
        from vista_slam_tpu_torch.kernels import adamw, build
        from vista_slam_tpu_torch.kernels import attn_train as at
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
    sources = [fa.SOURCE, fa.SOURCE_BWD, adamw.SOURCE, at.SOURCE, adamw.SOURCE_INT8]
    secs = build.build_many(sources)  # one nvcc per source, all at once
    log(f"build: {', '.join(f'{s} (nvcc {t:.2f} s)' for s, t in secs.items())} "
        f"in {time.perf_counter() - t0:.2f} s [{card}]")
    for lib in (fa.load(), fa.load_bwd(), adamw.load(), at.load(), adamw.load_int8()):
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {lib.path.name}: {line.strip()}")

    k1 = check_k1(card)
    k2 = check_k2(card)
    k5 = check_k5(card)
    k3 = check_k3(card)
    k4 = check_k4(card)
    sdpa = time_sdpa(card)
    check_svd(card)
    check_small_agreement(card)
    check_train_agree(card, "highres")
    check_train_agree(card, "memory_knob")
    slam_launches = run_slice(card)
    torch.cuda.empty_cache()
    train = run_train_slice(card, "highres")
    torch.cuda.empty_cache()
    knob = run_train_slice(card, "memory_knob")

    bounds = {**{k: v for k, v in attn_bounds(K1_TIMED_AT, 769, 2).items() if k == "K1"},
              **{k: v for k, v in attn_bounds(K2_TIMED_AT, 769, 2).items() if k != "K1"},
              **k3_bounds(K3_TIMED_AT, 2),
              "K4": (k4["bound_ms"], k4["bound_by"]),
              "K5": (k5["bound_ms"], k5["bound_by"])}
    timed = {"K1": dict(k1, library_ms=sdpa["K1"], timed_at=f"bf16 q{list(K1_TIMED_AT)}"),
             "K2a": dict(k2["K2a"], library_ms=None, timed_at=f"bf16 q{list(K2_TIMED_AT)}"),
             "K2b": dict(k2["K2b"], library_ms=None, timed_at=f"bf16 q{list(K2_TIMED_AT)}"),
             "K3a": dict(k3["K3a"], library_ms=sdpa["K3a"], timed_at=f"bf16 q{list(K3_TIMED_AT)}"),
             "K3b": dict(k3["K3b"], library_ms=sdpa["K3b"], timed_at=f"bf16 q{list(K3_TIMED_AT)}"),
             "K4": dict(max_abs_err=k4["max_abs_err"], ms=k4["ms"], plain_ms=k4["plain_ms"],
                        library_ms=None, timed_at=f"leaf of {k4['n']} params"),
             "K5": dict(max_abs_err=k5["max_abs_err"], ms=k5["ms"], plain_ms=k5["plain_ms"],
                        library_ms=None, timed_at=f"leaf of {k5['n']} params")}
    by_path = {k: {"slam": slam_launches if k == "K1" else 0,
                   "train": train["launches"][k],
                   "train_memory_knob": knob["launches"][k]} for k in KERNELS}
    log(f"SDPA backward (yardstick for K2a + K2b together, bf16 q{list(K2_TIMED_AT)}): "
        f"{sdpa['K2_bwd']:.4f} ms vs K2a + K2b {k2['K2a']['ms'] + k2['K2b']['ms']:.4f} ms "
        f"[{card}]")
    log(json.dumps({"kernels": [{
        "name": KERNELS[k][0], "route": "cuda", "source": KERNELS[k][1],
        "replaces": KERNELS[k][2], "launches": sum(by_path[k].values()),
        "launches_by_path": by_path[k], "max_abs_err": timed[k]["max_abs_err"],
        "ms": timed[k]["ms"], "plain_ms": timed[k]["plain_ms"],
        "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
        "library_ms": timed[k]["library_ms"], "timed_at": timed[k]["timed_at"]}
        for k in KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
