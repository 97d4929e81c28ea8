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
               of the SLAM and training paths, bf16 and fp32, and in bf16
               again with q and k scaled x8: finiteness, max errors; device
               times by CUDA-graph replay (graph_ms) of the kernel, its
               plain version and, in bf16, SDPA's forward; at the timed
               shape also the three one call per event pair, host work
               included (cuda_ms, the method of every kernel's "ms",
               "plain_ms" and "library_ms" in the kernels JSON);
  4. K2      — K2a (delta and dq) and K2b (dk, dv) against their plain
               versions at the training path's shapes, bf16 and fp32, K2a's
               delta against the torch sum, two calls bit-identical, in bf16
               also at scales -0.125, 0 and 1.0; times one call per event
               pair and, in bf16, device times by CUDA-graph replay of K2a,
               K2b and the whole flash backward beside SDPA's flash backward
               called alone, as a table;
  5. K5      — the fused bf16-moment AdamW against its plain version at the
               model's largest and smallest eligible leaves, and its times
               (at the largest also by CUDA-graph replay);
  5a. K3     — K3a (fused short-sequence attention forward) and K3b (its
               one-kernel backward) against their plain versions at the
               memory-knob training path's shapes and at N = 130, 256, 1024,
               bf16 and fp32, two calls of each bit-identical; their times
               one call per event pair and bounds; device times by
               CUDA-graph replay beside SDPA's forward and SDPA's flash
               backward called alone (K3b alone and with delta);
  5b. K4     — the int8-moment AdamW against its plain version on the
               memory-knob model's largest conv leaf, its largest Linear
               leaves of output widths 4096 and 768 (transposed JAX
               layouts), its largest transposed-conv leaf and its smallest
               eligible leaf, and on all five in one multi-leaf call where
               the tree has one: p and scales bit-identical, differing codes
               counted, a no-weight-decay control, two calls bit-identical;
               device times by CUDA-graph replay beside the bound;
  6. SDPA    — torch's scaled_dot_product_attention forward and backward
               at the K2/K3 timed shapes: a yardstick, never on the path;
               beside its backward at K2's shape, the port's whole flash
               backward (delta, K2a, K2b) timed the same way, through
               torch.autograd.grad, and both again by CUDA-graph replay;
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
               trajectory and that every attention launched K1; then,
               warm, one frame's encode and a batch-8 decode_pairs_fused
               (median of 10 calls each) with K1's launches per call and
               its estimated share of the call;
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
               equal to those derived from the model (K4: its passes per
               step where the tree updates all leaves at once, else one per
               leaf with a gradient), with no K1/K2/K5 and no plain or flash
               attention; K4's scratch and leaf-table bytes; after the
               steps, the K4 work of one step over every leaf as the
               optimizer runs it, once against the plain version leaf by
               leaf (as in 5b, with each leaf's weight decay; leaves
               without a gradient unchanged), then by CUDA-graph replay,
               and FusedAdamW.step() by event pair; before the steps,
               the first batch's loss forward only through K3a, K1, SDPA
               and K3's plain versions in bf16 and in fp32, their relative
               gaps printed beside the launch counts (a reading, not gated).
Each launch count is set to 0 just before a path runs and read just after.
The second-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}. Without CUDA, or without the port next to
this file, it fails and prints no result.
"""

from __future__ import annotations

import functools
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
# K1's q shape in the warm frontend calls: one frame's encode, a batch-8 decode
FRONTEND_SHAPES = {"encode": (1, 16, 768, 64), "decode": (16, 12, 769, 64)}
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


@functools.cache
def side_stream():
    """One stream for every graph_ms warm-up: each stream that runs a
    cuBLAS call keeps a workspace of its own, allocated, for the rest of
    the process (a new stream per timing raised the slices' peaks)."""
    import torch

    return torch.cuda.Stream()


def graph_ms(fn, reps: int = 20, inner: int = 10) -> float:
    """Device time per call: ``inner`` calls captured in one CUDA graph,
    replayed ``reps`` times between CUDA events, median over the replays.
    No host work is timed, so a kernel's time is its own even where the
    call's host overhead is longer than the kernel."""
    import torch

    side = side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    del graph
    return statistics.median(times)


def check_k1(card: str) -> dict:
    """K1 against its plain version at every K1 shape (bf16 and fp32; q and
    k scaled x8 in a second bf16 pass, so the logits are large), and its
    device time beside its plain version's and, in bf16, SDPA's forward;
    at the timed shape also the three one call per event pair."""
    import torch
    import torch.nn.functional as F

    from vista_slam_tpu_torch.kernels import flash_attn as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst_bf16, timed, bf16_ms = 0.0, None, {}
    for dtype, qk_mul in ((torch.bfloat16, 1.0), (torch.bfloat16, 8.0), (torch.float32, 1.0)):
        for qshape, nk in K1_SHAPES:
            B, H, Nq, D = qshape

            def rnd(*shape, mul=1.0):
                return (torch.randn(shape, generator=gen, device="cuda") * mul).to(dtype)

            q, k, v = rnd(B, H, Nq, D, mul=qk_mul), rnd(B, H, nk, D, mul=qk_mul), rnd(B, H, nk, D)
            scale = D ** -0.5
            out, lse = fa.flash_attention(q, k, v, scale)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa.flash_attention_plain(q, k, v, scale)
            if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
                raise AssertionError(f"K1 {dtype} {qshape}: non-finite output")
            err = (out.float() - ref_out.float()).abs().max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            tol = TOL["bf16_out"] if dtype == torch.bfloat16 else TOL["fp32_out"]
            tag = f"K1 {str(dtype)[6:]} q{list(qshape)} nk={nk}" + (
                f" (q, k x{qk_mul:g})" if qk_mul != 1 else "")
            if err > tol or lse_err > TOL["lse"]:
                raise AssertionError(f"{tag}: out err {err} / lse err {lse_err} over "
                                     "tolerance")
            if dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, err)
            if qk_mul != 1:
                log(f"{tag}: out err {err:.3e} (tol {tol:g}), lse err {lse_err:.3e} "
                    f"(tol {TOL['lse']:g}) [{card}]")
                continue
            ms = graph_ms(lambda: fa.flash_attention(q, k, v, scale))
            plain_ms = graph_ms(lambda: fa.flash_attention_plain(q, k, v, scale),
                                reps=5, inner=3)
            line = (f"{tag}: out err {err:.3e} (tol {tol:g}), lse err {lse_err:.3e} "
                    f"(tol {TOL['lse']:g}); device ms (CUDA-graph replay): kernel "
                    f"{ms:.4f}, plain {plain_ms:.4f}")
            if dtype == torch.bfloat16:
                sdpa_ms = graph_ms(lambda: F.scaled_dot_product_attention(q, k, v))
                line += f", SDPA forward {sdpa_ms:.4f} (K1 / SDPA {ms / sdpa_ms:.3f})"
                bf16_ms[qshape] = ms
                if qshape == K1_TIMED_AT:
                    # one call between two events, host work included: the
                    # method of every kernel's times in the kernels JSON
                    single = [cuda_ms(fn) for fn in (
                        lambda: fa.flash_attention(q, k, v, scale),
                        lambda: fa.flash_attention_plain(q, k, v, scale),
                        lambda: F.scaled_dot_product_attention(q, k, v))]
                    timed = {"ms": single[0], "plain_ms": single[1], "library_ms": single[2],
                             "graph_ms": ms, "library_graph_ms": sdpa_ms}
                    line += ("; one call per event pair: kernel {:.4f}, plain {:.4f}, SDPA "
                             "forward {:.4f} (K1 / SDPA {:.3f})").format(
                                 *single, single[0] / single[2])
            log(line + f" [{card}]")
    return {"max_abs_err": worst_bf16, **timed, "bf16_ms": bf16_ms}


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


def k2_calls(fa, q, k, v, out, do, lse, scale: float) -> dict:
    """Closures over one input set: "K2a" (dq and delta), "K2b", "bwd" (the
    whole flash backward: delta, K2a, K2b) and their plain versions;
    "delta" is the one K2b is given."""
    a = (q, k, v, out, do, lse, scale)
    delta = fa.flash_attention_bwd_dq(*a)[1]
    b = (q, k, v, do, lse, delta, scale)
    return {"K2a": lambda: fa.flash_attention_bwd_dq(*a),
            "K2a_plain": lambda: fa.flash_attention_bwd_dq_plain(*a),
            "K2b": lambda: fa.flash_attention_bwd_dkv(*b),
            "K2b_plain": lambda: fa.flash_attention_bwd_dkv_plain(*b),
            "bwd": lambda: fa.flash_attention_bwd(*a),
            "bwd_plain": lambda: fa.flash_attention_bwd_plain(*a), "delta": delta}


def k2_errors(got, want) -> dict:
    """Normwise errors of (dq, dk, dv): max abs error over the plain
    result's largest magnitude; non-finite output fails."""
    errs = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        if not g.isfinite().all():
            raise AssertionError(f"K2 {name}: non-finite")
        errs[name] = ((g.float() - w.float()).abs().max()
                      / w.float().abs().max().clamp_min(1e-6)).item()
    return errs


def check_k2(card: str) -> dict:
    """K2a and K2b against their plain versions at every K2 shape, bf16 and
    fp32; K2a's delta against the torch sum rowsum(dO * O) (1e-5 normwise);
    two calls bit-identical; in bf16 at two shapes also scales -0.125, 0
    and 1.0. Times: one call per event pair (the JSON's "ms") and, in bf16,
    device times by CUDA-graph replay of K2a, K2b and the whole flash
    backward beside SDPA's flash backward called alone (which computes its
    delta itself), printed as a table."""
    import torch

    from vista_slam_tpu_torch.kernels import flash_attn as fa

    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = {"K2a": 0.0, "K2b": 0.0}
    timed, table = {}, []
    for dtype, tname in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        for qshape, nk in K2_SHAPES:
            B, H, Nq, D = qshape

            def rnd(*shape):
                return torch.randn(shape, generator=gen, device="cuda").to(dtype)

            q, k, v, do = rnd(B, H, Nq, D), rnd(B, H, nk, D), rnd(B, H, nk, D), rnd(B, H, Nq, D)
            scale = D ** -0.5
            out, lse = fa.flash_attention(q, k, v, scale)
            calls = k2_calls(fa, q, k, v, out, do, lse, scale)
            got, again = calls["bwd"](), calls["bwd"]()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"K2 {tname} {qshape}: two calls differ")
            want_delta = fa.delta_plain(do, out)
            delta_err = ((calls["delta"] - want_delta).abs().max()
                         / want_delta.abs().max()).item()
            ref = calls["bwd_plain"]()
            errs = k2_errors(got, ref)
            abs_errs = {n: (g.float() - w.float()).abs().max().item()
                        for n, g, w in zip(("dq", "dk", "dv"), got, ref)}
            ms_dq, ms_dkv = cuda_ms(calls["K2a"]), cuda_ms(calls["K2b"])
            plain_dq, plain_dkv = cuda_ms(calls["K2a_plain"]), cuda_ms(calls["K2b_plain"])
            tol = K2_TOL[tname]
            log(f"K2 {tname} q{list(qshape)} nk={nk}: normwise err "
                + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
                + f" (tol {tol:g}), delta {delta_err:.2e} (tol 1e-5), two calls "
                f"bit-identical; one call per event pair: K2a {ms_dq:.4f} ms vs plain "
                f"{plain_dq:.4f} ms, K2b {ms_dkv:.4f} ms vs plain {plain_dkv:.4f} ms [{card}]")
            if max(errs.values()) > tol or delta_err > 1e-5:
                raise AssertionError(f"K2 {tname} {qshape}: errors {errs}, delta "
                                     f"{delta_err} over tolerance")
            if dtype != torch.bfloat16:
                continue
            worst["K2a"] = max(worst["K2a"], abs_errs["dq"])
            worst["K2b"] = max(worst["K2b"], abs_errs["dk"], abs_errs["dv"])
            g = {name: graph_ms(calls[name]) for name in ("K2a", "K2b", "bwd")}
            g["sdpa"] = graph_ms(sdpa_backward(q, k, v, do, scale))
            b = attn_bounds(qshape, nk, 2)
            table.append(f"| q{list(qshape)} nk={nk} | {g['K2a']:.4f} | {g['K2b']:.4f} | "
                         f"{g['bwd']:.4f} | {g['sdpa']:.4f} | {g['bwd'] / g['sdpa']:.3f} | "
                         f"{b['K2a'][0]:.4f} | {b['K2b'][0]:.4f} |")
            if qshape == K2_TIMED_AT:
                timed = {"K2a": (ms_dq, plain_dq, g["K2a"]), "K2b": (ms_dkv, plain_dkv, g["K2b"])}
            if nk in (769, 260):  # the 16-wide tails and Nq != Nk, at any scale
                for other in (-0.125, 0.0, 1.0):
                    o2, lse2 = fa.flash_attention(q, k, v, other)
                    c2 = k2_calls(fa, q, k, v, o2, do, lse2, other)
                    e2 = k2_errors(c2["bwd"](), c2["bwd_plain"]())
                    log(f"K2 bf16 q{list(qshape)} nk={nk} scale {other:g}: normwise err "
                        + ", ".join(f"{n} {e:.2e}" for n, e in e2.items())
                        + f" (tol {tol:g}) [{card}]")
                    if max(e2.values()) > tol:
                        raise AssertionError(f"K2 scale {other} {qshape}: errors {e2}")
    log("K2, bf16 device ms by CUDA-graph replay (the whole backward: delta, K2a, K2b "
        f"as this tree computes them), SDPA's flash backward called alone [{card}]:\n"
        "| shape | K2a | K2b | whole backward | SDPA flash bwd | whole/SDPA | K2a bound "
        "| K2b bound |\n|---|---|---|---|---|---|---|---|\n" + "\n".join(table))
    return {name: {"max_abs_err": worst[name], "ms": timed[name][0],
                   "plain_ms": timed[name][1], "graph_ms": timed[name][2]} for name in worst}


def time_sdpa(card: str) -> dict:
    """Yardstick only, never on the port's path: one PyTorch
    scaled_dot_product_attention call forward, and its backward through
    autograd, at the K2 and K3 timed shapes (bf16), one call per event pair;
    beside SDPA's backward at K2's shape, the port's whole flash backward
    timed the same way (torch.autograd.grad through FlashAttention: delta,
    K2a and K2b), and both again by CUDA-graph replay (delta, K2a and K2b
    against SDPA's flash backward called alone). That the autograd pair
    computes one function: the backend SDPA picks there, and both
    gradients' normwise errors against K2's plain versions on K1's out."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    from vista_slam_tpu_torch.kernels import flash_attn as fa
    from vista_slam_tpu_torch.ops.attention import FlashAttention

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(5)
    for tag, (qshape, nk) in (("K2", (K2_TIMED_AT, 769)),
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
        if tag == "K2":
            scale = D ** -0.5
            of = FlashAttention.apply(qg, kg, vg, scale)
            port = cuda_ms(lambda: torch.autograd.grad(of, (qg, kg, vg), do,
                                                       retain_graph=True))
            out["K2_port"] = port
            o_p, lse_p = fa.flash_attention(q, k, v, scale)
            calls = k2_calls(fa, q, k, v, o_p, do, lse_p, scale)
            want = calls["bwd_plain"]()
            errs = {name: k2_errors(torch.autograd.grad(y, (qg, kg, vg), do,
                                                        retain_graph=True), want)
                    for name, y in (("SDPA", o), ("port", of))}
            backend = SDPBackend(torch._fused_sdp_choice(qg, kg, vg)).name
            log(f"K2 like for like, bf16 q{list(qshape)}, torch.autograd.grad with host "
                f"work included: the port's flash backward (delta, K2a, K2b) {port:.4f} "
                f"ms vs SDPA's backward {bwd:.4f} ms ({port / bwd:.2f}x); SDPA's backend "
                f"{backend}; normwise errors against K2's plain versions on K1's out: "
                + "; ".join(f"{name} " + ", ".join(f"{n} {x:.2e}" for n, x in by.items())
                            for name, by in errs.items()) + f" [{card}]")
            # device time: the same two backwards by CUDA-graph replay
            port_g = graph_ms(calls["bwd"])
            sdpa_g = graph_ms(sdpa_backward(q, k, v, do, scale))
            out["K2_graph"] = (port_g, sdpa_g)
            log(f"K2 like for like, bf16 q{list(qshape)}, device ms by CUDA-graph replay: "
                f"the port's flash backward (delta, K2a, K2b) {port_g:.4f} vs SDPA's flash "
                f"backward {sdpa_g:.4f} ({port_g / sdpa_g:.2f}x) [{card}]")
    return {"K2_bwd": out["K2"][1], "K2_port": out["K2_port"], "K2_graph": out["K2_graph"],
            "K3a": out["K3"][0], "K3b": out["K3"][1]}


def sdpa_backward(q, k, v, do, scale: float, out=None, lse=None):
    """SDPA's flash-attention backward alone, as one call for graph replay:
    aten's op, called directly after its forward has run once here. It
    computes rowsum(dO * O) itself, so the port's like-for-like time is
    delta + its backward kernels. With ``out`` and ``lse`` (K1's, lse
    [B*H, Nq] in natural log as FlashAttention-2's) it differentiates
    through them instead of its own forward's. A yardstick, never on the
    port's path."""
    import torch

    fwd = torch.ops.aten._scaled_dot_product_flash_attention(q, k, v, 0.0, False, False,
                                                             scale=scale)
    o, logsumexp, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]
    if out is not None:
        o, logsumexp = out, logsumexp.clone()
        logsumexp[..., :q.shape[2]] = lse.view(*q.shape[:3])
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        do, q, k, v, o, logsumexp, cum_q, cum_k, max_q, max_k, 0.0, False, seed, offset,
        scale=scale)


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
        line = (f"K5 n={n}: normwise err " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
                + f" (tol p {K5_TOL['p']:g}, moments {K5_TOL['moments']:g}); one call per "
                f"event pair: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms "
                f"({b_by})")
        if errs["p"] > K5_TOL["p"] or max(errs["mu"], errs["nu"]) > K5_TOL["moments"]:
            raise AssertionError(f"K5 n={n}: errors {errs} over tolerance")
        if not result:  # the largest leaf is timed, also by CUDA-graph replay
            g_ms = graph_ms(lambda: adamw.fused_adamw_bf16(p, g, mu, nu, scalars, **hp))
            line += (f"; device ms (CUDA-graph replay) {g_ms:.4f} ({b_ms / g_ms:.3f} of the "
                     "bound's rate)")
            result = {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by, "n": n, "graph_ms": g_ms}
        log(line + f" [{card}]")
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
    """K3a and K3b against their plain versions at every K3 shape (bf16 and
    fp32), two calls of each bit-identical; in bf16 their times one call per
    event pair (as PRs 3-4) and device times by CUDA-graph replay: K3a
    beside SDPA's forward, K3b and delta + K3b beside SDPA's flash backward
    called alone (which computes its delta itself)."""
    import torch
    import torch.nn.functional as F

    from vista_slam_tpu_torch.kernels import attn_train as at
    from vista_slam_tpu_torch.kernels import flash_attn as fa

    gen = torch.Generator(device="cuda").manual_seed(9)
    worst = {"K3a": 0.0, "K3b": 0.0}
    timed, graphs = {}, {}
    for dtype, tname in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        for shape in K3_SHAPES:
            B, H, N, D = shape
            q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                           for _ in range(4))
            scale = D ** -0.5
            out, lse = at.fused_attention_fwd(q, k, v, scale)
            args = (q, k, v, do, lse, fa.delta_plain(do, out), scale)
            grads = at.fused_attention_bwd(*args)
            again = (*at.fused_attention_fwd(q, k, v, scale), *at.fused_attention_bwd(*args))
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip((out, lse, *grads), again)):
                raise AssertionError(f"K3 {tname} {shape}: two calls differ")
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
                    + f" (tol {K3_TOL[tname]:g}); two calls bit-identical")
            if dtype == torch.bfloat16:  # the path's type is timed
                ms = (cuda_ms(lambda: at.fused_attention_fwd(q, k, v, scale)),
                      cuda_ms(lambda: at.fused_attention_fwd_plain(q, k, v, scale)),
                      cuda_ms(lambda: at.fused_attention_bwd(*args)),
                      cuda_ms(lambda: at.fused_attention_bwd_plain(*args)))
                g = {"K3a": graph_ms(lambda: at.fused_attention_fwd(q, k, v, scale)),
                     "K3b": graph_ms(lambda: at.fused_attention_bwd(*args)),
                     "delta_K3b": graph_ms(lambda: at.fused_attention_bwd(
                         q, k, v, do, lse, fa.delta_plain(do, out), scale)),
                     "sdpa_fwd": graph_ms(lambda: F.scaled_dot_product_attention(
                         q, k, v, scale=scale)),
                     "sdpa_bwd": graph_ms(sdpa_backward(q, k, v, do, scale))}
                graphs[shape] = g
                b = k3_bounds(shape, 2)
                line += (f"; one call per event pair: K3a {ms[0]:.4f} ms vs plain {ms[1]:.4f}"
                         f" (bound {b['K3a'][0]:.4f}), K3b {ms[2]:.4f} ms vs plain "
                         f"{ms[3]:.4f} (bound {b['K3b'][0]:.4f}); device ms (CUDA-graph "
                         f"replay): K3a {g['K3a']:.4f} vs SDPA forward {g['sdpa_fwd']:.4f} "
                         f"({g['K3a'] / g['sdpa_fwd']:.3f}x), K3b {g['K3b']:.4f}, delta + K3b "
                         f"{g['delta_K3b']:.4f} vs SDPA flash backward {g['sdpa_bwd']:.4f} "
                         f"({g['delta_K3b'] / g['sdpa_bwd']:.3f}x)")
                worst["K3a"] = max(worst["K3a"], out_err)
                worst["K3b"] = max(worst["K3b"], abs_err)
                if shape == K3_TIMED_AT:
                    timed = {"K3a": ms[:2] + (g["K3a"], g["sdpa_fwd"]),
                             "K3b": ms[2:] + (g["K3b"], g["sdpa_bwd"])}
            log(line + f" [{card}]")
            if (out_err > K3_TOL[tname + "_out"] or lse_err > K3_TOL["lse"]
                    or max(errs.values()) > K3_TOL[tname]):
                raise AssertionError(f"K3 {tname} {shape}: errors over tolerance")
    result = {name: {"max_abs_err": worst[name], "ms": timed[name][0],
                     "plain_ms": timed[name][1], "graph_ms": timed[name][2],
                     "library_graph_ms": timed[name][3]} for name in worst}
    result["K3b"]["graph_ms_with_delta"] = graphs[K3_TIMED_AT]["delta_K3b"]
    return result


def k4_leaves() -> list:
    """(class, torch shape, JAX-layout permutation) of the memory-knob
    model's leaves that K4 is checked and timed on, from a meta-device build
    (shapes only): the largest conv leaf, the largest Linear leaves with
    output widths 4096 and 768 (transposed layouts; 768-wide rows straddle
    two inputs), the largest transposed-conv leaf and the smallest leaf K4
    takes."""
    import torch

    from vista_slam_tpu_torch.models.convert import jax_layouts
    from vista_slam_tpu_torch.models.sta import STA
    from vista_slam_tpu_torch.train import finetune
    from vista_slam_tpu_torch.train.quantized_opt import fused_eligible

    with torch.device("meta"):
        model = STA(finetune.model_config("memory_knob"))
    layouts = jax_layouts(model)
    leaves = [(tuple(p.shape), layouts[n]) for n, p in model.named_parameters()
              if fused_eligible(p)]

    def largest(name, keep):
        return (name, *max((x for x in leaves if keep(x)), key=lambda x: math.prod(x[0])))

    return [largest("conv", lambda x: x[1] == (2, 3, 1, 0)),
            largest("Linear out 4096", lambda x: x[1] == (1, 0) and x[0][0] == 4096),
            largest("Linear out 768", lambda x: x[1] == (1, 0) and x[0][0] == 768),
            largest("ConvTranspose", lambda x: x[1] == (0, 2, 3, 1)),
            ("smallest", *min(leaves, key=lambda x: math.prod(x[0])))]


K4_HP = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.05)


def k4_bound(n: int) -> tuple[float, str]:
    """K4's bound for n parameters: g, p read and p written (fp32), both
    codes read and written, four fp32 scales a row; ~40 fp32 operations an
    element."""
    return bound(40 * n, 16 * n + 16 * (n // 1024), "fp32_flops")


def k4_inputs(gen, shape, perm) -> tuple:
    """p, g (torch layout) and a random int8 state for one leaf."""
    import torch

    from vista_slam_tpu_torch.kernels import adamw

    C = math.prod(shape) // adamw.QBLOCK
    p = torch.randn(shape, generator=gen, device="cuda")
    g = torch.randn(shape, generator=gen, device="cuda") * torch.exp(
        torch.rand(shape, generator=gen, device="cuda") * 5 - 4)
    state = (torch.randint(-127, 128, (C, adamw.QBLOCK), generator=gen, device="cuda",
                           dtype=torch.int8),
             torch.rand((C, 1), generator=gen, device="cuda") * 1e-4,
             torch.randint(0, 128, (C, adamw.QBLOCK), generator=gen, device="cuda",
                           dtype=torch.int8),
             torch.rand((C, 1), generator=gen, device="cuda") * 1e-3)
    return p, g, state


def k4_diff(tag: str, mine, ref, n: int) -> tuple[dict, dict, float, bool]:
    """K4's result against the plain version's: whether p and both scales
    are bit-identical, the (count, max step) of differing codes, p's max
    error, and whether that agrees: p and the scales bit-identical, codes at
    most one step apart in at most one of 10^4."""
    import torch

    for t, what in zip(mine, ("p", "mu_q", "mu_s", "nu_q", "nu_s")):
        if not torch.isfinite(t.float()).all():
            raise AssertionError(f"{tag} {what}: non-finite")
    exact = {what: torch.equal(a, b)
             for what, a, b in (("p", mine[0], ref[0]), ("mu_s", mine[2], ref[2]),
                                ("nu_s", mine[4], ref[4]))}
    codes = {}
    for what, a, b in (("mu_q", mine[1], ref[1]), ("nu_q", mine[3], ref[3])):
        d = (a.int() - b.int()).abs()
        codes[what] = (int((d > 0).sum()), int(d.max()))
    p_err = (mine[0] - ref[0]).abs().max().item()
    ok = (all(exact.values()) and all(c[1] <= 1 for c in codes.values())
          and sum(c[0] for c in codes.values()) <= 1e-4 * n)
    return exact, codes, p_err, ok


def k4_compare(tag: str, mine, ref, n: int) -> float:
    """k4_diff, printed; fails unless it agrees. Returns p's max error."""
    exact, codes, p_err, ok = k4_diff(tag, mine, ref, n)
    log(f"{tag}: bit-identical {exact}, p max abs err {p_err:.3e}, codes differing "
        f"(count, max) {codes}")
    if not ok:
        raise AssertionError(f"{tag}: kernel and plain version disagree")
    return p_err


def check_k4(card: str) -> dict:
    """K4 against its plain version on the card, on each leaf of k4_leaves
    and, where the tree has the multi-leaf entry, on all of them in one
    call (k4_compare). At lr 1.5e-5 the whole update is ~3e-6 of max|p| and
    weight decay only a part of that, so a tolerance on p would let a wrong
    update through; a control run of the plain version without weight
    decay shows that the check sees that share. Two calls are
    bit-identical. Times per leaf: one call per event pair (host work
    included; the JSON's "ms", at the conv leaf) and by CUDA-graph replay
    (graph_ms, device time), beside the bound."""
    import torch

    from vista_slam_tpu_torch.kernels import adamw

    gen = torch.Generator(device="cuda").manual_seed(10)
    scalars = torch.tensor([0.7, 1.5e-5, 1 - 0.9 ** 3, 1 - 0.95 ** 3], device="cuda")
    result, graphs, many = {}, {}, []
    for name, shape, perm in k4_leaves():
        n = math.prod(shape)
        p, g, state = k4_inputs(gen, shape, perm)
        mine, again, ref, ctrl = ([t.clone() for t in (p, *state)] for _ in range(4))
        for out in (mine, again):
            adamw.fused_adamw_int8(out[0].permute(perm), g.permute(perm), *out[1:], scalars,
                                   **K4_HP)
        torch.cuda.synchronize()
        adamw.fused_adamw_int8_plain(ref[0].permute(perm), g.permute(perm), *ref[1:], scalars,
                                     **K4_HP)
        adamw.fused_adamw_int8_plain(ctrl[0].permute(perm), g.permute(perm), *ctrl[1:], scalars,
                                     **dict(K4_HP, wd=0.0))
        if torch.equal(ctrl[0], ref[0]):
            raise AssertionError(f"K4 {name}: the p check cannot see weight decay")
        if not all(torch.equal(a, b) for a, b in zip(mine, again)):
            raise AssertionError(f"K4 {name}: two calls differ")
        tag = f"K4 {name} {list(shape)} (JAX layout {list(perm)}, {n} params)"
        p_err = k4_compare(tag, mine, ref, n)
        many.append((shape, perm, p, g, state))
        args = (p.permute(perm), g.permute(perm), *state, scalars)
        ms = cuda_ms(lambda: adamw.fused_adamw_int8(*args, **K4_HP))
        plain_ms = cuda_ms(lambda: adamw.fused_adamw_int8_plain(*args, **K4_HP))
        graphs[name] = graph_ms(lambda: adamw.fused_adamw_int8(*args, **K4_HP))
        b_ms, b_by = k4_bound(n)
        log(f"{tag}: two calls bit-identical; device ms (CUDA-graph replay) "
            f"{graphs[name]:.4f} vs bound {b_ms:.4f} ({b_by}; {graphs[name] / b_ms:.2f}x); "
            f"one call per event pair {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]")
        if not result:  # the conv leaf is the JSON's timed leaf
            result = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "n": n, "graph_ms": graphs[name]}
        result["max_abs_err"] = max(result["max_abs_err"], p_err)
    result["graph_ms_by_leaf"] = graphs
    if not hasattr(adamw, "fused_adamw_int8_many"):
        log("K4 multi-leaf call: not in this tree")
        return result
    # every leaf of the list in one call, the last one with no weight decay
    # (p and the state were not touched since the plain version read them)
    leaves, refs = [], []
    for k, (shape, perm, p, g, state) in enumerate(many):
        wd = 0.0 if k == len(many) - 1 else K4_HP["wd"]
        out = [t.clone() for t in (p, *state)]
        leaves.append((out[0].permute(perm), g.permute(perm), *out[1:], wd))
        want = [t.clone() for t in (p, *state)]
        adamw.fused_adamw_int8_plain(want[0].permute(perm), g.permute(perm), *want[1:],
                                     scalars, **dict(K4_HP, wd=wd))
        refs.append((out, want, math.prod(shape)))
    adamw.fused_adamw_int8_many(leaves, scalars, b1=K4_HP["b1"], b2=K4_HP["b2"],
                                eps=K4_HP["eps"])
    torch.cuda.synchronize()
    for k, (out, want, n) in enumerate(refs):
        k4_compare(f"K4 one call over {len(refs)} leaves, leaf {k}", out, want, n)
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


def run_slice(card: str, k1_ms: dict) -> int:
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
    time_frontend(card, slam, frames[0]["rgb"], k1_ms)
    return launches


def time_frontend(card: str, slam, rgb, k1_ms: dict) -> None:
    """Warm frontend calls after the slice's run: one frame's encode and
    a batch-8 decode_pairs_fused (store writes to the scrap slot), each
    the median of 10 calls between CUDA events (host work and the decode's
    fetch included), with K1's launches per call and its estimated share
    (K1's device ms at the call's shape x launches / call ms)."""
    import torch

    from vista_slam_tpu_torch.kernels import flash_attn as fa

    fe, store = slam.frontend, slam.pointmaps
    scrap = store.max_nodes - 1
    feats = slam.enc_feats
    pairs = FRONTEND_SHAPES["decode"][0] // 2
    calls = {
        "encode (1 frame)": (lambda: fe.encode(rgb), FRONTEND_SHAPES["encode"]),
        f"decode_pairs_fused ({pairs} pairs)": (
            lambda: fe.decode_pairs_fused(feats[:pairs], feats[1:pairs + 1], store,
                                          [scrap] * (2 * pairs), []),
            FRONTEND_SHAPES["decode"]),
    }
    for name, (fn, qshape) in calls.items():
        before = fa.LAUNCHES
        fn()
        torch.cuda.synchronize()
        per_call = fa.LAUNCHES - before
        ms = cuda_ms(fn, warmup=3, reps=10)
        share = k1_ms[qshape] * per_call / ms
        log(f"frontend warm {name}: {ms:.3f} ms per call (median of 10), {per_call} K1 "
            f"launches at q{list(qshape)}, K1 {k1_ms[qshape]:.4f} ms each: est. K1 "
            f"share {share:.3f} [{card}]")


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


def route_losses(model, batch, n_support: int) -> dict:
    """The memory-knob loss of one batch, forward only (no gradient), on the
    model's current weights, with FusedTrainAttention's forward routed
    through K3a, K1 (the same function), SDPA, K3's plain version, and K3's
    plain version in fp32 (inputs cast up, output cast back); each route's
    relative gap to the two plain ones. Not gated: a random-weight network
    in bf16 amplifies rounding, so the gaps are readings for PERF.md that
    tell rounding (K3a near K1 and SDPA) from a bias (K3a alone far off)."""
    import torch
    import torch.nn.functional as F

    from vista_slam_tpu_torch.kernels import attn_train as at
    from vista_slam_tpu_torch.kernels import flash_attn as fa
    from vista_slam_tpu_torch.train import finetune
    from vista_slam_tpu_torch.train.step import batch_to, make_loss_fn

    def plain_fp32(q, k, v, scale):
        out, lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), scale)
        return out.to(q.dtype), lse

    routes = {"K3a": at.fused_attention_fwd, "K1": fa.flash_attention,
              "SDPA": lambda q, k, v, scale: (
                  F.scaled_dot_product_attention(q, k, v, scale=scale), None),
              "plain": at.fused_attention_fwd_plain, "plain_fp32": plain_fp32}
    loss_fn, b = make_loss_fn(model, n_support), batch_to(batch, "cuda")
    losses, kernel = {}, at.fused_attention_fwd
    with torch.no_grad():
        try:
            for name, fwd in routes.items():
                at.fused_attention_fwd = fwd
                losses[name] = loss_fn(b, finetune.TRAIN["alpha_init"])[0].item()
        finally:
            at.fused_attention_fwd = kernel
    gaps = {ref: {name: abs(x - losses[ref]) / abs(losses[ref]) for name, x in losses.items()
                  if name != ref} for ref in ("plain", "plain_fp32")}
    return {"losses": losses, "gaps": gaps}


def run_train_slice(card: str, preset: str) -> dict:
    """A training preset at full width (train/finetune.py), TRAIN_STEPS
    steps of the preset's batch through make_train_step: highres.yaml's
    384x512 model with bf16_fused AdamW, or train_fast.yaml's 224x224 model
    with attn_fused_train and int8_fused AdamW; train_fast's
    hyper-parameters."""
    import ctypes

    import torch

    from vista_slam_tpu_torch.kernels import adamw
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
        if getattr(opt, "int8", None) is not None:  # K4's own, apart from the state
            log(f"{tag}: K4's row-maxima scratch {opt.int8.scratch.numel() * 4} bytes on "
                f"the card; its leaf table {len(opt.int8.entries)} x "
                f"{ctypes.sizeof(adamw._Leaf)} bytes on the host (kernel parameters)")
    # the reference's unused skip unit gets no gradient and no update
    with_grad = sum("refinenet4.resConfUnit1" not in n for n, _ in fused)
    per_step = 2 * (cfg.enc_depth + cfg.dec_depth)  # attention calls per step
    expected = {k: 0 for k in launch_counts()}
    for k in (fwd, *bwd):
        expected[k] = per_step * TRAIN_STEPS
    # K5, and K4 before its multi-leaf form: one launch per leaf with a
    # gradient; K4 now: its passes per step, whatever the leaf count
    per_opt_step = with_grad
    if preset == "memory_knob" and hasattr(adamw, "int8_launches"):
        per_opt_step = adamw.int8_launches(with_grad)
    expected[opt_k] = per_opt_step * TRAIN_STEPS
    route = "flash" if preset == "highres" else "fused"
    expected_calls = {"flash": 0, "plain": 0, "fused": 0, route: per_step * TRAIN_STEPS}
    first = {n: p.detach().clone() for n, p in model.named_parameters()}
    if preset == "memory_knob":
        routes = route_losses(model, batches[0], S)

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
    if preset == "memory_knob":
        log(f"{tag}: step-1 loss {losses[0]!r} through K3a; forward only on the same "
            f"weights and batch, by route: {routes['losses']}; relative gap to K3's "
            "plain versions: " + ", ".join(f"{n} {g:.3e}" for n, g in
                                           routes["gaps"]["plain"].items())
            + "; to K3's plain versions in fp32: " + ", ".join(
                f"{n} {g:.3e}" for n, g in routes["gaps"]["plain_fp32"].items())
            + f" [{card}]")
    if moved[1] != 0 or moved[3] == 0:
        raise AssertionError(f"params changed per step {moved}: want none after "
                             "step 1 (lr 0) and some by step 3")
    if launches != expected or calls != expected_calls:
        raise AssertionError(f"{tag} launches {launches} / paths {calls}, expected "
                             f"{expected} / {expected_calls}")
    out = {"launches": launches, "ms_per_step": ms, "peak_gib": peak}
    if preset == "memory_knob":
        out["k4_step"] = time_k4_step(card, opt)
    return out


def check_k4_step(card: str, opt, grads: dict, scalars, work) -> float:
    """The K4 work of one memory-knob step in the form the path runs it
    (``work``: on this tree the optimizer's table over every int8 leaf, one
    launch a pass), once on the slice's own parameters and state, against
    fused_adamw_int8_plain leaf by leaf on copies of what it read: per leaf
    k4_diff's agreement, each leaf's weight decay from the optimizer (a
    control without it must differ on the decayed leaves), and the leaves
    without a gradient unchanged. Returns p's max error."""
    import torch

    from vista_slam_tpu_torch.kernels import adamw
    from vista_slam_tpu_torch.train.quantized_opt import FusedInt8Leaf

    views = {i: (opt.params[i].data.permute(opt.layouts[i]), *m)
             for i, m in enumerate(opt.moments) if isinstance(m, FusedInt8Leaf)}
    before = {i: [t.clone() for t in v] for i, v in views.items()}
    work()
    torch.cuda.synchronize()
    hp = dict(b1=opt.b1, b2=opt.b2, eps=opt.eps)
    bad, p_err, agree, differing, worst, decayed, seen = [], 0.0, 0, 0, 0, 0, 0
    for i, got in views.items():
        want = before.pop(i)
        if i not in grads:
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                bad.append((i, "changed without a gradient"))
            continue
        wd = opt.weight_decay if opt.decay[i] else 0.0
        ctrl = [t.clone() for t in want] if wd else None
        adamw.fused_adamw_int8_plain(want[0], grads[i], *want[1:], scalars, wd=wd, **hp)
        if ctrl is not None:
            adamw.fused_adamw_int8_plain(ctrl[0], grads[i], *ctrl[1:], scalars, wd=0.0, **hp)
            decayed += 1
            seen += not torch.equal(ctrl[0], want[0])
        exact, codes, err, ok = k4_diff(f"K4 step leaf {i}", got, want, want[0].numel())
        p_err = max(p_err, err)
        agree += all(exact.values())
        differing += sum(c[0] for c in codes.values())
        worst = max([worst] + [c[1] for c in codes.values()])
        if not ok:
            bad.append((i, exact, codes))
    n = sum(views[i][0].numel() for i in grads)
    log(f"K4 over one memory-knob step in one table call ({len(grads)} leaves with a "
        f"gradient, {n} params, {len(views) - len(grads)} without) against the plain "
        f"version leaf by leaf: {agree} leaves with p and scales bit-identical, "
        f"p max abs err {p_err:.3e}, codes differing "
        f"{differing} (max {worst} step), weight decay seen on {seen} of {decayed} "
        f"decayed leaves [{card}]")
    if bad:
        raise AssertionError(f"K4 over one step disagrees with its plain version: {bad[:8]}")
    if decayed and not seen:
        raise AssertionError("K4 over one step: the p check cannot see weight decay")
    return p_err


def time_k4_step(card: str, opt) -> dict:
    """The K4 work of one memory-knob step, on the slice's own leaves and
    last gradients, after the slice's checks: the optimizer's table step
    over every int8 leaf with a gradient where the tree has one, else one
    fused_adamw_int8 call per leaf as that tree's step makes them; first
    held against the plain version (check_k4_step), then timed (each call
    updates the parameters again) by CUDA-graph replay (device time), and
    FusedAdamW.step() as a whole, one call per event pair (host work
    included: the gradient norm, the step scalars, K4, the small leaves in
    fp32); beside the bound of those leaves."""
    import torch

    from vista_slam_tpu_torch.kernels import adamw
    from vista_slam_tpu_torch.train.quantized_opt import FusedInt8Leaf

    live = [i for i, (p, m) in enumerate(zip(opt.params, opt.moments))
            if isinstance(m, FusedInt8Leaf) and p.grad is not None]
    grads = {i: opt.params[i].grad.contiguous().permute(opt.layouts[i]) for i in live}
    scalars = torch.tensor([0.7, 1.5e-5, 1 - 0.9 ** 3, 1 - 0.95 ** 3], device="cuda")
    if getattr(opt, "int8", None) is not None:
        table, by_leaf = opt.int8, [grads.get(i) for i in opt.int8_index]

        def work():
            table.step(by_leaf, scalars)
    else:
        views = [(opt.params[i].data.permute(opt.layouts[i]), grads[i], *opt.moments[i],
                  opt.weight_decay if opt.decay[i] else 0.0) for i in live]

        def work():
            for p, g, *state, wd in views:
                adamw.fused_adamw_int8(p, g, *state, scalars, wd=wd, b1=opt.b1, b2=opt.b2,
                                       eps=opt.eps)
    p_err = check_k4_step(card, opt, grads, scalars, work)
    n = sum(opt.params[i].numel() for i in live)
    b_ms, b_by = k4_bound(n)
    t = {"step_max_abs_err": p_err, "step_graph_ms": graph_ms(work, reps=10, inner=2),
         "step_event_ms": cuda_ms(opt.step, warmup=2, reps=10), "step_bound_ms": b_ms}
    log(f"K4 over one memory-knob step ({len(live)} leaves, {n} params): device ms "
        f"(CUDA-graph replay) {t['step_graph_ms']:.4f} vs bound {b_ms:.4f} ({b_by}; "
        f"{t['step_graph_ms'] / b_ms:.2f}x); FusedAdamW.step() one call per event pair "
        f"{t['step_event_ms']:.4f} ms (host work included) [{card}]")
    return t


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
    slam_launches = run_slice(card, k1["bf16_ms"])
    torch.cuda.empty_cache()
    train = run_train_slice(card, "highres")
    torch.cuda.empty_cache()
    knob = run_train_slice(card, "memory_knob")

    bounds = {**{k: v for k, v in attn_bounds(K1_TIMED_AT, 769, 2).items() if k == "K1"},
              **{k: v for k, v in attn_bounds(K2_TIMED_AT, 769, 2).items() if k != "K1"},
              **k3_bounds(K3_TIMED_AT, 2),
              "K4": (k4["bound_ms"], k4["bound_by"]),
              "K5": (k5["bound_ms"], k5["bound_by"])}
    # no single call computes K2a's or K2b's function: their JSON rows carry
    # the whole flash backward (delta, K2a, K2b) against SDPA's, by graph replay
    k2_pair = {"backward_graph_ms": sdpa["K2_graph"][0],
               "sdpa_backward_graph_ms": sdpa["K2_graph"][1]}
    timed = {"K1": dict(max_abs_err=k1["max_abs_err"], ms=k1["ms"], plain_ms=k1["plain_ms"],
                        library_ms=k1["library_ms"], timed_at=f"bf16 q{list(K1_TIMED_AT)}",
                        graph_ms=k1["graph_ms"], library_graph_ms=k1["library_graph_ms"]),
             "K2a": dict(k2["K2a"], library_ms=None, timed_at=f"bf16 q{list(K2_TIMED_AT)}",
                         **k2_pair),
             "K2b": dict(k2["K2b"], library_ms=None, timed_at=f"bf16 q{list(K2_TIMED_AT)}",
                         **k2_pair),
             "K3a": dict(k3["K3a"], library_ms=sdpa["K3a"], timed_at=f"bf16 q{list(K3_TIMED_AT)}"),
             "K3b": dict(k3["K3b"], library_ms=sdpa["K3b"], timed_at=f"bf16 q{list(K3_TIMED_AT)}"),
             "K4": dict(max_abs_err=max(k4["max_abs_err"], knob["k4_step"]["step_max_abs_err"]),
                        ms=k4["ms"], plain_ms=k4["plain_ms"],
                        library_ms=None, timed_at=f"leaf of {k4['n']} params",
                        graph_ms=k4["graph_ms"], graph_ms_by_leaf=k4["graph_ms_by_leaf"],
                        **knob["k4_step"]),
             "K5": dict(max_abs_err=k5["max_abs_err"], ms=k5["ms"], plain_ms=k5["plain_ms"],
                        library_ms=None, timed_at=f"leaf of {k5['n']} params",
                        graph_ms=k5["graph_ms"])}
    by_path = {k: {"slam": slam_launches if k == "K1" else 0,
                   "train": train["launches"][k],
                   "train_memory_knob": knob["launches"][k]} for k in KERNELS}
    log(json.dumps({"kernels": [{
        "name": KERNELS[k][0], "route": "cuda", "source": KERNELS[k][1],
        "replaces": KERNELS[k][2], "launches": sum(by_path[k].values()),
        "launches_by_path": by_path[k], "max_abs_err": timed[k]["max_abs_err"],
        "ms": timed[k]["ms"], "plain_ms": timed[k]["plain_ms"],
        "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
        "library_ms": timed[k]["library_ms"], "timed_at": timed[k]["timed_at"],
        "ms_by": "one call per CUDA event pair, host work included",
        **{f: timed[k][f] for f in ("graph_ms", "library_graph_ms", "graph_ms_with_delta",
                                    "backward_graph_ms", "sdpa_backward_graph_ms",
                                    "graph_ms_by_leaf", "step_graph_ms", "step_event_ms",
                                    "step_bound_ms")
           if f in timed[k]}}
        for k in KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
