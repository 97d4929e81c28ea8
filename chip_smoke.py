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
  6a. dispatch — ops/attention.py's use_flash=None threshold measured:
               mha_plain (fp32 inside, TF32 off) against K1 on bf16
               [B,12,N,64] at N = 196 (the 224x224 encoder) and the
               decoder's 197 ... 769, B = 1 and 16, by CUDA-graph replay, and
               the N from which K1 is faster;
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
 13. trainer — train/trainer.py's Trainer at full width with
               train_fast.yaml's hyper-parameters and 224x224 model and the
               two memory knobs (K3a, K3b, K4), batch 8 with 3 supports over
               the synthetic scene given as train_ds/test_ds, into a
               temporary directory: Trainer.fit over 2 epochs of 3 steps and
               one test batch each (losses, ms per step, test loss and alpha,
               peak memory, checkpoint bytes and save seconds); a fresh
               Trainer resumed from epoch 0's checkpoint, bit-identical to
               the file with K4's table on live storage, training epoch 1
               (its losses beside the first run's); 2 steps with remat from
               the same weights and batches (step-1 loss within 1e-3, K3a
               twice a step, lower peak memory); each run's K3a/K3b/K4
               launches equal to those derived, with no K1/K2/K5 and no
               plain or flash attention.
 14. long sequence — configs/default.yaml's model at full width (224x224,
               attention by sequence length: K1 everywhere) with random
               weights, stride-1 keyframing over 401 frames of the box-scene
               orbit (400 keyframes, max_view_num): (a) run_sequence with
               the final PGO by PCG (LONG_PGO), K1 launches equal to those
               derived, no plain or fused attention, the PGO's seconds, LM
               steps and CG iterations; (b) the state saved every 100
               keyframes (bytes, seconds), the save at keyframe 200 loaded
               into a fresh OnlineSLAM and run to the end: graph, view names
               and store before the final PGO bit-identical to (a)'s, the
               trajectory after it bit-identical too; (c) evaluate_scene
               over every 16th frame with GT and reconstruction: finite ATE
               and chamfer, evaluation_results.json written; (d) the batched
               7x7 SPD inverse three ways at [4800,7,7], and dense against
               PCG per 20-step solve on chain+loop graphs in the production
               buffers (4800 nodes / 5200 edges) at 512, 1024, 2048 and 4790
               optimised nodes (median of 3, warm), final losses within
               0.2%, the crossover beside PGOConfig.dense_max.
 15. any aspect — configs/highres.yaml's model at full width with random
               weights: (a) predict_pair_mixed_aspect on 4 pairs in the
               384x512 buffer (2 landscape, 1 portrait stored transposed, 1
               landscape with a portrait partner), each sample held against
               its pair alone, K1 launches equal to those derived, no plain
               or fused-train attention; (b) a linear-head model's forward
               and a 6D pose head (rotations on SO(3) to 1e-4); (c) the
               head_bf16 DPT output against the fp32 head on the same hooks,
               and a warm batch-8 decode_pairs_fused with each head (median
               of 10, a reading); (d) decode_pairs (fetch true and false)
               against decode_pairs_fused, one decode traced by
               utils/profiling.py::profile_to (K1's kernel in the trace), and
               a 10-keyframe run_sequence through a frontend without the
               fused step against the fused run's trajectory.
 16. (none: the learning proof's phase was taken out, its gate, trained
               SLAM ATE below the random weights', failing in most runs at
               the port's seed 0 with no port fault found; see PERF.md.
               The proof runs as python -m
               vista_slam_tpu_torch.scripts.train_synthetic.)
 17. adapt_gelu — vista_slam_tpu_torch/scripts/adapt_gelu.py --full-size
               (the flagship model at 224x224, bf16 compute) for 50 steps,
               drift every 25: the step-0 and step-50 drifts and the
               verdict; fails on a non-finite drift or loss and unless K1,
               K2a and K2b launched as derived from the model (every
               attention of every forward on K1, of every training backward
               on K2a/K2b) and no other kernel.
Each launch count is set to 0 just before a path runs and read just after.
The second-to-last line is the kernels JSON, the last line
{"ok": true, "device": {...}}. Without CUDA, or without the port next to
this file, it fails and prints no result.
"""

from __future__ import annotations

import functools
import itertools
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

# configs/default.yaml's SLAM settings (it has no model section: 224x224,
# use_flash None, so every attention takes K1 from 196 tokens), inlined so
# that the run needs no YAML parser; tests/test_torch_slam.py holds the two
# equal
DEFAULT = {
    "max_view_num": 400, "neighbor_edge_num": 3, "loop_edge_num": 3,
    "loop_dist_min": 40, "loop_nms": 40, "loop_cand_thresh_neighbor": 5,
    "point_conf_thres": 4.2, "rel_pose_thres": 0.75, "pgo_every": 500,
    "state_every": 0, "compute_dtype": "bfloat16", "combine_loop_batch": False,
    "random_seed": 43,
}
LONG_KEYFRAMES = 400     # phase 14a: max_view_num keyframes, stride 1
# 14a's PGO solver: this random-weight model keeps about 2 optimised nodes a
# keyframe (its pose confidences reject most non-consecutive edges), about
# 800 at 400 keyframes, below PGOConfig.dense_max (4800, set by 14d): the
# run names the solver, as configs/live.yaml shows
LONG_PGO = {"solver": "pcg"}
LONG_STATE_EVERY = 100   # 14b: saves at keyframes 100, 200, 300, 400
EVAL_STRIDE = 16         # 14c: evaluate_scene over every 16th frame of the orbit

# configs/train_fast.yaml's hyper-parameters and model section (its dataset
# specs name data outside the repository) with the two memory knobs,
# attn_fused_train and int8_fused; inlined so that the run needs no YAML
# parser; tests/test_torch_trainer.py holds the two equal
TRAINER = {
    "batch_size": 8, "epochs": 200, "lr": 1.5e-5, "min_lr": 1.0e-6, "weight_decay": 0.05,
    "warmup_epochs": 10, "clip": 1.0, "neighbor_num": 1, "loop_num": 1, "alpha_c2f": True,
    "alpha_init": 0.4, "seed": 0, "opt_state_dtype": "int8_fused",
    "model": {"gelu_approx": True, "attn_fused_train": True},
}
TRAINER_EPOCHS = 2        # of train_fast.yaml's 200
TRAINER_STEPS = 3         # per epoch: 24 view graphs at batch 8
TRAINER_TEST_BATCHES = 1  # per test epoch: 8 view graphs
# the 224x224 encoder's tokens and the decoder's (patches + the pose token)
# from 224x224 to 384x512, at batches of one pair and of 8 pairs (both
# directions)
CROSSOVER_N = (196, 197, 257, 385, 513, 769)
CROSSOVER_B = (1, 16)

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
    and on all of them in one multi-leaf call (k4_compare). At lr 1.5e-5
    the whole update is ~3e-6 of max|p| and weight decay only a part of
    that, so a tolerance on p would let a wrong update through; a control
    run of the plain version without weight decay shows that the check
    sees that share. Two calls are bit-identical. Times per leaf: one call per event pair (host work
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
        # K4's own, apart from the state
        log(f"{tag}: K4's row-maxima scratch {opt.int8.scratch.numel() * 4} bytes on "
            f"the card; its leaf table {len(opt.int8.entries)} x "
            f"{ctypes.sizeof(adamw._Leaf)} bytes on the host (kernel parameters)")
    # the reference's unused skip unit gets no gradient and no update
    with_grad = sum("refinenet4.resConfUnit1" not in n for n, _ in fused)
    per_step = 2 * (cfg.enc_depth + cfg.dec_depth)  # attention calls per step
    expected = {k: 0 for k in launch_counts()}
    for k in (fwd, *bwd):
        expected[k] = per_step * TRAIN_STEPS
    # K5: one launch per leaf with a gradient; K4: its passes per step,
    # whatever the leaf count
    per_opt_step = adamw.int8_launches(with_grad) if preset == "memory_knob" else with_grad
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
    (``work``: the optimizer's table over every int8 leaf, one launch a
    pass), once on the slice's own parameters and state, against
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
    over every int8 leaf with a gradient; first held against the plain
    version (check_k4_step), then timed (each call updates the parameters
    again) by CUDA-graph replay (device time), and FusedAdamW.step() as a
    whole, one call per event pair (host work included: the gradient norm,
    the step scalars, K4, the small leaves in fp32); beside the bound of
    those leaves."""
    import torch

    from vista_slam_tpu_torch.train.quantized_opt import FusedInt8Leaf

    live = [i for i, (p, m) in enumerate(zip(opt.params, opt.moments))
            if isinstance(m, FusedInt8Leaf) and p.grad is not None]
    grads = {i: opt.params[i].grad.contiguous().permute(opt.layouts[i]) for i in live}
    scalars = torch.tensor([0.7, 1.5e-5, 1 - 0.9 ** 3, 1 - 0.95 ** 3], device="cuda")
    table, by_leaf = opt.int8, [grads.get(i) for i in opt.int8_index]

    def work():
        table.step(by_leaf, scalars)

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


def time_dispatch_crossover(card: str) -> dict:
    """Where K1 overtakes the plain attention that ops/attention.py::mha
    runs below its use_flash=None threshold: mha_plain as the 224x224 SLAM
    default runs it (bf16 q, k, v cast up to fp32 inside, TF32 off) against
    K1 on the same inputs, [B, 12, N, 64] at the decoder's token counts, by
    CUDA-graph replay (device time). Returns, per batch, the smallest N of
    the table from which K1 is faster at every larger N (None if at no N)."""
    import torch

    from vista_slam_tpu_torch.kernels import flash_attn as fa
    from vista_slam_tpu_torch.ops.attention import mha_plain

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, crossover = [], {}
    for b in CROSSOVER_B:
        faster = []
        for n in CROSSOVER_N:
            q, k, v = (torch.randn((b, 12, n, 64), generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(3))
            plain = graph_ms(lambda: mha_plain(q, k, v, 0.125))
            k1 = graph_ms(lambda: fa.flash_attention(q, k, v, 0.125))
            rows.append(f"B={b} N={n}: plain {plain:.4f} ms, K1 {k1:.4f} ms, "
                        f"plain / K1 {plain / k1:.2f}")
            faster.append(k1 < plain)
        from_n = [n for i, n in enumerate(CROSSOVER_N) if all(faster[i:])]
        crossover[b] = from_n[0] if from_n else None
    log("dispatch crossover, device ms by CUDA-graph replay of mha_plain (fp32 inside, "
        f"TF32 off) and K1 on bf16 [B,12,N,64] [{card}]:\n  " + "\n  ".join(rows))
    log(f"dispatch crossover: K1 faster from N = {crossover} (by batch; "
        f"ops/attention.py takes flash from 512 when use_flash is None) [{card}]")
    return crossover


def trainer_graphs(n: int, seed: int):
    """n view graphs of the synthetic box scene at 224x224 (focal 0.75 W, as
    train/finetune.py renders it), each drawn once, as a dataset: every run
    of the trainer phase reads the same batches (SyntheticSceneDataset
    draws its neighbours from one generator as it is read)."""
    from vista_slam_tpu_torch.datasets.combinators import ComposableDataset
    from vista_slam_tpu_torch.datasets.synthetic_scene import SyntheticSceneDataset

    class Graphs(ComposableDataset):
        def __init__(self, graphs):
            self.graphs = graphs

        def __len__(self):
            return len(self.graphs)

        def __getitem__(self, idx):
            return self.graphs[idx[0] if isinstance(idx, tuple) else idx]

    ds = SyntheticSceneDataset(n_frames=n, hw=(224, 224), focal=168.0, seed=seed,
                               neighbor_num=TRAINER["neighbor_num"],
                               loop_num=TRAINER["loop_num"])
    return Graphs([ds[i] for i in range(n)])


def run_trainer(card: str) -> dict:
    """Phase 13: train/trainer.py's Trainer at full width on the card with
    TRAINER (train_fast.yaml's 224x224 model and hyper-parameters, K3a, K3b
    and K4), the first TRAINER_EPOCHS epochs of its 200-epoch schedule, of
    TRAINER_STEPS steps each, over the synthetic
    scene given as train_ds/test_ds, into a temporary directory removed at
    the end. Run 1: Trainer.fit (per-step losses and ms, test loss and alpha
    per epoch, peak memory, checkpoint bytes and save seconds). Run 2: a
    fresh Trainer resumes from epoch 0's checkpoint (load seconds), whose
    parameters, optimizer state and step must be bit-identical to the file
    and whose K4 table must still point at live storage; it trains epoch 1
    (its losses beside run 1's, a reading). Run 3: 2 steps with remat from
    the same weights and batches: the step-1 loss within 1e-3 of run 1's,
    K3a twice a step, peak memory below run 1's. Each run's K3a/K3b/K4
    launches (counts set to 0 just before it) must equal those derived
    from the model and the epochs, with no K1, K2 or K5 and every
    attention on the fused path. One trainer at a time on the card."""
    import dataclasses
    import gc
    import os
    import shutil
    import tempfile

    import torch

    from vista_slam_tpu_torch.kernels import adamw
    from vista_slam_tpu_torch.ops import attention
    from vista_slam_tpu_torch.train.quantized_opt import FusedInt8Leaf
    from vista_slam_tpu_torch.train.trainer import TrainConfig, Trainer, _alpha_schedule

    t_phase = time.perf_counter()
    B = TRAINER["batch_size"]
    train_ds = trainer_graphs(B * TRAINER_STEPS, 0)
    test_ds = trainer_graphs(B * TRAINER_TEST_BATCHES, 1)
    log(f"trainer: {len(train_ds)} train and {len(test_ds)} test view graphs at 224x224 "
        f"rendered in {time.perf_counter() - t_phase:.2f} s (host) [{card}]")
    root = tempfile.mkdtemp(prefix="chip_smoke_trainer_")

    def build(name: str, **model) -> Trainer:
        """A Trainer on train_fast's 200-epoch schedule (its lr warm-up of
        10 epochs), cut to its first TRAINER_EPOCHS epochs."""
        cfg = TrainConfig(output_dir=os.path.join(root, name),
                          **dict(TRAINER, model=dict(TRAINER["model"], **model)))
        t = Trainer(cfg, device="cuda", train_ds=train_ds, test_ds=None if model else test_ds)
        t.cfg = dataclasses.replace(cfg, epochs=TRAINER_EPOCHS)
        return t

    def instrument(t: Trainer) -> dict:
        """Record each step's loss and ms and each checkpoint's bytes and
        save seconds (the calls themselves unchanged)."""
        rec = {"losses": [], "ms": [], "saves": []}
        step, save = t.step_fn, t.save_checkpoint

        def timed_step(batch, alpha):
            t0 = time.perf_counter()
            loss, details = step(batch, alpha)
            rec["losses"].append(loss.item())
            rec["ms"].append(1e3 * (time.perf_counter() - t0))
            return loss, details

        def timed_save(epoch, best, name="checkpoints"):
            t0 = time.perf_counter()
            path = save(epoch, best, name)
            rec["saves"].append((f"{name}/{epoch}.pt", os.path.getsize(path),
                                 round(time.perf_counter() - t0, 3)))
            return path

        t.step_fn, t.save_checkpoint = timed_step, timed_save
        return rec

    def derived(t: Trainer, steps: int, forwards: int, remat: bool = False) -> tuple:
        """K3a/K3b/K4 launches and attention paths of `steps` train steps
        and `forwards` test batches: 72 attention calls a forward (2 x 24
        encoder blocks, 12 decoder blocks of 2), twice a step under remat;
        K4 its passes a step over the int8 leaves with a gradient."""
        c = t.model_cfg
        per_fwd = 2 * (c.enc_depth + c.dec_depth)
        names = [n for (n, _), m in zip(t.model.named_parameters(), t.optimizer.moments)
                 if isinstance(m, FusedInt8Leaf)]
        with_grad = sum("refinenet4.resConfUnit1" not in n for n in names)
        want = {k: 0 for k in launch_counts()}
        want["K3a"] = per_fwd * (steps * (2 if remat else 1) + forwards)
        want["K3b"] = per_fwd * steps
        want["K4"] = adamw.int8_launches(with_grad) * steps
        return want, {"flash": 0, "plain": 0, "fused": want["K3a"]}

    def check_counts(run: str, want: tuple) -> dict:
        got = launch_counts(), dict(attention.CALLS)
        log(f"trainer {run}: launches {got[0]} (derived {want[0]}), attention paths "
            f"{got[1]} (derived {want[1]})")
        if got != want:
            raise AssertionError(f"trainer {run}: launches / paths {got}, derived {want}")
        return got[0]

    def free() -> None:
        """Return a dropped trainer's memory to the card (its recording
        wrappers and itself form a cycle: collect it)."""
        gc.collect()
        torch.cuda.empty_cache()

    def rel(a: float, b: float) -> float:
        return abs(a - b) / abs(b)

    try:
        totals = {k: 0 for k in launch_counts()}
        # -- run 1: fit -----------------------------------------------------
        t = build("run1")
        t.init_state(resume=False)
        rec1, sched = instrument(t), t.optimizer.schedule
        want = derived(t, TRAINER_EPOCHS * TRAINER_STEPS, TRAINER_EPOCHS * TRAINER_TEST_BATCHES)
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        t.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        peak1 = torch.cuda.max_memory_allocated() / 2**30
        for k, v in check_counts("run 1 (fit)", want).items():
            totals[k] += v
        with open(os.path.join(root, "run1", "log.txt")) as f:
            epochs = [json.loads(line) for line in f]
        if not all(math.isfinite(x) for x in rec1["losses"] + [e["test_loss"] for e in epochs]):
            raise AssertionError(f"trainer run 1: non-finite losses {rec1['losses']}, "
                                 f"test {[e['test_loss'] for e in epochs]}")
        ms = statistics.median(rec1["ms"][1:])
        log(f"trainer run 1: Trainer.fit, {TRAINER_EPOCHS} epochs of {TRAINER_STEPS} steps "
            f"(batch {B}, 3 supports) and {TRAINER_TEST_BATCHES} test batch, in "
            f"{fit_s:.2f} s; losses per step {rec1['losses']}; ms per step "
            f"{[round(x, 2) for x in rec1['ms']]} (step 1 cold), median of steps 2-"
            f"{len(rec1['ms'])} {ms:.2f} ms; lr per step "
            f"{[float(sched(c)) for c in range(len(rec1['ms']))]}; test loss and alpha per epoch "
            f"{[(e['test_loss'], e['alpha']) for e in epochs]}; peak device memory "
            f"{peak1:.2f} GiB [{card}]")
        log(f"trainer run 1: checkpoints (file, bytes, save s) {rec1['saves']} [{card}]")
        ckpt0 = os.path.join(root, "run1", "checkpoints", "0.pt")
        del t, sched
        free()
        os.remove(os.path.join(root, "run1", "checkpoints", f"{TRAINER_EPOCHS - 1}.pt"))
        shutil.rmtree(os.path.join(root, "run1", "checkpoints_best"))

        # -- run 2: resume from epoch 0's checkpoint --------------------------
        os.makedirs(os.path.join(root, "run2", "checkpoints"))
        try:
            os.link(ckpt0, os.path.join(root, "run2", "checkpoints", "0.pt"))
        except OSError:  # no hard links on this file system
            shutil.copyfile(ckpt0, os.path.join(root, "run2", "checkpoints", "0.pt"))
        t = build("run2")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.init_state(resume=True)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        saved = torch.load(ckpt0, map_location="cpu", weights_only=True)
        model_sd, opt_sd = t.model.state_dict(), t.optimizer.state_dict()
        same = {
            "params": model_sd.keys() == saved["model"].keys() and all(
                torch.equal(v.cpu(), saved["model"][k]) for k, v in model_sd.items()),
            "optimizer": opt_sd["count"] == saved["optimizer"]["count"]
            and opt_sd["state_dtype"] == saved["optimizer"]["state_dtype"]
            and all(torch.equal(a.cpu(), b) for m, s in zip(opt_sd["moments"],
                                                           saved["optimizer"]["moments"])
                    for a, b in zip(m, s)),
            "step": t.step == saved["step"] == TRAINER_STEPS,
            "K4 table": t.optimizer.int8_ptrs == [t.optimizer.params[i].data_ptr()
                                                  for i in t.optimizer.int8_index]}
        del saved, model_sd, opt_sd
        log(f"trainer run 2: resumed at epoch {t.start_epoch} from epoch 0's checkpoint in "
            f"{load_s:.2f} s (Trainer.init_state, load in place); bit-identical to the "
            f"file: {same} [{card}]")
        if t.start_epoch != 1 or not all(same.values()):
            raise AssertionError(f"trainer run 2: start epoch {t.start_epoch}, {same}")
        rec2 = instrument(t)
        want = derived(t, TRAINER_STEPS, TRAINER_TEST_BATCHES)
        reset_counts()
        t.fit()
        torch.cuda.synchronize()
        for k, v in check_counts("run 2 (resumed epoch 1)", want).items():
            totals[k] += v
        ref = rec1["losses"][TRAINER_STEPS:]
        log(f"trainer run 2: epoch-1 losses {rec2['losses']}, run 1's {ref}, relative gaps "
            f"{[f'{rel(a, b):.3e}' for a, b in zip(rec2['losses'], ref)]}; checkpoints "
            f"{rec2['saves']} [{card}]")
        if not all(math.isfinite(x) for x in rec2["losses"]):
            raise AssertionError(f"trainer run 2: non-finite losses {rec2['losses']}")
        del t
        free()

        # -- run 3: remat, 2 steps from the same weights and batches ------------
        t = build("remat", remat=True)
        t.init_state(resume=False)
        t.loader.set_epoch(0)
        batches = list(itertools.islice(t.loader, 2))
        alpha = _alpha_schedule(t.cfg, 0)
        want = derived(t, 2, 0, remat=True)
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses3, ms3 = [], []
        for b in batches:
            t0 = time.perf_counter()
            losses3.append(t.step_fn(b, alpha)[0].item())
            ms3.append(1e3 * (time.perf_counter() - t0))
        peak3 = torch.cuda.max_memory_allocated() / 2**30
        for k, v in check_counts("run 3 (remat)", want).items():
            totals[k] += v
        gap = rel(losses3[0], rec1["losses"][0])
        log(f"trainer run 3: remat, losses {losses3} (step 1 vs run 1's "
            f"{rec1['losses'][0]!r}: relative gap {gap:.3e}, tol 1e-3); ms per step "
            f"{[round(x, 2) for x in ms3]}; peak device memory {peak3:.2f} GiB against run "
            f"1's {peak1:.2f} GiB [{card}]")
        if not (math.isfinite(losses3[1]) and gap <= 1e-3 and peak3 < peak1):
            raise AssertionError(f"trainer run 3 (remat): losses {losses3}, gap {gap}, "
                                 f"peak {peak3} vs {peak1} GiB")
        del t
        free()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    log(f"trainer: phase in {secs:.2f} s [{card}]")
    return {"launches": totals, "ms_per_step": ms, "peak_gib": peak1,
            "remat_peak_gib": peak3, "phase_s": secs}


# phase 14 (long sequence): the PGO production buffers (configs/default.yaml's
# max_view_num 400 x 12 node slots a keyframe; 5200 edges) and the sweep's
# optimised-node counts (scripts/profile_pgo.py's chain with loop edges)
PGO_BUFFERS = (4800, 5200)
PGO_SWEEP = (512, 1024, 2048, 4790)
PGO_REPS = 3            # timed solves per point, after one warm-up
PGO_LOSS_RTOL = 2e-3    # dense vs PCG final loss: the oracle contract (BASELINE.md)
INV_SHAPE = (4800, 7, 7)


def pgo_sweep_graph(n_opt: int, seed: int = 0) -> tuple:
    """scripts/profile_pgo.py's graph on the host: a chain of n_opt + 1
    nodes (0.3 m forward, 0.05 rad yaw a step, 0.05 m of translation noise
    on each odometry edge), a loop edge back 50 nodes every 97, node 0 fixed,
    padded to PGO_BUFFERS; nodes start at the integrated odometry. Returns
    the six optimize_pose_graph arrays as CUDA tensors."""
    import numpy as np
    import torch

    from vista_slam_tpu_torch.slam import host_math as hm

    rng = np.random.default_rng(seed)
    n, e = PGO_BUFFERS
    real = n_opt + 1
    phi = 0.05
    rot = np.asarray([[np.cos(phi), -np.sin(phi), 0], [np.sin(phi), np.cos(phi), 0],
                      [0, 0, 1]])
    step = np.concatenate([[0.3, 0.0, 0.0], hm.matrix_to_quat(rot), [1.0]]).astype(np.float32)
    gt = [hm.identity()]
    for _ in range(1, real):
        gt.append(hm.mul(gt[-1], step))
    edges, meas = [], []
    for k in range(1, real):
        z = hm.mul(hm.inv(gt[k - 1]), gt[k])
        z[:3] += 0.05 * rng.standard_normal(3).astype(np.float32)
        meas.append(z)
        edges.append((k, k - 1))
    for k in range(50, real, 97):
        meas.append(hm.mul(hm.inv(gt[k - 50]), gt[k]))
        edges.append((k, k - 50))
    nodes = np.tile(hm.identity(), (n, 1))
    for k in range(1, real):
        nodes[k] = hm.mul(nodes[k - 1], meas[k - 1])
    E = len(edges)
    edges_buf = np.zeros((e, 2), np.int64)
    edges_buf[:E] = edges
    meas_buf = np.tile(hm.identity(), (e, 1))
    meas_buf[:E] = np.stack(meas)
    valid = np.zeros(e, bool)
    valid[:E] = True
    opt = np.zeros(n, bool)
    opt[1:real] = True
    return tuple(torch.from_numpy(np.asarray(a)).cuda() for a in (
        nodes.astype(np.float32), edges_buf, meas_buf.astype(np.float32),
        np.ones((e, 7), np.float32), valid, opt))


def time_spd_inverses(card: str) -> dict:
    """The batched 7x7 SPD inverse of the block-tridiagonal preconditioner,
    three ways at INV_SHAPE, one call per event pair (host work included:
    the PGO runs eagerly, and cholesky_inverse's MAGMA path cannot be
    captured in a CUDA graph): the port's Gauss-Jordan (ops/linalg.py),
    torch.linalg.inv_ex, and cholesky_ex + cholesky_inverse; each one's
    error against a float64 inverse."""
    import torch

    from vista_slam_tpu_torch.ops.block_tridiag import spd_inv
    from vista_slam_tpu_torch.ops.linalg import gauss_jordan_inv

    gen = torch.Generator(device="cuda").manual_seed(5)
    a = torch.randn(INV_SHAPE, generator=gen, device="cuda")
    spd = a @ a.transpose(1, 2) + 0.5 * torch.eye(7, device="cuda")
    want = torch.linalg.inv(spd.double())

    def cholesky(b):
        L, _ = torch.linalg.cholesky_ex(b)
        return torch.cholesky_inverse(L)

    ways = {"gauss_jordan_inv": gauss_jordan_inv,
            "linalg.inv_ex": lambda b: torch.linalg.inv_ex(b)[0],
            "cholesky_ex + cholesky_inverse": cholesky}
    out = {}
    for name, fn in ways.items():
        err = ((fn(spd).double() - want).abs().max() / want.abs().max()).item()
        out[name] = (cuda_ms(lambda: fn(spd)), err)
    same = torch.equal(spd_inv(spd), torch.linalg.inv_ex(spd)[0])
    log(f"SPD inverse at {list(INV_SHAPE)} fp32, ms per call (event pair) and normwise "
        "error against float64: " + ", ".join(
            f"{k} {ms:.4f} ms ({err:.1e})" for k, (ms, err) in out.items())
        + f"; block_tridiag.spd_inv is the inv_ex route: {same} [{card}]")
    if not same or max(err for _, err in out.values()) > 1e-4:
        raise AssertionError("block_tridiag.spd_inv is not the inv_ex route, or an "
                             "inverse is off")
    return out


def sweep_pgo(card: str) -> dict:
    """Phase 14d: dense against PCG (tridiag) per 20-step solve of
    pgo_sweep_graph at each PGO_SWEEP size, warm (a 2-step solve of the
    same graph first), the median of PGO_REPS by the host clock with the
    card synchronised (the solve's host work included: the LM loop runs on
    the host), with LM steps, CG iterations and final losses; the losses
    must agree within PGO_LOSS_RTOL, and each solver's timed solves must
    give the same nodes bit for bit. Prints the crossover beside
    PGOConfig.dense_max."""
    import torch

    from vista_slam_tpu_torch.slam.pgo import PGOConfig, optimize_pose_graph

    rows = {}
    t_sweep = time.perf_counter()
    for n_opt in PGO_SWEEP:
        arrays = pgo_sweep_graph(n_opt)
        row = {}
        for solver in ("dense", "pcg"):
            cfg = PGOConfig(solver=solver)
            optimize_pose_graph(*arrays, cfg._replace(max_steps=2))  # warm-up
            times, xs = [], []
            for _ in range(PGO_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                x, info = optimize_pose_graph(*arrays, cfg)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                xs.append(x)
            if not torch.isfinite(x).all():
                raise AssertionError(f"PGO sweep {solver} at {n_opt}: non-finite nodes")
            if not all(torch.equal(xs[0], y) for y in xs[1:]):
                raise AssertionError(f"PGO sweep {solver} at {n_opt}: solves differ")
            row[solver] = {"ms": statistics.median(times), "all_ms": times,
                           "steps": info["steps"], "cg_iters": sum(info["cg_iters"]),
                           "loss0": info["loss0"], "loss": info["loss"]}
            torch.cuda.empty_cache()
        gap = abs(row["pcg"]["loss"] - row["dense"]["loss"]) / row["dense"]["loss"]
        row["loss_gap"] = gap
        rows[n_opt] = row
        log(f"PGO sweep at {n_opt} optimised nodes ({PGO_BUFFERS[0]} / {PGO_BUFFERS[1]} "
            f"buffers): dense {row['dense']['ms']:.1f} ms per solve "
            f"({row['dense']['steps']} LM steps), PCG {row['pcg']['ms']:.1f} ms "
            f"({row['pcg']['steps']} LM steps, {row['pcg']['cg_iters']} CG iterations), "
            f"median of {PGO_REPS} warm, each solver's {PGO_REPS} solves bit-identical; loss "
            f"{row['dense']['loss0']:.6g} -> dense "
            f"{row['dense']['loss']:.6g}, PCG {row['pcg']['loss']:.6g} (gap {gap:.2e}, "
            f"tol {PGO_LOSS_RTOL:g}) [{card}]")
        if not gap <= PGO_LOSS_RTOL:
            raise AssertionError(f"PGO sweep at {n_opt}: dense and PCG losses disagree")
    dense_wins = [n for n in PGO_SWEEP if rows[n]["dense"]["ms"] <= rows[n]["pcg"]["ms"]]
    implied = max(dense_wins) if dense_wins else 0
    log(f"PGO sweep: dense is faster at {dense_wins} optimised nodes, so dense_max >= "
        f"{implied} by this sweep; PGOConfig.dense_max = {PGOConfig().dense_max} (the "
        f"buffers' {PGO_BUFFERS[0]} nodes); sweep in {time.perf_counter() - t_sweep:.2f} s "
        f"[{card}]")
    return {"rows": rows, "implied_dense_max": implied}


def orbit_frames(n: int, hw=(224, 224)) -> list:
    """n frames of the box scene on a 1.5 m orbit, with the evaluation
    loaders' keys: rgb in [-1, 1], gray, GT depth, intrinsics and
    cam-to-world pose; rendered on the host by 8 threads."""
    import concurrent.futures

    import numpy as np

    from vista_slam_tpu_torch.datasets.synthetic_scene import BoxScene, orbit_trajectory

    h, w = hw
    K = np.array([[0.75 * w, 0, w / 2], [0, 0.75 * w, h / 2], [0, 0, 1]], np.float32)
    scene, poses = BoxScene(), orbit_trajectory(n, radius=1.5)

    def frame(t):
        rgb, depth = scene.render(poses[t], K, hw)
        return {"rgb": (rgb * 2 - 1).astype(np.float32),
                "gray": (rgb.mean(-1) * 255).astype(np.uint8), "depth": depth,
                "intrinsic": K, "camera_pose": poses[t].astype(np.float32),
                "img_name": f"frame_{t:04d}"}

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return list(pool.map(frame, range(n)))


def pre_pgo_snapshot(slam) -> dict:
    """The graph, view names and pointmap store as they stand (copies)."""
    g, store = slam.graph, slam.pointmaps
    nn, ne = g.num_nodes, g.num_edges
    return {"num_nodes": nn, "num_edges": ne, "node_poses": g.node_poses[:nn].copy(),
            "node_view": g.node_view[:nn].copy(),
            "node_connected_view": g.node_connected_view[:nn].copy(),
            "edges": g.edges[:ne].copy(), "edge_poses": g.edge_poses[:ne].copy(),
            "edge_confs": g.edge_confs[:ne].copy(),
            "view_to_nodes": {k: list(v) for k, v in g.view_to_nodes.items()},
            "view_best_node": dict(g.view_best_node), "view_names": list(slam.view_names),
            "loop_related_views": set(slam.loop_related_views),
            "store_depth": store.depth[:nn].clone(), "store_conf": store.conf[:nn].clone(),
            "store_intri": store.intri[:nn].copy()}


def snapshots_equal(a: dict, b: dict) -> dict:
    """Key by key, bit for bit."""
    import numpy as np
    import torch

    def same(x, y):
        if isinstance(x, torch.Tensor):
            return x.shape == y.shape and torch.equal(x, y)
        if isinstance(x, np.ndarray):
            return x.shape == y.shape and x.dtype == y.dtype and np.array_equal(x, y)
        return x == y

    return {k: same(a[k], b[k]) for k in a}


def watch_pgo(slam, record: dict) -> None:
    """Wrap slam.pose_graph_optimize: before each call, the snapshot and the
    optimised-node count; after it, its seconds (card synchronised) and
    the solver's info."""
    import torch

    optimize = slam.pose_graph_optimize

    def run():
        g = slam.graph
        start = max(0, slam.view_num - slam.pgo_window_size)
        record["opt_nodes"] = int(g.opt_mask_for_window(
            start, slam.view_num - 1, slam.loop_related_views).sum())
        record["snapshot"] = pre_pgo_snapshot(slam)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = optimize()
        torch.cuda.synchronize()
        record["seconds"] = time.perf_counter() - t0
        record["info"] = info
        return info

    slam.pose_graph_optimize = run


def run_long_sequence(card: str) -> dict:
    """Phase 14 (a)-(c): configs/default.yaml's model at full width
    (24x1024 encoder, 12x768 decoder, DPT and pose heads, 224x224) with
    random weights from a seeded generator, stride-1 keyframing over
    LONG_KEYFRAMES + 1 frames of the box-scene orbit, the final PGO by PCG
    (LONG_PGO).
    (a) run_sequence with counts set to 0 just before: view count, finite
        trajectory, K1 launches equal to those derived, no plain or fused
        attention, one PGO solve and by PCG; the PGO's seconds, optimised
        nodes, LM steps and CG iterations.
    (b) the state saved every LONG_STATE_EVERY keyframes (bytes, seconds);
        the middle save loaded into a fresh OnlineSLAM on the same frontend
        (seconds) and run to the end: its graph, view names and store just
        before the final PGO bit-identical to (a)'s, and after it the
        trajectory too (slam/pgo.py sums over edges in a fixed order, so a
        solve repeats bit for bit); the final losses and how far (a)'s PGO
        moved the poses are printed beside it; its K1 launches equal to
        those derived.
    (c) cli/evaluate.py's evaluate_scene over every EVAL_STRIDE-th frame of
        the orbit as a dataset with GT, reconstruction on: finite ATE and
        chamfer, evaluation_results.json written, K1 launches equal to
        those derived."""
    import json as _json
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vista_slam_tpu_torch.cli.common import build_slam
    from vista_slam_tpu_torch.cli.evaluate import evaluate_scene
    from vista_slam_tpu_torch.cli.run import PREFETCH_CHUNK, run_sequence
    from vista_slam_tpu_torch.ops import attention
    from vista_slam_tpu_torch.slam import pgo
    from vista_slam_tpu_torch.utils.config import make_config

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_long_")
    try:
        n = LONG_KEYFRAMES + 1  # stride-1 keyframing starts at frame 1
        frames = orbit_frames(n)
        log(f"long sequence: {n} frames of the box-scene orbit at 224x224 rendered in "
            f"{time.perf_counter() - t_phase:.2f} s (host, 8 threads) [{card}]")
        cfg = make_config(DEFAULT, keyframe_detection="stride", stride=1, device="cuda",
                          output_dir=os.path.join(tmp, "run"),
                          state_every=LONG_STATE_EVERY, pgo=LONG_PGO)
        os.makedirs(cfg.output_dir)
        t0 = time.perf_counter()
        slam = build_slam(cfg)
        mc = slam.frontend.cfg
        log(f"long sequence: model built in {time.perf_counter() - t0:.2f} s "
            f"({sum(p.numel() for p in slam.frontend.model.parameters()) / 1e6:.1f} M params, "
            f"img_size {list(mc.img_size)}, use_flash {mc.use_flash}) [{card}]")

        saves = []
        save_state = slam.save_state

        def save_numbered(path, **extra):  # keep every save, time it
            torch.cuda.synchronize()
            t = time.perf_counter()
            save_state(path, **extra)
            secs = time.perf_counter() - t
            kept = f"{path}.{slam.view_num}"
            os.replace(path, kept)
            saves.append((slam.view_num, kept, os.path.getsize(kept), secs))

        slam.save_state = save_numbered
        rec_a: dict = {}
        watch_pgo(slam, rec_a)

        # (a)
        expected = (mc.enc_depth * math.ceil(LONG_KEYFRAMES / PREFETCH_CHUNK)
                    + 2 * mc.dec_depth * (LONG_KEYFRAMES - 1))
        reset_counts()
        pgo.CALLS.update(dense=0, pcg=0)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_sequence(slam, frames, cfg, progress=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, calls, solves = launch_counts(), dict(attention.CALLS), dict(pgo.CALLS)
        traj = np.stack([slam.graph.view_pose_scale(v)[0] for v in range(slam.view_num)])
        info = rec_a["info"]
        td = slam.get_time_dict()
        save_s = sum(s[3] for s in saves)
        log(f"long sequence (a): {slam.view_num} keyframes in {wall:.3f} s "
            f"({(wall - rec_a['seconds'] - save_s) / slam.view_num * 1e3:.2f} ms a keyframe "
            f"without the PGO and the saves), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        log("long sequence (a) stage times (s, host clock): "
            + ", ".join(f"{k} {v:.3f}" for k, v in td.items()) + f" [{card}]")
        log(f"long sequence (a): final PGO over {rec_a['opt_nodes']} optimised nodes "
            f"({slam.graph.num_nodes} node slots, {slam.graph.num_edges} edges; dense_max "
            f"{pgo.PGOConfig().dense_max}, config pgo {LONG_PGO}) by {info['solver']} in "
            f"{rec_a['seconds']:.3f} s: "
            f"{info['steps']} LM steps, CG iterations per step {info['cg_iters']} "
            f"({sum(info['cg_iters'])} in all), loss {info['loss0']:.6g} -> "
            f"{info['loss']:.6g}; solves by route {solves} [{card}]")
        log(f"long sequence (a): K1 launches {counts['K1']} (expected {expected}), attention "
            f"paths {calls}, trajectory {list(traj.shape)}")
        if slam.view_num != LONG_KEYFRAMES:
            raise AssertionError(f"view_num {slam.view_num} != {LONG_KEYFRAMES}")
        if traj.shape != (LONG_KEYFRAMES, 4, 4) or not np.isfinite(traj).all():
            raise AssertionError("long sequence: trajectory is not a finite [V,4,4] array")
        if (counts != dict.fromkeys(counts, 0) | {"K1": expected}
                or calls != {"flash": expected, "plain": 0, "fused": 0}):
            raise AssertionError(f"long sequence: launches {counts} / paths {calls}, "
                                 f"expected {expected} flash launches only")
        if solves != {"dense": 0, "pcg": 1}:
            raise AssertionError(f"long sequence: the final PGO ({rec_a['opt_nodes']} nodes, "
                                 f"solves {solves}) did not go through PCG")
        long_a = {"launches": counts["K1"], "pgo_s": rec_a["seconds"], "info": info,
                  "opt_nodes": rec_a["opt_nodes"], "wall_s": wall}

        # (b)
        log("long sequence (b): state saves (keyframe, bytes, save s) "
            f"{[(v, b, round(s, 3)) for v, _, b, s in saves]} [{card}]")
        views = [v for v, *_ in saves]
        if views != list(range(LONG_STATE_EVERY, LONG_KEYFRAMES + 1, LONG_STATE_EVERY)):
            raise AssertionError(f"long sequence: saves at {views}")
        mid_view, mid_path, mid_bytes, mid_s = saves[(len(saves) - 1) // 2]
        cfg_b = make_config(cfg, output_dir=os.path.join(tmp, "resumed"), state_every=0)
        resumed = build_slam(cfg_b, frontend=slam.frontend)
        t0 = time.perf_counter()
        extras = resumed.load_state(mid_path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        rec_b: dict = {}
        watch_pgo(resumed, rec_b)
        # the prefetch chunks from the resumed keyframe's on, and a decode
        # for each keyframe left
        expected_b = (mc.enc_depth * ((LONG_KEYFRAMES - 1) // PREFETCH_CHUNK
                                      - mid_view // PREFETCH_CHUNK + 1)
                      + 2 * mc.dec_depth * (LONG_KEYFRAMES - mid_view))
        reset_counts()
        run_sequence(resumed, frames, cfg_b, progress=False,
                     start_frame=int(extras["frame_cursor"]) + 1)
        launches_b = launch_counts()
        same = snapshots_equal(rec_b["snapshot"], rec_a["snapshot"])
        traj_b = np.stack([resumed.graph.view_pose_scale(v)[0]
                           for v in range(resumed.view_num)])
        extent = float(np.abs(traj[:, :3, 3]).max())
        gap = float(np.abs(traj_b - traj).max()) if traj_b.shape == traj.shape else np.inf
        loss_gap = abs(rec_b["info"]["loss"] - info["loss"]) / max(info["loss"], 1e-30)
        before = rec_a["snapshot"]["node_poses"]
        moved = float(np.abs(slam.graph.node_poses[:len(before)] - before).max())
        log(f"long sequence (b): resumed from the save at keyframe {mid_view} "
            f"({mid_bytes} bytes, saved in {mid_s:.3f} s, loaded in {load_s:.3f} s); "
            f"before the final PGO bit-identical to (a): "
            f"{all(same.values())} {[k for k, v in same.items() if not v] or ''}; after "
            f"it max |pose (b) - pose (a)| {gap:.3e} (trajectory extent {extent:.3e}; (a)'s "
            f"PGO moved node entries by up to {moved:.3e}), final loss {rec_b['info']['loss']:.6g} vs {info['loss']:.6g} "
            f"(relative gap {loss_gap:.2e}, {rec_b['info']['steps']} vs {info['steps']} LM "
            f"steps); its K1 launches {launches_b['K1']} (expected {expected_b}) [{card}]")
        if launches_b != dict.fromkeys(launches_b, 0) | {"K1": expected_b}:
            raise AssertionError(f"long sequence: resumed run's launches {launches_b}")
        if not all(same.values()):
            raise AssertionError(f"long sequence: resumed state differs before the PGO: {same}")
        if not (np.isfinite(traj_b).all() and gap == 0.0):
            raise AssertionError("long sequence: resumed trajectory differs after the PGO")
        del resumed, rec_b, rec_a
        torch.cuda.empty_cache()

        # (c)
        cfg_c = make_config(cfg, stride=EVAL_STRIDE, state_every=0,
                            output_dir=os.path.join(tmp, "eval"))

        class Orbit:  # the orbit as an evaluation dataset with GT
            def __len__(self):
                return len(frames)

            def __getitem__(self, i):
                return frames[i]

        slam_c = build_slam(cfg_c, frontend=slam.frontend)
        out_c = os.path.join(cfg_c.output_dir, "orbit")
        reset_counts()
        t0 = time.perf_counter()
        res = evaluate_scene(slam_c, Orbit(), cfg_c, out_c, do_recon=True)
        eval_s = time.perf_counter() - t0
        launches_c = launch_counts()
        n_c = len(range(1, n, EVAL_STRIDE))  # evaluate_scene's keyframes
        expected_c = (mc.enc_depth * math.ceil(n_c / PREFETCH_CHUNK)
                      + 2 * mc.dec_depth * (n_c - 1))
        written = _json.load(open(os.path.join(out_c, "evaluation_results.json")))
        log(f"long sequence (c): evaluate_scene over {res['n_keyframes']} keyframes (stride "
            f"{EVAL_STRIDE}) with reconstruction in {eval_s:.2f} s: {res}; "
            f"evaluation_results.json {written == res}; K1 launches "
            f"{launches_c['K1']} (expected {expected_c}) [{card}]")
        if launches_c != dict.fromkeys(launches_c, 0) | {"K1": expected_c}:
            raise AssertionError(f"long sequence: evaluation's launches {launches_c}")
        if not (written == res and res["n_keyframes"] == n_c and all(np.isfinite(res[k]) for k in (
                "ate_rmse", "ate_mean", "recon_acc", "recon_comp", "recon_chamfer"))):
            raise AssertionError(f"long sequence: evaluation not finite or not written: {res}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    log(f"long sequence (a)-(c): in {secs:.2f} s [{card}]")
    return {**long_a, "state_bytes": mid_bytes, "save_s": mid_s, "load_s": load_s,
            "eval": res, "phase_s": secs}


# phase 15 (any aspect): configs/highres.yaml's model at full width; 4 pairs in
# the 384x512 landscape buffer: 2 landscape, 1 portrait (512x384, stored
# transposed), 1 landscape with a portrait partner
ANY_ASPECT_KINDS = (("landscape", "landscape"), ("landscape", "landscape"),
                    ("portrait", "portrait"), ("landscape", "portrait"))
# bf16 bound, normwise (max |a - b| / max |b|), for a sample of the mixed
# batch against the same pair predicted alone, and for the plain decode's
# per-pair outputs against the fused decode's: the same kernels on the same
# inputs, the batch composition changing only the GEMMs' tiling
ANY_ASPECT_TOL = 2e-2
PLAIN_TRAJ_TOL = 1e-3  # the plain-decode run's trajectory against the fused run's
K1_KERNEL = "flash_fwd_bf16"  # K1's bf16 kernel (csrc/flash_attn_fwd.cu), in traces


class PlainFrontend:
    """A FrontendEngine seen without decode_pairs_fused and
    encode_decode_pairs_fused: OnlineSLAM then takes its plain path
    (decode_pairs without fetch, store write, scale reductions, one fetch)."""

    _HIDDEN = ("decode_pairs_fused", "encode_decode_pairs_fused")

    def __init__(self, engine):
        self._engine = engine

    def __getattr__(self, name):
        if name in self._HIDDEN:
            raise AttributeError(name)
        return getattr(self._engine, name)


def normwise(got, want) -> float:
    """max |got - want| / max |want|, fp32 on the host."""
    import torch

    got, want = torch.as_tensor(got).float().cpu(), torch.as_tensor(want).float().cpu()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-12)).item()


def check_path_counts(tag: str, expected_k1: int) -> int:
    """The launches since reset_counts(): K1 == expected_k1 and no other
    kernel, every attention on the flash path."""
    from vista_slam_tpu_torch.ops import attention

    counts, calls = launch_counts(), dict(attention.CALLS)
    if (counts != dict.fromkeys(counts, 0) | {"K1": expected_k1}
            or calls != {"flash": expected_k1, "plain": 0, "fused": 0}):
        raise AssertionError(f"{tag}: launches {counts} / paths {calls}, expected "
                             f"{expected_k1} K1 launches through flash only")
    return counts["K1"]


def run_any_aspect(card: str) -> dict:
    """Phase 15: configs/highres.yaml's model at full width (24x1024
    encoder, 12x768 decoder, 384x512) with random weights from the seeded
    generator, through the paths a user of any aspect, of either head
    variant and of a frontend without the fused step reaches.
    (a) predict_pair_mixed_aspect on ANY_ASPECT_KINDS: each sample's pts3d,
        conf and pose against its pair alone, normwise within
        ANY_ASPECT_TOL: a landscape pair against predict_pair_any_aspect; the
        portrait pair against the forward on its true 512x384 images (the
        mixed path embeds a portrait sample in its true orientation, as the
        reference's ManyAR patch embed does, where predict_pair_any_aspect
        transposes a portrait pair into landscape first: another input to
        the model, run here for finite outputs of the true shape); the mixed
        pair against predict_pair_mixed_aspect on it alone. K1's launches
        equal to those derived (two encodes and one decode), no plain or
        fused-train attention.
    (b) a head_type 'linear' model's forward (finite pointmaps; K1 derived)
        and a '6D' pose head over its pose tokens: rotations orthonormal with
        det +1 to 1e-4.
    (c) head_bf16: the DPT head in bf16 against fp32 on the same hooks
        (normwise gap, printed), and a warm batch-8 decode_pairs_fused with
        the head in fp32 and in bf16 (median of 10 by CUDA events): a
        reading, not gated.
    (d) decode_pairs (fetch true and false) against decode_pairs_fused on
        the same features, within ANY_ASPECT_TOL; one decode_pairs traced by
        utils/profiling.py::profile_to (the trace holds K1's kernel); a
        10-keyframe run_sequence through PlainFrontend against the same run
        on the fused step: trajectories within PLAIN_TRAJ_TOL, K1 derived.
    Returns the K1 launches of the paths (a), (b) and (d)'s plain run."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vista_slam_tpu_torch.cli.common import build_frontend, build_slam
    from vista_slam_tpu_torch.cli.run import PREFETCH_CHUNK, run_sequence
    from vista_slam_tpu_torch.models.heads import PoseHead
    from vista_slam_tpu_torch.models.sta import (STA, predict_pair_any_aspect,
                                                 predict_pair_mixed_aspect)
    from vista_slam_tpu_torch.slam.pointmap_store import DevicePointmapStore
    from vista_slam_tpu_torch.utils.config import make_config
    from vista_slam_tpu_torch.utils.profiling import profile_to

    t_phase = time.perf_counter()
    cfg = make_config(HIGHRES, keyframe_detection="stride", stride=1, device="cuda")
    h, w = cfg.model["img_size"]
    fe = build_frontend(cfg)
    model, mc = fe.model, fe.cfg
    per_forward = 2 * mc.enc_depth + 2 * mc.dec_depth  # two encodes, one decode
    land = orbit_frames(N_FRAMES, (h, w))
    port = orbit_frames(4, (w, h))
    launches = {}

    # (a) the mixed-aspect batch -------------------------------------------
    pick = {"landscape": iter(land), "portrait": iter(port)}
    views = [[torch.from_numpy(next(pick[kind])["rgb"]).to("cuda") for kind in kinds]
             for kinds in ANY_ASPECT_KINDS]
    shapes = [[list(v.shape[:2]) for v in pair] for pair in views]
    # portrait views are stored transposed in the landscape buffer
    buf = [torch.stack([pair[s] if pair[s].shape[0] <= pair[s].shape[1]
                        else pair[s].transpose(0, 1) for pair in views]) for s in range(2)]
    B = len(views)
    with torch.inference_mode():
        reset_counts()
        t0 = time.perf_counter()
        out = predict_pair_mixed_aspect(model, buf[0], buf[1], [sh[0] for sh in shapes],
                                        [sh[1] for sh in shapes])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches["mixed"] = check_path_counts("any aspect (a)", per_forward)
        errs = []
        for k, (pair, kinds) in enumerate(zip(views, ANY_ASPECT_KINDS)):
            if kinds == ("landscape", "landscape"):
                alone = predict_pair_any_aspect(model, pair[0][None], pair[1][None])
            elif kinds == ("portrait", "portrait"):
                alone = model(pair[0][None], pair[1][None])
                via = predict_pair_any_aspect(model, pair[0][None], pair[1][None])
                if (via["pts3d"].shape != alone["pts3d"].shape
                        or not all(torch.isfinite(via[key]).all() for key in via)):
                    raise AssertionError("predict_pair_any_aspect on the portrait pair: "
                                         "non-finite or not in the true orientation")
            else:
                alone = predict_pair_mixed_aspect(model, buf[0][k:k + 1], buf[1][k:k + 1],
                                                  [shapes[k][0]], [shapes[k][1]])
            for d, row in enumerate((k, B + k)):
                portrait = bool(out["portrait_mask"][row])
                e = {}
                for key in ("pts3d", "conf", "pose"):
                    got = out[key][row]
                    if key != "pose" and portrait and kinds[0] == kinds[1]:
                        got = got.transpose(0, 1)  # buffer layout -> true orientation
                    if not torch.isfinite(got).all():
                        raise AssertionError(f"any aspect (a) pair {k} {key}: non-finite")
                    e[key] = normwise(got, alone[key][d])
                errs.append(e)
                log(f"any aspect (a) pair {k} ({kinds[0]}/{kinds[1]}) direction {d + 1}"
                    f"{' (portrait)' if portrait else ''}: normwise err vs alone "
                    + ", ".join(f"{key} {v:.3e}" for key, v in e.items())
                    + f" (bound {ANY_ASPECT_TOL:g}) [{card}]")
    worst = max(v for e in errs for v in e.values())
    log(f"any aspect (a): {B} pairs at buffer {h}x{w}, mask "
        f"{out['portrait_mask'].int().tolist()}, in {secs:.3f} s (cold), K1 launches "
        f"{launches['mixed']} (expected {per_forward}), worst normwise err {worst:.3e} "
        f"[{card}]")
    if worst > ANY_ASPECT_TOL:
        raise AssertionError(f"mixed-aspect batch disagrees with the pairs alone: {worst}")
    del out, alone

    # (b) head variants ----------------------------------------------------
    lin = STA(dataclasses.replace(mc, head_type="linear")).to("cuda").eval()
    lin.init_weights_(torch.Generator(device="cuda").manual_seed(5))
    head6 = PoseHead(mc.dec_dim, rot_representation="6D").to("cuda")
    head6.reset_rotation_()  # zero kernel, identity bias; then a random kernel
    with torch.no_grad():
        head6.fc_rot.weight.normal_(0.0, 0.05, generator=torch.Generator(
            device="cuda").manual_seed(6))
    with torch.inference_mode():
        a, b = buf[0][:2], buf[1][:2]
        reset_counts()
        o = lin(a, b)
        torch.cuda.synchronize()
        launches["linear"] = check_path_counts("any aspect (b) linear head", per_forward)
        final = lin.decode_pair(lin.encode(a), lin.encode(b))[2]
        R = head6(final[:, 0])["pose"][:, :3, :3].double()
    eye = torch.eye(3, dtype=torch.float64, device=R.device)
    orth = (R @ R.transpose(1, 2) - eye).abs().max().item()
    det = (torch.linalg.det(R) - 1).abs().max().item()
    spread = (R - eye).abs().max().item()
    finite = bool(torch.isfinite(o["pts3d"]).all() and torch.isfinite(o["conf"]).all()
                  and torch.isfinite(R).all())
    log(f"any aspect (b): linear head pts3d {list(o['pts3d'].shape)} finite {finite}, K1 "
        f"launches {launches['linear']}; 6D pose head on its {R.shape[0]} pose tokens: "
        f"|RR^T - I| {orth:.3e}, |det - 1| {det:.3e}, max |R - I| {spread:.3f} [{card}]")
    if not finite or orth > 1e-4 or det > 1e-4:
        raise AssertionError("head variants: non-finite output or a rotation off SO(3)")
    del lin, o, final

    # (c) the bf16 head ----------------------------------------------------
    dpt = model.downstream_head_pts.dpt
    with torch.inference_mode():
        f1, f2 = model.encode(buf[0][:2]), model.encode(buf[1][:2])
        h1, h2, final = model.decode_pair(f1, f2)
        hooks = [torch.cat([f1, f2]).float(), h1[:, 1:], h2[:, 1:], final[:, 1:]]
        raw32 = dpt(hooks, (h, w))
        dpt.dtype = torch.bfloat16
        raw16 = dpt(hooks, (h, w))
        dpt.dtype = torch.float32
    head_gap = normwise(raw16, raw32)
    rel_l2 = ((raw16 - raw32).norm() / raw32.norm()).item()
    feats = [f for chunk in (land[:8], land[8:9])
             for f in fe.encode_batch(np.stack([x["rgb"] for x in chunk]))]
    store = DevicePointmapStore(2 * 8 + 1, (h, w), device="cuda")
    scrap = store.max_nodes - 1

    def decode8():
        return fe.decode_pairs_fused(feats[:8], feats[1:9], store, [scrap] * 16, [])

    head_ms = {}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        dpt.dtype = dtype
        head_ms[name] = cuda_ms(decode8, warmup=3, reps=10)
    dpt.dtype = torch.float32
    log(f"any aspect (c): head_bf16 DPT output vs fp32 on the same hooks (2 pairs): "
        f"normwise gap {head_gap:.3e}, relative L2 {rel_l2:.3e}; warm batch-8 "
        f"decode_pairs_fused {head_ms['fp32']:.3f} ms with the fp32 head, "
        f"{head_ms['bf16']:.3f} ms with head_bf16 (median of 10, CUDA events; "
        f"bf16 / fp32 {head_ms['bf16'] / head_ms['fp32']:.3f}) [{card}]")
    del raw16, raw32, hooks, h1, h2, final

    # (d) the plain decode -------------------------------------------------
    fused = decode8()
    plain = fe.decode_pairs(feats[:8], feats[1:9])
    lazy = fe.decode_pairs(feats[:8], feats[1:9], fetch=False)
    perr = {}
    for key in ("pose_ij", "pose_ji", "pose_conf_ij", "pose_conf_ji", "mean_conf_i",
                "mean_conf_j", "K"):
        perr[key] = max(normwise(plain[key], fused[key]),
                        normwise(lazy[key].cpu(), fused[key]))
    if lazy["depth_dev"].shape != (16, h, w) or {plain["bucket"], lazy["bucket"]} != {8}:
        raise AssertionError("decode_pairs: unexpected dense layout or bucket")
    log("any aspect (d): decode_pairs (fetch true / false) vs decode_pairs_fused, 8 "
        "pairs, normwise: " + ", ".join(f"{k} {v:.3e}" for k, v in perr.items())
        + f" (bound {ANY_ASPECT_TOL:g}) [{card}]")
    if max(perr.values()) > ANY_ASPECT_TOL:
        raise AssertionError(f"the plain decode disagrees with the fused one: {perr}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        with profile_to(tmp) as prof:
            fe.decode_pairs(feats[:1], feats[1:2])
        size = os.path.getsize(prof.trace_path)
        with open(prof.trace_path) as fh:
            k1_in_trace = K1_KERNEL in fh.read()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"any aspect (d): profile_to wrote a {size}-byte trace of one decode_pairs; "
        f"K1's kernel {K1_KERNEL} in it: {k1_in_trace} [{card}]")
    if not k1_in_trace:
        raise AssertionError("the profile_to trace does not hold K1's kernel")
    del store, feats, fused, plain, lazy
    torch.cuda.empty_cache()

    n_kf = N_FRAMES - 1  # stride-1 keyframing starts at frame 1
    expected = mc.enc_depth * math.ceil(n_kf / PREFETCH_CHUNK) + 2 * mc.dec_depth * (n_kf - 1)
    trajs, walls = {}, {}
    for name, frontend in (("fused", fe), ("plain", PlainFrontend(fe))):
        slam = build_slam(cfg, frontend=frontend)
        reset_counts()
        t0 = time.perf_counter()
        run_sequence(slam, land, cfg, progress=False)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        launches[f"run_{name}"] = check_path_counts(f"any aspect (d) {name} run", expected)
        trajs[name] = np.stack([slam.graph.view_pose_scale(v)[0]
                                for v in range(slam.view_num)])
        del slam
        torch.cuda.empty_cache()
    gap = np.abs(trajs["plain"] - trajs["fused"]).max()
    log(f"any aspect (d): {n_kf}-keyframe run_sequence through the plain path "
        f"{walls['plain']:.3f} s vs the fused step {walls['fused']:.3f} s (host clock, "
        f"final PGO included): trajectories {list(trajs['plain'].shape)}, max |plain - "
        f"fused| {gap:.3e} (bound {PLAIN_TRAJ_TOL:g}), K1 launches {launches['run_plain']} "
        f"each (expected {expected}) [{card}]")
    if (trajs["plain"].shape != (n_kf, 4, 4) or not np.isfinite(trajs["plain"]).all()
            or gap > PLAIN_TRAJ_TOL):
        raise AssertionError("the plain-decode run's trajectory disagrees with the fused run's")
    secs = time.perf_counter() - t_phase
    log(f"any aspect: phase in {secs:.2f} s [{card}]")
    return {"launches": launches["mixed"] + launches["linear"] + launches["run_plain"],
            "head_ms": head_ms, "head_gap": head_gap, "phase_s": secs}


# phase 17 (erf -> tanh adaptation at full width): scripts/adapt_gelu.py's
# port with --full-size, cut to 50 steps
ADAPT_ARGS = {"steps": 50, "eval_every": 25, "batch": 4, "n_train_pairs": 32,
              "n_eval_pairs": 8}


def run_adapt_gelu(card: str) -> dict:
    """Phase 17: vista_slam_tpu_torch.scripts.adapt_gelu.main --full-size
    (the flagship 24x1024 / 12x768 model at 224x224, bf16 compute, fp32
    parameters, seeded random weights) for ADAPT_ARGS' steps: the erf
    teacher's outputs, then the tanh student trained under Adam, its drift
    against the teacher at step 0 and every eval_every steps. Fails on a
    non-finite drift or loss, and unless K1 launched once per attention of
    every forward (teacher, drift and training; 196 and 197 tokens) and
    K2a/K2b once per attention of every training step, through the flash
    path only, with no other kernel."""
    import numpy as np

    from vista_slam_tpu_torch.ops import attention
    from vista_slam_tpu_torch.scripts import adapt_gelu

    t_phase = time.perf_counter()
    a = ADAPT_ARGS
    fs = adapt_gelu.FULL_SIZE
    per_forward = 2 * (fs["enc_depth"] + fs["dec_depth"])  # two encodes, one decode
    evals = len({s for s in range(1, a["steps"] + 1)
                 if s % a["eval_every"] == 0 or s == a["steps"]})
    batches = [-(-a[k] // a["batch"]) for k in ("n_train_pairs", "n_eval_pairs")]
    forwards = sum(batches) + (1 + evals) * batches[1] + a["steps"]
    expected = dict.fromkeys(launch_counts(), 0) | {
        "K1": per_forward * forwards, "K2a": per_forward * a["steps"],
        "K2b": per_forward * a["steps"]}
    reset_counts()
    res = adapt_gelu.main(["--full-size"] + [f"--{k.replace('_', '-')}={v}" for k, v in a.items()])
    counts, calls = launch_counts(), dict(attention.CALLS)
    secs = time.perf_counter() - t_phase
    drifts = res["drifts"]
    for step in (0, a["steps"]):
        m, r = drifts[step]
        log(f"adapt_gelu: step {step} drift max|d| " + ", ".join(f"{k} {v:.3e}" for k, v in m.items())
            + "; relative " + ", ".join(f"{k} {v:.3e}" for k, v in r.items()) + f" [{card}]")
    log(f"adapt_gelu: {res['verdict']}; losses step 1 {res['losses'][0]:.4e}, step "
        f"{a['steps']} {res['losses'][-1]:.4e}; {a['steps']} steps in {res['train_s']:.2f} s "
        f"({1e3 * res['train_s'] / a['steps']:.1f} ms a step with the drift evaluations, "
        f"host clock); launches {counts} (expected {expected}), attention {calls}; "
        f"phase in {secs:.2f} s [{card}]")
    finite = np.isfinite([v for m, r in drifts.values() for d in (m, r) for v in d.values()])
    if not (finite.all() and np.isfinite(res["losses"]).all()
            and len(res["losses"]) == a["steps"]):
        raise AssertionError("adapt_gelu: non-finite drift or loss")
    if counts != expected or calls != {"flash": expected["K1"], "plain": 0, "fused": 0}:
        raise AssertionError(f"adapt_gelu: launches {counts} / paths {calls}, expected "
                             f"{expected} through flash only")
    return {"launches": counts, "phase_s": secs}


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
    time_dispatch_crossover(card)
    check_svd(card)
    check_small_agreement(card)
    check_train_agree(card, "highres")
    check_train_agree(card, "memory_knob")
    slam_launches = run_slice(card, k1["bf16_ms"])
    torch.cuda.empty_cache()
    train = run_train_slice(card, "highres")
    torch.cuda.empty_cache()
    knob = run_train_slice(card, "memory_knob")
    torch.cuda.empty_cache()
    trainer = run_trainer(card)
    torch.cuda.empty_cache()
    t_long = time.perf_counter()
    long_seq = run_long_sequence(card)
    torch.cuda.empty_cache()
    time_spd_inverses(card)
    sweep_pgo(card)
    log(f"long sequence phase (a)-(d): in {time.perf_counter() - t_long:.2f} s [{card}]")
    torch.cuda.empty_cache()
    any_aspect = run_any_aspect(card)
    torch.cuda.empty_cache()
    adapt = run_adapt_gelu(card)

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
                   "train_memory_knob": knob["launches"][k],
                   "trainer": trainer["launches"][k],
                   "long_sequence": long_seq["launches"] if k == "K1" else 0,
                   "any_aspect": any_aspect["launches"] if k == "K1" else 0,
                   "adapt_gelu": adapt["launches"][k]}
               for k in KERNELS}
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
