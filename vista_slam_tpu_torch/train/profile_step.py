"""Where the time of the full-width training step goes, on one GPU.

Run from the repository root:
  python -m vista_slam_tpu_torch.train.profile_step [--preset NAME] [--steps N]
      [--img-size H W] [--batch B] [--[no-]attn-fused-train]
      [--opt-state MODE] [--table PATH]

Builds a training preset of train/finetune.py at full width with random
weights and 3 supports: by default ``highres``, the 384x512 fine-tune
(configs/highres.yaml's model, configs/train_fast.yaml's hyper-parameters,
bf16_fused AdamW, batch 2), or ``--preset memory_knob``, train_fast.yaml's
224x224 model at batch 8 with attn_fused_train and int8_fused AdamW. The
JAX package's scripts/profile_train.py flags that apply replace the
preset's settings: --img-size, --batch, --[no-]attn-fused-train,
--opt-state. train_fast.yaml as written (plain attention, bf16 carried
moments) is ``--preset memory_knob --no-attn-fused-train --opt-state bf16``.
It runs two warm-up steps, then traces N steps (default 2) with
torch.profiler and prints:
  * device time by kernel family (the port's kernels K1, K2a, K2b, K3a,
    K3b, K4, K5; matrix products; convolutions; everything else), summed
    over the traced steps, with its share of the device time and its
    device events (launches, copies, memsets) per step;
  * the device busy time against the host wall time of the traced steps
    (the idle share), the peak device memory over the warm-up and traced
    steps, the bytes of the optimizer's state, and the 25 kernels with the
    most device time.
With --table, the profiler's full table (200 rows) is written to PATH.
Needs CUDA.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

FAMILIES = (  # first match wins, on the lower-cased kernel name
    ("K1 flash fwd", ("flash_fwd",)),
    ("K2a flash bwd dq", ("flash_bwd_dq",)),
    ("K2b flash bwd dkv", ("flash_bwd_dkv",)),
    ("K3a fused attn fwd", ("attn_fwd_",)),
    ("K3b fused attn bwd", ("attn_bwd_",)),
    ("K4 adamw int8", ("adamw_int8",)),
    ("K5 adamw", ("adamw_bf16",)),
    # cuDNN's FFT convolutions run complex GEMMs (cf32) between their
    # transforms; its layout kernels (nchwToNhwc) serve the convolutions too
    ("convolution", ("conv", "implicit", "winograd", "fft", "dgrad", "wgrad",
                     "cf32", "nchwtonhwc", "nhwctonchw")),
    ("matrix product", ("gemm", "xmma", "cutlass", "nvjet", "matmul")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other (elementwise, norms, reductions, copies)"


def state_bytes(x) -> int:
    """Bytes of every tensor in a nest of tuples and lists (the optimizer's
    moments, codes and scales)."""
    if isinstance(x, (tuple, list)):
        return sum(state_bytes(y) for y in x)
    return x.numel() * x.element_size()


def main() -> int:
    from . import finetune

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="highres", choices=sorted(finetune.PRESETS))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--img-size", type=int, nargs=2, default=None, metavar=("H", "W"),
                    help="input resolution (default: the preset's)")
    ap.add_argument("--batch", type=int, default=None, help="default: the preset's")
    ap.add_argument("--attn-fused-train", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="the fused short-sequence attention (K3a/K3b) below the "
                         "flash threshold (cfg.attn_fused_train; default: the preset's)")
    ap.add_argument("--opt-state", default=None,
                    choices=("fp32", "bf16", "int8", "bf16_fused", "int8_fused"),
                    help="Adam moment storage (default: the preset's)")
    ap.add_argument("--table", default=None, help="write the full table here")
    args = ap.parse_args()
    overrides = {}
    if args.img_size:
        overrides["img_size"] = tuple(args.img_size)
    if args.attn_fused_train is not None:
        overrides["attn_fused_train"] = args.attn_fused_train
    batch = args.batch or finetune.PRESETS[args.preset].batch

    import torch
    if not torch.cuda.is_available():
        print("profile_step: needs a CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    model, opt, step_fn = finetune.build("cuda", preset=args.preset,
                                         state_dtype=args.opt_state, batch=batch, **overrides)
    batches = finetune.batches(model.cfg.img_size, 2 + args.steps, batch=batch)
    torch.cuda.reset_peak_memory_stats()
    alpha = finetune.TRAIN["alpha_init"]
    for b in batches[:2]:
        step_fn(b, alpha)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[2:]:
            step_fn(b, alpha)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)

    # device events (kernels, copies, memsets) with their device intervals
    kernels = [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
               if e.device_type.name == "CUDA"]
    if not kernels:
        print("profile_step: the trace holds no device events", file=sys.stderr)
        return 1
    busy_ms = sum(ms for _, ms in kernels)
    fams: dict[str, float] = {}
    launches: dict[str, int] = {}
    for name, ms in kernels:
        fams[family(name)] = fams.get(family(name), 0.0) + ms
        launches[family(name)] = launches.get(family(name), 0) + 1
    n = args.steps
    print(card)
    cfg = model.cfg
    print(f"preset {args.preset}: {list(cfg.img_size)}, batch {batch}, use_flash "
          f"{cfg.use_flash}, attn_fused_train {cfg.attn_fused_train}, moments "
          f"{opt.state_dtype}")
    print(f"traced {n} steps: host wall {wall_ms:.2f} ms ({wall_ms / n:.2f} ms/step), "
          f"device busy {busy_ms:.2f} ms ({busy_ms / n:.2f} ms/step), idle share "
          f"{1 - busy_ms / wall_ms:.3f} [{card}]")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"optimizer state {state_bytes(opt.moments)} bytes [{card}]")
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"  {fam}: {ms / n:.2f} ms/step ({ms / busy_ms:.1%} of device time, "
              f"{launches[fam] / n:g} launches/step)")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    if args.table:
        os.makedirs(os.path.dirname(os.path.abspath(args.table)), exist_ok=True)
        with open(args.table, "w") as f:
            f.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=200))
    return 0


if __name__ == "__main__":
    sys.exit(main())
