"""erf→tanh GELU adaptation by self-distillation (the port of
scripts/adapt_gelu.py): make ``gelu_approx=True`` usable with erf-trained
weights.

The same parameters run twice: as the erf TEACHER (its outputs computed
once, under ``no_grad``, from the initial parameters) and as the tanh
STUDENT (trained with Adam at optax's defaults), minimizing the squared
error of every model output (pts3d, conf, pose, pose_conf) on synthetic
image pairs; no labels are needed. Reports the parity drift metrics
(max|Δpts3d|, max|Δpose| against atol 5e-3, max|Δconf|, max|Δpose_conf|
against 1e-3) and the relative drift on held-out pairs at step 0 (the raw
flip) and every ``--eval-every`` steps, and the first step at which all
four are inside the tolerances. A non-finite output gives a NaN drift,
which is never inside them.

Usage:
  python -m vista_slam_tpu_torch.scripts.adapt_gelu [--full-size]
      [--steps 300] [--params f.npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..datasets.synthetic_scene import SyntheticSceneDataset
from ..models.convert import load_params_npz, state_dict_from_jax
from ..models.sta import STA, STAConfig
from . import device_name, script_device

# the JAX script's two models; fp32 parameters under either compute dtype
SMALL = dict(img_size=(64, 64), patch_size=8, enc_dim=96, enc_depth=4, enc_heads=4,
             dec_dim=64, dec_depth=4, dec_heads=4, mlp_ratio=4,
             compute_dtype=torch.float32, param_dtype=torch.float32)
FULL_SIZE = dict(img_size=(224, 224), patch_size=16, enc_dim=1024, enc_depth=24,
                 enc_heads=16, dec_dim=768, dec_depth=12, dec_heads=12, mlp_ratio=4,
                 compute_dtype=torch.bfloat16, param_dtype=torch.float32)
KEYS = ("pts3d", "conf", "pose", "pose_conf")
ATOL = {"pts3d": 5e-3, "pose": 5e-3, "conf": 1e-3, "pose_conf": 1e-3}


def make_pairs(ds, idxs):
    a = np.stack([ds.view(i)["img"] for i, _ in idxs])
    b = np.stack([ds.view(j)["img"] for _, j in idxs])
    return a.astype(np.float32), b.astype(np.float32)


def split_pairs(seed: int, n_train: int, n_eval: int):
    """The JAX script's (i, i + 1..3) pairs over the 64-frame orbit:
    (train pairs, held-out pairs)."""
    rng = np.random.default_rng(seed)
    n = n_train + n_eval
    pairs = [(int(i), int((i + d) % 64)) for i, d in zip(rng.integers(0, 64, n),
                                                         rng.integers(1, 4, n))]
    return pairs[:n_train], pairs[n_train:]


def distill_loss(out: dict, t_out: dict) -> torch.Tensor:
    return sum(torch.mean((out[k].float() - t_out[k].float()) ** 2) for k in KEYS)


def drift(forward, batches, t_outs):
    """max|Δ| (absolute, the parity metrics) and max relative drift
    max|Δ|/(|teacher|+1) of each output family against the teacher's
    outputs ``t_outs`` over ``batches``, in float64 on the host. A NaN
    anywhere makes that family's drift NaN (numpy's max and maximum
    propagate it)."""
    m = dict.fromkeys(KEYS, 0.0)
    r = dict.fromkeys(KEYS, 0.0)
    for (a, b), t_out in zip(batches, t_outs):
        out = forward(a, b)
        for k in KEYS:
            t = t_out[k].double().cpu().numpy()
            d = np.abs(out[k].double().cpu().numpy() - t)
            m[k] = float(np.maximum(m[k], d.max()))
            r[k] = float(np.maximum(r[k], (d / (np.abs(t) + 1.0)).max()))
    return m, r


def within(m: dict) -> bool:
    """Every family inside its tolerance (a NaN drift never is)."""
    return all(m[k] <= ATOL[k] for k in KEYS)


def report(step: int, m: dict, r: dict) -> bool:
    ok = within(m)
    print(f"step {step:4d}: " + "  ".join(
        f"max|d{k}|={m[k]:.2e}{' ' if m[k] <= ATOL[k] else '*'}"
        for k in KEYS) + ("  << WITHIN FULL-PARITY TOLERANCES" if ok else ""), flush=True)
    print("          rel: " + "  ".join(f"{k}={r[k]:.2e}" for k in KEYS), flush=True)
    return ok


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full-size", action="store_true",
                    help="flagship 224x224 enc 1024x24 / dec 768x12, bf16 "
                         "compute; default is a small CPU-runnable config")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-5)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--n-train-pairs", type=int, default=32)
    ap.add_argument("--n-eval-pairs", type=int, default=8)
    ap.add_argument("--params", default=None,
                    help="npz of erf-trained params (the JAX package's layout, "
                         "models/convert.py); default: seeded random init")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = script_device(args.device)
    kw = FULL_SIZE if args.full_size else SMALL
    hw = kw["img_size"]
    print(f"device: {device_name(device)}  config: "
          f"{'full-size' if args.full_size else 'small'}")
    ds = SyntheticSceneDataset(n_frames=64, hw=hw, focal=48.0 * hw[0] / 64, radius=2.0)
    tr_pairs, ev_pairs = split_pairs(args.seed, args.n_train_pairs, args.n_eval_pairs)

    teacher = STA(STAConfig(gelu_approx=False, **kw)).to(device)
    if args.params:
        teacher.load_state_dict(state_dict_from_jax(load_params_npz(args.params)))
    else:
        teacher.init_weights_(torch.Generator(device=device).manual_seed(args.seed))
    teacher.eval()

    def batches(pairs):
        for k in range(0, len(pairs), args.batch):
            a, b = make_pairs(ds, pairs[k: k + args.batch])
            yield (torch.as_tensor(a, device=device), torch.as_tensor(b, device=device))

    train_batches, eval_batches = list(batches(tr_pairs)), list(batches(ev_pairs))
    t0 = time.time()
    with torch.no_grad():
        t_train = [teacher(a, b) for a, b in train_batches]
        t_eval = [teacher(a, b) for a, b in eval_batches]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"teacher (erf) outputs precomputed on "
          f"{len(tr_pairs)}+{len(ev_pairs)} pairs ({time.time() - t0:.0f}s)")

    student = STA(STAConfig(gelu_approx=True, **kw)).to(device)
    student.load_state_dict(teacher.state_dict())
    del teacher
    opt = torch.optim.Adam(student.parameters(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8)

    @torch.no_grad()
    def s_fwd(a, b):
        return student(a, b)

    drifts = {0: drift(s_fwd, eval_batches, t_eval)}
    print("raw flip (step 0) — erf weights under tanh GELU, no adaptation:")
    k_ok = 0 if report(0, *drifts[0]) else None
    step = 0
    losses = []
    t0 = time.time()
    while step < args.steps:
        for (a, b), t_out in zip(train_batches, t_train):
            opt.zero_grad(set_to_none=True)
            loss = distill_loss(student(a, b), t_out)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            step += 1
            if step % args.eval_every == 0 or step == args.steps:
                drifts[step] = drift(s_fwd, eval_batches, t_eval)
                if report(step, *drifts[step]) and k_ok is None:
                    k_ok = step
            if step >= args.steps:
                break
    losses = torch.stack(losses).float().cpu().numpy() if losses else np.zeros(0)
    secs = time.time() - t0
    print(f"\n{args.steps} adaptation steps in {secs:.0f}s")
    if k_ok is not None:
        verdict = f"VERDICT: within full-parity tolerances from step {k_ok}"
    else:
        verdict = "VERDICT: NOT within tolerances yet — raise --steps or --lr"
    print(verdict)
    return {"drifts": drifts, "losses": losses, "k_ok": k_ok, "verdict": verdict,
            "train_s": secs, "device": device_name(device)}


if __name__ == "__main__":
    main()
