"""The learning proof's SLAM ATE by the port and by the JAX script, on one
weights file: vista_slam_tpu_torch.scripts.train_synthetic.run_slam_eval
and scripts/train_synthetic.py's run_slam_eval (imported by path), both on
the CPU, over the proof's held-out orbit. Prints both ATEs and their gap.

Not a test (the JAX side's compiles take half a minute even at a tiny
width); it reads weights that a training run wrote. Usage:

  JAX_PLATFORMS=cpu python tests/compare_slam_eval.py WEIGHTS.npz [--fp32]

WEIGHTS.npz is the JAX package's format, as train_synthetic --out writes
it. --fp32 runs both models in fp32 compute instead of the proof's bf16.
"""

import argparse
import dataclasses
import importlib.util
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("weights")
    ap.add_argument("--fp32", action="store_true")
    args = ap.parse_args(argv)

    import jax.numpy as jnp
    import numpy as np
    import torch

    from vista_slam_tpu.models.convert import load_params_npz as jax_load_params_npz
    from vista_slam_tpu.models.sta import STAConfig as JSTAConfig
    from vista_slam_tpu_torch.datasets.synthetic_scene import orbit_trajectory
    from vista_slam_tpu_torch.models.convert import load_params_npz, state_dict_from_jax
    from vista_slam_tpu_torch.scripts import train_synthetic

    spec = importlib.util.spec_from_file_location(
        "jax_train_synthetic", os.path.join(REPO, "scripts", "train_synthetic.py"))
    jts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jts)

    cfg = train_synthetic.CONFIG
    if args.fp32:
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    jcfg = JSTAConfig(
        compute_dtype=jnp.float32 if args.fp32 else jnp.bfloat16,
        **{f: getattr(cfg, f) for f in ("img_size", "patch_size", "enc_dim", "enc_depth",
                                        "enc_heads", "dec_dim", "dec_depth", "dec_heads",
                                        "mlp_ratio", "head_type")})
    poses = orbit_trajectory(20, radius=1.6, height=0.4).astype(np.float32)
    t0 = time.perf_counter()
    port = train_synthetic.run_slam_eval(
        cfg, state_dict_from_jax(load_params_npz(args.weights)), poses,
        train_synthetic.DATASET, "cpu")
    t1 = time.perf_counter()
    ref = jts.run_slam_eval(jcfg, jax_load_params_npz(args.weights), poses,
                            train_synthetic.DATASET)
    t2 = time.perf_counter()
    print(f"{args.weights} ({'fp32' if args.fp32 else 'bf16'} compute): SLAM ATE port "
          f"{port:.6f} m ({t1 - t0:.1f} s), JAX script {ref:.6f} m ({t2 - t1:.1f} s), "
          f"gap {abs(port - ref):.3e} m ({abs(port - ref) / ref:.3e} relative)")


if __name__ == "__main__":
    main()
