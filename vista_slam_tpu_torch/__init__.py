"""vista_slam_tpu_torch: the PyTorch + CUDA port of vista_slam_tpu for NVIDIA
Hopper (H100).

The JAX package ``vista_slam_tpu`` beside it is the reference; this package
imports torch and never jax, and nothing of the JAX package: its numpy-only
host modules (pose graph, host Sim(3) math, flow tracker, loop detector and
BoW vocabulary, synthetic scene, logging) are copies kept under the same
module names.

Layout:
  ops/      RoPE2D, attention dispatch, small linear algebra, Sim(3).
  kernels/  Python wrappers of the hand-written Hopper kernels (launch
            counters, plain-PyTorch versions beside each).
  csrc/     CUDA sources, built with nvcc at first use into _build/.
  models/   The STA frontend as nn.Modules (reference state-dict layout)
            and JAX-param -> state-dict conversion.
  slam/     Frontend engine, device pointmap store, dense Sim(3) PGO,
            OnlineSLAM without jax, host pose graph and loop detection.
  native/   The BoW vocabulary with its g++-built C++ helper.
  train/    Losses, AdamW (fused bf16 and int8 moments, the optax chain and
            its compressed carriers), the train step, the loader, presets.
  datasets/ Synthetic box scene, images-only sequences, batch sampler.
  cli/      build_slam / run_sequence / main of the offline entry point.
  utils/    Image resampling, camera geometry, config, logging.
"""
