"""vista_slam_tpu_torch: the PyTorch + CUDA port of vista_slam_tpu for NVIDIA
Hopper (H100).

The JAX package ``vista_slam_tpu`` beside it is the reference; this package
imports torch and never jax. Its numpy-only host modules (pose graph, host
Sim(3) math, loop detector, synthetic scene, logging) are imported from the
JAX package rather than copied.

Layout:
  ops/      RoPE2D, attention dispatch, small linear algebra, Sim(3).
  kernels/  Python wrappers of the hand-written Hopper kernels (launch
            counters, plain-PyTorch versions beside each).
  csrc/     CUDA sources, built with nvcc at first use into _build/.
  models/   The STA frontend as nn.Modules (reference state-dict layout)
            and JAX-param -> state-dict conversion.
  slam/     Frontend engine, device pointmap store, dense Sim(3) PGO,
            OnlineSLAM without jax.
  cli/      build_slam / run_sequence / main of the offline entry point.
  utils/    Image resampling, camera geometry, config.
"""
