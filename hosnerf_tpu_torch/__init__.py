"""HOSNeRF in PyTorch for NVIDIA Hopper: the stage-2 human-object field
(render and training), the scene stack and the stage-3 composed step.

Mirrors the module layout of `hosnerf_tpu` (the JAX reference), so each
counterpart sits at the same relative path:

  core/      body/skeleton math (torch + jax-free numpy helpers), ray and
             step-function math, the geodesic basis, compositing
  models/    embedders, state selection, init helpers, the human components
             and `HumanObjectField`, the scene's `SceneField`, LPIPS and
             the stage-3 composition
  ops/       trilinear sampling, gather-form LBS (the dense path), the
             stage-3 sample merge
  ops/cuda/  the sorted-domain glue and the hand-written Hopper kernels
             (inverse LBS, fused embed+trunk, fused forward LBS, forward
             and backward) with their plain versions
  csrc/      CUDA C++ sources of those kernels, built at first use
  data/      synthetic stage-2 and stage-3 batches (numpy)
  eval/      chunked image rendering (human field, composed model)
  train/     the stage-2 and stage-3 steps, the gradient check
  convert    JAX human, scene and LPIPS params -> this package's
             state_dicts

Importing the package imports neither JAX nor Triton and compiles nothing.
"""
