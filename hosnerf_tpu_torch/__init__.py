"""HOSNeRF in PyTorch for NVIDIA Hopper: the stage-2 human-object field
(render and training), the scene stack, the stage-1 and stage-3 trainers,
the host data pipeline that feeds them, the training loop, checkpoints,
evaluation and command line that run them, on one card or data-parallel
over several (torchrun).

Mirrors the module layout of `hosnerf_tpu` (the JAX reference), so each
counterpart sits at the same relative path:

  core/      body/skeleton math (torch + jax-free numpy helpers), ray and
             step-function math, the geodesic basis, compositing, SMPL
  models/    embedders, state selection, init helpers, the human components
             and `HumanObjectField`, the scene's `SceneField`, LPIPS and
             the stage-3 composition
  ops/       trilinear sampling, the gather and one-hot ('xla') LBS forms
             (the dense path), the stage-3 sample merge
  ops/cuda/  the sorted-domain glue and the hand-written Hopper kernels
             (inverse LBS, fused embed+trunk, fused forward LBS, forward
             and backward) with their plain versions
  csrc/      CUDA C++ sources of those kernels, built at first use
  config/    the gin and yaml config readers (no PyYAML)
  data/      the host pipeline in numpy: PNG and image operations in
             place of cv2 (`imgproc`), cameras and rays, the scene loader
             and its batch pipeline, the human dataset, the mini capture
             and synthetic batches, `to_device`
  eval/      chunked image rendering (scene, human field, composed
             model), the evaluation sweeps, metrics and image output
  train/     the stage-1, stage-2 and stage-3 steps, the training loop,
             checkpoints, the gradient check
  cli/       the command line (`python -m hosnerf_tpu_torch.cli.run`,
             or under torchrun over N cards)
  parallel/  the process group (`distributed`) and the ray-axis sharding
             of batches, draws, gradients and eval chunks (`mesh`)
  utils/     file helpers, the TensorBoard event writer, device timing
             (`benchtools`)
  entry      the dry-run entry: the tiny eval step, and N processes
             holding each stage's sharded step to the one-process step
  convert    JAX human, scene and LPIPS params -> this package's
             state_dicts

Importing the package imports neither JAX nor Triton and compiles nothing.
"""
