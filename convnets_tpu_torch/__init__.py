"""convnets_tpu_torch — the PyTorch + CUDA port of convnets_tpu.

The JAX package `convnets_tpu` stays the reference; every module here
mirrors its counterpart's name and is tested against it on the CPU
(tests/test_torch_*.py). This package imports torch and never jax.

Ported so far: the eval-mode (serving) path of the ResNet family.
  core/      dtype policy, shape math
  ops/       plain tensor ops (NHWC), the CPU oracles of the kernels
  ops/kernels/  hand-written CUDA kernels (csrc/*.cu) and their wrappers
  nn/        modules whose child names follow the JAX variable paths
  models/    Builder, Model, registry; ResNet-18..152
  serve/     the serving forward (uint8 wire, baked normalization)
  train/     read side of JAX checkpoints
  bridge.py  JAX variables -> port parameters, matched by path
"""

__version__ = "0.1.0"
