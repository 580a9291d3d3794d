"""convnets_tpu_torch — the PyTorch + CUDA port of convnets_tpu.

The JAX package `convnets_tpu` stays the reference; every module here
mirrors its counterpart's name and is tested against it on the CPU
(tests/test_torch_*.py). This package imports torch, never jax, and nothing
of convnets_tpu.

Ported so far: the ResNet, MobileNet-v1, DenseNet and ResNeXt families'
serving and train paths, and the Trainer with its host feed.
  settings.py   run configuration (a copy of the JAX package's)
  core/      dtype policy, shape math, random-number streams
  ops/       plain tensor ops (NHWC), the CPU oracles of the kernels
  ops/kernels/  hand-written CUDA kernels (csrc/*.cu) and their wrappers
  nn/        modules whose child names follow the JAX variable paths
  models/    Builder, Model, registry; the four families
  data/      datasets, the seeded DataLoader, device_prefetch
  serve/     the serving forward (uint8 wire, baked normalization)
  train/     train and eval steps, Trainer, optimizers, schedulers,
             metrics, checkpoints in the JAX package's format
  bridge.py  JAX variables and optimizer state <-> port tensors, by path
"""

__version__ = "0.1.0"
